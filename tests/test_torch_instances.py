"""The instance stage's modules of the port against the JAX package on the
CPU: K11's twin (the advection and the basin predicate) against both JAX
advection forms, K12's twins (``ops/ccl``) against ``irn_tpu.ops.ccl_tpu``
on the cases of ``tests/test_ccl_tpu.py``, the seed build, and the chunked
walk (``RandomWalkRunner.propagate_all``) against the one-shot walk and the
JAX ``propagate_all``. Every kernel wrapper takes its twin here (CPU
tensors: no launch)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import ccl_tpu
from irn_tpu.ops import centroids as jax_centroids
from irn_tpu.pipeline import stages_irn as jax_stages
from irn_tpu.pipeline.config import Config as JaxConfig
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import ccl
from irn_tpu_torch.ops import centroids
from irn_tpu_torch.pipeline import stages_irn
from irn_tpu_torch.pipeline.config import Config

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_launches():
    _build.reset_launches()
    yield
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


# -- K11 --------------------------------------------------------------------


@pytest.mark.parametrize("iters", [1, 4, 8])
@pytest.mark.parametrize("hw4", [(24, 32), (19, 27)])
def test_advect_matches_jax_forms(rng, hw4, iters):
    """Exact against the JAX default (matmul) and the gather oracle at short
    horizons, on the field of tests/test_instances_eval.py."""
    dp = (rng.standard_normal((2, 24, 32)) * 1.2).astype(np.float32)
    args = (jnp.asarray(dp), jnp.int32(hw4[0]), jnp.int32(hw4[1]), iters)
    cent, basin = centroids.advect(torch.from_numpy(dp), *hw4, iters)
    assert cent.dtype == torch.int32 and basin.dtype == torch.bool
    np.testing.assert_array_equal(
        cent.numpy(), np.asarray(jax_centroids._find_centroids_matmul(*args)))
    np.testing.assert_array_equal(
        cent.numpy(), np.asarray(jax_centroids._find_centroids_gather(*args)))


def _basin_field(rng, h=24, w=32):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    attract = np.where(xx < 16, 1.0, 0.0)
    cy = attract * 8 + (1 - attract) * 15
    cx = attract * 7 + (1 - attract) * 25
    dp = np.stack([(cy - yy) * 0.3, (cx - xx) * 0.3], 0).astype(np.float32)
    return dp + (rng.standard_normal(dp.shape) * 0.05).astype(np.float32)


def test_advect_basin_field_300(rng):
    """At the stage's 300 steps on a basin-structured field: >= 99% of the
    end points equal the JAX default's and the clustered instance maps are
    equal (the allowance of tests/test_instances_eval.py)."""
    dp = _basin_field(rng)
    h, w = dp.shape[1:]
    want = np.asarray(jax_centroids._find_centroids_matmul(
        jnp.asarray(dp), jnp.int32(h), jnp.int32(w), 300))
    got = centroids.advect(torch.from_numpy(dp), h, w)[0].numpy()
    assert (got == want).all(axis=0).mean() >= 0.99
    np.testing.assert_array_equal(
        centroids.cluster_centroids(got, dp),
        jax_centroids.cluster_centroids(want, dp))


def test_basin_predicate_bit_equal(rng):
    """``sqrt(dy^2 + dx^2) < 2.5`` as the JAX programs evaluate it, on
    magnitudes packed around the threshold."""
    ang = rng.random((40, 40)) * 2 * np.pi
    mag = 2.5 + rng.standard_normal((40, 40)) * 1e-6
    dp = np.stack([mag * np.sin(ang), mag * np.cos(ang)]).astype(np.float32)
    dp[:, :4] = 0.0
    _, basin = centroids.advect(torch.from_numpy(dp), 40, 40, 0)
    want = np.asarray(jnp.sqrt(jnp.asarray(dp)[0] ** 2
                               + jnp.asarray(dp)[1] ** 2) < jnp.float32(2.5))
    np.testing.assert_array_equal(basin.numpy(), want)
    assert 0 < want.mean() < 1


def test_fma_f32_rounds_once(rng):
    """The twin's fused multiply-add (f64 round-to-odd, then f32) equals
    the correctly rounded exact a * b + c, as ``__fmaf_rn`` on the card:
    checked against rational arithmetic, cancellations included."""
    from fractions import Fraction

    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = (rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 3, 3000)
         ).astype(np.float32)
    c[:500] = -(a[:500] * b[:500])  # near-total cancellation
    got = centroids.fma_f32(*(torch.from_numpy(v) for v in (a, b, c)))
    for i in range(3000):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        f = np.float32(float(exact))
        near = [np.nextafter(f, np.float32(-np.inf)), f,
                np.nextafter(f, np.float32(np.inf))]
        want = min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                        int(np.array(v).view(np.int32)) & 1))
        assert got[i].item() == float(want), i


def test_fma_f32_double_rounding_cases():
    """Sums whose f64 rounding lands exactly halfway between two f32 values
    (a plain f64 sum cast to f32 rounds them the wrong way), and results in
    f32's subnormal range, equal the correctly rounded a * b + c: the fast
    path hands them to the round-to-odd path, which agrees with it on 4096
    broadcast random entries."""
    from fractions import Fraction

    f32 = np.float32
    cases = [(1 + 2.0 ** -23, 1 - 2.0 ** -23, 2.0 ** 24 + 2),
             (1 + 2.0 ** -23, 1 - 2.0 ** -23, -(2.0 ** 24 + 2)),
             (-(1 + 2.0 ** -23), 1 - 2.0 ** -23, 2.0 ** 24 + 2),
             (1 + 2.0 ** -23, -(1 - 2.0 ** -23), 2.0 ** 20 + 0.25),
             (2.0 ** -70, 2.0 ** -70, 0.0), (3e-39, 1.5, 1e-45),
             (1e-30, 1e-10, -1e-40)]
    a, b, c = (np.array([x[i] for x in cases], f32) for i in range(3))
    got = centroids.fma_f32(*(torch.from_numpy(v) for v in (a, b, c)))
    naive = (a.astype(np.float64) * b + c).astype(f32)
    assert (naive[:3] != got.numpy()[:3]).all()  # the cases bite
    for i in range(len(cases)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        f = f32(float(exact))
        near = [np.nextafter(f, f32(-np.inf)), f, np.nextafter(f, f32(np.inf))]
        want = min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                        int(np.array(v).view(np.int32)) & 1))
        assert got[i].item() == float(want), i
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn((64, 1), generator=g), torch.randn((1, 64), generator=g)
    z = torch.randn((64, 64), generator=g)
    assert torch.equal(centroids.fma_f32(x, y, z),
                       centroids._fma_f32_odd(x, y, z))


def test_advect_rejects_bad_extent():
    with pytest.raises(ValueError, match="extent"):
        centroids.advect(torch.zeros(2, 8, 8), 9, 8)


# -- K12a -------------------------------------------------------------------


def _spiral(h):
    mask = np.zeros((h, h), bool)
    top, bot, lef, rig = 0, h - 1, 0, h - 1
    while top <= bot and lef <= rig:
        mask[top, lef : rig + 1] = True
        mask[top : bot + 1, rig] = True
        mask[bot, lef : rig + 1] = True
        mask[top + 2 : bot + 1, lef] = True
        top, bot, lef, rig = top + 2, bot - 2, lef + 2, rig - 2
    return mask


def _masks():
    rng = np.random.default_rng(7)
    cases = {f"random{p}_{h}x{w}": rng.random((h, w)) < p
             for p in (0.2, 0.5, 0.8) for h, w in ((16, 16), (13, 21))}
    cases.update(spiral=_spiral(17), empty=np.zeros((8, 8), bool),
                 full=np.ones((8, 8), bool))
    return cases


MASKS = _masks()


@pytest.mark.parametrize("case", sorted(MASKS))
def test_min_label_plane_matches_jax(case):
    mask = MASKS[case]
    got = ccl.min_label_plane(torch.from_numpy(mask))
    want = np.asarray(ccl_tpu.min_label_plane(jnp.asarray(mask)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_min_label_plane_extent(rng):
    """The extent argument clears the mask beyond (h_ext, w_ext) first, as
    ``cluster_from_basin`` does."""
    mask = rng.random((24, 32)) < 0.6
    cut = mask & (np.arange(24)[:, None] < 19) & (np.arange(32)[None] < 27)
    got = ccl.min_label_plane(torch.from_numpy(mask), 19, 27)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ccl_tpu.min_label_plane(jnp.asarray(cut))))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_vals", [1, 3, 7])
def test_min_label_plane_multi_matches_jax(seed, n_vals):
    labels = np.random.default_rng(seed).integers(
        0, n_vals + 1, (21, 17)).astype(np.int32)
    got = ccl.min_label_plane_multi(torch.from_numpy(labels))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(ccl_tpu.min_label_plane_multi(jnp.asarray(labels))))


def test_min_label_plane_multi_touching_labels():
    """A label-1 spiral interleaved with label 2: the values share every
    border and must not merge."""
    labels = np.where(_spiral(17), 1, 2).astype(np.int32)
    got = ccl.min_label_plane_multi(torch.from_numpy(labels))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(ccl_tpu.min_label_plane_multi(jnp.asarray(labels))))


# -- K12b -------------------------------------------------------------------


def _random_case(rng, h, w, h4, w4, p=0.25):
    basin = rng.random((h, w)) < p
    basin[h4:, :] = True  # dp is zero beyond the extent: |0| < 2.5
    basin[:, w4:] = True
    cy = rng.integers(0, h4, (h, w)).astype(np.int32)
    cx = rng.integers(0, w4, (h, w)).astype(np.int32)
    return basin, np.stack([cy, cx])


def _overflow_case():
    h = w = 16
    basin = np.zeros((h, w), bool)
    basin[::2, ::2] = True  # 64 singleton components
    cy, cx = np.mgrid[:h, :w].astype(np.int32)
    return basin, np.stack([cy & ~1, cx & ~1]), (h, w)


def _escape_case():
    basin = np.zeros((16, 16), bool)
    basin[4:8, 4:8] = True
    cy = np.full((16, 16), 5, np.int32)
    cx = np.full((16, 16), 5, np.int32)
    cy[0], cx[0] = 0, 0  # row 0 escapes: (0, 0) is not basin
    return basin, np.stack([cy, cx]), (16, 16)


def _cluster_cases():
    cases = {}
    for seed in range(3):
        basin, cent = _random_case(np.random.default_rng(seed), 24, 32, 19, 27)
        cases[f"random{seed}"] = (basin, cent, (19, 27), 64)
    basin, cent, hw = _overflow_case()
    cases["overflow"] = (basin, cent, hw, 5)
    basin, cent, hw = _escape_case()
    cases["escape_first"] = (basin, cent, hw, 4)
    cases["empty_basin"] = (np.zeros((8, 8), bool),
                            np.zeros((2, 8, 8), np.int32), (6, 7), 3)
    return cases


CLUSTERS = _cluster_cases()


@pytest.mark.parametrize("case", sorted(CLUSTERS))
def test_cluster_from_basin_matches_jax(case):
    """Masks and n_found equal ``ccl_tpu.cluster_from_basin``'s: random
    basins with padding junk beyond the extent, the escape bucket first,
    an empty basin, and the overflow flag (n_found = k_cap + 1)."""
    basin, cent, (h4, w4), k_cap = CLUSTERS[case]
    masks, n_found = ccl.cluster_from_basin(
        torch.from_numpy(basin), torch.from_numpy(cent), h4, w4, k_cap)
    want_masks, want_n = ccl_tpu.cluster_from_basin(
        jnp.asarray(basin), jnp.asarray(cent), jnp.int32(h4), jnp.int32(w4),
        k_cap)
    assert masks.dtype == torch.uint8 and masks.shape == (k_cap,) + basin.shape
    np.testing.assert_array_equal(masks.numpy(),
                                  np.asarray(want_masks).astype(np.uint8))
    assert int(n_found) == int(want_n)
    if case == "overflow":
        assert int(n_found) == k_cap + 1


def test_cluster_masks_match_host_union_find(rng):
    """The device ranks reproduce the host's ``compress_range`` +
    ``to_one_hot`` order (the flow the stage redoes overflows with)."""
    basin, cent = _random_case(rng, 24, 32, 19, 27)
    masks, n_found = ccl.cluster_from_basin(
        torch.from_numpy(basin), torch.from_numpy(cent), 19, 27, 64)
    host = centroids.cluster_centroids_from_basin(
        cent[:, :19, :27], basin[:19, :27].astype(np.uint8))
    assert int(n_found) == host.shape[0]
    np.testing.assert_array_equal(masks.numpy()[: host.shape[0], :19, :27],
                                  host.astype(np.uint8))


def _table_cases():
    cases = {}
    for seed in range(3):
        rng = np.random.default_rng(seed)
        blobs = np.kron(rng.integers(0, 4, (6, 8)), np.ones((4, 4), int))
        cases[f"blobby{seed}"] = (blobs.astype(np.int32),
                                  rng.random((24, 32)).astype(np.float32), 64)
        rng = np.random.default_rng(seed)
        cases[f"speckle{seed}"] = (
            rng.integers(0, 4, (24, 32)).astype(np.int32),
            rng.random((24, 32)).astype(np.float32), 400)
    labels = np.zeros((16, 16), np.int32)
    labels[::2, ::2] = 1
    cases["overflow"] = (labels, np.linspace(0, 1, 256, dtype=np.float32)
                         .reshape(16, 16), 5)
    cases["empty"] = (np.zeros((8, 8), np.int32), np.ones((8, 8), np.float32),
                      4)
    # negative scores floor at 0, as the JAX max over where(eq, best, 0)
    cases["negative_best"] = (np.kron(np.arange(4).reshape(2, 2),
                                      np.ones((4, 4), int)).astype(np.int32),
                              -np.ones((8, 8), np.float32), 8)
    return cases


TABLES = _table_cases()


@pytest.mark.parametrize("case", sorted(TABLES))
def test_component_tables_match_jax(case):
    """All five outputs equal ``ccl_tpu.component_tables``'s, overflow
    (n_comp = cap + 1, ids past the cap 0) included."""
    labels, best, cap = TABLES[case]
    got = ccl.component_tables(torch.from_numpy(labels),
                               torch.from_numpy(best), cap)
    want = ccl_tpu.component_tables(jnp.asarray(labels), jnp.asarray(best),
                                    cap)
    for name, g, w in zip(("comp_map", "rows", "sizes", "scores", "n_comp"),
                          got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if case == "overflow":
        assert int(got[4]) == cap + 1


# -- seeds and the chunked walk ----------------------------------------------


def test_seed_build_class_major(rng):
    """Rows c * K + k, equal to ``mask_scores_by_instance`` and to the JAX
    ``_seed_build`` / ``_seed_build_cropped`` (masks at a larger grid)."""
    cams = rng.random((3, 8, 12)).astype(np.float32)
    masks = (rng.random((4, 10, 16)) < 0.4).astype(np.uint8)
    got = stages_irn.seed_build(torch.from_numpy(cams),
                                torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, centroids.mask_scores_by_instance(
        cams, masks[:, :8, :12]))
    np.testing.assert_array_equal(got, np.asarray(
        jax_stages._seed_build_cropped(jnp.asarray(cams), jnp.asarray(masks))))
    assert [stages_irn.pow2_ge(x) for x in (0, 1, 2, 3, 8, 9)] == [
        1, 1, 2, 4, 8, 16]


def _walk_inputs(rng, k, h4=26, w4=29):
    edge = np.ones((32, 32), np.float32)
    edge[:h4, :w4] = rng.random((h4, w4)) * 0.8
    edge[:h4, 13] = 0.97  # a wall
    seeds = np.zeros((k, 32, 32), np.float32)
    for r in range(k):
        y, x = rng.integers(0, h4), rng.integers(0, w4)
        seeds[r, max(y - 3, 0) : y + 3, max(x - 3, 0) : x + 3] = rng.random()
    seeds[:, h4:] = 0
    seeds[:, :, w4:] = 0
    return edge, seeds, (h4, w4), (4 * h4 - 2, 4 * w4 - 1)


def test_propagate_all_chunks_equal_one_walk(rng):
    """19 seed rows through chunks of 8 equal one walk of all 19: the same
    labels, best within 1e-6."""
    edge, seeds, (h4, w4), size = _walk_inputs(rng, 19)
    cfg = Config(rw_grid_cap=32)
    dev = torch.device("cpu")
    one = stages_irn.RandomWalkRunner(cfg, 32, dev)
    chunked = stages_irn.RandomWalkRunner(cfg, 8, dev)
    args = (torch.from_numpy(seeds), torch.from_numpy(edge), h4, w4, size,
            0.25)
    want_labels, want_best = one.propagate_all(*args)
    got_labels, got_best = chunked.propagate_all(*args)
    assert chunked.modes == {(32, 32): "diag"}
    assert got_labels.dtype == torch.int32
    assert int(want_labels.max()) > 8  # rows of the later chunks win
    torch.testing.assert_close(got_labels, want_labels, rtol=0, atol=0)
    torch.testing.assert_close(got_best, want_best, rtol=0, atol=1e-6)


@pytest.mark.parametrize("route", ["diag", "dense"])
def test_propagate_all_matches_jax(rng, monkeypatch, route):
    """The chunked walk against the JAX ``propagate_all``: labels equal; on
    the route the stage takes (the stencil, which the JAX runner takes only
    on a TPU backend, so the test reports one) best within 1e-6, and
    against the JAX CPU default (dense squarings) within 1e-4."""
    import jax

    if route == "diag":
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    edge, seeds, (h4, w4), size = _walk_inputs(rng, 19)
    cfg = Config(rw_grid_cap=32)
    walker = stages_irn.RandomWalkRunner(cfg, 8, torch.device("cpu"))
    got_labels, got_best = walker.propagate_all(
        torch.from_numpy(seeds), torch.from_numpy(edge), h4, w4, size, 0.25)
    jcfg = dataclasses.replace(JaxConfig(), rw_grid_cap=32)
    jwalker = jax_stages.RandomWalkRunner(jcfg, 8)
    assert jwalker.resolve_mode(32, 32) == route
    labels, best = jwalker.propagate_all(
        seeds[:, :h4, :w4], jnp.asarray(edge), h4, w4, size, 0.25)
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(labels))
    np.testing.assert_allclose(got_best.numpy(), np.asarray(best), rtol=0,
                               atol=1e-6 if route == "diag" else 1e-4)


def test_walk_best_is_winning_score(rng):
    """``walk`` returns the label map of ``__call__`` and, wherever a row
    wins, that row's normalized score."""
    edge, seeds, (h4, w4), size = _walk_inputs(rng, 5)
    walker = stages_irn.RandomWalkRunner(Config(rw_grid_cap=32), 8,
                                         torch.device("cpu"))
    labels, best = walker.walk(torch.from_numpy(seeds),
                               torch.from_numpy(edge), h4, w4, size, 0.25)
    np.testing.assert_array_equal(
        labels.numpy(), walker(seeds[:, :h4, :w4], torch.from_numpy(edge),
                               h4, w4, size, 0.25).numpy())
    assert float(best.max()) == 1.0
    assert (best[labels > 0] > 0.25).all() and (best[labels == 0] <= 0.25).all()
