"""Port ops vs the JAX package on the same numpy inputs (CPU).

On the CPU every kernel wrapper of ``irn_tpu_torch`` runs its plain PyTorch
twin; the Pallas kernels of the JAX package run in interpret mode, as
tests/test_random_walk.py runs them. Tolerances are stated per test: f32
sums taken in another order differ in the last bits, copies and
comparisons not at all."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import affinity as jaff
from irn_tpu.ops import matpow_pallas as jmp
from irn_tpu.ops import paths
from irn_tpu.ops import random_walk as jrw
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import affinity as taff
from irn_tpu_torch.ops import matpow_kernels as tmk
from irn_tpu_torch.ops import random_walk as trw

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scene(rng, cap, extent, c=3):
    """Capped (cam, edge): random inside the extent, edge 1 beyond it."""
    h4, w4 = extent
    edge = np.ones((cap, cap), np.float32)
    edge[:h4, :w4] = rng.random((h4, w4)).astype(np.float32)
    cam = np.zeros((c, cap, cap), np.float32)
    cam[:, :h4, :w4] = rng.random((c, h4, w4))
    return cam, edge


def _banded(rng, n, h, scale=1.0):
    r = np.arange(n)
    band = np.abs(r[:, None] - r[None, :]) <= h
    t = np.zeros((n, n), np.float32)
    t[band] = rng.random(band.sum(), dtype=np.float32) * scale
    return t, r


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach a kernel: every launch counter stays 0."""
    _build.reset_launches()
    yield
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


@pytest.mark.parametrize("radius", [2, 5])
def test_path_affinity_bit_equal(rng, radius):
    ps = paths.build_path_set(radius)
    edge = rng.random((18, 23)).astype(np.float32)
    edge[3, 4] = edge[3, 5]  # a tie: the first maximal cell must win
    want = np.asarray(jaff.path_affinity(jnp.asarray(edge), ps))
    got = taff.path_affinity(_t(edge), ps).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius,cap", [(2, 24), (5, 32)])
def test_band_values_and_diag_operator(rng, radius, cap):
    _, edge = _scene(rng, cap, (cap - 3, cap - 5))
    jg = jrw.build_geometry(cap, cap, radius=radius)
    tg = trw.build_geometry(cap, cap, radius=radius)
    assert (tg.n_pad, tg.padded) == (jg.n_pad, jg.padded)
    assert trw.band_halfwidth(tg) == jrw.band_halfwidth(jg)
    assert trw.diag_offsets(tg) == jrw.diag_offsets(jg)
    jvs, jd = jrw.band_values(jg, jnp.asarray(edge))
    tvs, td = trw.band_values(tg, _t(edge))
    assert td == jd
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), rtol=1e-6)
    jw, jinv = jrw.build_diag_operator(jg, jnp.asarray(edge), beta=10)
    tw, tinv = trw.build_diag_operator(tg, _t(edge), beta=10)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6)
    jdense = np.asarray(jrw.dense_affinity(jg, jnp.asarray(edge)))
    np.testing.assert_array_equal(
        trw.dense_affinity(tg, _t(edge)).numpy(), jdense
    )


@pytest.mark.parametrize("exp_times", [3, 8])
@pytest.mark.parametrize("radius,cap", [(2, 24), (5, 32)])
def test_propagate_diag_matches_jax(rng, radius, cap, exp_times):
    """K0's plain twin through the whole e = 0 walk."""
    cam, edge = _scene(rng, cap, (cap - 4, cap - 2))
    jg = jrw.build_geometry(cap, cap, radius=radius)
    tg = trw.build_geometry(cap, cap, radius=radius)
    want = np.asarray(jrw.propagate_diag(jg, cam, edge, 10, exp_times))
    got = trw.propagate_diag(tg, _t(cam), _t(edge), 10, exp_times).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_pack_banded_bit_equal(rng):
    """K1's plain twin vs the Pallas pack (interpret mode)."""
    n, bs, h = 1024, 128, 200
    t = rng.random((n, n), dtype=np.float32)
    want = np.asarray(jmp.pack_banded(jnp.asarray(t), h, bs, interpret=True))
    got = tmk.pack_banded(_t(t), h, bs)
    np.testing.assert_array_equal(got.numpy(), want)


def test_square_banded_in_band(rng):
    """K2's plain twin vs the Pallas banded squaring (interpret mode), in
    band only: out-of-band output is unspecified on both sides."""
    n, bs, h = 768, 128, 130
    a, r = _banded(rng, n, h)
    want = np.asarray(jmp.square_banded(jnp.asarray(a), h, bs=bs,
                                        interpret=True))
    got = tmk.square_banded(_t(a), h, bs).numpy()
    inband = np.abs(r[:, None] - r[None, :]) <= 2 * h
    np.testing.assert_allclose(got[inband], want[inband], atol=1e-4)
    np.testing.assert_allclose(got[inband], (a @ a)[inband], atol=1e-4)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_apply_banded_chain_matches_jax(rng, impl):
    """K1 + K3's plain twins vs the Pallas packed chain and its XLA
    windowed-einsum twin; out-of-band garbage must not leak."""
    n, bs, h = 1024, 128, 130
    t, r = _banded(rng, n, h, scale=0.01)
    t /= t.sum(0, keepdims=True)
    kh = -(-h // bs)
    bi = r // bs
    t_poison = t.copy()
    t_poison[np.abs(bi[:, None] - bi[None, :]) > kh] = 1e6
    x = rng.random((8, n), dtype=np.float32)
    want = np.asarray(jmp.apply_banded_chain(
        jnp.asarray(x), jnp.asarray(t), h, 4, bs=bs, interpret=True,
        impl=impl,
    ))
    got = tmk.apply_banded_chain(_t(x), _t(t_poison), h, 4, bs=bs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("square_times,exp_times", [(1, 3), (2, 3), (2, 2)],
                         ids=["1", "2", "2-single-application"])
def test_propagate_banded_matches_jax(rng, square_times, exp_times):
    """The banded walk; at square_times == exp_times its one application
    runs through apply_banded (K4's twin)."""
    geom_args = (24, 24)
    cam, edge = _scene(rng, 24, (20, 20))
    jg = jrw.build_geometry(*geom_args, radius=2)
    tg = trw.build_geometry(*geom_args, radius=2)
    assert trw.banded_fits(tg, exp_times, square_times, bs=128)
    want = np.asarray(jrw.propagate_banded(
        jg, cam, edge, beta=10, exp_times=exp_times,
        square_times=square_times, bs=128, interpret=True,
    ))
    got = trw.propagate_banded(
        tg, _t(cam), _t(edge), beta=10, exp_times=exp_times,
        square_times=square_times, bs=128,
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("square_times", [0, 2])
def test_dense_propagate_matches_jax(rng, square_times):
    cam, edge = _scene(rng, 16, (13, 11))
    jg = jrw.build_geometry(16, 16, radius=5)
    tg = trw.build_geometry(16, 16, radius=5)
    want = np.asarray(jrw.propagate(jg, cam, edge, beta=10, exp_times=3,
                                    square_times=square_times))
    got = trw.propagate(tg, _t(cam), _t(edge), beta=10, exp_times=3,
                        square_times=square_times).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_route_gates_match_jax():
    for cap, e in [(16, 1), (24, 0), (32, 1), (96, 2), (128, 3)]:
        jg = jrw.build_geometry(cap, cap, radius=5)
        tg = trw.build_geometry(cap, cap, radius=5)
        assert trw.banded_fits(tg, 8, e) == jrw.banded_fits(jg, 8, e)
        assert trw.pick_square_times(tg.n_pad, 8) == jrw.pick_square_times(
            jg.n_pad, 8)
    assert trw.pick_square_times_banded(8) == jrw.pick_square_times_banded(8)


def test_upsample_and_decode_matches_jax(rng):
    c, cap = 4, 12
    h4, w4, h0, w0 = 10, 9, 37, 33
    rw = np.zeros((c, cap, cap), np.float32)
    rw[:, :h4, :w4] = rng.random((c, h4, w4))
    jl, jup, jmax = jrw.upsample_and_decode(rw, h4, w4, h0, w0, 0.35)
    tl, tup, tmax = trw.upsample_and_decode(_t(rw), h4, w4, h0, w0, 0.35)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tup.numpy(), np.asarray(jup), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(tmax), float(jmax), rtol=1e-5)


def _held(plan):
    """A card that holds 7 clusters of one CTA per SM (w in shared memory,
    as the H100 reports for 12-16 CTAs per cluster) and 30 of the small
    L2-path CTAs."""
    return 7 if plan[4] else 30


@pytest.mark.parametrize("cap,c,rows", [
    ((32, 32), 3, 1), ((32, 32), 21, 4), ((96, 128), 8, 2),
    ((128, 128), 8, 2), ((128, 128), 16, 2), ((256, 256), 20, 1)])
def test_diag_chain_plan(cap, c, rows):
    """K0's launch plan at the walk's geometries, up to rw_grid_cap 256:
    slices that cover n, a halo that covers the largest offset, 16-byte
    units, w in shared memory up to the default cap's 128x128 bucket, one
    wave of clusters where the rows per cluster allow it (C 8 on a card
    that holds 7 clusters: 2 rows each; at n 18432 four rows and w do not
    fit, so C 16 takes two waves of 2 rows), and buffers within a CTA's
    shared memory."""
    geom = trw.build_geometry(*cap, radius=5)
    n, doffs = geom.n_pad, trw.diag_offsets(geom)
    hmax = max(doffs)
    plan = trw.diag_chain_plan(c, n, doffs, _held)
    assert plan[0] == rows
    _, cluster, m, hpad, w_shared = plan
    assert cluster in trw.DIAG_CLUSTERS
    assert m * cluster >= n > (m - 4) * cluster
    assert m % 4 == 0 and hpad % 4 == 0 and hmax <= hpad < hmax + 4
    assert w_shared == (cap[0] * cap[1] <= 128 * 128)
    assert cluster == 16  # the least work per CTA
    w_floats = sum(m + d for d in doffs) if w_shared else 0
    assert trw._diag_smem(rows, m, hpad, w_floats) <= trw.DIAG_SMEM_MAX
    if cap == (32, 32):
        assert hmax > m  # the halo reaches past the neighbouring CTA


def test_diag_chain_plan_limits():
    """The plan keeps w in shared memory over fewer waves, takes fewer
    waves over less work per CTA, pins what it is given, skips plans the
    card cannot hold, and raises with the limit in the message when no
    plan fits; n must be a multiple of 4."""
    doffs = (1, 500, 1000)
    assert trw.diag_chain_plan(32, 16 * 512, doffs, _held)[::4] == (4, True)
    assert trw.diag_chain_plan(3, 16 * 512, doffs, _held)[:2] == (1, 16)
    assert trw.diag_chain_plan(8, 16 * 512, doffs, _held, rows=1,
                               cluster=12, w_shared=False)[::4] == (1, False)
    assert trw.diag_chain_plan(8, 16 * 512, doffs,
                               lambda p: p[1] <= 10)[1] == 10
    with pytest.raises(ValueError, match="232448"):
        trw.diag_chain_plan(8, 16 * 30000, doffs, _held)
    with pytest.raises(ValueError, match="multiple of 4"):
        trw.diag_chain_plan(8, 1026, (10,), _held)


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain twin only for CPU tensors; anything else
    that is not CUDA raises instead of falling back."""
    x = torch.empty((8, 1024), device="meta")
    t = torch.empty((1024, 1024), device="meta")
    with pytest.raises(ValueError):
        tmk.pack_banded(t, 130, 128)
    with pytest.raises(ValueError):
        tmk.square_banded(t, 130, 128)
    with pytest.raises(ValueError):
        trw.apply_diag_chain(x, torch.empty((2, 1024), device="meta"),
                             torch.empty((1024,), device="meta"), (1, 5), 2)
    with pytest.raises(ValueError):
        tmk.apply_banded(x, t, 130, 128)
    with pytest.raises(ValueError):
        tmk.square_dense(t)
    with pytest.raises(ValueError):
        tmk.square_fused_first(t, 10)
    with pytest.raises(ValueError):
        tmk.banded_chain(x, t, 130, 4, 128, 256)
