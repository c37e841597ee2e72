"""K16, train_irn's loss side after the path max (``affinity.irn_loss``
over the plain twins ``irn_loss_fwd_plain`` / ``irn_loss_bwd_plain``),
against the JAX package on the same numpy inputs (CPU): the total and the
four terms against ``irn_total_loss(affinity_displacement_loss_maps(...),
*affinity_labels_2d(...))``, the gradients with respect to the edge logits
and the displacements through ``path_max`` -> ``irn_loss`` against
``jax.grad`` of the same, special label maps, NaN in the displacements,
and the twins' own order of operations. The kernels' tests on the card:
tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import affinity as jax_aff
from irn_tpu.ops import paths as jax_paths
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import affinity
from irn_tpu_torch.ops import paths

torch.set_num_threads(2)

CASES = [(4, (2, 20, 24)), (5, (2, 24, 21)), (10, (2, 32, 32))]


def _labels(shape, seed, values=(0, 1, 2, 255), p=(0.4, 0.25, 0.25, 0.1)):
    return np.random.default_rng(seed).choice(
        np.array(values, np.int32), size=shape, p=p)


def _inputs(shape, seed, dtype):
    g = np.random.default_rng(seed)
    b, h, w = shape
    logit = g.standard_normal((b, h, w, 1)).astype(dtype)
    dp = g.standard_normal((b, h, w, 2)).astype(dtype)
    return logit, dp


def _jax_loss(logit, dp, lab, radius):
    """JAX's total and terms, the same from JAX's ``irn_total_loss`` over
    its own maps and masks taken to f64 (the same formula with exact
    sums), and JAX's gradients (edge logits, displacements)."""
    h, w = lab.shape[1:]
    jps = jax_paths.build_path_set(radius)
    grid = jax_paths.build_grid_index(jps, (h, w))
    masks = jax_aff.affinity_labels_2d(jnp.asarray(lab), jps)

    def loss(lg, d):
        maps = jax_aff.affinity_displacement_loss_maps(lg, d, grid)
        return jax_aff.irn_total_loss(maps, *masks)

    (total, terms), grads = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(logit),
                                            jnp.asarray(dp))
    own = {"loss": float(total), **{k: float(v) for k, v in terms.items()}}
    maps = jax_aff.affinity_displacement_loss_maps(
        jnp.asarray(logit), jnp.asarray(dp), grid)
    with jax.enable_x64(True):
        t64, terms64 = jax_aff.irn_total_loss(
            jax_aff.AffinityLossMaps(*(
                jnp.asarray(np.asarray(m, np.float64)) for m in maps)),
            *(jnp.asarray(np.asarray(m, np.float64)) for m in masks))
        exact = {"loss": float(t64),
                 **{k: float(v) for k, v in terms64.items()}}
    return own, exact, [np.asarray(gr) for gr in grads]


def _port_loss(logit, dp, lab, radius):
    table = affinity.path_table(paths.build_path_set(radius))
    lg = torch.from_numpy(logit).permute(0, 3, 1, 2).contiguous()
    d = torch.from_numpy(dp).permute(0, 3, 1, 2).contiguous()
    lg.requires_grad_(True)
    d.requires_grad_(True)
    maxed = affinity.path_max(torch.sigmoid(lg[:, 0]).contiguous(), table)
    total, terms = affinity.irn_loss(maxed, d, torch.from_numpy(lab), table)
    total.backward()
    out = {"loss": float(total.detach()),
           **{k: float(v.detach()) for k, v in terms.items()}}
    return out, [lg.grad.permute(0, 2, 3, 1).numpy(),
                 d.grad.permute(0, 2, 3, 1).numpy()]


def _assert_grads(got, want, tol):
    for name, a, b in zip(("edge_logit", "dp"), got, want):
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        assert err <= tol, (name, err)


# f32: the terms within rtol 1e-6 both of JAX's own f32 results (XLA's
# f32 sums) and of JAX's formula over its f32 maps and masks summed exactly
# (f64), and the gradients within 1e-5 of jax.grad's largest magnitude.
# f64 (x64): both within 1e-12 of JAX's own results.
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radius,shape", CASES)
def test_irn_loss_matches_jax(radius, shape, dtype):
    _build.reset_launches()
    logit, dp = _inputs(shape, radius, dtype)
    lab = _labels(shape, radius + 1)
    with jax.enable_x64(dtype == "float64"):
        want, exact, want_g = _jax_loss(logit, dp, lab, radius)
    got, got_g = _port_loss(logit, dp, lab, radius)
    rtol = 1e-6 if dtype == "float32" else 1e-12
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=rtol), k
        if dtype == "float32":
            assert got[k] == pytest.approx(exact[k], rel=rtol), k
    _assert_grads(got_g, want_g, 1e-5 if dtype == "float32" else 1e-12)
    assert not any(_build.LAUNCHES.values())


def _special_labels(kind, shape, seed):
    if kind == "no foreground":
        return _labels(shape, seed, (0, 255), (0.8, 0.2))
    if kind == "all ignore":
        return np.full(shape, 255, np.int32)
    # mostly 255 with a few classes: many pairs valid on one side only
    return _labels(shape, seed, (0, 3, 20, 21, 255), (0.1, 0.1, 0.1, 0.1,
                                                       0.6))


@pytest.mark.parametrize("kind", ["no foreground", "all ignore",
                                  "mostly ignore"])
def test_irn_loss_special_labels_match_jax(kind):
    """A batch with no foreground (fg terms 0), an all-ignore batch (every
    term 0 and every gradient 0, as in JAX), and one that is mostly 255
    with class 21 (ignored: >= 21); f32, the tolerances above."""
    radius, shape = 5, (2, 24, 21)
    logit, dp = _inputs(shape, 11, "float32")
    lab = _special_labels(kind, shape, 12)
    want, exact, want_g = _jax_loss(logit, dp, lab, radius)
    got, got_g = _port_loss(logit, dp, lab, radius)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=0.0), k
        assert got[k] == pytest.approx(exact[k], rel=1e-6, abs=0.0), k
    if kind == "all ignore":
        assert all(v == 0.0 for v in got.values())
        assert all(not np.any(gr) for gr in got_g)
    if kind == "no foreground":
        assert got["loss_dp_fg"] == 0.0
    _assert_grads(got_g, want_g, 1e-5)


def test_irn_loss_nan_in_dp_matches_jax():
    """NaN planted in the displacements: the dp terms and the total are NaN
    in both, the affinity terms finite, within rtol 1e-6 of the exact sums
    and 1e-5 of JAX's own f32 results; the gradients equal JAX's within
    1e-5 of the largest magnitude, NaN where JAX has NaN (its abs JVP takes
    -1 at NaN, so there are none)."""
    radius, shape = 4, (2, 20, 24)
    logit, dp = _inputs(shape, 21, "float32")
    dp[0, 5, 9, 0] = np.nan
    dp[1, 12, 3, 1] = np.nan
    lab = _labels(shape, 22)
    want, exact, want_g = _jax_loss(logit, dp, lab, radius)
    got, got_g = _port_loss(logit, dp, lab, radius)
    for k in ("loss", "loss_dp_fg", "loss_dp_bg"):
        assert np.isnan(want[k]) and np.isnan(got[k]), k
    for k in ("loss_pos_aff", "loss_neg_aff"):
        assert got[k] == pytest.approx(exact[k], rel=1e-6), k
        # JAX's own f32 neg_aff sits 1.08e-6 from the port's here (XLA's
        # f32 sum order), just past 1e-6
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    for a, b in zip(got_g, want_g):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        fin = ~np.isnan(b)
        scale = float(np.abs(b[fin]).max())
        assert float(np.abs(a[fin] - b[fin]).max()) <= 1e-5 * scale


def _table_and_tensors(radius, shape, seed, dtype=torch.float32):
    table = affinity.path_table(paths.build_path_set(radius))
    g = np.random.default_rng(seed)
    b, h, w = shape
    edge = torch.sigmoid(torch.from_numpy(g.standard_normal(shape))).to(dtype)
    maxed, _ = affinity.path_max_plain(edge, table)
    dp = torch.from_numpy(g.standard_normal((b, 2, h, w))).to(dtype)
    lab = torch.from_numpy(_labels(shape, seed + 1))
    return table, maxed, dp, lab


def test_irn_loss_bwd_d_maxed_direct_formula():
    """The twin's d_maxed is bit-equal to the elementwise formula written
    from ``affinity_labels_2d``'s masks (coefficients k = upstream /
    (count + eps)) and exactly zero outside every mask."""
    table, maxed, dp, lab = _table_and_tensors(5, (2, 24, 21), 31)
    g = torch.tensor([1.0, 0.25, -0.5, 0.125, 2.0])
    loss, stats = affinity.irn_loss_fwd_plain(maxed, dp, lab, table)
    d_maxed, _ = affinity.irn_loss_bwd_plain(g, stats, maxed, dp, lab, table)
    bg, fg, neg = (m.reshape(maxed.shape) for m in
                   affinity.affinity_labels_2d(lab, table.path_set))
    n_bg, n_fg, n_neg = (m.sum(dtype=torch.float64).float()
                         for m in (bg, fg, neg))
    assert torch.equal(stats[5:].float(), torch.stack([n_bg, n_fg, n_neg]))
    eps = 1e-5
    g_pos = (g[0] * 0.5 + g[1]) * 0.5
    a = 1.0 - maxed
    want = ((bg * (g_pos / (n_bg + eps)) + fg * (g_pos / (n_fg + eps)))
            / (a + 1e-5)
            - neg * ((g[0] * 0.5 + g[2]) / (n_neg + eps)) / (1.0 + 1e-5 - a))
    assert torch.equal(d_maxed, want)
    outside = (bg + fg + neg) == 0
    assert bool(outside.any()) and not bool(d_maxed[outside].any())


def test_irn_loss_bwd_d_dp_gather_order():
    """The twin's d_dp bit-equal to a per-pixel loop in the kernel's order
    (numpy f32): pairs ascending, + t where the pixel is the pair's source,
    then - t where it is the destination, from +0."""
    radius, shape = 4, (1, 12, 14)
    table, maxed, dp, lab = _table_and_tensors(radius, shape, 41)
    g = torch.tensor([1.0, 0.0, 0.0, 0.5, -0.25])
    _, stats = affinity.irn_loss_fwd_plain(maxed, dp, lab, table)
    _, d_dp = affinity.irn_loss_bwd_plain(g, stats, maxed, dp, lab, table)
    f = np.float32
    s = stats.float().numpy()
    eps = f(1e-5)
    half = f(g[0]) * f(0.5)
    k_dfg = (half + f(g[3])) / (f(2) * s[6] + eps)
    k_dbg = (half + f(g[4])) / (f(2) * s[5] + eps)
    L, D = lab[0].numpy(), dp[0].numpy()
    rf = table.rf
    h, w = shape[1:]
    ch, cw = h - rf, w - 2 * rf

    def t(sy, sx, p, c):
        dy, dx = (int(v) for v in table.path_set.dst_offsets[p])
        ls, ld = L[sy, sx], L[sy + dy, sx + dx]
        valid = ls < 21 and ld < 21
        bg = f(ls == ld and valid and ls == 0)
        fg = f(ls == ld and valid and ls > 0)
        pair = D[c, sy, sx] - D[c, sy + dy, sx + dx]
        off = f((dy, dx)[c])
        sgn = lambda v: f(1) if v >= 0 else f(-1)  # noqa: E731
        return (fg * k_dfg) * sgn(pair - off) + (bg * k_dbg) * sgn(pair)

    want = np.zeros((2, h, w), np.float32)
    for c in range(2):
        for y in range(h):
            for x in range(w):
                acc = f(0)
                for p, (dy, dx) in enumerate(table.path_set.dst_offsets):
                    if y < ch and rf <= x < rf + cw:
                        acc = acc + t(y, x, p, c)
                    sy, sx = y - int(dy), x - int(dx)
                    if 0 <= sy < ch and rf <= sx < rf + cw:
                        acc = acc - t(sy, sx, p, c)
                want[c, y, x] = acc
    np.testing.assert_array_equal(d_dp[0].numpy(), want)


def test_irn_loss_fwd_sums_and_counts():
    """The stats: the label counts are the exact integer sums of
    ``affinity_labels_2d``'s masks; each f64 total is within 1e-12 of the
    exact sum of the twin's own per-element terms (math.fsum); the terms
    follow irn_total_loss's formula from them."""
    import math

    table, maxed, dp, lab = _table_and_tensors(10, (2, 32, 32), 51)
    loss, stats = affinity.irn_loss_fwd_plain(maxed, dp, lab, table)
    bg, fg, neg = (m.reshape(maxed.shape) for m in
                   affinity.affinity_labels_2d(lab, table.path_set))
    assert stats[5:].tolist() == [float(m.sum()) for m in (bg, fg, neg)]
    a = 1.0 - maxed
    pos_aff = -torch.log(a + 1e-5)
    pair = affinity.pair_displacement(dp, table.path_set).reshape(
        2, 2, table.n_pairs, *maxed.shape[2:])
    off = torch.from_numpy(table.path_set.dst_offsets.T.astype(np.float32))
    off = off[None, :, :, None, None]
    exact = [bg * pos_aff, fg * pos_aff, neg * -torch.log(1.0 + 1e-5 - a),
             fg[:, None] * torch.abs(pair - off), bg[:, None] * torch.abs(pair)]
    for k, v in enumerate(exact):
        want = math.fsum(v.double().reshape(-1).tolist())
        assert float(stats[k]) == pytest.approx(want, rel=1e-6, abs=0)
    s = stats.float()
    eps = 1e-5
    pos = s[0] / (s[5] + eps) * 0.5 + s[1] / (s[6] + eps) * 0.5
    want = torch.stack([pos, s[2] / (s[7] + eps), s[3] / (2 * s[6] + eps),
                        s[4] / (2 * s[5] + eps)])
    assert torch.equal(loss[1:], want)
    assert torch.equal(loss[0], (want[0] + want[1]) * 0.5
                       + (want[2] + want[3]) * 0.5)


def test_irn_loss_gradcheck():
    """torch.autograd.gradcheck of IrnLoss in f64 (the twins) with respect
    to maxed and dp, with the four terms' cotangents as well as the
    total's."""
    table, maxed, dp, lab = _table_and_tensors(4, (1, 10, 12), 61,
                                               torch.float64)
    maxed.requires_grad_(True)
    dp.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda m, d: affinity.IrnLoss.apply(m, d, lab, table), (maxed, dp),
        eps=1e-6, atol=1e-8)


def test_irn_loss_checks():
    """Mismatched shapes raise before any work; nothing launches on the
    CPU."""
    _build.reset_launches()
    table, maxed, dp, lab = _table_and_tensors(4, (2, 12, 14), 71)
    with pytest.raises(ValueError, match="maxed"):
        affinity.irn_loss_fwd(maxed[:, 1:], dp, lab, table)
    with pytest.raises(ValueError, match="labels"):
        affinity.irn_loss_fwd(maxed, dp, lab[:, 1:], table)
    with pytest.raises(ValueError, match="dp must be"):
        affinity.irn_loss_fwd(maxed, dp[:, :1], lab, table)
    loss, stats = affinity.irn_loss_fwd(maxed, dp, lab, table)
    with pytest.raises(ValueError, match="expected \\(5,\\)"):
        affinity.irn_loss_bwd(loss[:4], stats, maxed, dp, lab, table)
    assert not any(_build.LAUNCHES.values())
