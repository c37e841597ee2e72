"""K11's early stop on the CPU: ``centroids.advect_schedule``, a torch
model of the kernel's schedule (steps in chunks of 8; when a particle's
position bits after a chunk equal those before it, only the ``left mod
8`` steps still due run, then it stops; fewer than 8 steps run one by
one), built on ``centroids.advect_step`` (the twin's step), held equal to
``centroids.advect_plain`` on the fields and step counts that decide
whether the rule is exact, and to JAX on a non-finite dp; the
staged rows' layout (pitch W + 1, the last column and row repeated)
against the twin's clamped taps; and ``advect`` on the CPU against JAX's
``_find_centroids_matmul``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import centroids as jax_centroids
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import centroids
from irn_tpu_torch.tools import probe_advect as pa

torch.set_num_threads(2)

CHUNK = centroids.CHUNK
ITERATIONS = (0, 1, 7, 8, 9, 17, 300)
GRID = (24, 32)
EXTENTS = ((24, 32), (19, 27))


@pytest.fixture(autouse=True)
def _no_launches():
    _build.reset_launches()
    yield
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def bits(t):
    return t.view(torch.int32)


def schedule(dp, h4, w4, iterations):
    """(cent, steps each particle ran, whether it ran fewer than
    ``iterations``) of the kernel's schedule."""
    cent, _, ran = centroids.advect_schedule(dp, h4, w4, iterations)
    return cent, ran, ran < iterations


def _field(kind, hw4, seed=0):
    """dp [2, 24, 32] f32 of one kind, zero beyond the extent where the
    kind says so."""
    h, w = GRID
    g = np.random.default_rng(seed)
    if kind == "basin":
        dp = pa.pull_field(w, hw4, 0.3, 0.1, seed)[:, :h]
    elif kind == "full gain":
        dp = pa.pull_field(w, hw4, 1.0, 0.05, seed)[:, :h]
    elif kind == "random":
        dp = pa.random_field(h, w, seed)
    elif kind == "clamp":
        # every particle pushed hard toward the corner of its quadrant,
        # where the clip pins it
        yy, xx = np.mgrid[:h, :w].astype(np.float32)
        dp = np.stack([np.where(yy < hw4[0] / 2, -7.0, 7.0),
                       np.where(xx < hw4[1] / 2, -9.0, 9.0)])
        dp += g.standard_normal(dp.shape) * 0.5
    elif kind.startswith("period"):
        dp = pa.cycle_field(h, w, hw4, int(kind[-1]))
    else:  # "signed zero": a pull to row and column 0, -0.0 on both
        yy, xx = np.mgrid[:h, :w].astype(np.float32)
        dp = np.stack([-0.6 * yy, -0.6 * xx])
        dp[0, 0, :] = -0.0
        dp[1, :, 0] = -0.0
        dp[:, :2, :2] = -0.0
    return torch.from_numpy(np.ascontiguousarray(dp, np.float32))


KINDS = ("basin", "full gain", "random", "clamp", "period 2", "period 3",
         "signed zero")


@pytest.mark.parametrize("iterations", ITERATIONS)
@pytest.mark.parametrize("hw4", EXTENTS)
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_equals_twin(kind, hw4, iterations):
    """The early stop gives the twin's end points bit for bit at every step
    count: 0, fewer than a chunk, a chunk, a chunk and one, 300."""
    dp = _field(kind, hw4)
    cent, ran, _ = schedule(dp, *hw4, iterations)
    want, _ = centroids.advect_plain(dp, *hw4, iterations)
    assert torch.equal(cent, want)
    assert int(ran.max()) <= iterations


@pytest.mark.parametrize("hw4", EXTENTS)
def test_schedule_stops(hw4):
    """A logic check of when the rule stops a particle (not of speed): on
    the full-gain field most particles stop (at 24 x 32 a third settle
    into a 3-cycle of float rounding around a centre, and run all their
    steps); on the period-2 field every one stops after its
    first chunk; on the period-3 field (3 does not divide 8) none of the
    cycling ones stops; on the random field some stop (pinned against the
    clip) and some run all 300 steps."""
    n = 300
    tail = n % CHUNK
    dp = _field("full gain", hw4)
    _, ran, stopped = schedule(dp, *hw4, n)
    assert float(stopped.float().mean()) > 0.5
    assert bool((ran[~stopped] == n).all())
    _, ran, stopped = schedule(_field("period 2", hw4), *hw4, n)
    assert bool(stopped.all()) and int(ran.max()) == CHUNK + tail
    _, ran, stopped = schedule(_field("period 3", hw4), *hw4, n)
    # by the start column, min(col, w4 - 1)
    cycling = torch.clamp(torch.arange(GRID[1]), max=hw4[1] - 1) < \
        hw4[1] // 3 * 3
    assert bool((ran[:, cycling] == n).all())
    assert bool(stopped[:, ~cycling].all())

    _, ran, _ = schedule(_field("random", hw4), *hw4, n)
    assert bool((ran == n).any()) and bool((ran < n).any())


def test_bit_compare_keeps_signed_zeros():
    """The chunk compare is of the bits: -0.0 and +0.0 differ there, as
    ``__float_as_uint`` makes them differ on the card."""
    z = torch.tensor([0.0, -0.0])
    assert bits(z)[0] != bits(z)[1]
    assert bool(z[0] == z[1])


@pytest.mark.parametrize("value", [float("nan"), float("inf")])
@pytest.mark.parametrize("hw4", EXTENTS)
def test_schedule_nan(hw4, value):
    """A non-finite value in dp (NaN or an infinity), planted inside the
    extent and beyond the taps' reach (rows past h4, columns past w4), or
    beyond it alone: the schedule's end points are JAX's
    (``_find_centroids_matmul``: its weight-0 products make every sample
    of the plane NaN, and a NaN end point converts to 0), the basin the
    twin's (``sqrt(NaN) < 2.5`` is false)."""
    h, w = GRID
    dp = torch.from_numpy(pa.nan_field(w, hw4, value=value)[:, :h].copy())
    outside = dp.clone()
    outside[:, : hw4[0] + 1, : hw4[1] + 1] = _field("basin", hw4)[
        :, : hw4[0] + 1, : hw4[1] + 1]
    for field in (dp, outside):
        cent, _, _ = schedule(field, *hw4, 300)
        want = jax_centroids._find_centroids_matmul(
            jnp.asarray(field.numpy()), jnp.int32(hw4[0]), jnp.int32(hw4[1]),
            300)
        np.testing.assert_array_equal(cent.numpy(), np.asarray(want))
        want_cent, want_basin = centroids.advect_plain(field, *hw4)
        assert torch.equal(cent, want_cent)
        assert torch.equal(centroids.advect(field, *hw4)[1], want_basin)
        assert not bool(want_basin[hw4[0] + 1:].any())


def staged_rows(dp, h4):
    """The kernel's staged rows: [h4 + 1, W + 1, 2], rows and columns past
    the grid repeating its last ones."""
    _, h, w = dp.shape
    rows = torch.clamp(torch.arange(h4 + 1), max=h - 1)
    cols = torch.clamp(torch.arange(w + 1), max=w - 1)
    return dp[:, rows][:, :, cols].permute(1, 2, 0)


@pytest.mark.parametrize("grid,hw4", [((24, 32), (24, 32)),
                                      ((24, 32), (19, 27)),
                                      ((128, 128), (94, 125)),
                                      ((128, 128), (128, 128))])
def test_staged_taps_are_the_twins(grid, hw4):
    """Every cell a particle can floor to, (iy, ix) in [0, h4) x [0, w4):
    the staged rows' four taps at (iy, ix), (iy, ix + 1), (iy + 1, ix),
    (iy + 1, ix + 1), no clamp, equal the twin's clamped ones."""
    h, w = grid
    g = np.random.default_rng(1)
    dp = torch.from_numpy(g.standard_normal((2, h, w)).astype(np.float32))
    st = staged_rows(dp, hw4[0])
    iy, ix = torch.meshgrid(torch.arange(hw4[0]), torch.arange(hw4[1]),
                            indexing="ij")
    i00 = iy * w + ix
    i10 = torch.clamp(iy + 1, max=h - 1) * w + ix
    dx1 = torch.clamp(ix + 1, max=w - 1) - ix
    for c in range(2):
        f = dp[c].reshape(-1)
        assert torch.equal(st[iy, ix, c], f[i00])
        assert torch.equal(st[iy, ix + 1, c], f[i00 + dx1])
        assert torch.equal(st[iy + 1, ix, c], f[i10])
        assert torch.equal(st[iy + 1, ix + 1, c], f[i10 + dx1])


@pytest.mark.gpu
def test_staged_size_rule():
    """The staged instance needs a width that is a multiple of 4 and rows
    [0, h4] x [0, W] of float2 within a CTA's 227 KB: the kernel's own
    rule (``irn_advect_staged_bytes``), which runs only where the
    kernels are built."""
    if not torch.cuda.is_available():
        pytest.skip("the rule is the built kernel's: needs a CUDA card")
    assert centroids.advect_staged(128, 128)
    assert centroids.advect_staged(160, 160)  # 161 x 161 x 8 bytes
    assert not centroids.advect_staged(192, 188)
    assert not centroids.advect_staged(30, 29)
    assert centroids.advect_staged(168, 170)  # 171 x 169 x 8 <= 232448
    assert not centroids.advect_staged(172, 170)  # 171 x 173 x 8 > it


@pytest.mark.parametrize("iters", [1, 4, 8, 9, 17])
@pytest.mark.parametrize("hw4", EXTENTS)
def test_advect_matches_jax(rng, hw4, iters):
    """``advect`` on the CPU (the twin) equals JAX's default
    ``_find_centroids_matmul`` on the field of
    tests/test_torch_instances.py, at step counts around the chunk."""
    dp = (rng.standard_normal((2, *GRID)) * 1.2).astype(np.float32)
    cent, _ = centroids.advect(torch.from_numpy(dp), *hw4, iters)
    want = jax_centroids._find_centroids_matmul(
        jnp.asarray(dp), jnp.int32(hw4[0]), jnp.int32(hw4[1]), iters)
    np.testing.assert_array_equal(cent.numpy(), np.asarray(want))
