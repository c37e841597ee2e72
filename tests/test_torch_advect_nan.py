"""K11's twin on a dp that holds NaN or an infinity, against the JAX
package's default advection, ``_find_centroids_matmul``, on the CPU: end
points bit-equal.

JAX's form multiplies every cell of a plane by a two-tap weight that is 0
off the particle's taps, so 0 * NaN and 0 * inf make the sample NaN
wherever the plane holds a non-finite cell, padding included, unless every
such cell is an infinity of one sign on a tap of positive weight; the clip
carries NaN on, and XLA's CPU conversion turns a NaN end point into 0.
``centroids.advect_plain`` (the twin) and ``centroids.advect_schedule``
(the kernel's schedule) follow it step for step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import centroids as jax_centroids
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import centroids
from irn_tpu_torch.tools import probe_advect as pa

torch.set_num_threads(2)

# grids, each at an extent short of both sides
GRIDS = {(6, 7): (5, 6), (32, 32): (27, 29)}
VALUES = {"nan": float("nan"), "+inf": float("inf"), "-inf": float("-inf")}
PLANES = {"dy": (0,), "dx": (1,), "both": (0, 1)}


@pytest.fixture(autouse=True)
def _no_launches():
    _build.reset_launches()
    yield
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def _where(place, grid, hw4):
    """The planted cell: inside the extent, at the extent's corner (where
    every padding particle starts), in the padding just past it, or at the
    grid's own corner."""
    (h, w), (h4, w4) = grid, hw4
    return {"inside": (h4 // 2, w4 // 3), "extent corner": (h4 - 1, w4 - 1),
            "padding": (h4, w4), "grid corner": (h - 1, w - 1)}[place]


def _field(grid, hw4, seed=0):
    """dp [2, H, W] f32: a pull toward three centres plus noise, zero beyond
    the extent (``tools/probe_advect``'s basin field)."""
    h, w = grid
    return np.ascontiguousarray(
        pa.pull_field(max(h, w), hw4, 0.3, 0.1, seed)[:, :h, :w])


def _jax(dp, hw4, iterations):
    return np.asarray(jax_centroids._find_centroids_matmul(
        jnp.asarray(dp), jnp.int32(hw4[0]), jnp.int32(hw4[1]), iterations))


def _check(dp, hw4, iterations):
    want = _jax(dp, hw4, iterations)
    t = torch.from_numpy(dp)
    cent, basin = centroids.advect(t, *hw4, iterations)
    np.testing.assert_array_equal(cent.numpy(), want)
    sched, sched_basin, ran = centroids.advect_schedule(t, *hw4, iterations)
    np.testing.assert_array_equal(sched.numpy(), want)
    assert torch.equal(sched_basin, basin)
    assert int(ran.max()) <= iterations
    # sqrt(NaN) < 2.5 and sqrt(inf) < 2.5 are false in both packages
    bad = ~np.isfinite(dp).all(0)
    assert not bool(basin.numpy()[bad].any())
    return want


@pytest.mark.parametrize("iterations", [0, 1, 2, 300])
@pytest.mark.parametrize("place", ["inside", "extent corner", "padding",
                                   "grid corner"])
@pytest.mark.parametrize("plane", list(PLANES))
@pytest.mark.parametrize("value", list(VALUES))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_advect_nan_matches_jax(grid, value, plane, place, iterations):
    """One non-finite cell per poisoned plane: the twin's and the schedule's
    end points equal JAX's bit for bit, at 0, 1, 2 and 300 steps."""
    hw4 = GRIDS[grid]
    dp = _field(grid, hw4)
    r, c = _where(place, grid, hw4)
    for k in PLANES[plane]:
        dp[k, r, c] = VALUES[value]
    want = _check(dp, hw4, iterations)
    if iterations == 0:  # the start positions, poisoned or not
        h, w = grid
        yy, xx = np.mgrid[:h, :w]
        np.testing.assert_array_equal(
            want, np.stack([np.minimum(yy, hw4[0] - 1),
                            np.minimum(xx, hw4[1] - 1)]))


@pytest.mark.parametrize("value", list(VALUES))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_advect_nan_rule(grid, value):
    """A poisoned dy with a clean dx, the cell in the padding row h4 (which
    no particle taps with a positive weight): every y end point is 0 and
    every x end point is the rounded, clipped position after step 1 (from
    step 2 on a NaN y has no tap of positive weight, so the clean dx
    samples 0)."""
    hw4 = GRIDS[grid]
    dp = _field(grid, hw4)
    dp[0, hw4[0], hw4[1] // 3] = VALUES[value]
    want = _check(dp, hw4, 300)
    h, w = grid
    yy, xx = np.mgrid[:h, :w]
    y0, x0 = np.minimum(yy, hw4[0] - 1), np.minimum(xx, hw4[1] - 1)
    # step 1 from the integer start positions: dx's one tap, (y0, x0)
    x1 = np.clip(x0.astype(np.float32) + dp[1][y0, x0], np.float32(0),
                 np.float32(hw4[1] - 1))
    assert not want[0].any()
    np.testing.assert_array_equal(want[1], np.rint(x1).astype(np.int32))


@pytest.mark.parametrize("seed", range(8))
def test_advect_nan_random_plants(seed):
    """Several non-finite cells at once (NaN and infinities of either sign,
    in one plane or both, anywhere; blocks of infinities of one sign
    around a start position, which some particles tap with positive
    weight), grids down to 1 x 3 and 2 x 2, extents anywhere: the twin's
    and the schedule's end points equal JAX's."""
    g = np.random.default_rng(seed)
    grids = [(6, 7), (32, 32), (9, 5), (3, 4), (2, 2), (1, 3)]
    for trial in range(6):
        h, w = grids[(seed + trial) % len(grids)]
        hw4 = (int(g.integers(1, h + 1)), int(g.integers(1, w + 1)))
        dp = (g.standard_normal((2, h, w)) * g.choice([0.3, 1.0, 3.0])
              ).astype(np.float32)
        if trial % 2:
            v = g.choice([np.inf, -np.inf])
            r, c = int(g.integers(0, hw4[0])), int(g.integers(0, hw4[1]))
            cells = [(r, c), (r + 1, c), (r, c + 1), (r + 1, c + 1)]
            cells = [(a, b) for a, b in cells[: int(g.integers(1, 5))]
                     if a < h and b < w]
            for k in PLANES[str(g.choice(list(PLANES)))]:
                for a, b in cells:
                    dp[k, a, b] = v
        else:
            for _ in range(int(g.integers(1, 4))):
                v = g.choice([np.nan, np.inf, -np.inf])
                r, c = int(g.integers(0, h)), int(g.integers(0, w))
                for k in PLANES[str(g.choice(list(PLANES)))]:
                    dp[k, r, c] = v
        _check(dp, hw4, int(g.choice([1, 2, 3, 7, 300])))


def test_plane_poison():
    """What the kernel pools of a plane: the kinds found and the span of
    its infinities; None for a finite plane."""
    f = torch.zeros(5, 6)
    assert centroids.plane_poison(f) is None
    f[1, 2] = float("inf")
    f[3, 4] = float("inf")
    assert centroids.plane_poison(f) == (centroids.POS_INF, 1, 3, 2, 4)
    f[0, 0] = float("nan")
    kinds, *_ = centroids.plane_poison(f)
    assert kinds == centroids.POS_INF | centroids.NAN
    g = torch.zeros(5, 6)
    g[4, 5] = float("nan")
    assert centroids.plane_poison(g) == (centroids.NAN, 0, -1, 0, -1)
