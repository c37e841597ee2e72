"""Displacement-field instance grouping — the counterpart of
:mod:`irn_tpu.ops.centroids` (step/make_ins_seg_labels.py:18-105 of the
reference).

- K11 (:func:`advect`, ``csrc/advect.cu``): every pixel advects a particle
  through the displacement field for 300 steps with bilinear sampling,
  clipped to the true extent, and rounds the end point; the same kernel
  evaluates the ``|dp| < thres`` basin predicate. A NaN or infinity in dp
  gives JAX's end points (:func:`advect_step`). The JAX package runs the
  steps as one XLA loop; eager PyTorch would launch ~15 ops per step. The
  kernel reads dp from shared memory when the rows its particles reach fit
  (:func:`advect_staged`) and stops a particle early, exactly, once its
  orbit repeats within a chunk of steps.
- The host side (numpy, copied from the JAX module): the union-find
  clustering of the centroids by basin, the (instance x class) seed rows,
  the component split of a decoded label map and ``detect_instance``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from irn_tpu_torch.data.transforms import compress_range
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import cc

ITERATIONS = 300
BASIN_THRES = 2.5
# K11's steps between two compares of a particle's position (kChunk)
CHUNK = 8
# K11 floors a position by adding 2^23, exact below it
MAX_SIDE = 1 << 23


def _fma_f32_odd(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                 ) -> torch.Tensor:
    """fma_f32 by round-to-odd: the product is exact in f64; the sum is
    rounded to odd in f64 (``TwoSum`` gives its exact error, and an inexact
    sum with an even last bit steps one ulp toward the exact value), and
    the cast to f32 then rounds the exact value correctly (53 >= 24 + 2
    bits: Boldo and Melquiond's round-to-odd). Finite inputs only."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.tensor(float("inf"), dtype=s.dtype,
                                             device=s.device),
                       torch.tensor(float("-inf"), dtype=s.dtype,
                                    device=s.device))
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` of f32 tensors (broadcast) with one rounding, as a
    fused multiply-add (``__fmaf_rn``). The product is exact in f64, so s =
    RN64(a b + c) is one f64 rounding, and RN32(s) is the correctly rounded
    result unless s lies exactly halfway between two f32 values: every f32
    midpoint is an f64 number, so the exact sum and s lie on one side of
    it. Those sums (low 29 bits of the f64 mantissa 1 << 28), and the sums
    in f32's subnormal range (other midpoints), go through the
    round-to-odd path (:func:`_fma_f32_odd`)."""
    s = torch.addcmul(c.double(), a.double(), b.double())
    out = s.float()
    suspect = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) | (
        (s.abs() < 2.0 ** -126) & (s != 0))
    if bool(suspect.any()):
        a, b, c = torch.broadcast_tensors(a, b, c)
        out[suspect] = _fma_f32_odd(a[suspect], b[suspect], c[suspect])
    return out


# A plane's non-finite cells, as K11 gathers them: (kinds, r0, r1, c0, c1),
# kinds a mask of NAN / POS_INF / NEG_INF, (r0, r1, c0, c1) the rows and
# columns the infinities span; None for a finite plane.
NAN, POS_INF, NEG_INF = 1, 2, 4
Poison = Tuple[int, int, int, int, int]


def plane_poison(f: torch.Tensor) -> Optional[Poison]:
    """What K11 gathers of the non-finite cells of one [H, W] plane of dp,
    over the whole plane (padding included): None when it is finite."""
    nan, pos, neg = torch.isnan(f), f == float("inf"), f == float("-inf")
    kinds = (NAN * bool(nan.any()) | POS_INF * bool(pos.any())
             | NEG_INF * bool(neg.any()))
    if not kinds:
        return None
    r, c = torch.nonzero(pos | neg, as_tuple=True)
    if not len(r):
        return kinds, 0, -1, 0, -1
    return kinds, int(r.min()), int(r.max()), int(c.min()), int(c.max())


def _poisoned_sample(q: Poison, fin: torch.Tensor, y: torch.Tensor,
                     ly: torch.Tensor, x: torch.Tensor, lx: torch.Tensor
                     ) -> torch.Tensor:
    """The JAX form's sample of a plane that holds a non-finite cell: its
    two-tap matmul and masked sum multiply every cell by a weight, and a
    weight is 0 everywhere but at the particle's taps, so 0 * inf and 0 *
    NaN make the sample NaN unless every non-finite cell is an infinity of
    one sign on a tap of positive weight, rows {ly, ly + 1 if fy > 0} x
    columns {lx, lx + 1 if fx > 0}: then it is that infinity."""
    kinds, r0, r1, c0, c1 = q
    nan = torch.full_like(y, float("nan"))
    if kinds & NAN or kinds == POS_INF | NEG_INF:
        return nan
    inside = (fin & (r0 >= ly) & (r1 <= ly + (y > ly).float())
              & (c0 >= lx) & (c1 <= lx + (x > lx).float()))
    inf = float("inf") if kinds == POS_INF else float("-inf")
    return torch.where(inside, torch.full_like(y, inf), nan)


def advect_step(fdy: torch.Tensor, fdx: torch.Tensor, y: torch.Tensor,
                x: torch.Tensor, h: int, w: int, ymax: torch.Tensor,
                xmax: torch.Tensor,
                poison: Tuple[Optional[Poison], Optional[Poison]] = (
                    None, None)) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the particles at (y, x) through the flat dp planes
    ``fdy``, ``fdx`` of an [h, w] grid whose non-finite cells ``poison``
    describes (:func:`plane_poison`), as JAX's ``_find_centroids_matmul``
    takes it. With ly = floor(y), fy = y - ly (likewise for x): the row
    interpolation is the two-tap matmul, which XLA's CPU dot accumulates by
    fused multiply-adds, r(c) = fma(fy, f[ly + 1, c], (1 - fy) f[ly, c]) at
    c = lx, lx + 1; the column step is a product and a sum, s = (1 - fx)
    r(lx) + fx r(lx + 1). Both channels are sampled at the old (y, x)
    before either moves. A tap past the grid carries weight exactly 0 (an
    integer position), so its index is clamped and its product is 0, as
    the matmul form drops it. A NaN position has no tap of positive weight:
    a finite plane samples 0 there. A plane with a non-finite cell samples
    NaN or an infinity (:func:`_poisoned_sample`). The clip carries a NaN
    on, as XLA's max and min do."""
    zero = torch.zeros((), device=y.device)
    fin = ~(torch.isnan(y) | torch.isnan(x))
    ys, xs = torch.where(fin, y, zero), torch.where(fin, x, zero)
    ly, lx = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - ly, xs - lx
    gy, gx = 1.0 - fy, 1.0 - fx
    iy, ix = ly.long(), lx.long()
    i00 = iy * w + ix
    i10 = torch.clamp(iy + 1, max=h - 1) * w + ix
    dx1 = torch.clamp(ix + 1, max=w - 1) - ix
    s = []
    for f, q in zip((fdy, fdx), poison):
        if q is not None:
            s.append(_poisoned_sample(q, fin, ys, ly, xs, lx))
            continue
        r0 = fma_f32(fy, f[i10], gy * f[i00])
        r1 = fma_f32(fy, f[i10 + dx1], gy * f[i00 + dx1])
        s.append(torch.where(fin, gx * r0 + fx * r1, zero))
    return (torch.minimum(torch.maximum(y + s[0], zero), ymax),
            torch.minimum(torch.maximum(x + s[1], zero), xmax))


def _start(h: int, w: int, h4: int, w4: int, dev: torch.device):
    """Each pixel's particle, flat: (min(row, h4 - 1), min(col, w4 - 1)),
    and the clip bounds (h4 - 1, w4 - 1)."""
    ymax = torch.tensor(float(h4 - 1), device=dev)
    xmax = torch.tensor(float(w4 - 1), device=dev)
    y = torch.minimum(torch.arange(h, dtype=torch.float32, device=dev)[
        :, None], ymax).expand(h, w).reshape(-1).clone()
    x = torch.minimum(torch.arange(w, dtype=torch.float32, device=dev)[
        None, :], xmax).expand(h, w).reshape(-1).clone()
    return y, x, ymax, xmax


def _end_points(y: torch.Tensor, x: torch.Tensor, h: int, w: int
                ) -> torch.Tensor:
    """[2, h, w] int32: each position rounded half to even, a NaN to 0 (as
    XLA's CPU conversion gives it; never a cast of NaN)."""
    p = torch.stack([y, x])
    p = torch.where(torch.isnan(p), torch.zeros((), device=p.device),
                    torch.round(p))
    return p.to(torch.int32).reshape(2, h, w)


def advect_plain(dp: torch.Tensor, h4: int, w4: int,
                 iterations: int = ITERATIONS,
                 thres: float = BASIN_THRES
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11's plain twin: the JAX package's default
    ``_find_centroids_matmul`` (centroids.py:140-168), step for step in the
    rounding its CPU build performs (:func:`advect_step`), NaN and
    infinities in dp included. The loop ends early, exactly, once no
    particle's position bits change in a step."""
    _, h, w = dp.shape
    y, x, ymax, xmax = _start(h, w, h4, w4, dp.device)
    fdy = dp[0].reshape(-1)
    fdx = dp[1].reshape(-1)
    poison = (plane_poison(dp[0]), plane_poison(dp[1]))
    for _ in range(iterations):
        ny, nx = advect_step(fdy, fdx, y, x, h, w, ymax, xmax, poison)
        still = (torch.equal(ny.view(torch.int32), y.view(torch.int32))
                 and torch.equal(nx.view(torch.int32), x.view(torch.int32)))
        y, x = ny, nx
        if still:
            break
    basin = torch.sqrt(dp[0] * dp[0] + dp[1] * dp[1]) < thres
    return _end_points(y, x, h, w), basin


def advect_schedule(dp: torch.Tensor, h4: int, w4: int,
                    iterations: int = ITERATIONS, chunk: int = CHUNK,
                    thres: float = BASIN_THRES
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11 as its threads run it, in torch on any device: (cent [2, H, W]
    int32, basin [H, W] bool, the steps each particle ran [H, W] int64).
    On a finite dp, steps of :func:`advect_step` in chunks of ``chunk``: a
    particle whose position bits after a chunk equal those before it has an
    orbit whose period divides ``chunk``, so it runs the ``left mod
    chunk`` steps still due and stops; fewer than ``chunk`` steps left run
    one by one; ``chunk`` 0 runs every step. Where dp holds a non-finite
    value, the kernel's second pass: each particle steps again from its
    start, one step at a time, until its bits stop changing (the steps
    counted are that pass's). Equal to :func:`advect_plain`
    (tests/test_torch_advect_schedule.py); the step counts are the work
    the kernel's rule does."""
    _, h, w = dp.shape
    y, x, ymax, xmax = _start(h, w, h4, w4, dp.device)
    fdy, fdx = dp[0].reshape(-1), dp[1].reshape(-1)
    poison = (plane_poison(dp[0]), plane_poison(dp[1]))
    left = torch.full((h * w,), iterations, dtype=torch.int64,
                      device=dp.device)
    ran = torch.zeros_like(left)
    if poison != (None, None):
        on = left > 0
        while bool(on.any()):
            ny, nx = advect_step(fdy, fdx, y, x, h, w, ymax, xmax, poison)
            moved = ((ny.view(torch.int32) != y.view(torch.int32))
                     | (nx.view(torch.int32) != x.view(torch.int32)))
            y, x = torch.where(on, ny, y), torch.where(on, nx, x)
            ran += on
            left -= on.long()
            on = on & moved & (left > 0)
        left.zero_()
    on = left >= chunk if chunk > 0 else torch.zeros_like(left, dtype=torch.bool)
    while bool(on.any()):
        by, bx = y.view(torch.int32).clone(), x.view(torch.int32).clone()
        for _ in range(chunk):
            ny, nx = advect_step(fdy, fdx, y, x, h, w, ymax, xmax)
            y, x = torch.where(on, ny, y), torch.where(on, nx, x)
        left = torch.where(on, left - chunk, left)
        ran += chunk * on
        rep = on & (y.view(torch.int32) == by) & (x.view(torch.int32) == bx)
        left = torch.where(rep, left % chunk, left)
        on = on & ~rep & (left >= chunk)
    while bool((left > 0).any()):
        on = left > 0
        ny, nx = advect_step(fdy, fdx, y, x, h, w, ymax, xmax)
        y, x = torch.where(on, ny, y), torch.where(on, nx, x)
        left -= on.long()
        ran += on
    basin = torch.sqrt(dp[0] * dp[0] + dp[1] * dp[1]) < thres
    return _end_points(y, x, h, w), basin, ran.reshape(h, w)


def advect_staged(w: int, h4: int) -> bool:
    """Whether K11 reads its taps from rows staged in shared memory (else
    through L1) on a grid of width ``w`` at extent height ``h4``: the
    kernel's own rule (``irn_advect_staged_bytes``), so the card only."""
    return _build.load().irn_advect_staged_bytes(w, h4) > 0


@functools.lru_cache(maxsize=None)
def _scratch_words() -> int:
    """uint32 words of K11's scratch (the source's irn_advect_scratch_words,
    asked once)."""
    return _build.load().irn_advect_scratch_words()


def advect(dp: torch.Tensor, h4: int, w4: int, iterations: int = ITERATIONS,
           thres: float = BASIN_THRES) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11: (cent [2, H, W] int32, basin [H, W] bool) from dp [2, H, W]
    f32 (zero beyond the (h4, w4) extent). Particles start at
    (min(row, h4 - 1), min(col, w4 - 1)) and stay in [0, h4 - 1] x
    [0, w4 - 1]; the end points round half to even. basin is
    ``sqrt(dy^2 + dx^2) < thres`` over the whole grid. One cooperative
    launch on the card, bit-equal to :func:`advect_plain`, JAX's end points
    where dp holds NaN or infinities too; its scratch (the CTAs' pooled
    check of dp) is per stream and left ready for the next launch."""
    if dp.dim() != 3 or dp.shape[0] != 2:
        raise ValueError(f"advect: dp must be [2, H, W], got {tuple(dp.shape)}")
    _, h, w = dp.shape
    if not (1 <= h4 <= h and 1 <= w4 <= w) or iterations < 0:
        raise ValueError(f"advect: extent {(h4, w4)} of grid {(h, w)}, "
                         f"iterations {iterations}")
    if _build.is_plain(dp):
        return advect_plain(dp, h4, w4, iterations, thres)
    _build.check_cuda("advect", dp)
    if max(h, w) > MAX_SIDE:
        raise ValueError(f"advect: grid {(h, w)} has a side over {MAX_SIDE}")
    if dp.data_ptr() % 16:  # the staged rows are loaded 16 bytes at a time
        dp = dp.clone()
    cent = torch.empty((2, h, w), dtype=torch.int32, device=dp.device)
    basin = torch.empty((h, w), dtype=torch.bool, device=dp.device)
    scratch = _build.stream_scratch("advect", dp.device, _scratch_words())
    _build.launch("advect", dp.device, dp.data_ptr(), cent.data_ptr(),
                  basin.data_ptr(), scratch.data_ptr(), h, w, h4, w4,
                  iterations, float(thres))
    return cent, basin


def cluster_centroids(centroids: np.ndarray, dp: np.ndarray,
                      thres: float = BASIN_THRES) -> np.ndarray:
    """[K, H, W] boolean one-hot instance masks (K includes the 0 bucket of
    pixels whose centroid escaped every basin)."""
    strength = np.sqrt(dp[0] ** 2 + dp[1] ** 2)
    return cluster_centroids_from_basin(
        centroids, (strength < thres).astype(np.uint8)
    )


def cluster_centroids_from_basin(centroids: np.ndarray,
                                 basin: np.ndarray) -> np.ndarray:
    """:func:`cluster_centroids` from a precomputed basin mask: the basin's
    components (union-find), each pixel labelled by the component its
    centroid lands on, renumbered densely with the escape bucket first."""
    h, w = basin.shape
    basin_labels, _ = cc.label_components(basin.astype(np.uint8))
    flat = basin_labels.reshape(-1)
    centroid_flat = (
        centroids[0].astype(np.int64).reshape(-1) * w
        + centroids[1].astype(np.int64).reshape(-1)
    )
    clusters = flat[centroid_flat].reshape(h, w)
    cluster_map = compress_range(clusters + 1)
    return cc.to_one_hot(cluster_map)


def mask_scores_by_instance(scores: np.ndarray,
                            instance_masks: np.ndarray) -> np.ndarray:
    """[C*K, H, W] per-(instance, class) masked score maps, class-major:
    [C, 1, H, W] * [1, K, H, W] flattened (make_ins_seg_labels.py:135)."""
    c = scores.shape[0]
    k = instance_masks.shape[0]
    out = scores[:, None] * instance_masks[None].astype(scores.dtype)
    return out.reshape(c * k, *scores.shape[1:])


def split_components(labels_np: np.ndarray, n_rows: int):
    """Global component map over the per-row masks of a decoded label map.

    Components never cross rows (labels are an argmax), so per-row CC
    results concatenate into one map. Returns (comp_map [H, W] int32 with
    ids 1..K, comp_rows [K] the seed row of each component, comp_sizes [K]).
    """
    comp_map = np.zeros(labels_np.shape, np.int32)
    comp_rows = []
    comp_sizes = []
    present = np.unique(labels_np)
    # labels name seed rows 1..n_rows (0 = background)
    assert present.max(initial=0) <= n_rows, (present.max(), n_rows)
    offset = 0
    for row in present:
        if row == 0:
            continue
        mask = labels_np == row
        lab, k = cc.label_components(mask.astype(np.uint8))
        comp_map[mask] = lab[mask] + offset
        sizes = np.bincount(lab.reshape(-1), minlength=k + 1)[1 : k + 1]
        comp_rows.extend([int(row) - 1] * k)
        comp_sizes.extend(sizes.tolist())
        offset += k
    return comp_map, np.asarray(comp_rows, np.int32), np.asarray(
        comp_sizes, np.int64
    )


def detect_instance(score_map: np.ndarray, masks: np.ndarray,
                    class_ids: np.ndarray,
                    max_fragment_size: float = 0) -> Dict[str, np.ndarray]:
    """Split winning masks into components, zero-score small fragments
    (make_ins_seg_labels.py:82-105): score_map [N, H, W], masks [N, H, W]
    bool, class_ids [N]."""
    pred_score, pred_label, pred_mask = [], [], []
    for score, mask, cls in zip(score_map, masks, class_ids):
        if mask.sum() < 1:
            continue
        labels, k = cc.label_components(mask.astype(np.uint8))
        for comp in range(1, k + 1):
            seg = labels == comp
            if seg.sum() < max_fragment_size:
                pred_score.append(0.0)
            else:
                pred_score.append(float(np.max(score * seg)))
            pred_label.append(int(cls))
            pred_mask.append(seg)
    if not pred_mask:
        h, w = masks.shape[1:]
        return {
            "score": np.zeros((0,), np.float32),
            "mask": np.zeros((0, h, w), bool),
            "class": np.zeros((0,), np.int32),
        }
    return {
        "score": np.asarray(pred_score, np.float32),
        "mask": np.stack(pred_mask, 0),
        "class": np.asarray(pred_label, np.int32),
    }
