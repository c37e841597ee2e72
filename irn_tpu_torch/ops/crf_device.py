"""Device dense-CRF mean field on PyTorch: the counterpart of
:mod:`irn_tpu.ops.crf_tpu` (its ``crf_pair_program`` and ``LandmarkCRF``),
cam_to_ir_label's device backend.

The exact CRF operator is approximated with dense products instead of the
permutohedral lattice's scatter and gather (:mod:`irn_tpu_torch.ops.crf`,
the host backend):

- **Gaussian kernel (sxy 3, compat 3): exact.** A truncated separable
  convolution (|tap| <= 4 sigma, 25 taps) in f32, a row pass then a column
  pass (:func:`blur`), with the symmetric normalisation's row sums from the
  blurred validity mask.
- **Bilateral kernel (sxy 50, srgb 5, compat 10): landmark subgrid.**
  Every pixel exchanges messages with a stride-``s`` subgrid of landmark
  pixels; the 5-D kernel to each landmark is evaluated exactly and stored
  with its row sums by :func:`landmark_rows`: on the card two launches per
  image (K14, ``csrc/crf_landmark.cu``: the landmark table, then the
  rows), on the CPU its plain twin :func:`landmark_rows_plain` in chunks
  of at most 4096 rows. Each
  mean-field iteration is then one [N, S] @ [S, 2L] product: bf16 storage
  with f32 accumulation (``kernel_store='dense'``), or int8 storage with
  int32 accumulation (``'int8'``, the activations quantized per column on
  the fly, the row sums taken from the quantized kernel).

DenseCRF v2 conventions as the JAX module: unit-variance kernels on 1/sxy-
and 1/srgb-scaled features, symmetric D^-1/2 K D^-1/2 normalisation, self
term included, positive-Potts update, unary log gt_prob /
log((1 - gt_prob) / (n - 1)). The fg/bg pair of the ir-label stage shares
one kernel build and rides one product ([S, 2L] right operand).

The products are library calls: on CUDA ``torch._int_mm`` (int8 x int8 ->
int32, its right operand column-major with a multiple of 8 columns) and
``torch.mm(..., out_dtype=torch.float32)`` for bf16; on the CPU the same
``torch._int_mm``, and the bf16 product upcast to f32 (exact products, f32
sums, as XLA's bf16 dot with an f32 result). Everything else of an
iteration is K17 (``csrc/crf_mean_field.cu``), two launches around the
product: :func:`quantize` writes the product's operand straight in its
layout, :func:`combine` reads the product's output in place, blurs,
adds the unary made from the uint8 label maps, and takes the softmax (on
the last iteration the argmax); :func:`start` takes the first softmax and
:func:`blur` the Gaussian's row sums. On the CPU each runs its plain twin
(``*_plain``), in the kernel's order of operations.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops.centroids import fma_f32

CHUNK_ROWS = 4096
KERNEL_STORES = ("dense", "int8")
# K14's stores on the card (the twin takes any float dtype as well)
LANDMARK_STORES = (torch.int8, torch.bfloat16, torch.float32)
# sqrt(log2(e) / 2) rounded to f32 (0.8493218): with F = RN(SIGMA f),
# exp(-|f_p - f_j|^2 / 2) = exp2(2 <F_p, F_j> - |F_p|^2 - |F_j|^2)
SIGMA_BITS = 0x3F596D27
# K14's landmark table: rows F_0 .. F_4 and b = chain(F, F), its columns a
# multiple of the widest tile (32 lanes x 16 int8 columns)
TABLE_ROWS = 6
TABLE_ALIGN = 512
# K17's compiled limits: the Gaussian's taps (2r + 1 <= 25, sxy <= 3) and
# the channels per map whose logits a thread keeps in registers
BLUR_TAPS = 25
MAX_CAP_CARD = 32
INV_127_SQ = np.float32(1.0 / (127.0 * 127.0))
NEVER_LOGIT = -1e30  # the unary of a channel past the image's labels


def landmark_grid(h: int, w: int, stride: int) -> Tuple[int, int]:
    """Rows and columns of the landmark subgrid of an [h, w] bucket: the
    pixels (off + stride i, off + stride j), off = stride // 2."""
    off = stride // 2
    return len(range(off, h, stride)), len(range(off, w, stride))


def landmark_columns(n_land: int, store: torch.dtype) -> int:
    """Columns of the stored kernel: the int8 product wants S in multiples
    of 8, so int8 pads with zero landmarks (v 0, zero columns)."""
    return n_land + (-n_land) % 8 if store == torch.int8 else n_land


def _check_rows(planes: torch.Tensor, rows, stride: int) -> Tuple[int, int]:
    if planes.dim() != 3 or planes.shape[0] != 3 or planes.dtype != torch.uint8:
        raise ValueError(f"crf_landmark: image planes [3, H, W] uint8, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    n = planes.shape[1] * planes.shape[2]
    r0, r1 = (0, n) if rows is None else rows
    if not 0 <= r0 < r1 <= n or stride < 1 or n >= 2 ** 31:
        raise ValueError(f"crf_landmark: rows [{r0}, {r1}) of {n}, stride "
                         f"{stride}")
    return r0, r1


def _chain(p, q) -> torch.Tensor:
    """K14's five-term dot of feature tensors: fma(p4, q4, fma(p3, q3,
    fma(p2, q2, fma(p1, q1, RN(p0 q0))))), each fma rounded once
    (:func:`centroids.fma_f32`, ``__fmaf_rn`` on the card)."""
    c = p[0] * q[0]
    for x, y in zip(p[1:], q[1:]):
        c = fma_f32(x, y, c)
    return c


def _exp2(u: torch.Tensor) -> torch.Tensor:
    """exp2 of f32 u as the twin takes it: on the card torch's f32 exp2,
    whose bits K14 follows; on the CPU through f64, rounded once to f32,
    because torch's f32 exp2 there gives other bits in a tensor's
    vectorized body than in its scalar tail (a row range would not be the
    slice of the whole build)."""
    if u.device.type == "cuda":
        return torch.exp2(u)
    return torch.exp2(u.double()).float()


def _lane_sums(k: torch.Tensor, v: int) -> torch.Tensor:
    """Row sums of k [rows, S] f32 in K14's order: lane l of 32 adds the
    columns j with (j // v) % 32 == l from 0 in increasing j, then the lane
    sums are added pairwise (l, l + o) for o = 16, 8, 4, 2, 1 (a warp's
    butterfly, read at lane 0). Zero columns pad S to a tile: adding +0
    changes no sum."""
    rows, s = k.shape
    tile = 32 * v
    k = torch.nn.functional.pad(k, (0, (-s) % tile)).view(rows, -1, 32, v)
    acc = torch.zeros((rows, 32), dtype=torch.float32, device=k.device)
    for i in range(k.shape[1]):
        for j in range(v):
            acc = acc + k[:, i, :, j]
    for o in (16, 8, 4, 2, 1):
        acc = acc[:, :o] + acc[:, o:2 * o]
    return acc[:, 0]


def _scaled_features(planes: torch.Tensor, sxy: float, srgb: float):
    """features(ys, xs) -> the five scaled features F = RN(SIGMA f) of the
    pixels (ys, xs), f = (x / sxy, y / sxy, r / srgb, g / srgb, b / srgb).
    The divisions take a tensor divisor: a CUDA tensor divided by a Python
    number is a product with its reciprocal in torch, not a division."""
    dev = planes.device
    sxy_t = torch.full((), sxy, dtype=torch.float32, device=dev)
    srgb_t = torch.full((), srgb, dtype=torch.float32, device=dev)
    sigma = torch.tensor(SIGMA_BITS, dtype=torch.int32).view(
        torch.float32).to(dev)
    flat = planes.reshape(3, -1)
    w = planes.shape[2]

    def features(ys, xs):
        p = ys * w + xs
        f = [xs.float() / sxy_t, ys.float() / sxy_t,
             *(flat[c, p].float() / srgb_t for c in range(3))]
        return [x * sigma for x in f]

    return features


def table_columns(n_land: int) -> int:
    """Columns of K14's landmark table: S padded to a multiple of the
    widest tile, so that every tile reads whole 16-byte rows."""
    return n_land + (-n_land) % TABLE_ALIGN


def landmark_table_plain(planes: torch.Tensor, eh: int, ew: int, *,
                         stride: int = 4, sxy: float = 50.0,
                         srgb: float = 5.0) -> torch.Tensor:
    """The twin of K14's table pass: [6, table_columns(S)] f32, rows F_0 ..
    F_4 of each landmark's scaled features and b = chain(F, F); b is +inf
    for a landmark outside the true extent (eh, ew), and the padded columns
    hold F = 0, b = +inf."""
    _check_rows(planes, None, stride)
    _, h, w = planes.shape
    dev = planes.device
    lh, lw = landmark_grid(h, w, stride)
    off = stride // 2
    jy, jx = torch.meshgrid(torch.arange(lh, device=dev) * stride + off,
                            torch.arange(lw, device=dev) * stride + off,
                            indexing="ij")
    jy, jx = jy.reshape(-1), jx.reshape(-1)
    n_land = lh * lw
    f = _scaled_features(planes, sxy, srgb)(jy, jx)
    # b from the finite features first (fma_f32's exact path takes finite
    # inputs only), +inf for the invalid landmarks after
    b = torch.where((jy < eh) & (jx < ew), _chain(f, f),
                    torch.full((), math.inf, device=dev))
    table = torch.zeros((TABLE_ROWS, table_columns(n_land)),
                        dtype=torch.float32, device=dev)
    table[5] = math.inf
    table[:5, :n_land] = torch.stack(f)
    table[5, :n_land] = b
    return table


def landmark_rows_plain(planes: torch.Tensor, eh: int, ew: int, *,
                        stride: int = 4, sxy: float = 50.0, srgb: float = 5.0,
                        store: torch.dtype = torch.int8,
                        rows: Optional[Tuple[int, int]] = None,
                        sums_only: bool = False):
    """K14's plain twin, in the kernel's order of operations (see
    :func:`landmark_rows`), built in chunks of CHUNK_ROWS rows from
    :func:`landmark_table_plain`."""
    r0, r1 = _check_rows(planes, rows, stride)
    _, h, w = planes.shape
    dev = planes.device
    features = _scaled_features(planes, sxy, srgb)
    lh, lw = landmark_grid(h, w, stride)
    s_cols = landmark_columns(lh * lw, store)
    table = landmark_table_plain(planes, eh, ew, stride=stride, sxy=sxy,
                                 srgb=srgb)[:, :s_cols]
    f_land = [x[None, :] for x in table[:5]]
    b_land = table[5][None, :]
    lanes = 16 // store.itemsize
    out = None if sums_only else torch.empty((r1 - r0, s_cols), dtype=store,
                                             device=dev)
    sums = torch.empty(r1 - r0, dtype=torch.float32, device=dev)
    for a in range(r0, r1, CHUNK_ROWS):
        b = min(a + CHUNK_ROWS, r1)
        p = torch.arange(a, b, device=dev)
        f_pix = features(p // w, p % w)
        t = _chain(f_pix, f_pix)[:, None] + b_land
        c = _chain([x[:, None] for x in f_pix], f_land)
        # 2c is exact, so 2c - t rounds once, as fma(2, c, -t)
        k = _exp2((2.0 * c - t).clamp(max=0.0))
        del c, t
        if store == torch.int8:
            # entries live in [0, 1]: symmetric scale 127; the row sums
            # come from the quantized values, the kernel actually applied
            k = torch.round(k * 127.0)
            sums[a - r0:b - r0] = k.sum(1) * np.float32(1.0 / 127.0)
        else:
            sums[a - r0:b - r0] = _lane_sums(k, lanes)
        if out is not None:
            out[a - r0:b - r0] = k.to(store)
    return out, sums


def landmark_table(planes: torch.Tensor, eh: int, ew: int, *,
                   stride: int = 4, sxy: float = 50.0,
                   srgb: float = 5.0) -> torch.Tensor:
    """K14's landmark table of one image (:func:`landmark_table_plain`): on
    the card one launch of its table pass, on the CPU the twin."""
    if _build.is_plain(planes):
        return landmark_table_plain(planes, eh, ew, stride=stride, sxy=sxy,
                                    srgb=srgb)
    _check_rows(planes, None, stride)
    _build.check_cuda("crf_landmark", planes, dtype=torch.uint8)
    _, h, w = planes.shape
    lh, lw = landmark_grid(h, w, stride)
    table = torch.empty((TABLE_ROWS, table_columns(lh * lw)),
                        dtype=torch.float32, device=planes.device)
    _build.launch("crf_landmark", planes.device, planes.data_ptr(),
                  table.data_ptr(), h, w, eh, ew, stride, lw, lh * lw,
                  table.shape[1], sxy, srgb, entry="crf_landmark_table")
    return table


def landmark_rows(planes: torch.Tensor, eh: int, ew: int, *,
                  stride: int = 4, sxy: float = 50.0, srgb: float = 5.0,
                  store: torch.dtype = torch.int8,
                  rows: Optional[Tuple[int, int]] = None,
                  sums_only: bool = False):
    """The bilateral landmark kernel of one image and its f32 row sums:
    (store [r1 - r0, S'] or None, sums [r1 - r0]) for the pixel rows
    [r0, r1) (default all) of the image planes [3, H, W] uint8 (the packed
    upload's first three), true extent (eh, ew).

    Pixel p = y W + x has the f32 features f_p = (x / sxy, y / sxy,
    r / srgb, g / srgb, b / srgb) and the scaled features F_p = RN(SIGMA
    f_p); landmark j is the pixel (off + stride (j // lw), off + stride
    (j % lw)), valid inside (eh, ew); under int8 S is padded to S' (a
    multiple of 8) with zero landmarks. With chain the five-term fma dot
    (:func:`_chain`), a_p = chain(F_p, F_p), b_j = chain(F_j, F_j) (+inf
    for an invalid or padded landmark) and c = chain(F_p, F_j), each entry
    is k = exp2(min(RN(2c - RN(a_p + b_j)), 0)) = exp(-d2 / 2) up to
    rounding (SIGMA^2 = log2(e) / 2), stored as int8 round(127 k), bf16 or
    f32 (``store``); the row sums are taken over the stored values,
    sum(round(127 k)) / 127 under int8, the f32 k otherwise (in K14's lane
    order, :func:`_lane_sums`). ``sums_only`` drops the store.

    On the card two launches of K14 (``csrc/crf_landmark.cu``: the table
    pass, then the rows), bit-equal to :func:`landmark_rows_plain`; on the
    CPU the twin."""
    if _build.is_plain(planes):
        return landmark_rows_plain(planes, eh, ew, stride=stride, sxy=sxy,
                                   srgb=srgb, store=store, rows=rows,
                                   sums_only=sums_only)
    r0, r1 = _check_rows(planes, rows, stride)
    if store not in LANDMARK_STORES:
        raise TypeError(f"crf_landmark: stores {LANDMARK_STORES}, got {store}")
    _build.check_cuda("crf_landmark", planes, dtype=torch.uint8)
    _, h, w = planes.shape
    dev = planes.device
    lh, lw = landmark_grid(h, w, stride)
    s_cols = landmark_columns(lh * lw, store)
    table = torch.empty((TABLE_ROWS, table_columns(lh * lw)),
                        dtype=torch.float32, device=dev)
    out = None if sums_only else torch.empty((r1 - r0, s_cols), dtype=store,
                                             device=dev)
    sums = torch.empty(r1 - r0, dtype=torch.float32, device=dev)
    _build.launch("crf_landmark", dev, planes.data_ptr(), table.data_ptr(),
                  None if out is None else out.data_ptr(), sums.data_ptr(),
                  h, w, eh, ew, stride, lw, lh * lw, s_cols, table.shape[1],
                  store.itemsize, r0, r1, sxy, srgb)
    return out, sums


def map_columns(cap: int) -> int:
    """Columns per label map in the product's operand and output: cap
    rounded up to a multiple of 4, so each map's columns start on 16 bytes
    and the 2 cp columns are a multiple of 8 (as ``torch._int_mm`` wants);
    map m's channel c is column m cp + c, the rest stay zero."""
    return cap + (-cap) % 4


def _columns(cap: int, device) -> torch.Tensor:
    """The operand column of each (map, channel) in q's channel order."""
    cp = map_columns(cap)
    return (torch.arange(2, device=device)[:, None] * cp
            + torch.arange(cap, device=device)[None, :]).reshape(-1)


def gaussian_taps(sxy: float) -> torch.Tensor:
    """The Gaussian's 2r + 1 f32 taps exp(-(i / sxy)^2 / 2), |i| <= r =
    ceil(4 sxy), made on the CPU: the host and the card blur with the same
    taps."""
    r = int(math.ceil(4.0 * sxy))
    return torch.exp(-0.5 * (torch.arange(-r, r + 1, dtype=torch.float32)
                             / sxy) ** 2)


def _card_taps(taps: torch.Tensor) -> torch.Tensor:
    """The taps as K17 takes them: BLUR_TAPS f32 in host memory, zero-padded
    at both ends (fma(0, x, acc) = acc for finite x)."""
    k = taps.shape[0]
    if taps.dim() != 1 or k % 2 == 0 or k > BLUR_TAPS:
        raise ValueError(f"crf_mean_field: an odd number of taps <= "
                         f"{BLUR_TAPS}, got {tuple(taps.shape)}")
    pad = (BLUR_TAPS - k) // 2
    return torch.nn.functional.pad(taps.detach().float().cpu(),
                                   (pad, pad)).contiguous()


def blur_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """K17's blur twin: the separable blur of x [C, H, W] f32 with zero
    padding, a row pass y[i, j] = sum_t taps[t] x[i, j + t - r], then a
    column pass sum_t taps[t] y[i + t - r, j], each sum from +0 over t in
    order by fused multiply-adds (:func:`centroids.fma_f32`; the Toeplitz
    products of the JAX module's ``_sep_gauss``, summed over the 2r + 1
    taps alone)."""
    k = taps.shape[0]
    r = (k - 1) // 2
    taps = taps.to(x.device)
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (r, r))
    y = torch.zeros_like(x)
    for t in range(k):
        y = fma_f32(taps[t], xp[..., t:t + w], y)
    yp = torch.nn.functional.pad(y, (0, 0, r, r))
    z = torch.zeros_like(x)
    for t in range(k):
        z = fma_f32(taps[t], yp[..., t:t + h, :], z)
    return z


def blur(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The separable Gaussian blur of x [C, H, W] f32 (:func:`blur_plain`):
    on the card one K17 launch (``csrc/crf_mean_field.cu``, taps 2r + 1 <=
    25), bit-equal to the twin; on the CPU the twin."""
    if _build.is_plain(x):
        return blur_plain(x, taps)
    if x.dim() != 3:
        raise ValueError(f"crf_mean_field: blur of [C, H, W], got "
                         f"{tuple(x.shape)}")
    _build.check_cuda("crf_mean_field", x)
    host_taps = _card_taps(taps)
    out = torch.empty_like(x)
    _build.launch("crf_mean_field", x.device, x.data_ptr(), out.data_ptr(),
                  *x.shape, host_taps.data_ptr(), entry="crf_blur")
    return out


def unary_logs(gt_prob: float, n_labels: int) -> Tuple[float, float]:
    """(log gt_prob, log((1 - gt_prob) / max(n_labels - 1, 1))) in f32,
    computed on the CPU: the host and the card take the same unary."""
    gt = torch.tensor(gt_prob, dtype=torch.float32)
    p_other = (1.0 - gt) / torch.tensor(max(float(n_labels) - 1.0, 1.0),
                                        dtype=torch.float32)
    return float(torch.log(gt)), float(torch.log(p_other))


def unary_plain(labels: torch.Tensor, cap: int, n_labels: int, lg: float,
                lo: float) -> torch.Tensor:
    """[2, cap, H, W] f32 unary of labels [2, H, W]: lg where the label is
    the channel, lo elsewhere, NEVER_LOGIT for channels >= n_labels (they
    can never win)."""
    dev = labels.device
    c = torch.arange(cap, device=dev)[None, :, None, None]

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    u = torch.where(c == labels.long()[:, None], f32(lg), f32(lo))
    return torch.where(c < n_labels, u, f32(NEVER_LOGIT))


def softmax_plain(l: torch.Tensor) -> torch.Tensor:
    """K17's softmax over dim 1 of l [2, cap, H, W]: m = max, e = exp(l -
    m), s = e_0 + e_1 + ... in channel order, e / s (IEEE divisions)."""
    e = torch.exp(l - l.amax(1, keepdim=True))
    s = e[:, 0]
    for c in range(1, l.shape[1]):
        s = s + e[:, c]
    return e / s[:, None]


def _check_cap(cap: int) -> None:
    if not 1 <= cap <= MAX_CAP_CARD:
        raise ValueError(f"crf_mean_field: n_label_cap <= {MAX_CAP_CARD} on "
                         f"the card, got {cap}")


def start_plain(labels: torch.Tensor, cap: int, n_labels: int, lg: float,
                lo: float, *, argmax: bool = False) -> torch.Tensor:
    """K17's start twin: q0 = softmax of the unary, [2, cap, H, W] f32, or
    its argmax [2, H, W] uint8 (the first largest channel)."""
    q = softmax_plain(unary_plain(labels, cap, n_labels, lg, lo))
    return torch.argmax(q, 1).to(torch.uint8) if argmax else q


def start(labels: torch.Tensor, cap: int, n_labels: int, lg: float,
          lo: float, *, argmax: bool = False) -> torch.Tensor:
    """The first softmax of labels [2, H, W] uint8 (:func:`start_plain`):
    on the card one K17 launch, on the CPU the twin."""
    if _build.is_plain(labels):
        return start_plain(labels, cap, n_labels, lg, lo, argmax=argmax)
    _check_cap(cap)
    _build.check_cuda("crf_mean_field", labels, dtype=torch.uint8)
    if labels.dim() != 3 or labels.shape[0] != 2:
        raise ValueError(f"crf_mean_field: label maps [2, H, W], got "
                         f"{tuple(labels.shape)}")
    _, h, w = labels.shape
    if argmax:
        out = torch.empty_like(labels)
        q, lab = None, out.data_ptr()
    else:
        out = torch.empty((2, cap, h, w), dtype=torch.float32,
                          device=labels.device)
        q, lab = out.data_ptr(), None
    _build.launch("crf_mean_field", labels.device, labels.data_ptr(), q, lab,
                  h, w, cap, n_labels, lg, lo, entry="crf_start")
    return out


def operand_buffers(n_land: int, cap: int, store: torch.dtype,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (operand, qscale [2 cp] f32) for :func:`quantize`: under int8
    the [S', 2 cp] column-major operand (a view of a [2 cp, S'] buffer,
    S' = S padded to a multiple of 8), else [S, 2 cp] row-major in
    ``store``."""
    m = 2 * map_columns(cap)
    qscale = torch.zeros(m, dtype=torch.float32, device=device)
    if store == torch.int8:
        s_rows = landmark_columns(n_land, torch.int8)
        return torch.zeros((m, s_rows), dtype=torch.int8,
                           device=device).t(), qscale
    return torch.zeros((n_land, m), dtype=store, device=device), qscale


def quantize_plain(q: torch.Tensor, nr_b: torch.Tensor, opnd: torch.Tensor,
                   qscale: torch.Tensor, *, stride: int = 4) -> None:
    """K17's quantize twin: the landmark activations a = RN(nr_b q) of each
    (map, channel) column into the operand; under int8 qscale = max(max a,
    1e-20) and rint(RN(a RN(127 / qscale))), the scale into qscale."""
    _, cap, _, _ = q.shape
    off = stride // 2
    a = (nr_b * q)[:, :, off::stride, off::stride].reshape(2 * cap, -1)
    cols = _columns(cap, q.device)
    if opnd.dtype == torch.int8:
        scale = a.amax(1).clamp_min(1e-20)
        r = torch.full((), 127.0, device=q.device) / scale
        opnd.t()[cols, :a.shape[1]] = torch.round(a * r[:, None]).to(
            torch.int8)
        qscale[cols] = scale
    else:
        opnd[:, cols] = a.t().to(opnd.dtype)


def quantize(q: torch.Tensor, nr_b: torch.Tensor, opnd: torch.Tensor,
             qscale: torch.Tensor, *, stride: int = 4) -> None:
    """The product's operand from q [2, cap, H, W] f32 and the bilateral row
    norms nr_b [H, W] (:func:`quantize_plain`), into buffers from
    :func:`operand_buffers`: on the card one K17 launch, on the CPU the
    twin."""
    if _build.is_plain(q):
        return quantize_plain(q, nr_b, opnd, qscale, stride=stride)
    _, cap, h, w = q.shape
    _check_cap(cap)
    _build.check_cuda("crf_mean_field", q, nr_b, qscale)
    lh, lw = landmark_grid(h, w, stride)
    cp = map_columns(cap)
    if opnd.dtype == torch.int8:
        buf = opnd.t()
        _build.check_cuda("crf_mean_field", buf, dtype=torch.int8)
        ok = buf.shape[0] == 2 * cp and buf.shape[1] >= lh * lw
    else:
        _build.check_cuda("crf_mean_field", opnd, dtype=opnd.dtype)
        ok = (opnd.dtype in (torch.bfloat16, torch.float32)
              and opnd.shape == (lh * lw, 2 * cp))
    if not ok or nr_b.shape != (h, w) or qscale.shape[0] < 2 * cp:
        raise ValueError(f"crf_mean_field: operand {tuple(opnd.shape)} "
                         f"{opnd.dtype}, nr_b {tuple(nr_b.shape)} for q "
                         f"{tuple(q.shape)}")
    _build.launch("crf_mean_field", q.device, q.data_ptr(), nr_b.data_ptr(),
                  opnd.data_ptr(), qscale.data_ptr(), h, w, cap, cp, stride,
                  lw, lh * lw, opnd.shape[0], opnd.dtype.itemsize,
                  entry="crf_quantize")


def combine_plain(q: torch.Tensor, labels: torch.Tensor, nr_g: torch.Tensor,
                  nr_b: torch.Tensor, taps: torch.Tensor, prod: torch.Tensor,
                  qscale: Optional[torch.Tensor], n_labels: int, lg: float,
                  lo: float, out: torch.Tensor, *,
                  compat_gaussian: float = 3.0,
                  compat_bilateral: float = 10.0) -> torch.Tensor:
    """K17's combine twin: l = RN(RN(u + mg) + mb) with the Gaussian message
    mg = RN(RN(compat_g nr_g) blur(RN(nr_g q))) and the bilateral message
    mb = RN(RN(compat_b nr_b) x), x the product's column (int32 under int8,
    then RN(float(acc) RN(qscale / 127^2))); the softmax of l into ``out``
    [2, cap, H, W] f32, or its argmax into ``out`` [2, H, W] uint8."""
    _, cap, h, w = q.shape
    z = blur_plain((nr_g * q).reshape(2 * cap, h, w), taps).reshape(q.shape)
    l = unary_plain(labels, cap, n_labels, lg, lo) + (
        compat_gaussian * nr_g) * z
    cols = _columns(cap, q.device)
    x = prod[:, cols]
    if prod.dtype == torch.int32:
        x = x.float() * (qscale[cols] * INV_127_SQ)
    mb = (compat_bilateral * nr_b).reshape(-1, 1) * x
    q_next = softmax_plain(l + mb.t().reshape(q.shape))
    if out.dtype == torch.uint8:
        return out.copy_(torch.argmax(q_next, 1))
    return out.copy_(q_next)


def check_q_map(q: torch.Tensor) -> None:
    """Raises unless q [2, cap, H, W] f32 can back K17's combine's TMA
    tensor map: its base 16-byte aligned and a row, W * 4 bytes, a multiple
    of 16 (W a multiple of 4; the pipeline's buckets are multiples of
    ``pad_multiple``, 64 by default)."""
    _, _, h, w = q.shape
    if w % 4 or q.data_ptr() % 16 or not q.is_contiguous():
        raise ValueError(f"crf_mean_field: the combine reads q {tuple(q.shape)}"
                         f" through a TMA tensor map: W a multiple of 4 and a "
                         f"contiguous, 16-byte aligned q, got W {w}, address "
                         f"{q.data_ptr()} % 16 = {q.data_ptr() % 16}")


def combine(q: torch.Tensor, labels: torch.Tensor, nr_g: torch.Tensor,
            nr_b: torch.Tensor, taps: torch.Tensor, prod: torch.Tensor,
            qscale: Optional[torch.Tensor], n_labels: int, lg: float,
            lo: float, out: torch.Tensor, *, compat_gaussian: float = 3.0,
            compat_bilateral: float = 10.0) -> torch.Tensor:
    """One mean-field update after the product (:func:`combine_plain`): q
    [2, cap, H, W] f32, the label maps [2, H, W] uint8, the row norms [H, W],
    the product's output prod [N, >= 2 cp] (int32 with qscale, or f32, map
    m's channel c in column m cp + c, read in place) -> ``out`` (q_{i+1}, a
    buffer apart from q, or the labels). On the card one K17 launch (q
    as :func:`check_q_map` asks), on the CPU the twin."""
    kw = dict(compat_gaussian=compat_gaussian,
              compat_bilateral=compat_bilateral)
    if _build.is_plain(q):
        return combine_plain(q, labels, nr_g, nr_b, taps, prod, qscale,
                             n_labels, lg, lo, out, **kw)
    _, cap, h, w = q.shape
    _check_cap(cap)
    cp = map_columns(cap)
    int8 = prod.dtype == torch.int32
    _build.check_cuda("crf_mean_field", q, nr_g, nr_b,
                      *([qscale] if int8 else []))
    _build.check_cuda("crf_mean_field", labels, dtype=torch.uint8)
    check_q_map(q)
    if (labels.shape != (2, h, w) or nr_g.shape != (h, w)
            or nr_b.shape != (h, w) or prod.device != q.device
            or prod.dtype not in (torch.int32, torch.float32)
            or prod.shape[0] != h * w or prod.shape[1] < 2 * cp
            or prod.stride(1) != 1 or prod.stride(0) % 4
            or prod.data_ptr() % 16 or (int8 and qscale.shape[0] < 2 * cp)):
        raise ValueError(f"crf_mean_field: q {tuple(q.shape)}, labels "
                         f"{tuple(labels.shape)}, product "
                         f"{tuple(prod.shape)} {prod.dtype} strides "
                         f"{prod.stride()}")
    if out.dtype == torch.uint8:
        _build.check_cuda("crf_mean_field", out, dtype=torch.uint8)
        q_out, lab_out = None, out.data_ptr()
        ok = out.shape == (2, h, w)
    else:
        _build.check_cuda("crf_mean_field", out)
        q_out, lab_out = out.data_ptr(), None
        ok = out.shape == q.shape and out.data_ptr() != q.data_ptr()
    if not ok:
        raise ValueError(f"crf_mean_field: out {tuple(out.shape)} "
                         f"{out.dtype} for q {tuple(q.shape)}")
    host_taps = _card_taps(taps)
    _build.launch("crf_mean_field", q.device, q.data_ptr(), nr_g.data_ptr(),
                  nr_b.data_ptr(), labels.data_ptr(), prod.data_ptr(),
                  prod.stride(0), qscale.data_ptr() if int8 else None, q_out,
                  lab_out, host_taps.data_ptr(), h, w, cap, cp, n_labels,
                  int(int8), lg, lo, compat_gaussian, compat_bilateral)
    return out


def product_f32(k: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """k [N, S] (f32 or bf16) @ q [S, M] in k's dtype with an f32 result;
    q's columns padded to a multiple of 8 where they are not (zero columns,
    aligned rows for cuBLAS)."""
    m = q.shape[1]
    q = q.to(k.dtype)
    if m % 8:
        q = torch.nn.functional.pad(q, (0, (-m) % 8))
    if k.dtype == torch.float32:
        return torch.mm(k, q)[:, :m]
    if k.device.type == "cuda":
        return torch.mm(k, q, out_dtype=torch.float32)[:, :m]
    return torch.mm(k.float(), q.float())[:, :m]


def product_int8(k8: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """k8 [N, S] int8 @ q8 [S, M] int8 -> int32 (exact). ``torch._int_mm``
    wants S and the output's columns in multiples of 8 (S is padded at the
    kernel build) and q8 column-major, the layout cuBLAS's int8 product
    takes without a slower path: q8 is padded and laid out so unless it is
    already (as :func:`operand_buffers` makes it)."""
    m = q8.shape[1]
    if m % 8 or q8.stride(0) != 1:
        q8 = torch.nn.functional.pad(q8, (0, (-m) % 8)).t().contiguous().t()
    return torch._int_mm(k8, q8)[:, :m]


class LandmarkKernel:
    """One image's kernels at a bucket shape: the validity mask, the
    Gaussian's taps and row norms, the bilateral landmark kernel (None when
    streaming) and its row norms."""

    def __init__(self, img_u8: torch.Tensor, eh: int, ew: int, *,
                 stride: int = 4, sxy_gaussian: float = 3.0,
                 sxy_bilateral: float = 50.0, srgb_bilateral: float = 5.0,
                 matmul_dtype: str = "bfloat16", stream_kernel: bool = False,
                 kernel_store: str = "dense"):
        if kernel_store not in KERNEL_STORES:
            raise ValueError(f"kernel_store {kernel_store!r}")
        if stream_kernel and kernel_store == "int8":
            # streaming recomputes the kernel every iteration: there is no
            # stored kernel to quantize
            raise ValueError("stream_kernel and kernel_store='int8' exclude "
                             "each other")
        dev = img_u8.device
        h, w = img_u8.shape[:2]
        self.hw = (h, w)
        self.n = h * w
        self.stride = stride
        self.int8 = kernel_store == "int8"
        self.stream = stream_kernel
        self.mdt = getattr(torch, matmul_dtype)

        ys = torch.arange(h, device=dev)[:, None].expand(h, w)
        xs = torch.arange(w, device=dev)[None, :].expand(h, w)
        self.valid = valid = ((ys < eh) & (xs < ew)).float()

        # bilateral landmark kernel: K14 on the card, its twin on the CPU
        self.n_land = math.prod(landmark_grid(h, w, stride))
        if self.int8 and self.n_land * 127 * 127 >= 2 ** 31:
            raise ValueError(f"{self.n_land} landmarks overflow the int32 "
                             "accumulator of the int8 store")
        self.planes = img_u8.permute(2, 0, 1).contiguous()
        self.extent = (eh, ew)
        self.bilateral_hypers = dict(stride=stride, sxy=sxy_bilateral,
                                     srgb=srgb_bilateral,
                                     store=torch.int8 if self.int8
                                     else self.mdt)
        # only the stored kernel [N, S] and the f32 row sums stay (none of
        # the kernel when streaming)
        self.k_land, d_b = self.landmark_rows(sums_only=stream_kernel)
        self.nr_b = torch.rsqrt(d_b.clamp_min(1e-12)).reshape(h, w) * valid

        # gaussian separable kernel: its row sums are the blurred validity
        # mask (K17's blur on the card)
        self.taps = gaussian_taps(sxy_gaussian)
        d_g = blur(valid[None], self.taps)[0]
        self.nr_g = torch.rsqrt(d_g.clamp_min(1e-12)) * valid

    def landmark_rows(self, rows: Optional[Tuple[int, int]] = None,
                      sums_only: bool = False):
        """(stored kernel rows or None, their f32 row sums) for the pixel
        rows [r0, r1) (default all): :func:`landmark_rows`."""
        return landmark_rows(self.planes, *self.extent, rows=rows,
                             sums_only=sums_only, **self.bilateral_hypers)

    def operand(self, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed (operand, qscale) buffers of the product for ``cap``
        channels per map (:func:`operand_buffers`)."""
        return operand_buffers(self.n_land, cap,
                               self.bilateral_hypers["store"],
                               self.nr_b.device)

    def product(self, opnd: torch.Tensor) -> torch.Tensor:
        """K @ opnd: [N, 2 cp], int32 under int8, else f32 (the stream mode
        rebuilds the kernel in CHUNK_ROWS-row chunks)."""
        if self.stream:
            return torch.cat([
                product_f32(self.landmark_rows(
                    (a, min(a + CHUNK_ROWS, self.n)))[0], opnd)
                for a in range(0, self.n, CHUNK_ROWS)])
        if self.int8:
            return product_int8(self.k_land, opnd)
        return product_f32(self.k_land, opnd)

    def nbytes(self) -> int:
        """Bytes of the stored landmark kernel (0 when streaming)."""
        k = self.k_land
        return 0 if k is None else k.numel() * k.element_size()


def mean_field_pair(kern: LandmarkKernel, labels: torch.Tensor,
                    n_labels: int, gt_prob: float, *, n_label_cap: int = 21,
                    t: int = 10, compat_gaussian: float = 3.0,
                    compat_bilateral: float = 10.0) -> torch.Tensor:
    """t mean-field iterations for two label maps labels [2, H, W] uint8
    (ints in [0, n_labels)) over one kernel build; returns the argmax [2,
    H, W] uint8. Each iteration is a K17 quantize, the library product and
    a K17 combine (the twins on the CPU), after one K17 start."""
    cap = n_label_cap
    labels = labels.contiguous()
    lg, lo = unary_logs(gt_prob, n_labels)
    if t == 0:
        return start(labels, cap, n_labels, lg, lo, argmax=True)
    q = start(labels, cap, n_labels, lg, lo)
    q_next = torch.empty_like(q)
    out = torch.empty_like(labels)
    opnd, qscale = kern.operand(cap)
    for i in range(t):
        quantize(q, kern.nr_b, opnd, qscale, stride=kern.stride)
        combine(q, labels, kern.nr_g, kern.nr_b, kern.taps,
                kern.product(opnd), qscale if kern.int8 else None, n_labels,
                lg, lo, out if i == t - 1 else q_next,
                compat_gaussian=compat_gaussian,
                compat_bilateral=compat_bilateral)
        q, q_next = q_next, q
    return out


class LandmarkCRF:
    """Pads to shape buckets, runs the kernel build and the mean field on
    ``device``, crops: the counterpart of ``irn_tpu.ops.crf_tpu.
    LandmarkCRF`` and a drop-in for
    :func:`irn_tpu_torch.ops.crf.crf_inference_label_pair` (the hyper
    defaults match the reference call, imutils.py:156-166).

    Under ``kernel_store='int8'`` ``matmul_dtype`` is unused, as in the
    JAX class."""

    def __init__(self, stride: int = 4, t: int = 10, pad_multiple: int = 64,
                 n_label_cap: int = 21, matmul_dtype: str = "bfloat16",
                 stream_kernel: bool = False, kernel_store: str = "dense",
                 device="cuda"):
        if n_label_cap > 255:
            raise ValueError("labels ride uint8 planes: n_label_cap <= 255")
        self.stride = stride
        self.t = t
        self.pad_multiple = pad_multiple
        self.n_label_cap = n_label_cap
        self.matmul_dtype = matmul_dtype
        self.stream_kernel = stream_kernel
        self.kernel_store = kernel_store
        self.device = torch.device(device)

    def _bucket(self, h: int, w: int) -> Tuple[int, int]:
        m = self.pad_multiple
        return (-(-h // m) * m, -(-w // m) * m)

    def upload(self, img: np.ndarray, labels_a: np.ndarray,
               labels_b: np.ndarray) -> torch.Tensor:
        """The image and both label maps as one [5, ph, pw] uint8 upload at
        the bucket shape."""
        h, w = labels_a.shape
        for lab in (labels_a, labels_b):
            # a label >= n_label_cap would wrap in the uint8 pack
            if lab.max(initial=0) >= self.n_label_cap:
                raise ValueError(f"label {int(lab.max())} >= n_label_cap "
                                 f"{self.n_label_cap}")
        ph, pw = self._bucket(h, w)
        packed = np.zeros((5, ph, pw), np.uint8)
        packed[:3, :h, :w] = np.moveaxis(img, -1, 0)
        packed[3, :h, :w] = labels_a
        packed[4, :h, :w] = labels_b
        return torch.from_numpy(packed).to(self.device)

    def build(self, packed: torch.Tensor, h: int, w: int) -> LandmarkKernel:
        """The kernels of the upload's image, true extent (h, w)."""
        return LandmarkKernel(
            packed[:3].permute(1, 2, 0), h, w, stride=self.stride,
            matmul_dtype=self.matmul_dtype, stream_kernel=self.stream_kernel,
            kernel_store=self.kernel_store)

    def iterate(self, kern: LandmarkKernel, packed: torch.Tensor,
                n_labels: int, gt_prob: float) -> torch.Tensor:
        """The mean field over the upload's two label maps: [2, ph, pw]
        uint8 on the device."""
        return mean_field_pair(kern, packed[3:5], n_labels, gt_prob,
                               n_label_cap=self.n_label_cap, t=self.t)

    @torch.no_grad()
    def pair(self, img: np.ndarray, labels_a: np.ndarray,
             labels_b: np.ndarray, n_labels: int = 21, gt_prob: float = 0.7
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Refine two [h, w] label maps of one [h, w, 3] uint8 image;
        returns both refined maps (uint8)."""
        h, w = labels_a.shape
        packed = self.upload(img, labels_a, labels_b)
        kern = self.build(packed, h, w)
        out = self.iterate(kern, packed, n_labels, gt_prob).cpu().numpy()
        return out[0, :h, :w], out[1, :h, :w]

    def single(self, img, labels, n_labels: int = 21,
               gt_prob: float = 0.7) -> np.ndarray:
        a, _ = self.pair(img, labels, labels, n_labels, gt_prob)
        return a
