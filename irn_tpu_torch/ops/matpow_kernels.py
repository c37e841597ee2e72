"""Transition-power kernels: the counterparts of
:mod:`irn_tpu.ops.matpow_pallas`.

- :func:`pack_banded` (K1, ``csrc/pack_banded.cu``): T's in-band blocks
  into packed tiles [nb, (2kh+1)*bs, bs].
- :func:`square_banded` (K2, ``csrc/square_banded.cu``): T @ T over the
  band only, the same split product as K5 and K6 on band layouts (a split
  pass, :func:`split_banded`, then six bf16 products); out-of-band output
  is unspecified.
- :func:`packed_chain` (K3, ``csrc/packed_chain.cu``): x @ T^n over the
  packed tiles, one cooperative launch per chain over the tiles' nonzero
  rows (:func:`packed_chain_plan`).
- :func:`apply_banded` (K4, ``csrc/apply_banded.cu``): one x @ T over the
  in-band blocks only.
- :func:`square_dense` (K5, ``csrc/square_dense.cu``): dense T @ T, an
  f32-accurate split product on the tensor cores (a split pass,
  :func:`split_identity`, then K6's six bf16 products).
- :func:`square_fused_first` (K6, ``csrc/square_fused_first.cu``):
  A -> T @ T with T = colnorm(A^beta), the same split product (a split
  pass, :func:`split_operands`, then six bf16 products).
- :func:`banded_chain` (K7, ``csrc/banded_chain.cu``): x @ T^n with T
  masked to its band, K3's one cooperative launch per chain over the
  masked T's nonzeros, read straight from T.
- :func:`packed_chain_batched` (K8, ``csrc/packed_chain_batched.cu``): B
  images' packed chains, each with its own tiles, K3's chain body with a
  group of CTAs per image in one cooperative launch.

K3, K7 and K8 share one chain body (``csrc/packed_chain.cuh``) and one
launch plan (:func:`packed_chain_plan`).

:func:`apply_banded_chain` dispatches among K4, K1 + K3 and K7 as the JAX
function does; :func:`apply_banded_chain_batched` packs each image's T (K1)
and runs K8.

Each kernel has a plain PyTorch twin beside it (``*_plain``). A wrapper runs
the twin for CPU tensors and launches the kernel for CUDA tensors (or
raises); it never falls back from the card to the twin. The dense products
the JAX package leaves to XLA's dot outside any Pallas body (a band that
covers the matrix) are ``torch.matmul`` here (:func:`matmul`). Kernels take
f32 tensors.

``matmul_dtype`` (None or ``torch.bfloat16``, the JAX package's
``matmul_dtype``) picks the operand mode of K2, K4, K5 and K6 and of the
products outside them: None keeps f32 operands (K2, K5 and K6 to f32
accuracy through six bf16 products); bf16 rounds each operand value to
bf16 (nearest even) and accumulates in f32, so each product is exact and
only the summation order separates a kernel from its twin (K2, K5 and K6
run one bf16 product of the hi pieces, K4 rounds as it reads). The chains
K1 + K3, K7 and K8 have no bf16 mode yet: a bf16 chain of more than one
application that needs them raises :class:`NotImplementedError`
(:func:`check_chain_dtype`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from irn_tpu_torch.ops import _build


def pow_int(x: torch.Tensor, e: int) -> torch.Tensor:
    """x**e by binary exponentiation (static integer e >= 1) — the
    multiplication order of JAX's ``integer_pow``."""
    acc = None
    base = x
    while e:
        if e & 1:
            acc = base if acc is None else acc * base
        e >>= 1
        if e:
            base = base * base
    return acc


def normalize_transition(affinity: torch.Tensor, beta: int = 10) -> torch.Tensor:
    """A^beta, column-normalized (misc/indexing.py:132-137)."""
    scaled = pow_int(affinity, beta)
    return scaled / torch.sum(scaled, dim=0, keepdim=True)


# -- operand modes ------------------------------------------------------------

CHAIN_BF16_TODO = (
    "--rw_matmul_dtype bfloat16 on a banded chain of more than one "
    "application: the bf16 operand mode of K1 pack_banded + K3 packed_chain, "
    "K7 banded_chain and K8 packed_chain_batched is not ported yet (ROADMAP "
    "queue 1, item 13)")


def check_dtype(matmul_dtype) -> None:
    """``matmul_dtype`` is None (f32 operands) or ``torch.bfloat16``."""
    if matmul_dtype not in (None, torch.bfloat16):
        raise ValueError(f"matmul_dtype {matmul_dtype!r}: None or "
                         "torch.bfloat16")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to bf16 (nearest even), as f32 values."""
    return x.to(torch.bfloat16).float()


def operand(x: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """``x`` as a product at ``matmul_dtype`` takes it: as it is for f32
    operands, :func:`round_bf16` for bf16. An operand reused over several
    products is rounded once."""
    check_dtype(matmul_dtype)
    return x if matmul_dtype is None else round_bf16(x)


def matmul(a: torch.Tensor, b: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """``a @ b`` in f32 (``torch.matmul``, TF32 off as the stages pin it);
    with ``matmul_dtype`` bf16 both operands are rounded to bf16 first, so
    each product is exact and the result stays f32: the JAX package's dot
    of bf16 operands with ``preferred_element_type`` f32, which it runs
    outside its Pallas kernels. (``torch.matmul`` of two bf16 tensors would
    return bf16.)"""
    return torch.matmul(operand(a, matmul_dtype), operand(b, matmul_dtype))


def _parts(matmul_dtype) -> int:
    """bf16 pieces per operand value in the split kernels: 3 (hi, mid, lo:
    six products, f32 accuracy) or 1 (hi: one product, bf16 operands)."""
    check_dtype(matmul_dtype)
    return 3 if matmul_dtype is None else 1


def _passes(matmul_dtype) -> int:
    """The split kernels' pass count: 6 products per k step, or 1."""
    return 6 if _parts(matmul_dtype) == 3 else 1


def split_products(n_pieces: int):
    """(left piece, right piece) of the products over ``n_pieces`` split
    pieces (both operands'): :data:`SPLIT_PRODUCTS` over 6, hi.hi over 2."""
    if n_pieces == 6:
        return SPLIT_PRODUCTS
    if n_pieces == 2:
        return ((0, 0),)
    raise ValueError(f"split pieces {n_pieces}: 6 or 2")


def chain_covers(n: int, h: int, bs: int, bj: int) -> bool:
    """Whether :func:`apply_banded_chain`'s band covers the matrix (its
    dense path, T masked to the band)."""
    nkb, kh = _blocks(n, h, bs)
    return bj // bs + 2 * kh >= nkb


def check_chain_dtype(n: int, h: int, n_apply: int, bs: int, bj: int,
                      matmul_dtype) -> None:
    """Raises :class:`NotImplementedError` (:data:`CHAIN_BF16_TODO`) where
    :func:`apply_banded_chain` at ``matmul_dtype`` bf16 would run a chain
    without a bf16 mode: more than one application with the band under the
    matrix (K1 + K3, or K7)."""
    check_dtype(matmul_dtype)
    if (matmul_dtype is not None and n_apply > 1
            and not chain_covers(n, h, bs, bj)):
        raise NotImplementedError(CHAIN_BF16_TODO)


def _blocks(n: int, h: int, bs: int):
    if n % bs:
        raise ValueError(f"{n} not divisible by block {bs}")
    return n // bs, -(-h // bs)


# -- K1 ---------------------------------------------------------------------

def pack_banded_plain(t: torch.Tensor, h: int, bs: int = 512) -> torch.Tensor:
    """Tile j = rows [j*bs - kh*bs, j*bs + (kh+1)*bs) of column block j of
    the zero-row-padded T (the literal slices the Pallas pack produces)."""
    n = t.shape[0]
    nb, kh = _blocks(n, h, bs)
    span = (2 * kh + 1) * bs
    tpad = F.pad(t, (0, 0, kh * bs, kh * bs))
    return torch.stack(
        [tpad[j * bs : j * bs + span, j * bs : (j + 1) * bs]
         for j in range(nb)]
    )


def pack_banded(t: torch.Tensor, h: int, bs: int = 512) -> torch.Tensor:
    """[nb, (2kh+1)*bs, bs] band tiles of T (K1). Bit-equal to the twin."""
    n = t.shape[0]
    if t.shape != (n, n):
        raise ValueError(f"pack_banded: square matrix expected, got {t.shape}")
    if _build.is_plain(t):
        return pack_banded_plain(t, h, bs)
    nb, kh = _blocks(n, h, bs)
    if bs % 4 or n % 4:
        raise ValueError(f"pack_banded: n={n}, bs={bs} must be multiples of 4")
    _build.check_cuda("pack_banded", t)
    out = torch.empty((nb, (2 * kh + 1) * bs, bs), dtype=t.dtype,
                      device=t.device)
    _build.launch("pack_banded", t.device,
                  t.data_ptr(), out.data_ptr(), n, bs, kh)
    return out


# -- K2 ---------------------------------------------------------------------

def _square_bands(n: int, h: int, bs: int):
    """(nb, kb, jb, covers): block counts of the input band (kb) and the
    output band (jb), and whether the band covers the matrix — then the
    squaring is a dense product, as the TPU path falls back to XLA's dot
    (matpow_pallas.square_banded)."""
    nb, kb = _blocks(n, h, bs)
    jb = -(-2 * h // bs)
    return nb, kb, jb, 2 * kb + 1 >= nb or 2 * jb + 1 >= nb


def square_banded_plain(t: torch.Tensor, h: int, bs: int = 512,
                        matmul_dtype=None) -> torch.Tensor:
    """Block loop over the in-band output blocks, each contracting only the
    blocks inside both operands' bands (:func:`matmul` at
    ``matmul_dtype``); out-of-band blocks are zero here (the kernel leaves
    them unspecified)."""
    nb, kb, jb, covers = _square_bands(t.shape[0], h, bs)
    if covers:
        return matmul(t, t, matmul_dtype)
    out = torch.zeros_like(t)
    for i in range(nb):
        for j in range(max(0, i - jb), min(nb, i + jb + 1)):
            klo = max(max(i, j) - kb, 0)
            khi = min(min(i, j) + kb, nb - 1)
            if klo > khi:
                continue
            out[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = matmul(
                t[i * bs : (i + 1) * bs, klo * bs : (khi + 1) * bs],
                t[klo * bs : (khi + 1) * bs, j * bs : (j + 1) * bs],
                matmul_dtype)
    return out


def split_banded_plain(t: torch.Tensor, h: int, bs: int = 512,
                       matmul_dtype=None) -> torch.Tensor:
    """K2's split pass, plain: [2P, n, W] bf16 with W = (2kb+1)*bs, the
    :func:`split_parts_plain` pieces of T's in-band blocks in band layouts
    (P = 3, hi, mid and lo, for f32 operands; P = 1, hi, for bf16). L's
    pieces: row r of block row i holds T[r, (i - kb)*bs + w] at w (K-major
    for the A operand); then Rt's: row c of block column j holds
    T[(j - kb)*bs + w, c] at w (T's column bands transposed, K-major for
    B). Positions whose block lies past the matrix edge are zeros; no block
    outside the band is read."""
    n = t.shape[0]
    nb, kb = _blocks(n, h, bs)
    w = (2 * kb + 1) * bs
    parts = _parts(matmul_dtype)
    pieces = torch.zeros((2 * parts, n, w), dtype=torch.bfloat16,
                         device=t.device)
    for i in range(nb):
        for d in range(2 * kb + 1):
            k = i + d - kb
            if not 0 <= k < nb:
                continue
            blk = torch.stack(split_parts_plain(
                t[i * bs : (i + 1) * bs, k * bs : (k + 1) * bs], parts))
            pieces[:parts, i * bs : (i + 1) * bs, d * bs : (d + 1) * bs] = blk
            e = 2 * kb - d  # block row i is offset e of column band k
            pieces[parts:, k * bs : (k + 1) * bs, e * bs : (e + 1) * bs] = \
                blk.transpose(1, 2)
    return pieces


def split_banded(t: torch.Tensor, h: int, bs: int = 512,
                 matmul_dtype=None) -> torch.Tensor:
    """K2's split pass alone (its first launch, counted under
    ``square_banded``); bit-equal to :func:`split_banded_plain`. ``t``:
    [n, n] f32, bs a multiple of 128, n of bs."""
    n = t.shape[0]
    if t.shape != (n, n):
        raise ValueError(f"split_banded: square matrix expected, got {t.shape}")
    if _build.is_plain(t):
        return split_banded_plain(t, h, bs, matmul_dtype)
    _build.check_cuda("square_banded", t)
    _, kb = _blocks(n, h, bs)
    if bs % 128:
        raise ValueError(f"split_banded: bs={bs} must be a multiple of 128")
    pieces = torch.empty((2 * _parts(matmul_dtype), n, (2 * kb + 1) * bs),
                         dtype=torch.bfloat16, device=t.device)
    _build.launch("square_banded", t.device, t.data_ptr(), pieces.data_ptr(),
                  n, bs, kb, _passes(matmul_dtype),
                  entry="square_banded_split")
    return pieces


def square_banded_split_plain(t: torch.Tensor, h: int, bs: int = 512,
                              matmul_dtype=None) -> torch.Tensor:
    """What K2's product computes, plain: each in-band output block sums
    the products (:func:`split_products`) of :func:`split_banded_plain`'s
    pieces over its own k range, in f64 (exact for the bf16 products),
    returned as f32; out-of-band blocks are zero. K2 differs only in the
    order of its f32 sums. A band that covers the matrix is
    :func:`matmul`, as the kernel's wrapper."""
    n = t.shape[0]
    nb, kb, jb, covers = _square_bands(n, h, bs)
    if covers:
        return matmul(t, t, matmul_dtype)
    pieces = split_banded_plain(t, h, bs, matmul_dtype).double()
    parts = pieces.shape[0] // 2
    out = torch.zeros_like(t)
    for i in range(nb):
        for j in range(max(0, i - jb), min(nb, i + jb + 1)):
            klo = max(max(i, j) - kb, 0)
            khi = min(min(i, j) + kb, nb - 1)
            a = pieces[:parts, i * bs : (i + 1) * bs,
                       (klo - i + kb) * bs : (khi - i + kb + 1) * bs]
            b = pieces[parts:, j * bs : (j + 1) * bs,
                       (klo - j + kb) * bs : (khi - j + kb + 1) * bs]
            acc = sum(a[p] @ b[q].t()
                      for p, q in split_products(2 * parts))
            out[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = acc.float()
    return out


def square_banded(t: torch.Tensor, h: int, bs: int = 512,
                  matmul_dtype=None) -> torch.Tensor:
    """T @ T for T banded with halfwidth ``h`` (K2) on the tensor cores:
    the split pass writes the bf16 pieces of T's in-band blocks in band
    layouts (:func:`split_banded`), then K6's product sums the piece
    products over each in-band output block's k range: six to f32 accuracy
    (``matmul_dtype`` None), or one of the hi pieces (bf16: T rounded once
    to bf16, f32 accumulation). Two launches. Only blocks within the 2h
    output band are written; the rest is unspecified, so read the result
    through :func:`pack_banded` only. Blocks of ``t`` outside its own band
    are never read. A band that covers the matrix is :func:`matmul`, as the
    JAX function falls back to XLA's dot. On the card bs is a multiple of
    128; scratch 12 n (2kb+1) bs bytes (4 n (2kb+1) bs in bf16)."""
    n = t.shape[0]
    if t.shape != (n, n):
        raise ValueError(f"square_banded: square matrix expected, got {t.shape}")
    check_dtype(matmul_dtype)
    if _build.is_plain(t):
        return square_banded_plain(t, h, bs, matmul_dtype)
    _build.check_cuda("square_banded", t)
    _, kb, jb, covers = _square_bands(n, h, bs)
    if covers:
        return matmul(t, t, matmul_dtype)
    if bs % 128:
        raise ValueError(f"square_banded: bs={bs} must be a multiple of 128")
    pieces = torch.empty((2 * _parts(matmul_dtype), n, (2 * kb + 1) * bs),
                         dtype=torch.bfloat16, device=t.device)
    out = torch.empty_like(t)
    _build.launch("square_banded", t.device, t.data_ptr(), pieces.data_ptr(),
                  out.data_ptr(), n, bs, kb, jb, _passes(matmul_dtype))
    return out


# -- K3 ---------------------------------------------------------------------

def packed_chain_plain(x: torch.Tensor, tp: torch.Tensor, n_apply: int,
                       bs: int = 512) -> torch.Tensor:
    """``_apply_chain_xla``'s windowed einsum: window j of the kh*bs-padded
    seed rows contracts against packed tile j, ``n_apply`` times."""
    c, n = x.shape
    nb, span = tp.shape[0], tp.shape[1]
    pad = (span // bs - 1) // 2 * bs
    out = x
    for _ in range(n_apply):
        wins = F.pad(out, (pad, pad)).unfold(1, span, bs)  # [c, nb, span]
        res = torch.bmm(wins.transpose(0, 1), tp)           # [nb, c, bs]
        out = res.transpose(0, 1).reshape(c, n)
    return out


# The launch plan of K3, K7 and K8 (csrc/packed_chain.cuh's chain body): one
# cooperative launch, one CTA per SM; an item is one (tile, 32-column strip),
# read by one warp per quarter of each slot from its nonzero entries in ELL
# form; K8 gives each image its own group of CTAs.
PACKED_STRIP = 32  # columns per item
PACKED_ROWS = 8  # seed rows per group
PACKED_PREFETCH = 4  # float4 of x each thread prefetches
PACKED_MAX_THREADS = 512
PACKED_ENTRY_BYTES = 6 * PACKED_STRIP  # one entry: 32 f32 values, 32 rows
PACKED_SMEM_MAX = 232448  # dynamic shared memory one CTA may use (bytes)

# (CTAs, items per CTA, threads per CTA, x blocks staged per slot, held
# entry slots per CTA, shared-memory bytes per CTA); the CTAs are those of
# one launch, a whole number of images' groups (:func:`packed_chain_images`)
PackedChainPlan = Tuple[int, int, int, int, int, int]


def _packed_smem(bs: int, kh: int, ipc: int, x_blocks: int,
                 slots: int) -> int:
    """Bytes of the chain's shared memory per CTA: the staged x blocks, the
    quarters' and slots' partial sums, each item's quarter-slot table (first
    entry, length) and counts, and the held entries."""
    nqs = 4 * (2 * kh + 1)
    return (4 * x_blocks * PACKED_ROWS * bs
            + ipc * 5 * 4 * PACKED_ROWS * PACKED_STRIP
            + 8 * ipc * nqs + 32 * ipc + PACKED_ENTRY_BYTES * slots)


def _packed_items(n: int, bs: int) -> int:
    return n // bs * (bs // PACKED_STRIP)


def _group_plan(n: int, bs: int, kh: int, sms: int, images: int,
                smem_max: int):
    """(plan, threads, fixed bytes) for ``images`` images in one launch,
    each on sms // images CTAs; plan None if it does not fit."""
    strips = bs // PACKED_STRIP
    items = _packed_items(n, bs)
    per = sms // images
    if per < 1:
        return None, None, None
    ipc = -(-items // per)
    cpi = -(-items // ipc)
    x_blocks = max((min(b * ipc + ipc, items) - 1) // strips
                   - b * ipc // strips + 1 for b in range(cpi))
    total4 = x_blocks * PACKED_ROWS * bs // 4
    threads = 128 * max(min(ipc, PACKED_MAX_THREADS // 128),
                         -(-total4 // (PACKED_PREFETCH * 128)))
    fixed = _packed_smem(bs, kh, ipc, x_blocks, 0)
    if threads > PACKED_MAX_THREADS or fixed > smem_max:
        return None, threads, fixed
    slots = (smem_max - fixed) // PACKED_ENTRY_BYTES
    return ((images * cpi, ipc, threads, x_blocks, slots,
             fixed + PACKED_ENTRY_BYTES * slots), threads, fixed)


def packed_chain_plan(n: int, bs: int, kh: int, sms: int, images: int = 1,
                      smem_max: int = PACKED_SMEM_MAX) -> PackedChainPlan:
    """The chain's launch plan over ``images`` images of n columns, tiles
    of bs with 2kh+1 slots, on a card of ``sms`` SMs. Each image of a
    launch gets sms // images CTAs; its nb * bs/32 items are dealt in whole
    runs of ceil(items / CTAs) to as few CTAs as that needs (so no CTA waits
    on a second wave: the launch is cooperative, and no CTA's items cross an
    image); one warp per quarter of up to 4 items at a time, and enough
    threads to prefetch a slot's x blocks (512 at most, 128 registers each);
    every byte of shared memory left after the fixed parts
    (:func:`_packed_smem`) to held entries. At images 1 this is K3's plan.
    When the images do not fit one launch, the plan is that of the fewest
    launches of equal image groups that fit (:func:`packed_chain_groups`).
    Raises ValueError, with the limit, when one image does not fit."""
    if bs < 64 or bs % 64 or n < bs or n % bs or kh < 0 or sms < 1:
        raise ValueError(f"packed_chain: n={n} must be a positive multiple "
                         f"of bs={bs}, bs a multiple of 64")
    if images < 1:
        raise ValueError(f"packed_chain: images={images} must be >= 1")
    tried = set()
    for launches in range(1, images + 1):
        group = -(-images // launches)
        if group in tried:
            continue
        tried.add(group)
        plan, threads, fixed = _group_plan(n, bs, kh, sms, group, smem_max)
        if plan is not None:
            return plan
    raise ValueError(
        f"packed_chain: n={n}, bs={bs}, kh={kh} on {sms} SMs needs "
        f"{threads} threads and {fixed} bytes of shared memory per CTA "
        f"before any held entry, over the {PACKED_MAX_THREADS} and "
        f"{smem_max} a CTA may use")


def packed_chain_images(plan: PackedChainPlan, n: int, bs: int) -> int:
    """Images per launch of ``plan``: its CTAs over each image's."""
    return plan[0] // -(-_packed_items(n, bs) // plan[1])


def packed_chain_groups(images: int, plan: PackedChainPlan, n: int,
                        bs: int) -> list:
    """(first image, images) of each launch that runs ``images`` images
    under ``plan``: consecutive groups of :func:`packed_chain_images`, the
    last one the rest."""
    group = packed_chain_images(plan, n, bs)
    return [(b, min(group, images - b)) for b in range(0, images, group)]


def packed_occupancy_plain(tp: torch.Tensor) -> torch.Tensor:
    """[nb, bs/32, span] bool: whether row s of tile j's 32-column strip
    holds a nonzero (NaN counts)."""
    nb, span, bs = tp.shape
    return (tp.reshape(nb, span, bs // PACKED_STRIP, PACKED_STRIP) != 0
            ).any(-1).transpose(1, 2)


def packed_ell_plain(tp: torch.Tensor) -> torch.Tensor:
    """[nb, bs/32, 2kh+1, 4] int: K3's ELL length of each item's
    quarter-slots, the most nonzeros (NaN counts) any of the strip's 32
    columns holds over the slot's quarter of rows."""
    nb, span, bs = tp.shape
    nslot = span // bs
    nz = (tp != 0).reshape(nb, nslot, 4, bs // 4, bs // PACKED_STRIP,
                           PACKED_STRIP)
    return nz.sum(3).amax(-1).permute(0, 3, 1, 2)


def packed_chain_held_plain(entries, plan: PackedChainPlan) -> list:
    """Held entries per item under ``plan``, from each item's ELL entry
    count (items in order: tile, then strip), as K3's prologue shares a
    CTA's entry slots: item i of ipc holds min(entries, left // (ipc - i))."""
    ctas, ipc, _, _, slots, _ = plan
    entries = [int(v) for v in entries]
    held = []
    for b in range(ctas):
        left = slots
        for i in range(ipc):
            if b * ipc + i >= len(entries):
                break
            h = min(entries[b * ipc + i], left // (ipc - i))
            held.append(h)
            left -= h
    return held


def packed_chain_occupancy(device: torch.device, threads: int,
                           smem: int) -> Tuple[int, int]:
    """(CTAs of K3 one SM holds at ``threads`` threads and ``smem`` bytes,
    the card's SM count); launches nothing."""
    bps, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        status = _build.load().irn_packed_chain_occupancy(
            threads, smem, ctypes.byref(bps), ctypes.byref(sms))
    if status != 0:
        raise RuntimeError(f"packed_chain: occupancy query failed with "
                           f"cudaError {status}")
    return bps.value, sms.value


@functools.lru_cache(maxsize=None)
def card_packed_chain_plan(device: torch.device, n: int, bs: int, kh: int,
                           images: int = 1) -> PackedChainPlan:
    """:func:`packed_chain_plan` for ``images`` images on the card's own SM
    count, checked to fit one CTA per SM (cached per device and shape). K3,
    K7 and K8 run one body under one ``__launch_bounds__``, so K3's
    occupancy answers for all three."""
    _, sms = packed_chain_occupancy(device, 128, 0)
    plan = packed_chain_plan(n, bs, kh, sms, images)
    held, _ = packed_chain_occupancy(device, plan[2], plan[5])
    if held < 1:
        raise RuntimeError(f"packed_chain: the card holds no CTA of plan "
                           f"{plan}")
    return plan


def _chain_buffers(x: torch.Tensor, span: int, bs: int, ctas: int,
                   launches: int = 1, held_images: int = 1):
    """What the chain launches over x ([C, n], or [B, C, n] for B images)
    need beside their inputs: out and the ping-pong scratch like x, a zeroed
    barrier counter per launch, stats [images, items, 3] int32, timing
    [ctas, 5] int64, and the scratch for the entries not held of
    ``held_images`` images at a time, ell_val / ell_row [held_images,
    items, span, 32] f32 / int16 (6 bytes per tile entry: 1.5x the tiles)."""
    n = x.shape[-1]
    items = _packed_items(n, bs)
    images = x.shape[0] if x.dim() == 3 else 1
    dev = x.device
    ell = (held_images, items, span, PACKED_STRIP)
    return (torch.empty_like(x), torch.empty_like(x),
            torch.zeros(launches, dtype=torch.int32, device=dev),
            torch.zeros((images, items, 3), dtype=torch.int32, device=dev),
            torch.zeros((ctas, 5), dtype=torch.int64, device=dev),
            torch.empty(ell, dtype=torch.float32, device=dev),
            torch.empty(ell, dtype=torch.int16, device=dev))


def launch_packed_chain(x: torch.Tensor, tp: torch.Tensor, n_apply: int,
                        bs: int, plan: PackedChainPlan):
    """K3's one cooperative launch under ``plan``, for CUDA tensors that
    :func:`packed_chain` has checked. Returns (out, stats, timing): stats
    [items, 3] int32 holds each item's occupied 32-column row segments, ELL
    entries and held entries; timing [CTAs, 5] int64 the clock cycles each
    CTA spent in the prologue, the grid barriers, the x waits, the products
    and the sums. The entries not held go to a scratch the size of the
    tiles (plus half for their rows)."""
    c, n = x.shape
    kh = (tp.shape[1] // bs - 1) // 2
    ctas, ipc, threads, x_blocks, slots, smem = plan
    out, scratch, counter, stats, timing, ell_val, ell_row = _chain_buffers(
        x, tp.shape[1], bs, ctas)
    _build.launch("packed_chain", x.device,
                  x.data_ptr(), tp.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), counter.data_ptr(), stats.data_ptr(),
                  timing.data_ptr(), ell_val.data_ptr(), ell_row.data_ptr(),
                  c, n, bs, kh, n_apply, ctas, ipc, threads, x_blocks,
                  slots, smem)
    return out, stats[0], timing


def packed_chain(x: torch.Tensor, tp: torch.Tensor, n_apply: int,
                 bs: int = 512) -> torch.Tensor:
    """x @ T^n_apply over K1's packed tiles (K3): one cooperative launch
    per chain that reads only the tiles' nonzero rows, bit-equal to K8 on
    each image. ``x``: [C, n] f32; on the card bs a multiple of 64, within
    :func:`packed_chain_plan`'s limit."""
    c, n = x.shape
    if tp.dim() != 3 or tp.shape[0] * bs != n or tp.shape[2] != bs \
            or tp.shape[1] % bs or (tp.shape[1] // bs) % 2 == 0:
        raise ValueError(f"packed_chain: tiles {tuple(tp.shape)} vs x {x.shape}")
    if n_apply < 1:
        raise ValueError(f"packed_chain: n_apply={n_apply} must be >= 1")
    if _build.is_plain(x):
        return packed_chain_plain(x, tp, n_apply, bs)
    _build.check_cuda("packed_chain", x, tp)
    if bs % 64 or bs > 1536:
        raise ValueError(f"packed_chain: bs={bs} must be a multiple of 64, <= 1536")
    kh = (tp.shape[1] // bs - 1) // 2
    plan = card_packed_chain_plan(x.device, n, bs, kh)
    return launch_packed_chain(x, tp, n_apply, bs, plan)[0]


# -- K4 ---------------------------------------------------------------------

def apply_banded_plain(x: torch.Tensor, t: torch.Tensor, h: int,
                       bs: int = 512, matmul_dtype=None) -> torch.Tensor:
    """Column block j contracts the row blocks [j - kb, j + kb] in range
    (:func:`matmul` each, at ``matmul_dtype``); a band that covers the
    matrix is a full product, as the TPU path's dot."""
    n = t.shape[0]
    nb, kb = _blocks(n, h, bs)
    if 2 * kb + 1 >= nb:
        return matmul(x, t, matmul_dtype)
    out = torch.empty_like(x)
    for j in range(nb):
        lo, hi = max(j - kb, 0) * bs, (min(j + kb, nb - 1) + 1) * bs
        out[:, j * bs : (j + 1) * bs] = matmul(
            x[:, lo:hi], t[lo:hi, j * bs : (j + 1) * bs], matmul_dtype)
    return out


def apply_banded(x: torch.Tensor, t: torch.Tensor, h: int,
                 bs: int = 512, matmul_dtype=None) -> torch.Tensor:
    """x @ T for a banded T (halfwidth ``h``), reading only the in-band
    bs x bs blocks (K4): the rest may hold :func:`square_banded`'s
    unspecified fill. ``matmul_dtype`` bf16 rounds x and T to bf16 as K4
    reads them (f32 sums, f32 output). ``x``: [C, n] with C a multiple of
    8. When the band covers the matrix this is a full product,
    :func:`matmul` (valid only for a T that is zero out of band, as in the
    JAX package)."""
    c, n = x.shape
    if t.shape != (n, n) or n % bs or c % 8:
        raise ValueError(f"apply_banded: x {tuple(x.shape)} t "
                         f"{tuple(t.shape)} bs {bs}")
    check_dtype(matmul_dtype)
    if _build.is_plain(x):
        return apply_banded_plain(x, t, h, bs, matmul_dtype)
    _build.check_cuda("apply_banded", x, t)
    nb, kb = _blocks(n, h, bs)
    if 2 * kb + 1 >= nb:
        return matmul(x, t, matmul_dtype)
    if bs % 32:
        raise ValueError(f"apply_banded: bs={bs} must be a multiple of 32")
    out = torch.empty_like(x)
    _build.launch("apply_banded", x.device,
                  x.data_ptr(), t.data_ptr(), out.data_ptr(), c, n, bs, kb,
                  int(matmul_dtype is not None))
    return out


# -- K5 ---------------------------------------------------------------------

def square_dense_plain(t: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """:func:`matmul` (t, t) at ``matmul_dtype`` (f32 with TF32 off)."""
    return matmul(t, t, matmul_dtype)


def split_identity_plain(t: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """K5's split pass, plain: [2P, n, n] bf16, the :func:`split_parts_plain`
    pieces of T (hi, mid, lo for f32 operands, P = 3; hi for bf16, P = 1;
    as [i][k]) and the same pieces stored transposed ([j][k]), so both
    operands are K-major for the product: :func:`split_operands_plain` at
    beta 1 with inv all ones, since x * 1.0 is exact."""
    pieces = split_parts_plain(t, _parts(matmul_dtype))
    return torch.stack([*pieces, *(p.t() for p in pieces)]).contiguous()


def split_identity(t: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """K5's split pass alone (its first launch, counted under
    ``square_dense``); bit-equal to :func:`split_identity_plain`. ``t``:
    [n, n] f32, n a multiple of 128."""
    n = t.shape[0]
    if t.shape != (n, n):
        raise ValueError(f"split_identity: square matrix expected, got {t.shape}")
    if _build.is_plain(t):
        return split_identity_plain(t, matmul_dtype)
    _build.check_cuda("square_dense", t)
    if n % 128:
        raise ValueError(f"split_identity: n={n} must be a multiple of 128")
    pieces = torch.empty((2 * _parts(matmul_dtype), n, n),
                         dtype=torch.bfloat16, device=t.device)
    _build.launch("square_dense", t.device, t.data_ptr(), pieces.data_ptr(),
                  n, _passes(matmul_dtype), entry="square_dense_split")
    return pieces


def square_dense(t: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """Dense T @ T on the tensor cores (K5): the split pass writes the bf16
    pieces of T and of T transposed (:func:`split_identity`), then K6's
    product sums the piece products in f32: the six of
    :data:`SPLIT_PRODUCTS` to f32 accuracy (``matmul_dtype`` None), or
    hi.hi alone (bf16: T rounded once to bf16, as ``square_pallas`` rounds
    it). Two launches. ``t``: [n, n] f32, n a multiple of 128 (the
    product's tile; the walk pads n to 512); scratch 12 n^2 bytes (4 n^2 in
    bf16)."""
    n = t.shape[0]
    if t.shape != (n, n):
        raise ValueError(f"square_dense: square matrix expected, got {t.shape}")
    check_dtype(matmul_dtype)
    if _build.is_plain(t):
        return square_dense_plain(t, matmul_dtype)
    _build.check_cuda("square_dense", t)
    if n % 128:
        raise ValueError(f"square_dense: n={n} must be a multiple of 128")
    pieces = torch.empty((2 * _parts(matmul_dtype), n, n),
                         dtype=torch.bfloat16, device=t.device)
    out = torch.empty_like(t)
    _build.launch("square_dense", t.device, t.data_ptr(), pieces.data_ptr(),
                  out.data_ptr(), n, _passes(matmul_dtype))
    return out


# -- K6 ---------------------------------------------------------------------

# (left piece, right piece) of the six products K6 keeps, as the TPU's
# Precision.HIGHEST: hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid (0 hi,
# 1 mid, 2 lo); the three dropped ones are about 2^-24 of each product.
SPLIT_PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def split3_plain(x: torch.Tensor):
    """f32 ``x`` as three bf16 pieces, hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid), each rounded to nearest even: together they
    carry x's 24 bits (hi + mid + lo == x exactly while lo's bits stay above
    bf16's subnormal spacing, 2^-133, which |x| >= 2^-100 ensures, and |x|
    stays below bf16's largest finite value, about 3.39e38)."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def split_parts_plain(x: torch.Tensor, parts: int):
    """f32 ``x`` as its first ``parts`` bf16 pieces: (hi, mid, lo) of
    :func:`split3_plain` at 3, (hi,) = bf16(x) at 1 (the bf16 operand
    mode: JAX's ``astype(bfloat16)``)."""
    if parts == 3:
        return split3_plain(x)
    if parts == 1:
        return (x.to(torch.bfloat16),)
    raise ValueError(f"split parts {parts}: 3 or 1")


def fused_operands(a: torch.Tensor, inv: torch.Tensor, beta: int = 10):
    """K6's f32 operands before they are split: L = A^beta and
    R[k, j] = A^beta[k, j] * inv[k] * inv[j], in that multiply order (the
    JAX kernel's order, matpow_pallas._fused_kernel)."""
    b = pow_int(a, beta)
    return b, b * inv[:, None] * inv[None, :]


def split_operands_plain(a: torch.Tensor, inv: torch.Tensor,
                         beta: int = 10, matmul_dtype=None) -> torch.Tensor:
    """K6's split pass, plain: [2P, n, n] bf16 pieces (P = 3 for f32
    operands, 1 for bf16: :func:`split_parts_plain`) of the left operand
    L (as [i][k]) and of the right operand R (stored transposed, [j][k]) of
    :func:`fused_operands`, so both are K-major for the product; each value
    is split after its f32 pow and scale."""
    parts = _parts(matmul_dtype)
    b, r = fused_operands(a, inv, beta)
    return torch.stack([*split_parts_plain(b, parts),
                        *(p.t() for p in split_parts_plain(r, parts))]
                       ).contiguous()


def split_operands(a: torch.Tensor, inv: torch.Tensor,
                   beta: int = 10, matmul_dtype=None) -> torch.Tensor:
    """K6's split pass alone (its first launch, counted under
    ``square_fused_first``); bit-equal to :func:`split_operands_plain`.
    ``a``: [n, n] f32, ``inv``: [n] f32, n a multiple of 128."""
    n = a.shape[0]
    if a.shape != (n, n) or inv.shape != (n,) or beta < 1:
        raise ValueError(f"split_operands: a {tuple(a.shape)} inv "
                         f"{tuple(inv.shape)} beta {beta}")
    if _build.is_plain(a):
        return split_operands_plain(a, inv, beta, matmul_dtype)
    _build.check_cuda("square_fused_first", a, inv)
    if n % 128:
        raise ValueError(f"split_operands: n={n} must be a multiple of 128")
    pieces = torch.empty((2 * _parts(matmul_dtype), n, n),
                         dtype=torch.bfloat16, device=a.device)
    _build.launch("square_fused_first", a.device, a.data_ptr(),
                  inv.data_ptr(), pieces.data_ptr(), n, beta,
                  _passes(matmul_dtype), entry="square_fused_first_split")
    return pieces


def split_product_plain(pieces: torch.Tensor) -> torch.Tensor:
    """The sum of the products (:func:`split_products`: six over [6, n, n]
    pieces, one over [2, n, n]) over split pieces (:func:`split_operands`'
    for K6, :func:`split_identity`'s for K5), each in f64 (exact for the
    bf16 products; the sums round once per add), returned as f32: what the
    K5/K6 product computes, up to the order of its f32 sums."""
    parts = pieces.shape[0] // 2
    lt, rt = pieces[:parts].double(), pieces[parts:].double()
    out = torch.zeros(pieces.shape[1:], dtype=torch.float64,
                      device=pieces.device)
    for p, q in split_products(pieces.shape[0]):
        out += lt[p] @ rt[q].t()
    return out.float()


def fused_inv(a: torch.Tensor, beta: int = 10) -> torch.Tensor:
    """1 / colsum(A^beta): K6's column scale, computed outside the kernel
    as the JAX function computes it with XLA."""
    return 1.0 / torch.sum(pow_int(a, beta), dim=0)


def square_fused_first_plain(a: torch.Tensor, beta: int = 10,
                             matmul_dtype=None) -> torch.Tensor:
    """f32 operands: :func:`normalize_transition`, then
    ``torch.matmul(t, t)``. bf16: :func:`matmul` of K6's own operands
    (:func:`fused_operands` with :func:`fused_inv`), each rounded to bf16
    after its f32 pow and scale as the JAX kernel rounds them."""
    check_dtype(matmul_dtype)
    if matmul_dtype is None:
        t = normalize_transition(a, beta)
        return torch.matmul(t, t)
    return matmul(*fused_operands(a, fused_inv(a, beta), beta), matmul_dtype)


def square_fused_first(a: torch.Tensor, beta: int = 10,
                       matmul_dtype=None) -> torch.Tensor:
    """T @ T with T = colnorm(A^beta) (K6): the split pass writes the bf16
    pieces of L = A^beta and of R = A^beta * inv[k] * inv[j], with
    inv = 1 / colsum(A^beta) computed here, and the product sums the piece
    products on the tensor cores in f32: the six of :data:`SPLIT_PRODUCTS`
    to f32 accuracy (``matmul_dtype`` None), or hi.hi alone (bf16: L and R
    each rounded once to bf16). Two launches. ``a``: [n, n] f32, n a
    multiple of 128 (the product's tile; the walk pads n to 512); scratch
    12 n^2 bytes (4 n^2 in bf16)."""
    n = a.shape[0]
    if a.shape != (n, n) or beta < 1:
        raise ValueError(f"square_fused_first: a {tuple(a.shape)} beta {beta}")
    check_dtype(matmul_dtype)
    if _build.is_plain(a):
        return square_fused_first_plain(a, beta, matmul_dtype)
    _build.check_cuda("square_fused_first", a)
    if n % 128:
        raise ValueError(f"square_fused_first: n={n} must be a multiple of 128")
    inv = fused_inv(a, beta)
    pieces = torch.empty((2 * _parts(matmul_dtype), n, n),
                         dtype=torch.bfloat16, device=a.device)
    out = torch.empty_like(a)
    _build.launch("square_fused_first", a.device,
                  a.data_ptr(), inv.data_ptr(), pieces.data_ptr(),
                  out.data_ptr(), n, beta, _passes(matmul_dtype))
    return out


# -- K7 ---------------------------------------------------------------------

def banded_chain_plain(x: torch.Tensor, t: torch.Tensor, h: int,
                       n_apply: int, matmul_dtype=None) -> torch.Tensor:
    """K7's twin: T with every element of |r - c| > h replaced by 0 (a
    select, so a NaN out of band does not leak), then ``n_apply`` dense
    products (:func:`matmul`: at bf16 the carry is rounded to bf16 before
    each product); K7's tile row ranges only skip elements the mask zeroes.
    This is also the JAX package's path when the band covers the matrix
    (an XLA dot outside any kernel)."""
    r = torch.arange(t.shape[0], device=t.device)
    tm = operand(torch.where((r[:, None] - r[None, :]).abs() <= h, t,
                             torch.zeros((), dtype=t.dtype, device=t.device)),
                 matmul_dtype)
    out = x
    for _ in range(n_apply):
        out = torch.matmul(operand(out, matmul_dtype), tm)
    return out


def banded_ell_plain(t: torch.Tensor, h: int, bs: int = 512) -> torch.Tensor:
    """[nb, bs/32, 2kh+1, 4] int: K7's ELL length of each item's
    quarter-slots, read straight from the dense T masked to |r - c| <= h
    (a select, so NaN beyond h does not count; NaN within it does): the
    most nonzeros any of the strip's 32 columns holds over the slot's
    quarter of rows, 0 for a slot past the matrix edge."""
    n = t.shape[0]
    nb, kh = _blocks(n, h, bs)
    r = torch.arange(n, device=t.device)
    nz = torch.where((r[:, None] - r[None, :]).abs() <= h, t,
                     torch.zeros((), dtype=t.dtype, device=t.device)) != 0
    # per (row block i, quarter u, column block j, strip): the longest column
    cnt = nz.reshape(nb, 4, bs // 4, nb, bs // PACKED_STRIP,
                     PACKED_STRIP).sum(2).amax(-1)
    out = torch.zeros((nb, bs // PACKED_STRIP, 2 * kh + 1, 4),
                      dtype=cnt.dtype, device=t.device)
    for j in range(nb):
        for m in range(2 * kh + 1):
            i = j + m - kh
            if 0 <= i < nb:
                out[j, :, m, :] = cnt[i, :, j, :].t()
    return out


def launch_banded_chain(x: torch.Tensor, t: torch.Tensor, h: int,
                        n_apply: int, bs: int, plan: PackedChainPlan):
    """K7's one cooperative launch under ``plan`` (:func:`packed_chain_plan`
    at kh = ceil(h / bs)), for CUDA tensors that :func:`banded_chain` has
    checked. Returns (out, stats, timing) as :func:`launch_packed_chain`;
    the scratch for the entries not held is 6 bytes per element of T's band
    tiles, n * (2kh+1) * bs * 6 bytes."""
    c, n = x.shape
    _, kh = _blocks(n, h, bs)
    ctas, ipc, threads, x_blocks, slots, smem = plan
    out, scratch, counter, stats, timing, ell_val, ell_row = _chain_buffers(
        x, (2 * kh + 1) * bs, bs, ctas)
    _build.launch("banded_chain", x.device,
                  x.data_ptr(), t.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), counter.data_ptr(), stats.data_ptr(),
                  timing.data_ptr(), ell_val.data_ptr(), ell_row.data_ptr(),
                  c, n, bs, kh, h, n_apply, ctas, ipc, threads, x_blocks,
                  slots, smem)
    return out, stats[0], timing


def banded_chain(x: torch.Tensor, t: torch.Tensor, h: int, n_apply: int,
                 bs: int = 512, bj: int = 512) -> torch.Tensor:
    """x @ T^n_apply with T masked to |r - c| <= h (K7), for a T whose
    elements beyond h may hold anything (NaN included). The JAX function
    runs rectangular (bs x bj) tiles whose row ranges [j*bj - kh*bs,
    j*bj + bj + kh*bs) hold every row within h of their columns, so its
    result does not depend on bj: the kernel runs K3's one cooperative
    launch per chain over the masked T's nonzero entries, read straight
    from T, and bj only keeps its checks. ``x``: [C, n] f32; n a multiple of
    bj, bj of bs; on the card bs a multiple of 64, <= 1536, within
    :func:`packed_chain_plan`'s limit."""
    c, n = x.shape
    if t.shape != (n, n) or n % bs or bj % bs or n % bj:
        raise ValueError(f"banded_chain: x {tuple(x.shape)} t "
                         f"{tuple(t.shape)} bs {bs} bj {bj}")
    if n_apply < 1:
        raise ValueError(f"banded_chain: n_apply={n_apply} must be >= 1")
    if _build.is_plain(x):
        return banded_chain_plain(x, t, h, n_apply)
    _build.check_cuda("banded_chain", x, t)
    if bs % 64 or bs > 1536:
        raise ValueError(f"banded_chain: bs={bs} must be a multiple of 64, "
                         "<= 1536")
    _, kh = _blocks(n, h, bs)
    plan = card_packed_chain_plan(x.device, n, bs, kh)
    return launch_banded_chain(x, t, h, n_apply, bs, plan)[0]


def apply_banded_chain(x: torch.Tensor, t: torch.Tensor, h: int,
                       n_apply: int, bs: int = 512,
                       bj: Optional[int] = None,
                       matmul_dtype=None) -> torch.Tensor:
    """x @ T^n_apply for a banded T (halfwidth ``h``) whose out-of-band
    blocks may hold :func:`square_banded`'s fill, dispatched as
    ``matpow_pallas.apply_banded_chain``: one application through
    :func:`apply_banded` (K4); a band covering the matrix through T masked
    to the band and dense products (:func:`banded_chain_plain`); square
    tiles (``bj == bs``) through :func:`pack_banded` + :func:`packed_chain`
    (K1 + K3); otherwise rectangular tiles through :func:`banded_chain`
    (K7). ``matmul_dtype`` bf16 runs K4 and the dense products on bf16
    operands and raises (:func:`check_chain_dtype`) for K1 + K3 and K7.
    ``x``: [C, n] with C a multiple of 8; ``bj`` defaults to ``bs``, as
    ``matpow_pallas.default_apply_bj``."""
    c, n = x.shape
    if bj is None:
        bj = bs
    if t.shape != (n, n) or n % bs or c % 8 or bj % bs or n % bj:
        raise ValueError(f"bad shapes x={tuple(x.shape)} t={tuple(t.shape)} "
                         f"bs={bs} bj={bj}")
    check_chain_dtype(n, h, n_apply, bs, bj, matmul_dtype)
    if n_apply == 1:
        return apply_banded(x, t, h, bs, matmul_dtype)
    if chain_covers(n, h, bs, bj):
        return banded_chain_plain(x, t, h, n_apply, matmul_dtype)
    if bj == bs:
        return packed_chain(x, pack_banded(t, h, bs), n_apply, bs)
    return banded_chain(x, t, h, n_apply, bs, bj)


# -- K8 ---------------------------------------------------------------------

def packed_chain_batched_plain(xs: torch.Tensor, tps: torch.Tensor,
                               n_apply: int, bs: int = 512) -> torch.Tensor:
    """K8's twin: :func:`packed_chain_plain`'s windowed bmm on each image."""
    return torch.stack([packed_chain_plain(x, tp, n_apply, bs)
                        for x, tp in zip(xs, tps)])


def launch_packed_chain_batched(xs: torch.Tensor, tps: torch.Tensor,
                                n_apply: int, bs: int, plan: PackedChainPlan):
    """K8 under ``plan`` (:func:`packed_chain_plan` for the batch), for CUDA
    tensors that :func:`packed_chain_batched` has checked: one cooperative
    launch per image group of :func:`packed_chain_groups` (one for a batch
    that fits one wave), each with its own barrier counter; a plan of
    several images per launch runs the kernel's tuning for them (8 entries
    per warp in flight), one image per launch K3's. Returns (out,
    stats [B, items, 3], timing [CTAs of all launches, 5]) as
    :func:`launch_packed_chain`. The scratch for the entries not held is
    sized for one group and reused by the next: 1.5x one group's tiles
    (6 bytes per tile entry; 1.2 GB for a group of 4 at n 14336, h 1112)."""
    bimg, c, n = xs.shape
    span = tps.shape[2]
    kh = (span // bs - 1) // 2
    ctas, ipc, threads, x_blocks, slots, smem = plan
    group = packed_chain_images(plan, n, bs)
    cpi = ctas // group
    groups = packed_chain_groups(bimg, plan, n, bs)
    out, scratch, counters, stats, timing, ell_val, ell_row = _chain_buffers(
        xs, span, bs, cpi * bimg, len(groups), min(group, bimg))
    for k, (b, count) in enumerate(groups):
        _build.launch("packed_chain_batched", xs.device,
                      xs[b].data_ptr(), tps[b].data_ptr(), out[b].data_ptr(),
                      scratch[b].data_ptr(), counters[k].data_ptr(),
                      stats[b].data_ptr(), timing[b * cpi].data_ptr(),
                      ell_val.data_ptr(), ell_row.data_ptr(), count, group, c,
                      n, bs, kh, n_apply, count * cpi, ipc, threads, x_blocks,
                      slots, smem)
    return out, stats, timing


def packed_chain_batched(xs: torch.Tensor, tps: torch.Tensor, n_apply: int,
                         bs: int = 512) -> torch.Tensor:
    """x_b @ T_b^n_apply for B images at once over each image's packed tiles
    (K8): ``xs`` [B, C, n] f32, ``tps`` [B, n/bs, (2kh+1)*bs, bs] from
    :func:`pack_banded`. K3's chain body with a group of CTAs per image, in
    one cooperative launch per chain (or per image group, when the batch
    does not fit one wave: :func:`launch_packed_chain_batched`); each
    image's result is bit-equal to :func:`packed_chain` on it."""
    if xs.dim() != 3 or tps.dim() != 4 or tps.shape[0] != xs.shape[0]:
        raise ValueError(f"packed_chain_batched: xs {tuple(xs.shape)} "
                         f"tiles {tuple(tps.shape)}")
    bimg, c, n = xs.shape
    if tps.shape[1] * bs != n or tps.shape[3] != bs or tps.shape[2] % bs \
            or (tps.shape[2] // bs) % 2 == 0:
        raise ValueError(f"packed_chain_batched: tiles {tuple(tps.shape)} "
                         f"vs xs {tuple(xs.shape)}")
    if n_apply < 1:
        raise ValueError(f"packed_chain_batched: n_apply={n_apply} must be >= 1")
    if _build.is_plain(xs):
        return packed_chain_batched_plain(xs, tps, n_apply, bs)
    _build.check_cuda("packed_chain_batched", xs, tps)
    if bs % 64 or bs > 1536:
        raise ValueError(f"packed_chain_batched: bs={bs} must be a multiple "
                         "of 64, <= 1536")
    kh = (tps.shape[2] // bs - 1) // 2
    plan = card_packed_chain_plan(xs.device, n, bs, kh, bimg)
    return launch_packed_chain_batched(xs, tps, n_apply, bs, plan)[0]


def apply_banded_chain_batched(xs: torch.Tensor, ts: Iterable[torch.Tensor],
                               h: int, n_apply: int, bs: int = 512,
                               matmul_dtype=None) -> torch.Tensor:
    """B images' x_b @ T_b^n_apply in one batched chain, as
    ``matpow_pallas.apply_banded_chain_batched``: each T_b (halfwidth
    ``h``, out-of-band blocks unspecified) is packed by :func:`pack_banded`
    (K1), then :func:`packed_chain_batched` (K8) runs the chain. ``xs``:
    [B, C, n] with C a multiple of 8. ``ts``: a [B, n, n] tensor, or B
    [n, n] tensors in image order; it is read once, each T_b only until it
    is packed, so a generator that builds them lets each dense T be freed
    before the next is built. A band that does not fit under the matrix
    raises (no dense fallback). ``matmul_dtype`` bf16 raises
    :class:`NotImplementedError` (K1 and K8 have no bf16 mode yet). Returns
    [B, C, n] f32."""
    bimg, c, n = xs.shape
    check_dtype(matmul_dtype)
    if matmul_dtype is not None:
        raise NotImplementedError(CHAIN_BF16_TODO)
    if n % bs or c % 8:
        raise ValueError(f"bad shapes xs={tuple(xs.shape)} bs={bs}")
    nkb, kh = _blocks(n, h, bs)
    if 1 + 2 * kh >= nkb:
        raise ValueError(f"band 2*{h} does not fit n={n} (bs={bs})")
    tps = []
    for t in ts:
        if t.shape != (n, n):
            raise ValueError(f"apply_banded_chain_batched: T {tuple(t.shape)} "
                             f"vs xs {tuple(xs.shape)}")
        tps.append(pack_banded(t, h, bs))
        del t
    if len(tps) != bimg:
        raise ValueError(f"apply_banded_chain_batched: {len(tps)} T for "
                         f"{bimg} images")
    return packed_chain_batched(xs, torch.stack(tps), n_apply, bs)
