"""Banded transition-power kernels: the counterparts of
:mod:`irn_tpu.ops.matpow_pallas` on the slice's path.

- :func:`pack_banded` (K1, ``csrc/pack_banded.cu``): T's in-band blocks
  into packed tiles [nb, (2kh+1)*bs, bs].
- :func:`square_banded` (K2, ``csrc/square_banded.cu``): T @ T over the
  band only; out-of-band output is unspecified.
- :func:`packed_chain` (K3, ``csrc/packed_chain.cu``): x @ T^n over the
  packed tiles; :func:`apply_banded_chain` packs and chains.

Each kernel has a plain PyTorch twin beside it (``*_plain``). A wrapper runs
the twin for CPU tensors and launches the kernel for CUDA tensors (or
raises); it never falls back from the card to the twin. Kernels take f32
only in this version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from irn_tpu_torch.ops import _build


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


def square_banded_plain(t: torch.Tensor, h: int, bs: int = 512) -> torch.Tensor:
    """Block loop over the in-band output blocks, each contracting only the
    blocks inside both operands' bands; out-of-band blocks are zero here
    (the kernel leaves them unspecified)."""
    nb, kb, jb, covers = _square_bands(t.shape[0], h, bs)
    if covers:
        return torch.matmul(t, t)
    out = torch.zeros_like(t)
    for i in range(nb):
        for j in range(max(0, i - jb), min(nb, i + jb + 1)):
            klo = max(max(i, j) - kb, 0)
            khi = min(min(i, j) + kb, nb - 1)
            if klo > khi:
                continue
            out[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = torch.matmul(
                t[i * bs : (i + 1) * bs, klo * bs : (khi + 1) * bs],
                t[klo * bs : (khi + 1) * bs, j * bs : (j + 1) * bs],
            )
    return out


def square_banded(t: torch.Tensor, h: int, bs: int = 512) -> torch.Tensor:
    """T @ T for T banded with halfwidth ``h`` (K2). Only blocks within the
    2h output band are written; the rest is unspecified, so read the
    result through :func:`pack_banded` only."""
    n = t.shape[0]
    if t.shape != (n, n):
        raise ValueError(f"square_banded: square matrix expected, got {t.shape}")
    if _build.is_plain(t):
        return square_banded_plain(t, h, bs)
    _build.check_cuda("square_banded", t)
    _, kb, jb, covers = _square_bands(n, h, bs)
    if covers:
        return torch.matmul(t, t)
    if bs % 64:
        raise ValueError(f"square_banded: bs={bs} must be a multiple of 64")
    out = torch.empty_like(t)
    _build.launch("square_banded", t.device,
                  t.data_ptr(), out.data_ptr(), n, bs, kb, jb)
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


def packed_chain(x: torch.Tensor, tp: torch.Tensor, n_apply: int,
                 bs: int = 512) -> torch.Tensor:
    """x @ T^n_apply over K1's packed tiles (K3). ``x``: [C, n] f32."""
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
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    part = torch.empty((2 * kh + 1, c, n), dtype=x.dtype, device=x.device)
    _build.launch("packed_chain", x.device,
                  x.data_ptr(), tp.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), part.data_ptr(), c, n, bs, kh, n_apply)
    return out


def apply_banded_chain(x: torch.Tensor, t: torch.Tensor, h: int,
                       n_apply: int, bs: int = 512) -> torch.Tensor:
    """x @ T^n_apply for a banded T (halfwidth ``h``): pack (K1), then the
    packed chain (K3). ``x``: [C, n] with C a multiple of 8. The band must
    stay under the matrix (``random_walk.banded_fits``); a single
    application (the TPU's separate ``apply_banded`` kernel) runs as a
    one-step chain."""
    c, n = x.shape
    if t.shape != (n, n) or c % 8:
        raise ValueError(f"bad shapes x={tuple(x.shape)} t={tuple(t.shape)}")
    nb, kh = _blocks(n, h, bs)
    if 1 + 2 * kh >= nb:
        raise ValueError(f"band {h} covers the matrix (n={n}, bs={bs})")
    return packed_chain(x, pack_banded(t, h, bs), n_apply, bs)
