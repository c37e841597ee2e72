"""The 3x3 conv probe's kernel: the counterpart of
``tools/bench_conv_pallas.conv3x3_pallas``.

:func:`conv3x3` (K9, ``csrc/conv3x3.cu``) is a SAME 3x3 stride-1
convolution, NHWC bf16 in and out, accumulated in f32 and rounded once to
bf16 (nearest even): an implicit GEMM on Hopper's wgmma, fed by TMA. The
wrapper re-lays the HWIO weights once per call as [F, 9, C]
(:func:`relayout_weights`, a plain copy of 18 C F bytes outside the
kernel), so that every weight slice the kernel loads is K-major. Its plain twin
:func:`conv3x3_plain` is the JAX function's math, ``conv_xla`` with
``preferred_element_type=f32``: ``F.conv2d`` in f32 on the bf16 values,
rounded once. The wrapper runs the twin for CPU tensors and launches the
kernel for CUDA tensors (or raises). The Pallas function's ``bh`` (a TPU
row-block size) is not part of the contract.

On the card, keep TF32 off for the twin (``torch.backends.cudnn.allow_tf32
= False``): an f32 conv under TF32 is not the JAX function's math.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from irn_tpu_torch.ops import _build


def _shapes(x: torch.Tensor, k: torch.Tensor):
    if x.dim() != 4 or k.dim() != 4 or k.shape[:2] != (3, 3) \
            or k.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} (NHWC), k "
                         f"{tuple(k.shape)} (3, 3, C, F)")
    return (*x.shape, k.shape[3])


def conv3x3_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """K9's twin: ``F.conv2d`` in f32 on x [B, H, W, C] and k [3, 3, C, F]
    (NCHW / OIHW views, ``padding=1``), rounded once to x's dtype. Any
    shape."""
    _shapes(x, k)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), k.float().permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def relayout_weights(k: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, C, F] -> [F, 9, C] (tap = 3 dy + dx), contiguous: the
    kernel's K-major weight layout."""
    f = k.shape[3]
    return k.permute(3, 0, 1, 2).reshape(f, 9, k.shape[2]).contiguous()


def conv3x3(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 stride-1 conv (K9): x [B, H, W, C] bf16 NHWC, k [3, 3, C, F]
    bf16 HWIO, both contiguous; returns [B, H, W, F] bf16. C and F must be
    multiples of 16. A non-contiguous input raises rather than being copied."""
    b, h, w, c, f = _shapes(x, k)
    if c % 16 or f % 16:
        raise ValueError(f"conv3x3: C={c} and F={f} must be multiples of 16")
    if _build.is_plain(x):
        return conv3x3_plain(x, k)
    _build.check_cuda("conv3x3", x, k, dtype=torch.bfloat16)
    if x.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError("conv3x3: tensors must be 16-byte aligned")
    wt = relayout_weights(k)
    out = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    _build.launch("conv3x3", x.device, x.data_ptr(), wt.data_ptr(),
                  out.data_ptr(), b, h, w, c, f)
    return out
