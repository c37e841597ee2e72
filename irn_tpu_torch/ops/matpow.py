"""Repeated dense matrix squaring T -> T^(2^e) — the counterpart of
:mod:`irn_tpu.ops.matpow` (single device).

The port reads no environment switch (``IRN_TPU_MATPOW`` is not read):
every squaring on a CUDA tensor runs the hand kernel K5
(:func:`matpow_kernels.square_dense`), the route the JAX package takes
under ``IRN_TPU_MATPOW=pallas|fused``; a CPU tensor runs its plain twin.
The JAX default (XLA's dot) would be cuBLAS here, a library kernel.

``matmul_dtype`` as in the JAX module: None keeps f32 operands (K5's six
bf16 products, f32-accurate); ``torch.bfloat16`` rounds T to bf16 for each
squaring and accumulates in f32 (K5's one product).
"""

from __future__ import annotations

import torch

from irn_tpu_torch.ops import matpow_kernels as mk


def matmul_square(t: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """One squaring T @ T, f32 out (K5 on the card)."""
    return mk.square_dense(t, matmul_dtype)


def matrix_power_squarings(t: torch.Tensor, exp_times: int,
                           matmul_dtype=None) -> torch.Tensor:
    """``exp_times`` squarings, unrolled; the carry stays f32."""
    for _ in range(exp_times):
        t = matmul_square(t, matmul_dtype)
    return t
