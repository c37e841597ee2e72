"""Repeated dense matrix squaring T -> T^(2^e) — the counterpart of
:mod:`irn_tpu.ops.matpow` (single device).

The port reads no environment switch (``IRN_TPU_MATPOW`` is not read):
every squaring on a CUDA tensor runs the hand kernel K5
(:func:`matpow_kernels.square_dense`), the route the JAX package takes
under ``IRN_TPU_MATPOW=pallas|fused``; a CPU tensor runs its plain twin.
The JAX default (XLA's dot) would be cuBLAS here, a library kernel.
"""

from __future__ import annotations

import torch

from irn_tpu_torch.ops import matpow_kernels as mk


def matmul_square(t: torch.Tensor) -> torch.Tensor:
    """One squaring T @ T in f32 (K5 on the card)."""
    return mk.square_dense(t)


def matrix_power_squarings(t: torch.Tensor, exp_times: int) -> torch.Tensor:
    """``exp_times`` squarings, unrolled."""
    for _ in range(exp_times):
        t = matmul_square(t)
    return t
