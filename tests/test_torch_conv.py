"""The 3x3 conv probe's kernel (K9) vs the JAX package on the same numpy
inputs (CPU).

K9 ``conv3x3`` runs its plain twin here (f32 ``F.conv2d`` on the bf16
values, rounded once to bf16). The Pallas ``conv3x3_pallas`` of
``tools/bench_conv_pallas.py`` runs in interpret mode: it calls
``pl.pallas_call`` without an ``interpret`` argument, so the test wraps
``pallas_call`` with ``interpret=True`` for the call. Tolerance: both sides
accumulate in f32 in another order and round once to bf16, so an output
may land one bf16 step apart: max |got - want| <= 2^-7 * max|want|, and at
least 99% of the elements bit-equal."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import conv3x3 as tconv
from tools import bench_conv_pallas as jconv

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach a kernel: every launch counter stays 0."""
    _build.reset_launches()
    yield
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


def _inputs(rng, b, h, w, c, f):
    """bf16-representable x [B, H, W, C] and k [3, 3, C, F] as numpy f32, and
    the same values as bf16 for JAX and torch."""
    x = np.array(jnp.asarray(rng.standard_normal((b, h, w, c)),
                              jnp.bfloat16).astype(jnp.float32))
    k = np.array(jnp.asarray(rng.standard_normal((3, 3, c, f)) * 0.05,
                              jnp.bfloat16).astype(jnp.float32))
    return x, k


def _bf16_close(got: torch.Tensor, want):
    """got (torch bf16) vs want (JAX bf16): max abs <= 2^-7 max|want|, and
    >= 99% of the elements bit-equal."""
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    assert float(np.abs(g - w).max()) <= 2.0 ** -7 * float(np.abs(w).max())
    assert float(np.mean(g == w)) >= 0.99


def _twin(x, k):
    return tconv.conv3x3(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(k).to(torch.bfloat16))


def test_conv3x3_twin_matches_pallas_interpret(rng, monkeypatch):
    """K9's twin vs conv3x3_pallas (interpret mode) at B 2, H 8, W 10, C 16,
    F 32, bh 4: zero halo at rows 0 / h+1 and columns 0 / w+1, and
    K'[dy] row dx*C + c = k[dy, dx, c, f]."""
    x, k = _inputs(rng, 2, 8, 10, 16, 32)
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    want = jconv.conv3x3_pallas(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(k, jnp.bfloat16), bh=4)
    _bf16_close(_twin(x, k), want)


@pytest.mark.parametrize("shape", [(2, 8, 10, 16, 32), (1, 13, 11, 32, 48)])
def test_conv3x3_twin_matches_conv_xla(rng, shape):
    """K9's twin vs conv_xla (lax.conv_general_dilated, f32 accumulation,
    one round to bf16), including H and W that are not multiples of 8."""
    x, k = _inputs(rng, *shape)
    want = jconv.conv_xla(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(k, jnp.bfloat16))
    _bf16_close(_twin(x, k), want)


def test_conv3x3_shape_contract():
    """C and F must be multiples of 16 for the kernel's wrapper; the twin
    takes any shape; a k that is not [3, 3, C, F] raises."""
    x = torch.zeros((1, 5, 6, 24), dtype=torch.bfloat16)
    k = torch.zeros((3, 3, 24, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tconv.conv3x3(x, k)
    assert tconv.conv3x3_plain(x, k).shape == (1, 5, 6, 16)
    with pytest.raises(ValueError):
        tconv.conv3x3(torch.zeros((1, 5, 6, 16), dtype=torch.bfloat16),
                      torch.zeros((3, 3, 32, 16), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tconv.conv3x3(torch.zeros((1, 5, 6, 16), dtype=torch.bfloat16),
                      torch.zeros((1, 1, 16, 16), dtype=torch.bfloat16))
    meta = torch.empty((1, 5, 6, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no fallback
        tconv.conv3x3(meta, torch.empty((3, 3, 16, 16), dtype=torch.bfloat16,
                                        device="meta"))
