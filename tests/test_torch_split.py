"""K6's and K5's split passes and six-product sum, and K9's weight
re-layout, through their plain twins on the CPU.

K6 on the card splits each f32 operand into three bf16 pieces and sums six
piece products on the tensor cores (the TPU's Precision.HIGHEST). Here the
pieces come from ``split_operands_plain`` and the products are summed in
f64 (``split_product_plain``), against ``torch.matmul`` in f32 and against
``square_fused_first``'s Pallas body in interpret mode. Tolerances: the
three dropped products are about 2^-24 of each term and every term is
>= 0, so the split sum lies within 2^-20 of max|T @ T| of an f32 product."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl

from irn_tpu.ops import matpow_pallas as jmp
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import conv3x3 as cv
from irn_tpu_torch.ops import matpow_kernels as tmk

torch.set_num_threads(2)

# finite f32 below bf16's largest finite value (about 3.39e38), where the
# hi piece would round to inf
_f32 = st.floats(-2.0 ** 127, 2.0 ** 127, width=32, allow_subnormal=True)


def _reconstruct(x: torch.Tensor):
    hi, mid, lo = tmk.split3_plain(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    return hi.double() + mid.double() + lo.double()


def _check_split(x: torch.Tensor):
    """hi + mid + lo == x exactly where |x| >= 2^-100; below, within bf16's
    subnormal spacing 2^-133."""
    err = (_reconstruct(x) - x.double()).abs()
    big = x.double().abs() >= 2.0 ** -100
    assert float(err[big].sum()) == 0.0
    assert bool((err[~big] <= 2.0 ** -133).all())


@settings(max_examples=200, deadline=None)
@given(st.lists(_f32, min_size=1, max_size=64))
def test_split3_reconstructs_f32(values):
    _check_split(torch.tensor(values, dtype=torch.float32))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(0.0, 1.0, width=32, allow_subnormal=True),
                min_size=1, max_size=64),
       st.sampled_from([1, 3, 10, 16]))
def test_split3_of_powers_into_subnormals(values, beta):
    """A^beta of affinities in [0, 1]: the walk's left operand, whose weak
    entries underflow into f32 subnormals at beta 10."""
    _check_split(tmk.pow_int(torch.tensor(values, dtype=torch.float32), beta))


def test_split3_edge_values():
    x = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0 ** -100, 2.0 ** -126,
                      2.0 ** -140, 2.0 ** -149, 2.0 ** 127, 1.0 + 2.0 ** -23,
                      1.0 / 3.0], dtype=torch.float32)
    _check_split(x)


def _affinity(rng, n, lo=0.3):
    a = rng.uniform(lo, 1.0, (n, n)).astype(np.float32)
    a = np.minimum(a, a.T)
    np.fill_diagonal(a, 1.0)
    return torch.from_numpy(a)


@pytest.mark.parametrize("n,lo", [(128, 0.3), (384, 0.3), (384, 0.0)])
def test_six_product_sum_matches_matmul(rng, n, lo):
    """The split operands' six-product sum (f64) vs normalize + torch.matmul
    in f32 and vs the JAX kernel body (interpret mode), within 2^-20 of
    max|T @ T|; and vs the f64 product of the f64 T, closer than the f32
    matmul is. lo 0.0 puts affinities near 0 (subnormal 10th powers)."""
    beta = 10
    a = _affinity(rng, n, lo)
    inv = 1.0 / torch.sum(tmk.pow_int(a, beta), dim=0)
    pieces = tmk.split_operands(a, inv, beta)  # the CPU runs the twin
    assert pieces.shape == (6, n, n) and pieces.dtype == torch.bfloat16
    got = tmk.split_product_plain(pieces)
    want = tmk.square_fused_first_plain(a, beta)
    tol = 2.0 ** -20 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    extra = (pl.BlockSpec((1, 128), lambda i, j, k: (0, k)),
             pl.BlockSpec((1, 128), lambda i, j, k: (0, j)))
    kernel = pl.pallas_call(
        functools.partial(jmp._fused_kernel, beta=beta, matmul_dtype=None),
        interpret=True, **jmp._grid_spec(n, 128, 128, 128, extra_in=extra))
    jax_out = np.asarray(kernel(jnp.asarray(a.numpy()), jnp.asarray(a.numpy()),
                                jnp.asarray(inv.numpy()).reshape(1, n),
                                jnp.asarray(inv.numpy()).reshape(1, n)))
    assert float(np.abs(got.numpy() - jax_out).max()) <= tol
    b64 = tmk.pow_int(a.double(), beta)
    t64 = b64 / b64.sum(0, keepdim=True)
    exact = t64 @ t64
    assert float((got.double() - exact).abs().max()) <= float(
        (want.double() - exact).abs().max()) + 2.0 ** -24 * float(exact.max())


def test_split_operands_layout(rng):
    """L's pieces as [i][k] reconstruct A^beta; R's pieces are stored
    transposed and reconstruct A^beta[k, j] * inv[k] * inv[j] at [j][k]."""
    n, beta = 128, 10
    a = _affinity(rng, n)
    inv = 1.0 / torch.sum(tmk.pow_int(a, beta), dim=0)
    pieces = tmk.split_operands_plain(a, inv, beta)
    b = tmk.pow_int(a, beta)
    r = b * inv[:, None] * inv[None, :]
    left = pieces[0].double() + pieces[1].double() + pieces[2].double()
    right = pieces[3].double() + pieces[4].double() + pieces[5].double()
    big = b.abs() >= 2.0 ** -100
    assert torch.equal(left[big], b.double()[big])
    big_r = r.abs() >= 2.0 ** -100
    assert torch.equal(right.t()[big_r], r.double()[big_r])
    assert all(v == 0 for v in _build.LAUNCHES.values())


@pytest.mark.parametrize("n", [128, 384])
def test_split_identity_pieces(rng, n):
    """K5's split twin: T's split3 pieces as [i][k], then the same pieces
    transposed, piece by piece; equal to K6's split at beta 1 with inv all
    ones (x * 1.0 is exact), and the pieces reconstruct T."""
    t = rng.random((n, n), dtype=np.float32)
    t = torch.from_numpy(t / t.sum(0, keepdims=True))
    pieces = tmk.split_identity(t)  # the CPU runs the twin
    assert pieces.shape == (6, n, n) and pieces.dtype == torch.bfloat16
    hi, mid, lo = tmk.split3_plain(t)
    for got, want in zip(pieces, (hi, mid, lo, hi.t(), mid.t(), lo.t())):
        assert torch.equal(got, want)
    assert torch.equal(pieces, tmk.split_operands_plain(t, torch.ones(n), 1))
    assert torch.equal(_reconstruct(t), t.double())
    assert all(v == 0 for v in _build.LAUNCHES.values())


@pytest.mark.parametrize("c,f", [(16, 16), (32, 48), (128, 256)])
def test_conv3x3_weight_relayout_round_trips(c, f):
    """HWIO -> [F, 9, C] (tap 3 dy + dx) -> HWIO is the identity, and the
    re-laid tensor holds k[dy, dx, c, f] at [f, 3 dy + dx, c]."""
    g = torch.Generator().manual_seed(c + f)
    k = torch.randn((3, 3, c, f), generator=g).to(torch.bfloat16)
    wt = cv.relayout_weights(k)
    assert wt.shape == (f, 9, c) and wt.is_contiguous()
    back = wt.reshape(f, 3, 3, c).permute(1, 2, 3, 0)  # [F, 9, C] -> HWIO
    assert torch.equal(back, k)
    for dy, dx, ci, fi in ((0, 0, 0, 0), (2, 1, c - 1, f - 1),
                           (1, 2, c // 2, f // 3)):
        assert torch.equal(wt[fi, 3 * dy + dx, ci], k[dy, dx, ci, fi])
