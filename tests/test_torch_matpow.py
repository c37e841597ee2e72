"""The pure-squaring and banded-apply kernels' plain twins vs the JAX
package on the same numpy inputs (CPU).

K4 apply_banded, K5 square_dense, K6 square_fused_first and K7
banded_chain run their plain PyTorch twins here; the Pallas kernels of
``irn_tpu.ops.matpow_pallas`` run in interpret mode. ``square_pallas`` and
``square_fused_first`` refuse the CPU and take no ``interpret`` argument,
so their kernel bodies run through ``pl.pallas_call(..., interpret=True)``
with the package's own grid spec. Tolerances: f32 sums taken in another
order differ in the last bits (rel 1e-5 on one product, looser over a chain
of products)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from irn_tpu.ops import matpow_pallas as jmp
from irn_tpu.ops import random_walk as jrw
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import matpow as tmp
from irn_tpu_torch.ops import matpow_kernels as tmk
from irn_tpu_torch.ops import random_walk as trw

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel_close(got, want, rtol):
    """max |got - want| <= rtol * max |want|, all finite."""
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _banded(rng, n, h, scale=0.01):
    """Column-stochastic T with band halfwidth h (true zeros outside)."""
    r = np.arange(n)
    band = np.abs(r[:, None] - r[None, :]) <= h
    t = np.zeros((n, n), np.float32)
    t[band] = rng.random(band.sum(), dtype=np.float32) * scale
    t /= t.sum(0, keepdims=True)
    return t, r


def _poison_blocks(t, r, h, bs, value=np.nan):
    """T with every bs x bs block beyond the block band kb = ceil(h/bs) set
    to ``value`` — where square_banded's output is unspecified."""
    kb = -(-h // bs)
    bi = r // bs
    tp = t.copy()
    tp[np.abs(bi[:, None] - bi[None, :]) > kb] = value
    return tp


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach a kernel: every launch counter stays 0."""
    _build.reset_launches()
    yield
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


@pytest.mark.parametrize("n", [256, 384])
def test_square_dense_matches_jax_kernel(rng, n):
    """K5's twin vs square_pallas's kernel body (interpret mode) and an f32
    HIGHEST dot; and K5's arithmetic, the six-product sum over its identity
    split's pieces (f64), vs both and vs torch.matmul within rel 1e-5 (the
    f32 products' own rounding), and vs the f64 product within 2^-20 of
    max|T @ T| (the three dropped products are about 2^-24 of each term and
    every term is >= 0)."""
    t = rng.random((n, n), dtype=np.float32)
    t /= t.sum(0, keepdims=True)
    kernel = pl.pallas_call(
        functools.partial(jmp._square_kernel, matmul_dtype=None),
        interpret=True, **jmp._grid_spec(n, 128, 128, 128))
    want = np.asarray(kernel(jnp.asarray(t), jnp.asarray(t)))
    dot = np.asarray(jnp.dot(t, t, precision=jax.lax.Precision.HIGHEST))
    got = tmk.square_dense(_t(t)).numpy()
    _rel_close(got, want, 1e-5)
    _rel_close(got, dot, 1e-5)
    np.testing.assert_array_equal(tmp.matmul_square(_t(t)).numpy(), got)
    split = tmk.split_product_plain(tmk.split_identity(_t(t))).numpy()
    for ref in (want, dot, got):
        _rel_close(split, ref, 1e-5)
    _rel_close(split, t.astype(np.float64) @ t.astype(np.float64),
               2.0 ** -20)


@pytest.mark.parametrize("n", [256, 384])
def test_square_fused_first_matches_jax_kernel(rng, n):
    """K6's twin (normalize, then square) vs square_fused_first's kernel
    body (interpret mode) with its two inv_colsum BlockSpecs, beta 10."""
    beta = 10
    a = rng.uniform(0.3, 1.0, (n, n)).astype(np.float32)
    a = np.minimum(a, a.T)
    np.fill_diagonal(a, 1.0)
    colsum = jnp.sum(jmp._pow_int(jnp.asarray(a), beta), axis=0)
    inv = (1.0 / colsum).astype(jnp.float32).reshape(1, n)
    extra = (
        pl.BlockSpec((1, 128), lambda i, j, k: (0, k)),
        pl.BlockSpec((1, 128), lambda i, j, k: (0, j)),
    )
    kernel = pl.pallas_call(
        functools.partial(jmp._fused_kernel, beta=beta, matmul_dtype=None),
        interpret=True, **jmp._grid_spec(n, 128, 128, 128, extra_in=extra))
    want = np.asarray(kernel(jnp.asarray(a), jnp.asarray(a), inv, inv))
    got = tmk.square_fused_first(_t(a), beta).numpy()
    _rel_close(got, want, 1e-5)
    t = np.asarray(jrw.normalize_transition(jnp.asarray(a), beta))
    _rel_close(got, np.asarray(jnp.dot(
        t, t, precision=jax.lax.Precision.HIGHEST)), 1e-5)


@pytest.mark.parametrize("c", [8, 16])
def test_apply_banded_matches_jax(rng, c):
    """K4's twin vs the Pallas apply_banded (interpret mode) on a T whose
    blocks beyond kb are NaN: neither side may read them."""
    n, bs, h = 1024, 128, 130
    t, r = _banded(rng, n, h)
    tp = _poison_blocks(t, r, h, bs)
    x = rng.random((c, n), dtype=np.float32)
    want = np.asarray(jmp.apply_banded(jnp.asarray(x), jnp.asarray(tp), h,
                                       bs=bs, interpret=True))
    got = tmk.apply_banded(_t(x), _t(tp), h, bs).numpy()
    _rel_close(got, want, 1e-5)
    _rel_close(got, x @ t, 1e-5)


@pytest.mark.parametrize("n,bj", [(1024, 256), (2048, 512)])
def test_banded_chain_matches_jax(rng, n, bj):
    """K7's twin vs the Pallas rectangular-tile chain (interpret mode), with
    NaN beyond the written block band: wide tiles straddle it, and the
    band mask (a select) must keep it out. As
    tests/test_random_walk.py::test_apply_chain_rect_tiles_ignore_out_of_band_garbage."""
    bs, h = 128, 130
    t, r = _banded(rng, n, h)
    tp = _poison_blocks(t, r, h, bs)
    x = rng.random((8, n), dtype=np.float32)
    want = np.asarray(jmp.apply_banded_chain(
        jnp.asarray(x), jnp.asarray(tp), h, 4, bs=bs, bj=bj, interpret=True))
    got = tmk.banded_chain(_t(x), _t(tp), h, 4, bs, bj).numpy()
    _rel_close(got, want, 1e-5)
    _rel_close(got, x @ t @ t @ t @ t, 1e-5)
    chain = tmk.apply_banded_chain(_t(x), _t(tp), h, 4, bs=bs, bj=bj)
    np.testing.assert_array_equal(chain.numpy(), got)


def test_apply_banded_chain_band_covering_matrix(rng):
    """A band that covers the matrix (1 + 2kh >= nb) is masked to
    |r - c| <= h with a select and applied densely, as
    matpow_pallas.apply_banded_chain does; NaN beyond the band must not
    leak."""
    n, bs, h = 1024, 128, 500
    assert 1 + 2 * -(-h // bs) >= n // bs
    t, r = _banded(rng, n, h)
    tp = t.copy()
    tp[np.abs(r[:, None] - r[None, :]) > h] = np.nan
    x = rng.random((8, n), dtype=np.float32)
    want = np.asarray(jmp.apply_banded_chain(
        jnp.asarray(x), jnp.asarray(tp), h, 3, bs=bs, interpret=True))
    got = tmk.apply_banded_chain(_t(x), _t(tp), h, 3, bs=bs).numpy()
    _rel_close(got, want, 1e-5)
    _rel_close(got, x @ t @ t @ t, 1e-5)


def test_apply_banded_chain_single_application_is_apply_banded(
        rng, monkeypatch):
    """n_apply == 1 goes through apply_banded (K4), never through the
    packed chain (K1 + K3), as matpow_pallas.apply_banded_chain does."""
    n, bs, h = 1024, 128, 130
    t, r = _banded(rng, n, h)
    tp = _poison_blocks(t, r, h, bs)
    x = rng.random((8, n), dtype=np.float32)
    calls = []
    plain = tmk.apply_banded_plain

    def spy(*args, **kw):
        calls.append(args[2])
        return plain(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the packed chain ran for one application")

    monkeypatch.setattr(tmk, "apply_banded_plain", spy)
    monkeypatch.setattr(tmk, "pack_banded", refuse)
    monkeypatch.setattr(tmk, "packed_chain", refuse)
    got = tmk.apply_banded_chain(_t(x), _t(tp), h, 1, bs=bs).numpy()
    assert calls == [h]
    want = np.asarray(jmp.apply_banded_chain(
        jnp.asarray(x), jnp.asarray(tp), h, 1, bs=bs, interpret=True))
    _rel_close(got, want, 1e-5)


@pytest.mark.parametrize("exp_times", [3, 8])
def test_pure_squaring_matches_jax(rng, exp_times):
    """The dense route at square_times=None (the reference's pure
    squaring): K6 then exp_times - 1 K5 through their twins, vs the JAX
    transition_matrix and propagate (cap 16, n_pad 1024)."""
    cap = 16
    edge = np.ones((cap, cap), np.float32)
    edge[:13, :11] = rng.random((13, 11)).astype(np.float32)
    cam = np.zeros((3, cap, cap), np.float32)
    cam[:, :13, :11] = rng.random((3, 13, 11))
    jg = jrw.build_geometry(cap, cap, radius=5)
    tg = trw.build_geometry(cap, cap, radius=5)
    assert tg.n_pad == 1024
    a = trw.dense_affinity(tg, _t(edge))
    want_t = np.asarray(jrw.transition_matrix(jnp.asarray(a.numpy()), 10,
                                              exp_times))
    got_t = trw.transition_matrix(a, 10, exp_times).numpy()
    _rel_close(got_t, want_t, 1e-4)
    want = np.asarray(jrw.propagate(jg, cam, edge, beta=10,
                                    exp_times=exp_times))
    got = trw.propagate(tg, _t(cam), _t(edge), beta=10,
                        exp_times=exp_times).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
