"""The batched banded chain (K8) and ``propagate_banded_batch`` vs the JAX
package on the same numpy inputs (CPU).

K8 ``packed_chain_batched`` runs its plain twin here (each image's windowed
bmm); the Pallas ``apply_banded_chain_batched`` runs in interpret mode.
Tolerances: f32 sums taken in another order differ in the last bits, so
the port is held within rel 1e-5 of max|want| over a 4-application chain;
the twin against the port's own per-image chain, the same arithmetic, is
held bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import matpow_pallas as jmp
from irn_tpu.ops import random_walk as jrw
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import matpow_kernels as tmk
from irn_tpu_torch.ops import random_walk as trw

torch.set_num_threads(2)

N, BS, H, BIMG = 1024, 128, 130, 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel_close(got, want, rtol):
    """max |got - want| <= rtol * max |want|, all finite."""
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach a kernel: every launch counter stays 0."""
    _build.reset_launches()
    yield
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


def _batch(rng, c=8):
    """B column-stochastic T's of band halfwidth H, with NaN in every block
    beyond kb = ceil(H/BS) (where square_banded leaves its output
    unspecified), and B seed matrices [c, N]."""
    r = np.arange(N)
    band = np.abs(r[:, None] - r[None, :]) <= H
    kb = -(-H // BS)
    far = np.abs((r // BS)[:, None] - (r // BS)[None, :]) > kb
    ts, xs = [], []
    for _ in range(BIMG):
        t = np.zeros((N, N), np.float32)
        t[band] = rng.random(band.sum(), dtype=np.float32) * 0.01
        t /= t.sum(0, keepdims=True)
        t[far] = np.nan
        ts.append(t)
        xs.append(rng.random((c, N), dtype=np.float32))
    return np.stack(xs), np.stack(ts)


def test_batched_chain_matches_jax(rng):
    """K8's route (K1 per image, then the batched twin) vs the Pallas
    apply_banded_chain_batched (interpret mode), NaN beyond the band."""
    xs, ts = _batch(rng)
    want = np.asarray(jmp.apply_banded_chain_batched(
        jnp.asarray(xs), jnp.asarray(ts), H, 4, bs=BS, interpret=True))
    got = tmk.apply_banded_chain_batched(_t(xs), _t(ts), H, 4, BS).numpy()
    assert got.shape == (BIMG, 8, N)
    _rel_close(got, want, 1e-5)


def test_batched_twin_bit_equal_to_per_image_chain(rng):
    """Each image of the batched twin equals the port's per-image
    apply_banded_chain (K1 + K3's twins) bit for bit, from a [B, n, n]
    tensor and from a generator of T's alike."""
    xs, ts = _batch(rng)
    got = tmk.apply_banded_chain_batched(_t(xs), _t(ts), H, 4, BS).numpy()
    lazy = tmk.apply_banded_chain_batched(
        _t(xs), (_t(t) for t in ts), H, 4, BS).numpy()
    np.testing.assert_array_equal(lazy, got)
    tps = torch.stack([tmk.pack_banded(_t(t), H, BS) for t in ts])
    np.testing.assert_array_equal(
        tmk.packed_chain_batched(_t(xs), tps, 4, BS).numpy(), got)
    for b in range(BIMG):
        one = tmk.apply_banded_chain(_t(xs[b]), _t(ts[b]), H, 4, bs=BS)
        np.testing.assert_array_equal(one.numpy(), got[b], err_msg=str(b))


def test_batched_chain_raises_as_jax(rng):
    """The ValueErrors of apply_banded_chain_batched: n % bs, C % 8, and a
    band that does not fit (1 + 2kh >= nkb; no dense fallback)."""
    xs, ts = _batch(rng)
    for args in ((xs[:, :, :1000], ts[:, :1000, :1000], H),  # n % bs
                 (np.concatenate([xs, xs[:, :4]], 1), ts, H),  # C % 8
                 (xs, ts, 400)):                               # band
        with pytest.raises(ValueError):
            jmp.apply_banded_chain_batched(
                jnp.asarray(args[0]), jnp.asarray(args[1]), args[2], 4,
                bs=BS, interpret=True)
        with pytest.raises(ValueError):
            tmk.apply_banded_chain_batched(_t(args[0]), _t(args[1]),
                                           args[2], 4, BS)
    with pytest.raises(ValueError):  # one T short of the batch
        tmk.apply_banded_chain_batched(_t(xs), _t(ts[:-1]), H, 4, BS)


def _scene(rng, geom_cap=24, extent=20):
    """The 24x24, radius-2 scene of
    tests/test_random_walk.py::test_batched_apply_chain_matches_per_image."""
    edges = np.ones((BIMG, geom_cap, geom_cap), np.float32)
    edges[:, :extent, :extent] = rng.random(
        (BIMG, extent, extent)).astype(np.float32)
    cams = np.zeros((BIMG, 3, geom_cap, geom_cap), np.float32)
    cams[:, :, :extent, :extent] = rng.random((BIMG, 3, extent, extent))
    return cams, edges


@pytest.mark.parametrize("exp_times,square_times,fits", [
    (3, 1, True),   # the batched chain: K2, K1 per image, then K8
    (3, 0, True),   # the diagonal stencil (K0) per image
    (4, 4, False),  # the band (29 << 4) outgrows the matrix: dense per image
])
def test_propagate_banded_batch_matches_jax(rng, exp_times, square_times,
                                            fits):
    """propagate_banded_batch vs the JAX function (interpret mode) on each
    of its three routes; within rel 1e-5 of max|want|, and each image equal
    to the port's propagate_banded of that image."""
    jg = jrw.build_geometry(24, 24, radius=2)
    tg = trw.build_geometry(24, 24, radius=2)
    bs = 128
    assert trw.banded_fits(tg, exp_times, square_times, bs) == fits
    assert jrw.banded_fits(jg, exp_times, square_times, bs) == fits
    cams, edges = _scene(rng)
    want = np.asarray(jrw.propagate_banded_batch(
        jg, jnp.asarray(cams), jnp.asarray(edges), beta=10,
        exp_times=exp_times, square_times=square_times, bs=bs,
        interpret=True))
    got = trw.propagate_banded_batch(tg, _t(cams), _t(edges), beta=10,
                                     exp_times=exp_times,
                                     square_times=square_times, bs=bs).numpy()
    assert got.shape == cams.shape
    _rel_close(got, want, 1e-5)
    for b in range(BIMG):
        one = trw.propagate_banded(tg, _t(cams[b]), _t(edges[b]), beta=10,
                                   exp_times=exp_times,
                                   square_times=square_times, bs=bs).numpy()
        np.testing.assert_array_equal(one, got[b], err_msg=str(b))


def test_propagate_banded_batch_stencil_runs_no_chain(rng, monkeypatch):
    """At e = 0 the batch goes through the stencil per image and never
    through a matmul chain (the JAX function's vmapped propagate_diag)."""
    def refuse(*args, **kw):
        raise AssertionError("a matmul chain ran at square_times=0")

    monkeypatch.setattr(tmk, "apply_banded_chain_batched", refuse)
    monkeypatch.setattr(tmk, "packed_chain_batched", refuse)
    monkeypatch.setattr(tmk, "square_banded", refuse)
    tg = trw.build_geometry(24, 24, radius=2)
    cams, edges = _scene(rng)
    got = trw.propagate_banded_batch(tg, _t(cams), _t(edges), beta=10,
                                     exp_times=3, square_times=0, bs=128)
    want = trw.propagate_diag(tg, _t(cams[1]), _t(edges[1]), 10, 3)
    np.testing.assert_array_equal(got[1].numpy(), want.numpy())
