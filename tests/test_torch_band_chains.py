"""K7 and K8 on K3's chain body, around their kernels, on the CPU: K7's ELL
lengths read straight from the masked dense T against K1's tiles of the
same T, the chain plan at several images (K8), and the twins of K7 and K8
against the JAX functions with NaN where their kernels must not read.

Tolerances are stated per test: the twins sum in another order than the
Pallas kernels, so f32 sums differ in their last bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import matpow_pallas as jmp
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import matpow_kernels as tmk
from irn_tpu_torch.tools import bench_chains

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach a kernel: every launch counter stays 0."""
    _build.reset_launches()
    yield
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


def _banded(rng, n, h):
    """A column-stochastic band matrix (|r - c| <= h), true zeros outside."""
    r = np.arange(n)
    t = np.where(np.abs(r[:, None] - r[None, :]) <= h,
                 rng.uniform(0.01, 1.0, (n, n)), 0.0).astype(np.float32)
    return t / t.sum(0, keepdims=True)


def _nan_beyond(t, h, bs, near=True):
    """T with NaN in every bs x bs block beyond kb = ceil(h/bs) (K2's
    unspecified fill) and, with ``near``, between h and that block band's
    edge too (where K1's tiles would carry it)."""
    r = np.arange(t.shape[0])
    bi = r // bs
    d = np.abs(r[:, None] - r[None, :])
    blocks = np.abs(bi[:, None] - bi[None, :]) > -(-h // bs)
    out = t.copy()
    out[blocks | ((d > h) if near else False)] = np.nan
    return out


def _masked(t, h):
    r = np.arange(t.shape[0])
    return np.where(np.abs(r[:, None] - r[None, :]) <= h, t, 0.0).astype(
        np.float32)


@pytest.mark.parametrize("n,h,bs", [(1024, 130, 128), (1024, 60, 64),
                                    (1536, 260, 128), (2048, 200, 256),
                                    (1024, 400, 128)])
def test_banded_ell_plain_is_k1_tiles_ell(rng, n, h, bs):
    """K7's ELL lengths over the dense T masked to its band (a select, NaN
    planted beyond h) equal K3's over K1's tiles of the masked T; NaN inside
    the band counts as a nonzero in both."""
    t = _banded(rng, n, h)
    t[n // 2, n // 2 + h // 2] = np.nan  # in band: counted
    got = tmk.banded_ell_plain(torch.from_numpy(_nan_beyond(t, h, bs)), h, bs)
    want = tmk.packed_ell_plain(tmk.pack_banded_plain(
        torch.from_numpy(_masked(t, h)), h, bs))
    assert got.shape == want.shape == (n // bs, bs // 32, 2 * -(-h // bs) + 1,
                                       4)
    assert torch.equal(got, want)
    assert int(got.sum()) > 0


# the parent's K3 plan (one image) at the walk's and the GPU tests' shapes
K3_PLANS = {
    (14336, 512, 3, 132): (112, 4, 512, 1, 1013, 232384),
    (18432, 512, 3, 132): (116, 5, 512, 2, 900, 232448),
    (69632, 512, 6, 132): (128, 17, 512, 2, 547, 232448),
    (1024, 128, 2, 132): (32, 1, 128, 1, 1161, 232320),
    (2048, 64, 5, 132): (64, 1, 128, 1, 1171, 232384),
    (14336, 512, 3, 64): (64, 7, 512, 2, 844, 232448),
    (2048, 64, 5, 7): (7, 10, 512, 5, 870, 232320),
    (1024, 128, 2, 2): (2, 16, 512, 4, 682, 232320),
}


@pytest.mark.parametrize("shape", sorted(K3_PLANS))
def test_packed_chain_plan_one_image_is_k3s(shape):
    """At one image the chain plan is K3's plan as it was before K7 and K8
    took its body, and one launch holds that image."""
    plan = tmk.packed_chain_plan(*shape, images=1)
    assert plan == K3_PLANS[shape]
    n, bs = shape[:2]
    assert tmk.packed_chain_images(plan, n, bs) == 1
    assert tmk.packed_chain_groups(1, plan, n, bs) == [(0, 1)]


def _cta_items(plan, n, bs, images):
    """Each CTA of one launch of ``images`` images: (image, its items), as
    the kernel deals them (image = CTA // cpi, first item (CTA % cpi) * ipc
    of that image)."""
    items = n // bs * (bs // 32)
    ctas, ipc = plan[:2]
    cpi = ctas // tmk.packed_chain_images(plan, n, bs)
    return [(b // cpi, range((b % cpi) * ipc,
                             min((b % cpi) * ipc + ipc, items)))
            for b in range(cpi * images)]


@pytest.mark.parametrize("n,bs,kh,sms,images", [
    (14336, 512, 3, 132, 2), (14336, 512, 3, 132, 4), (14336, 512, 3, 132, 5),
    (18432, 512, 3, 132, 4), (14336, 512, 3, 132, 8), (1024, 128, 3, 132, 5),
    (1024, 128, 3, 2, 5), (1024, 128, 3, 3, 5), (2048, 64, 5, 16, 3),
    (14336, 512, 3, 132, 24)])
def test_packed_chain_plan_images(n, bs, kh, sms, images):
    """The plan at several images: no more CTAs than SMs; every image's
    items dealt once over its own CTAs and no CTA's items crossing an
    image, within the CTA's staged x blocks; the image groups of its
    launches cover the batch exactly once, each group's size at most the
    plan's and all but the last equal; shared memory filled up to the
    limit and not past it."""
    plan = tmk.packed_chain_plan(n, bs, kh, sms, images)
    ctas, ipc, threads, x_blocks, slots, smem = plan
    strips = bs // 32
    items = n // bs * strips
    group = tmk.packed_chain_images(plan, n, bs)
    assert 1 <= group <= images and ctas <= sms and ctas % group == 0
    groups = tmk.packed_chain_groups(images, plan, n, bs)
    covered = [b for first, count in groups
               for b in range(first, first + count)]
    assert covered == list(range(images))
    assert all(count == group for _, count in groups[:-1])
    assert 1 <= groups[-1][1] <= group
    seen = {}
    for img, its in _cta_items(plan, n, bs, group):
        assert len(its) <= ipc
        if len(its):
            assert its[-1] // strips - its[0] // strips + 1 <= x_blocks
        for i in its:
            seen[(img, i)] = seen.get((img, i), 0) + 1
    assert seen == {(b, i): 1 for b in range(group) for i in range(items)}
    assert threads % 128 == 0 and threads <= tmk.PACKED_MAX_THREADS
    assert x_blocks * tmk.PACKED_ROWS * bs // 4 <= (
        tmk.PACKED_PREFETCH * threads)
    assert smem == tmk._packed_smem(bs, kh, ipc, x_blocks, slots)
    assert smem <= tmk.PACKED_SMEM_MAX < smem + tmk.PACKED_ENTRY_BYTES
    if (n, bs, kh, sms, images) == (14336, 512, 3, 132, 4):
        # the smoke run's batch: one launch of 4 groups of 32 CTAs
        assert plan[:4] == (128, 14, 512, 2) and len(groups) == 1
    # the fewest launches that fit: no fewer equal groups fit one wave
    for launches in range(1, len(groups)):
        assert tmk._group_plan(n, bs, kh, sms, -(-images // launches),
                               tmk.PACKED_SMEM_MAX)[0] is None


@pytest.mark.parametrize("images", [1, 4])
def test_packed_chain_plan_image_limit(images):
    """When one image does not fit a CTA's shared memory or threads, the
    plan raises with the limit in its message, at any image count; an image
    count below 1 is refused."""
    with pytest.raises(ValueError, match="232448"):
        tmk.packed_chain_plan(512 * 512, 512, 3, 2, images)
    with pytest.raises(ValueError, match="30000"):
        tmk.packed_chain_plan(14336, 512, 3, 132, images, smem_max=30000)
    for bad in (0, -images):
        with pytest.raises(ValueError, match="images"):
            tmk.packed_chain_plan(14336, 512, 3, 132, bad)


@pytest.mark.parametrize("n,bj,near", [(1024, 256, True), (2048, 512, True),
                                       (1024, 256, False)])
def test_banded_chain_twin_drops_nan_near_band(rng, n, bj, near):
    """K7's twin against the Pallas rectangular-tile chain (interpret mode)
    on a T with NaN beyond the block band and, with ``near``, between h and
    the block band's edge: both mask with a select, so the result is finite
    and within rel 1e-5 (sums in another order); and within rel 1e-5 of
    K1 + K3's twin on the masked T without NaN."""
    bs, h = 128, 130
    t = _banded(rng, n, h)
    tn = _nan_beyond(t, h, bs, near)
    x = rng.random((8, n), dtype=np.float32)
    want = np.asarray(jmp.apply_banded_chain(
        jnp.asarray(x), jnp.asarray(tn), h, 4, bs=bs, bj=bj, interpret=True))
    got = tmk.banded_chain(torch.from_numpy(x), torch.from_numpy(tn), h, 4,
                           bs, bj).numpy()
    assert np.isfinite(got).all()
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    k13 = tmk.packed_chain(torch.from_numpy(x), tmk.pack_banded(
        torch.from_numpy(_masked(t, h)), h, bs), 4, bs).numpy()
    np.testing.assert_allclose(got, k13, rtol=0, atol=tol)


def test_bench_chains_needs_a_card(monkeypatch):
    """The chains' timing tool measures the card only: without CUDA it
    raises before it builds or runs anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench_chains.main([])
