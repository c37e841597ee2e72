"""The redesigned K2 and K3 around their kernels, on the CPU: K2's band
split and split-product twins against the JAX banded squaring, K3's launch
plan, entry shares, occupancy and ELL helpers, and the directories the port's
``run_pipeline`` creates against the JAX one's.

Tolerances are stated per test: the split twins sum exact bf16 products
in f64 and round once, so they differ from an f32 product only in the last
bits of its sum."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import matpow_pallas as jmp
from irn_tpu.pipeline import run as jax_run
from irn_tpu.pipeline.config import Config as JaxConfig
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import matpow_kernels as tmk
from irn_tpu_torch.ops import random_walk as trw
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline.config import Config

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach a kernel: every launch counter stays 0."""
    _build.reset_launches()
    yield
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


def _banded(rng, n, h):
    """A random band matrix (|r - c| <= h) with entries in [0.01, 1)."""
    r = np.arange(n)
    band = np.abs(r[:, None] - r[None, :]) <= h
    return np.where(band, rng.uniform(0.01, 1.0, (n, n)), 0.0).astype(
        np.float32)


def _poison(t, h, bs):
    """T with NaN in every bs x bs block beyond kb = ceil(h/bs)."""
    bi = np.arange(t.shape[0]) // bs
    out = t.copy()
    out[np.abs(bi[:, None] - bi[None, :]) > -(-h // bs)] = np.nan
    return out


def _dirs(root):
    return sorted(os.path.relpath(d, root) for d, _, _ in os.walk(root))


def test_run_pipeline_creates_the_jax_directories(tmp_path, monkeypatch):
    """With every pass off, the port's run_pipeline and the JAX one leave
    the same directories (session_dir and the four output directories)
    from the same relative Config."""
    trees = {}
    for tag, run in (("jax", lambda: jax_run.run_pipeline(JaxConfig())),
                     ("port", lambda: port_run.run_pipeline(Config(), "cpu"))):
        root = tmp_path / tag
        root.mkdir()
        monkeypatch.chdir(root)
        run()
        trees[tag] = _dirs(str(root))
    assert trees["port"] == trees["jax"]
    assert {"sess", "result/cam", "result/ir_label", "result/sem_seg",
            "result/ins_seg"} <= set(trees["port"])


@pytest.mark.parametrize("n,h,bs", [(1024, 130, 128), (1536, 200, 128),
                                    (1024, 60, 256)])
def test_split_banded_pieces(rng, n, h, bs):
    """K2's band split twin: L's pieces sum (hi + mid + lo, in f32) to T's
    in-band row bands and Rt's to its column bands transposed, exactly;
    band positions past the matrix edge are zero; NaN planted beyond the
    band is never read."""
    t = _banded(rng, n, h)
    pieces = tmk.split_banded_plain(torch.from_numpy(_poison(t, h, bs)), h, bs)
    nb, kb = n // bs, -(-h // bs)
    w = (2 * kb + 1) * bs
    assert pieces.shape == (6, n, w) and pieces.dtype == torch.bfloat16
    assert bool(torch.isfinite(pieces.float()).all())
    lsum = ((pieces[0].float() + pieces[1].float()) + pieces[2].float()).numpy()
    rsum = ((pieces[3].float() + pieces[4].float()) + pieces[5].float()).numpy()
    tpad = np.pad(t, kb * bs)  # block (i, k) of t at (i + kb, k + kb)
    for i in range(nb):
        rows = slice(i * bs, (i + 1) * bs)
        np.testing.assert_array_equal(
            lsum[rows], tpad[(i + kb) * bs : (i + kb + 1) * bs,
                             i * bs : i * bs + w])
        np.testing.assert_array_equal(
            rsum[rows], tpad[i * bs : i * bs + w,
                             (i + kb) * bs : (i + kb + 1) * bs].T)


@pytest.mark.parametrize("n,h,bs", [(1536, 130, 128), (2048, 200, 256)])
def test_square_banded_split_product_matches_jax(rng, n, h, bs):
    """K2's split-product twin (six bf16 piece products per in-band block,
    summed in f64) against the f32 twin and the Pallas banded squaring in
    interpret mode, in band, within 1e-5 of max|T^2| (f32 sums in another
    order); NaN beyond the input band does not leak."""
    t = _banded(rng, n, h)
    assert not tmk._square_bands(n, h, bs)[3]  # the band is under the matrix
    got = tmk.square_banded_split_plain(
        torch.from_numpy(_poison(t, h, bs)), h, bs).numpy()
    plain = tmk.square_banded_plain(torch.from_numpy(t), h, bs).numpy()
    want = np.asarray(jmp.square_banded(jnp.asarray(t), h, bs=bs,
                                        interpret=True))
    r = np.arange(n)
    inband = np.abs(r[:, None] - r[None, :]) <= 2 * h
    tol = 1e-5 * float(np.abs(plain).max())
    assert np.isfinite(got[inband]).all()
    np.testing.assert_allclose(got[inband], plain[inband], rtol=0, atol=tol)
    np.testing.assert_allclose(got[inband], want[inband], rtol=0, atol=tol)
    exact = t.astype(np.float64) @ t.astype(np.float64)
    np.testing.assert_allclose(got[inband], exact[inband], rtol=0, atol=tol)


@pytest.mark.parametrize("n,bs,kh,sms", [
    (14336, 512, 3, 132), (18432, 512, 3, 132), (14336, 512, 2, 132),
    (69632, 512, 6, 132), (1024, 128, 2, 132), (2048, 64, 5, 132),
    (2048, 256, 2, 132), (14336, 512, 3, 64), (2048, 128, 3, 16),
    (2048, 64, 5, 7)])
def test_packed_chain_plan(n, bs, kh, sms):
    """K3's plan at the walk's geometries (the 96x128 and 128x128 buckets at
    e = 1, rw_grid_cap 256) and the GPU tests' shapes, on the H100's 132
    SMs and on smaller cards: every item in a CTA,
    no more CTAs than SMs, every CTA's items within its staged x blocks,
    one warp per quarter of up to 4 items, threads enough for the x
    prefetch, and shared memory filled with held entries up to the limit
    and not past it."""
    ctas, ipc, threads, x_blocks, seg, smem = tmk.packed_chain_plan(
        n, bs, kh, sms)
    strips = bs // tmk.PACKED_STRIP
    items = n // bs * strips
    assert ctas <= sms and ctas * ipc >= items > (ctas - 1) * ipc
    for b in range(ctas):
        last = min(b * ipc + ipc, items) - 1
        assert last // strips - b * ipc // strips + 1 <= x_blocks
    assert threads % 128 == 0 and threads <= tmk.PACKED_MAX_THREADS
    assert threads >= 128 * min(ipc, 4)
    assert x_blocks * tmk.PACKED_ROWS * bs // 4 <= (
        tmk.PACKED_PREFETCH * threads)
    assert smem == tmk._packed_smem(bs, kh, ipc, x_blocks, seg)
    assert smem <= tmk.PACKED_SMEM_MAX < smem + tmk.PACKED_ENTRY_BYTES
    if (n, bs, kh, sms) == (14336, 512, 3, 132):
        assert (ctas, ipc, threads, x_blocks) == (112, 4, 512, 1)


def test_packed_chain_plan_limits():
    """The plan raises with the shared-memory limit in its message when
    the fixed parts do not fit a CTA, and refuses a bs that is not a
    multiple of 64 or does not divide n."""
    with pytest.raises(ValueError, match="232448"):
        tmk.packed_chain_plan(512 * 512, 512, 3, 2)
    with pytest.raises(ValueError, match="30000"):
        tmk.packed_chain_plan(14336, 512, 3, 132, smem_max=30000)
    for n, bs in ((1024, 96), (1000, 128)):
        with pytest.raises(ValueError, match="multiple"):
            tmk.packed_chain_plan(n, bs, 2, 132)


def test_packed_chain_held_plain():
    """Each item of a CTA holds up to an equal share of the entry slots
    left; what a small item leaves goes to the items after it."""
    plan = (2, 3, 384, 1, 10, 0)
    assert tmk.packed_chain_held_plain([1, 20, 20, 9, 0, 3], plan) == [
        1, 4, 5, 3, 0, 3]
    assert tmk.packed_chain_held_plain([5, 5], (1, 3, 384, 1, 100, 0)) == [
        5, 5]


@pytest.mark.parametrize("cap,radius,bs", [((24, 24), 2, 128),
                                           ((32, 32), 5, 128),
                                           ((32, 32), 5, 256)])
def test_packed_occupancy_of_t2_tiles(rng, cap, radius, bs):
    """The plain occupancy helper on the packed T^2 tiles of a walk
    geometry: a row segment it marks empty holds only zeros, one it marks
    occupied holds a nonzero, and some are empty (at these small grid
    widths T^2's diagonal clusters are closer together than a strip; at
    the 96x128 bucket only ~21% of the segments are occupied)."""
    geom = trw.build_geometry(*cap, radius=radius)
    h = trw.band_halfwidth(geom)
    edge = torch.from_numpy(rng.random(cap, dtype=np.float32) * 0.9)
    t = trw.normalize_transition(trw.dense_affinity(geom, edge))
    assert trw.banded_fits(geom, 8, 1, bs)
    tp = tmk.pack_banded(tmk.square_banded(t, h, bs), 2 * h, bs)
    occ = tmk.packed_occupancy_plain(tp)
    nb, span, _ = tp.shape
    assert occ.shape == (nb, bs // 32, span)
    segs = tp.reshape(nb, span, bs // 32, 32).transpose(1, 2)
    nonzero = (segs != 0).any(-1)
    assert torch.equal(occ, nonzero)
    assert not bool((segs[~occ] != 0).any())
    assert 0.0 < float(occ.float().mean()) < 1.0
    # the ELL length of a quarter-slot: the most nonzeros any column of the
    # strip holds over the slot's quarter of rows, at most bs/4; the entries
    # cover every nonzero
    ell = tmk.packed_ell_plain(tp)
    nslot = span // bs
    assert ell.shape == (nb, bs // 32, nslot, 4)
    cols = (tp != 0).reshape(nb, nslot, 4, bs // 4, bs // 32, 32).sum(3)
    for j, strip, m, u in ((0, 0, nslot // 2, 1), (nb // 2, 1, 0, 3)):
        assert int(ell[j, strip, m, u]) == int(cols[j, m, u, strip].max())
    assert int(ell.max()) <= bs // 4
    assert int(ell.sum()) * 32 >= int((tp != 0).sum())
    # NaN counts as occupied
    tp[0, 5, 3] = float("nan")
    assert bool(tmk.packed_occupancy_plain(tp)[0, 0, 5])
