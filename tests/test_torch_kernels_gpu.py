"""The hand-written CUDA kernels vs their plain PyTorch twins on the card.

Marked ``gpu``: they need an NVIDIA card and nvcc, and skip without CUDA.
On the card host: ``python -m pytest tests/test_torch_kernels_gpu.py -q``.
Shapes are small; ``chip_smoke.py`` checks the main-path shapes."""

import functools

import numpy as np
import pytest
import torch

from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import crf_device
from irn_tpu_torch.ops import matpow
from irn_tpu_torch.ops import matpow_kernels as mk
from irn_tpu_torch.ops import random_walk as rw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.reset_launches()
    return torch.device("cuda")


def _banded(n, h, seed=0):
    g = np.random.default_rng(seed)
    r = np.arange(n)
    t = np.where(np.abs(r[:, None] - r[None, :]) <= h,
                 g.random((n, n), dtype=np.float32), 0.0).astype(np.float32)
    return torch.from_numpy(t / t.sum(0, keepdims=True))


@pytest.mark.parametrize("cap,c,n_apply", [
    ((32, 32), 5, 16), ((32, 32), 3, 16), ((32, 32), 21, 16),
    ((128, 128), 8, 64), ((32, 32), 8, 1), ((32, 32), 8, 2),
    ((256, 256), 3, 4)])
def test_diag_chain_bit_equal(cuda, cap, c, n_apply):
    """K0 bit-equal to its twin in one launch per chain: C not a multiple of
    the rows per cluster (3, 5, 21), the 32x32 grid whose largest offset
    (170) exceeds a CTA's 128-column slice, the 128x128 bucket (n 18432),
    one or two applications, and rw_grid_cap 256's largest bucket (n 69632,
    w read from L2)."""
    geom = rw.build_geometry(*cap, radius=5)
    g = np.random.default_rng(0)
    edge = torch.from_numpy(g.random(cap, dtype=np.float32)).to(cuda)
    w, inv = rw.build_diag_operator(geom, edge)
    x = torch.from_numpy(g.random((c, geom.n_pad), dtype=np.float32)).to(cuda)
    doffs = rw.diag_offsets(geom)
    got = rw.apply_diag_chain(x, w, inv, doffs, n_apply)
    want = rw.apply_diag_chain_plain(x, w, inv, doffs, n_apply)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["diag_chain"] == 1  # one per chain
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("rows,cluster,w_shared", [
    (1, 16, False), (2, 16, True), (4, 16, True), (4, 16, False),
    (1, 8, True), (2, 4, False)])
def test_diag_chain_plans_bit_equal(cuda, rows, cluster, w_shared):
    """Every launch plan gives the twin's bits: 1, 2 or 4 rows per cluster,
    16, 8 or 4 CTAs per cluster (slices of 128, 256, 512 columns against
    offsets up to 170), w in shared memory or from L2."""
    geom = rw.build_geometry(32, 32, radius=5)
    g = np.random.default_rng(1)
    edge = torch.from_numpy(g.random((32, 32), dtype=np.float32)).to(cuda)
    w, inv = rw.build_diag_operator(geom, edge)
    x = torch.from_numpy(g.random((7, geom.n_pad), dtype=np.float32)).to(cuda)
    doffs = rw.diag_offsets(geom)
    held = functools.partial(rw.diag_chain_max_clusters, cuda, 7,
                             geom.n_pad, doffs)
    plan = rw.diag_chain_plan(7, geom.n_pad, doffs, held, rows, cluster,
                              w_shared)
    assert plan[0] == rows and plan[4] == w_shared
    got = rw.launch_diag_chain(x, w, inv, doffs, 9, plan)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["diag_chain"] == 1
    assert torch.equal(got, rw.apply_diag_chain_plain(x, w, inv, doffs, 9))


def test_pack_banded_bit_equal(cuda):
    t = _banded(1024, 200).to(cuda)
    got = mk.pack_banded(t, 200, 128)
    assert torch.equal(got, mk.pack_banded_plain(t, 200, 128))
    assert _build.LAUNCHES["pack_banded"] == 1


@pytest.mark.parametrize("n", [1024, 2048])
def test_square_banded_in_band(cuda, n):
    """K2 (band split + six-product tensor-core product) within rel 1e-5 of
    its twin in band, with NaN in every input block beyond kb (never read);
    two launches; the split pass alone bit-equal to its twin."""
    h, bs = 130, 128
    t = _banded(n, h).to(cuda)
    got = mk.square_banded(_poisoned(t, h, bs), h, bs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["square_banded"] == 2  # split, product
    want = mk.square_banded_plain(t, h, bs)
    r = torch.arange(n, device=cuda)
    inband = (r[:, None] - r[None, :]).abs() <= 2 * h
    assert bool(torch.isfinite(got[inband]).all())
    torch.testing.assert_close(got[inband], want[inband], rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    pieces = mk.split_banded(_poisoned(t, h, bs), h, bs)
    assert _build.LAUNCHES["square_banded"] == 3
    assert torch.equal(pieces, mk.split_banded_plain(t, h, bs))


def test_square_banded_hgmma(cuda):
    """K2's SASS holds wgmma (HGMMA) instructions."""
    import chip_smoke

    assert chip_smoke.hgmma_counts(
        _build.cuobjdump_sass(_build.build()))["square_banded"] > 0


def test_packed_chain(cuda):
    n, h, bs = 1024, 130, 128
    t = _banded(n, h).to(cuda)
    x = torch.rand((12, n), generator=torch.Generator().manual_seed(0)).to(cuda)
    tp = mk.pack_banded(t, h, bs)
    got = mk.packed_chain(x, tp, 6, bs)
    want = mk.packed_chain_plain(x, tp, 6, bs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert _build.LAUNCHES["pack_banded"] == 1
    assert _build.LAUNCHES["packed_chain"] == 1  # one per chain


def _t2_tiles(n, h, bs, seed):
    """Packed tiles of T^2 (h doubled) from a banded T (the plain squaring,
    which takes any bs), NaN beyond the written block band of T^2, so only
    its in-band tiles are read."""
    t2 = mk.square_banded_plain(_banded(n, h, seed=seed).cuda(), h, bs)
    return mk.pack_banded(_poisoned(t2, 2 * h, bs), 2 * h, bs)


@pytest.mark.parametrize("tiles,c,bs", [
    ("full", 8, 128), ("t2", 8, 128), ("t2", 20, 128), ("t2", 8, 64),
    ("t2", 8, 256)])
def test_packed_chain_bit_equal_to_k8(cuda, tiles, c, bs):
    """K3 is torch.equal to K8 on each image, on tiles with no zero row
    (random everywhere) and on T^2 tiles (most row segments empty), at C 8
    and 20 (three seed-row groups) and bs 64, 128, 256; its per-item
    occupied rows and ELL lengths are the plain ones, its held entries the
    plain share's, also under a plan that holds few of them."""
    n, h, n_apply, bimg = 2048, 130, 5, 2
    g = torch.Generator().manual_seed(0)
    if tiles == "full":
        kh = -(-h // bs)
        tps = (torch.rand((bimg, n // bs, (2 * kh + 1) * bs, bs), generator=g)
               + 0.01).to(cuda) / n
    else:
        tps = torch.stack([_t2_tiles(n, h, bs, b) for b in range(bimg)])
    xs = torch.rand((bimg, c, n), generator=g).to(cuda)
    want = mk.packed_chain_batched(xs, tps, n_apply, bs)
    for b in range(bimg):
        got = mk.packed_chain(xs[b], tps[b], n_apply, bs)
        assert torch.equal(got, want[b])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["packed_chain"] == bimg
    kh = (tps.shape[2] // bs - 1) // 2
    plan = mk.card_packed_chain_plan(xs.device, n, bs, kh)
    out, stats, timing = mk.launch_packed_chain(xs[0], tps[0], n_apply, bs,
                                                plan)
    assert timing.shape == (plan[0], 5) and bool((timing >= 0).all())
    assert bool((timing[:, 3] > 0).any())  # products ran
    assert torch.equal(out, want[0])
    entries = mk.packed_ell_plain(tps[0]).sum((-2, -1)).flatten().tolist()
    stats = stats.cpu()
    assert stats[:, 0].tolist() == mk.packed_occupancy_plain(
        tps[0]).sum(-1).flatten().tolist()
    assert stats[:, 1].tolist() == entries
    assert stats[:, 2].tolist() == mk.packed_chain_held_plain(entries, plan)
    if tiles == "full":
        assert int(stats[:, 0].min()) == tps.shape[2]
    # a plan that holds 37 entries per CTA: the rest come from the scratch
    few = plan[:4] + (37, mk._packed_smem(bs, kh, plan[1], plan[3], 37))
    out, stats, _ = mk.launch_packed_chain(xs[0], tps[0], n_apply, bs, few)
    assert torch.equal(out, want[0])
    assert stats[:, 2].cpu().tolist() == mk.packed_chain_held_plain(entries,
                                                                     few)


def test_packed_chain_refused_launch_raises(cuda):
    """A cooperative launch of more CTAs than the card holds at once is
    refused, and the wrapper raises (no fallback, nothing counted)."""
    n, h, bs = 8192, 130, 128
    kh = -(-h // bs)
    _, sms = mk.packed_chain_occupancy(cuda, 128, 0)
    plan = mk.packed_chain_plan(n, bs, kh, n // bs * (bs // 32))
    assert plan[0] > sms and plan[1] == 1
    x = torch.rand((8, n), device=cuda)
    tp = torch.rand((n // bs, (2 * kh + 1) * bs, bs), device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        mk.launch_packed_chain(x, tp, 3, bs, plan)
    assert _build.LAUNCHES["packed_chain"] == 0


def _poisoned(t, h, bs):
    """T with every block beyond kb = ceil(h/bs) set to NaN (K2's
    unspecified fill)."""
    n = t.shape[0]
    kb = -(-h // bs)
    bi = torch.arange(n, device=t.device) // bs
    return torch.where((bi[:, None] - bi[None, :]).abs() > kb,
                       torch.full((), float("nan"), device=t.device), t)


@pytest.mark.parametrize("c", [8, 16])
def test_apply_banded(cuda, c):
    n, h, bs = 1024, 130, 128
    t = _banded(n, h).to(cuda)
    x = torch.rand((c, n), generator=torch.Generator().manual_seed(0)).to(cuda)
    got = mk.apply_banded(x, _poisoned(t, h, bs), h, bs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["apply_banded"] == 1
    torch.testing.assert_close(got, mk.apply_banded_plain(x, t, h, bs),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [384, 1024])
def test_square_dense(cuda, n):
    """K5 (identity split + six-product tensor-core product) within rel
    1e-5 of torch.matmul in f32, two launches per squaring; the split pass
    alone bit-equal to its twin."""
    t = _banded(n, n).to(cuda)  # dense, column-stochastic
    got = mk.square_dense(t)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["square_dense"] == 2  # split, product
    want = mk.square_dense_plain(t)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    matpow.matrix_power_squarings(t, 3)
    assert _build.LAUNCHES["square_dense"] == 2 * (1 + 3)
    pieces = mk.split_identity(t)
    assert _build.LAUNCHES["square_dense"] == 2 * (1 + 3) + 1
    assert torch.equal(pieces, mk.split_identity_plain(t))


def _affinity(n, lo=0.3, seed=0):
    """A symmetric affinity in [lo, 1) with a unit diagonal."""
    g = np.random.default_rng(seed)
    a = g.uniform(lo, 1.0, (n, n)).astype(np.float32)
    a = np.minimum(a, a.T)
    np.fill_diagonal(a, 1.0)
    return torch.from_numpy(a)


@pytest.mark.parametrize("n,lo", [(512, 0.3), (1024, 0.0), (4096, 0.3)])
def test_square_fused_first(cuda, n, lo):
    """K6 (split pass + six-product tensor-core product) vs its twin within
    rel 1e-5; lo 0.0 puts entries near 0 whose 10th power is subnormal or
    zero. The split pass alone is bit-equal to its plain twin."""
    a = _affinity(n, lo).to(cuda)
    got = mk.square_fused_first(a, 10)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["square_fused_first"] == 2  # split, product
    want = mk.square_fused_first_plain(a, 10)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    inv = 1.0 / torch.sum(mk.pow_int(a, 10), dim=0)
    pieces = mk.split_operands(a, inv, 10)
    assert _build.LAUNCHES["square_fused_first"] == 3
    assert torch.equal(pieces, mk.split_operands_plain(a, inv, 10))


def test_square_fused_first_refuses(cuda):
    """n not a multiple of the 128-row tile, or a non-square A, raises
    before any launch."""
    with pytest.raises(ValueError):
        mk.square_fused_first(_affinity(320).to(cuda), 10)
    with pytest.raises(ValueError):
        mk.square_fused_first(torch.ones((256, 128), device=cuda), 10)
    with pytest.raises(ValueError):
        mk.split_operands(_affinity(320).to(cuda), torch.ones(320, device=cuda))
    assert _build.LAUNCHES["square_fused_first"] == 0


def test_transition_matrix_runs_k6_then_k5(cuda):
    """The dense route on the card: one K6, then exp_times - 1 K5 (two
    launches each), and no twin."""
    geom = rw.build_geometry(16, 16, radius=5)
    g = np.random.default_rng(0)
    edge = torch.from_numpy(g.random((16, 16), dtype=np.float32)).to(cuda)
    a = rw.dense_affinity(geom, edge)
    got = rw.transition_matrix(a, 10, 4)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["square_fused_first"] == 2  # split, product
    assert _build.LAUNCHES["square_dense"] == 2 * 3
    want = rw.normalize_transition(a, 10)
    for _ in range(4):
        want = want @ want
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("n,bj", [(1024, 256), (2048, 512)])
def test_banded_chain(cuda, n, bj):
    h, bs = 130, 128
    t = _banded(n, h).to(cuda)
    x = torch.rand((8, n), generator=torch.Generator().manual_seed(0)).to(cuda)
    got = mk.banded_chain(x, _poisoned(t, h, bs), h, 6, bs, bj)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_chain"] == 1  # one per chain
    torch.testing.assert_close(got, mk.banded_chain_plain(x, t, h, 6),
                               rtol=1e-5, atol=1e-6)
    via = mk.apply_banded_chain(x, _poisoned(t, h, bs), h, 6, bs=bs, bj=bj)
    assert torch.equal(via, got)  # deterministic sums


def _nan_near_band(t, h, bs):
    """T with NaN between h and the block band's edge (where K1 + K3 would
    read it) and in every block beyond it."""
    n = t.shape[0]
    r = torch.arange(n, device=t.device)
    kb = -(-h // bs)
    near = ((r[:, None] - r[None, :]).abs() > h) & (
        (r[:, None] // bs - r[None, :] // bs).abs() <= kb)
    return torch.where(near, torch.full((), float("nan"), device=t.device),
                       _poisoned(t, h, bs))


@pytest.mark.parametrize("n,c,bs,bj", [(1024, 8, 128, 256),
                                       (2048, 24, 128, 512),
                                       (2048, 8, 256, 512)])
def test_banded_chain_select_mask_bit_equal_to_k1_k3(cuda, n, c, bs, bj):
    """K7 drops every element beyond h by a select before it counts a
    nonzero, so NaN between h and the tile edge and beyond the block band
    leaves its result finite, within rel 1e-5 of its twin, and torch.equal
    to K1 + K3 on the same T without that NaN; its per-item ELL lengths are
    banded_ell_plain's and its held entries the plain share's, under the
    card's plan and a plan that holds 37 entries per CTA."""
    h = 130
    t = _banded(n, h, seed=3).to(cuda)
    x = torch.rand((c, n), generator=torch.Generator().manual_seed(1)).to(cuda)
    tn = _nan_near_band(t, h, bs)
    got = mk.banded_chain(x, tn, h, 5, bs, bj)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_chain"] == 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, mk.banded_chain_plain(x, tn, h, 5),
                               rtol=1e-5, atol=1e-6)
    tp = mk.pack_banded(t, h, bs)
    assert torch.equal(got, mk.packed_chain(x, tp, 5, bs))
    kh = -(-h // bs)
    plan = mk.card_packed_chain_plan(cuda, n, bs, kh)
    entries = mk.banded_ell_plain(tn, h, bs).sum((-2, -1)).flatten().tolist()
    few = plan[:4] + (37, mk._packed_smem(bs, kh, plan[1], plan[3], 37))
    for p_ in (plan, few):
        out, stats, timing = mk.launch_banded_chain(x, tn, h, 5, bs, p_)
        assert torch.equal(out, got)
        assert timing.shape == (p_[0], 5)
        stats = stats.cpu()
        assert stats[:, 0].tolist() == mk.packed_occupancy_plain(
            tp).sum(-1).flatten().tolist()
        assert stats[:, 1].tolist() == entries
        assert stats[:, 2].tolist() == mk.packed_chain_held_plain(entries, p_)


def test_single_application_launches_apply_banded(cuda):
    """n_apply == 1 through apply_banded_chain launches K4 once and neither
    K1 nor K3."""
    n, h, bs = 1024, 130, 128
    t = _banded(n, h).to(cuda)
    x = torch.rand((8, n), generator=torch.Generator().manual_seed(0)).to(cuda)
    got = mk.apply_banded_chain(x, _poisoned(t, h, bs), h, 1, bs=bs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["apply_banded"] == 1
    assert _build.LAUNCHES["pack_banded"] == 0
    assert _build.LAUNCHES["packed_chain"] == 0
    torch.testing.assert_close(got, x @ t, rtol=1e-5, atol=1e-6)


def test_kernels_refuse_non_f32(cuda):
    t = _banded(512, 60).to(cuda).to(torch.float64)
    x = torch.zeros((8, 512), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        mk.pack_banded(t, 60, 128)
    with pytest.raises(TypeError):
        mk.square_banded(t, 60, 128)
    with pytest.raises(TypeError):
        mk.apply_banded(x, t, 60, 128)
    with pytest.raises(TypeError):
        mk.square_dense(t)
    with pytest.raises(TypeError):
        mk.square_fused_first(t, 10)
    with pytest.raises(TypeError):
        mk.banded_chain(x, t, 60, 2, 128, 256)


def test_packed_chain_batched_bit_equal_to_k3(cuda):
    """K8 on B = 3 images, each with its own T (NaN beyond the block band,
    read only through K1): each image bit-equal to K3 on it, all within rel
    1e-5 of the twin; one launch for the whole batch's chain."""
    n, h, bs, bimg, n_apply = 1024, 130, 128, 3, 6
    ts = [_poisoned(_banded(n, h, seed=b).to(cuda), h, bs) for b in range(bimg)]
    xs = torch.rand((bimg, 8, n),
                    generator=torch.Generator().manual_seed(0)).to(cuda)
    got = mk.apply_banded_chain_batched(xs, ts, h, n_apply, bs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pack_banded"] == bimg
    assert _build.LAUNCHES["packed_chain_batched"] == 1  # one per chain
    assert _build.LAUNCHES["packed_chain"] == 0
    tps = torch.stack([mk.pack_banded(t, h, bs) for t in ts])
    torch.testing.assert_close(
        got, mk.packed_chain_batched_plain(xs, tps, n_apply, bs),
        rtol=1e-5, atol=1e-6)
    for b in range(bimg):
        assert torch.equal(got[b], mk.packed_chain(xs[b], tps[b], n_apply, bs))
    assert _build.LAUNCHES["packed_chain"] == bimg  # one per chain


def test_propagate_banded_batch_launches_k8(cuda):
    """propagate_banded_batch at e = 1 runs one K8 chain for the batch and
    no K3; each image bit-equal to propagate_banded of that image."""
    geom = rw.build_geometry(24, 24, radius=2)
    g = np.random.default_rng(0)
    edges = torch.from_numpy(g.random((2, 24, 24), dtype=np.float32)).to(cuda)
    cams = torch.from_numpy(g.random((2, 3, 24, 24), dtype=np.float32)).to(cuda)
    got = rw.propagate_banded_batch(geom, cams, edges, 10, 3, square_times=1,
                                    bs=128)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["packed_chain_batched"] == 1
    assert _build.LAUNCHES["packed_chain"] == 0
    for b in range(2):
        assert torch.equal(got[b], rw.propagate_banded(
            geom, cams[b], edges[b], 10, 3, square_times=1, bs=128))


def _k8_inputs(cuda, bimg, c, n=1024, h=130, bs=128):
    """B images' packed T^2 tiles (NaN beyond the written block band) and
    seed rows."""
    tps = torch.stack([_t2_tiles(n, h, bs, b) for b in range(bimg)])
    xs = torch.rand((bimg, c, n),
                    generator=torch.Generator().manual_seed(bimg)).to(cuda)
    return xs, tps


@pytest.mark.parametrize("bimg", [1, 2, 5])
@pytest.mark.parametrize("c", [8, 24])
def test_packed_chain_batched_one_launch(cuda, bimg, c):
    """K8 at B 1, 2 and 5, C 8 and 24 (make_sem_seg's 21 classes padded):
    one cooperative launch for the batch, each image torch.equal to K3 on
    it; per-image stats are K3's plain counts and share."""
    n, bs, n_apply = 1024, 128, 5
    xs, tps = _k8_inputs(cuda, bimg, c)
    kh = (tps.shape[2] // bs - 1) // 2
    plan = mk.card_packed_chain_plan(cuda, n, bs, kh, bimg)
    assert mk.packed_chain_images(plan, n, bs) == bimg
    got, stats, timing = mk.launch_packed_chain_batched(xs, tps, n_apply, bs,
                                                        plan)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["packed_chain_batched"] == 1
    assert timing.shape == (plan[0], 5) and bool((timing[:, 3] > 0).any())
    assert torch.equal(got, mk.packed_chain_batched(xs, tps, n_apply, bs))
    assert _build.LAUNCHES["packed_chain_batched"] == 2
    stats = stats.cpu()
    for b in range(bimg):
        assert torch.equal(got[b], mk.packed_chain(xs[b], tps[b], n_apply, bs))
        entries = mk.packed_ell_plain(tps[b]).sum((-2, -1)).flatten().tolist()
        assert stats[b, :, 1].tolist() == entries
        assert stats[b, :, 2].tolist() == mk.packed_chain_held_plain(entries,
                                                                     plan)
    assert _build.LAUNCHES["packed_chain"] == bimg


@pytest.mark.parametrize("sms,slots", [(2, None), (2, 37), (3, 37)])
def test_packed_chain_batched_image_groups(cuda, sms, slots):
    """A plan for a card of 2 or 3 SMs cannot hold 5 images in one wave:
    K8 runs them as consecutive launches of image groups, each with its own
    barrier counter (groups of 2, 2, 1 at 2 SMs, of 3, 2 at 3), also under a
    plan that holds only 37 entries per CTA; each image torch.equal to
    K3."""
    n, bs, bimg, n_apply = 1024, 128, 5, 4
    xs, tps = _k8_inputs(cuda, bimg, 8)
    kh = (tps.shape[2] // bs - 1) // 2
    plan = mk.packed_chain_plan(n, bs, kh, sms, bimg)
    if slots is not None:
        plan = plan[:4] + (slots, mk._packed_smem(bs, kh, plan[1], plan[3],
                                                  slots))
    groups = mk.packed_chain_groups(bimg, plan, n, bs)
    assert len(groups) == {2: 3, 3: 2}[sms]
    got, stats, _ = mk.launch_packed_chain_batched(xs, tps, n_apply, bs, plan)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["packed_chain_batched"] == len(groups)
    for b in range(bimg):
        assert torch.equal(got[b], mk.packed_chain(xs[b], tps[b], n_apply, bs))
        entries = mk.packed_ell_plain(tps[b]).sum((-2, -1)).flatten().tolist()
        assert stats[b, :, 2].cpu().tolist() == mk.packed_chain_held_plain(
            entries, plan)


def test_packed_chain_batched_refused_launch_raises(cuda):
    """A K8 plan of more CTAs than the card holds at once is refused: the
    wrapper raises, counts nothing, and the next launch runs (the error was
    not left behind)."""
    n, h, bs, bimg = 8192, 130, 128, 2
    kh = -(-h // bs)
    _, sms = mk.packed_chain_occupancy(cuda, 128, 0)
    items = n // bs * (bs // 32)
    plan = mk.packed_chain_plan(n, bs, kh, bimg * items, bimg)
    assert plan[0] > sms and mk.packed_chain_images(plan, n, bs) == bimg
    xs = torch.rand((bimg, 8, n), device=cuda)
    tps = torch.rand((bimg, n // bs, (2 * kh + 1) * bs, bs), device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        mk.launch_packed_chain_batched(xs, tps, 3, bs, plan)
    assert _build.LAUNCHES["packed_chain_batched"] == 0
    xs, tps = _k8_inputs(cuda, bimg, 8)
    got = mk.packed_chain_batched(xs, tps, 3, bs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["packed_chain_batched"] == 1
    assert torch.equal(got[1], mk.packed_chain(xs[1], tps[1], 3, bs))


def _bf16_close(got, want):
    """max abs <= 2^-7 max|want| and >= 99% of the elements bit-equal."""
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    assert float((g - w).abs().max()) <= 2.0 ** -7 * float(w.abs().max())
    assert float((got == want).float().mean()) >= 0.99


@pytest.mark.parametrize("shape", [
    (2, 13, 11, 32, 48), (1, 9, 20, 512, 512), (1, 5, 7, 16, 16),
    (3, 19, 37, 96, 144), (1, 8, 16, 64, 128)])
def test_conv3x3(cuda, shape):
    """K9 vs its twin (f32 conv on the bf16 values, TF32 off, one round) at
    an odd shape (edge masks in H, W and F; C 32 fills half a 64-channel
    chunk), at C = F = 512, at C = F = 16, at a partial chunk (C 96) with a
    ragged second F tile (F 144), and at exactly one tile."""
    from irn_tpu_torch.ops import conv3x3 as cv

    torch.backends.cudnn.allow_tf32 = False
    b, h, w, c, f = shape
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, h, w, c), generator=gen).to(torch.bfloat16).to(cuda)
    k = (torch.randn((3, 3, c, f), generator=gen) * 0.05).to(
        torch.bfloat16).to(cuda)
    got = cv.conv3x3(x, k)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["conv3x3"] == 1
    _bf16_close(got, cv.conv3x3_plain(x, k))


def test_conv3x3_refuses(cuda):
    """C or F not a multiple of 16, a non-contiguous input (a permuted
    NCHW view), or f32 tensors raise; nothing is launched."""
    from irn_tpu_torch.ops import conv3x3 as cv

    bf = dict(dtype=torch.bfloat16, device=cuda)
    x = torch.zeros((1, 8, 8, 16), **bf)
    with pytest.raises(ValueError):
        cv.conv3x3(torch.zeros((1, 8, 8, 24), **bf),
                   torch.zeros((3, 3, 24, 16), **bf))
    with pytest.raises(ValueError):
        cv.conv3x3(x, torch.zeros((3, 3, 16, 40), **bf))
    with pytest.raises(ValueError):
        cv.conv3x3(torch.zeros((1, 16, 8, 8), **bf).permute(0, 2, 3, 1),
                   torch.zeros((3, 3, 16, 16), **bf))
    with pytest.raises(TypeError):
        cv.conv3x3(x.float(), torch.zeros((3, 3, 16, 16), device=cuda))
    assert _build.LAUNCHES["conv3x3"] == 0


def test_check_cuda_dtype(cuda):
    """check_cuda's dtype: conv3x3 takes bf16 and refuses f32; every other
    wrapper still takes f32 only and refuses bf16."""
    from irn_tpu_torch.ops import conv3x3 as cv

    k = torch.zeros((3, 3, 16, 16), dtype=torch.bfloat16, device=cuda)
    x = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16, device=cuda)
    assert cv.conv3x3(x, k).dtype == torch.bfloat16
    with pytest.raises(TypeError):
        cv.conv3x3(x.float(), k.float())
    t = _banded(512, 60).to(cuda).to(torch.bfloat16)
    xb = torch.zeros((8, 512), dtype=torch.bfloat16, device=cuda)
    for fn in (lambda: mk.pack_banded(t, 60, 128),
               lambda: mk.square_banded(t, 60, 128),
               lambda: mk.apply_banded(xb, t, 60, 128),
               lambda: mk.square_dense(t),
               lambda: mk.square_fused_first(t, 10),
               lambda: mk.banded_chain(xb, t, 60, 2, 128, 256),
               lambda: mk.packed_chain(xb, torch.zeros(
                   (4, 384, 128), dtype=torch.bfloat16, device=cuda), 2, 128),
               lambda: mk.packed_chain_batched(xb[None], torch.zeros(
                   (1, 4, 384, 128), dtype=torch.bfloat16, device=cuda), 2,
                   128)):
        with pytest.raises(TypeError):
            fn()
    geom = rw.build_geometry(16, 16, radius=5)
    w = torch.zeros((len(rw.diag_offsets(geom)), geom.n_pad),
                    dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        rw.apply_diag_chain(torch.zeros((8, geom.n_pad), dtype=torch.bfloat16,
                                        device=cuda), w, w[0],
                            rw.diag_offsets(geom), 2)
    assert sum(v for k_, v in _build.LAUNCHES.items() if k_ != "conv3x3") == 0


# -- K0 at the instance walk's row counts ----------------------------------


@pytest.mark.parametrize("c", [32, 64, 128])
def test_diag_chain_many_rows(cuda, c):
    """K0 at the instance walk's seed rows (up to ins_seed_cap 128 at the
    128x128 bucket): several waves of clusters, bit-equal to its twin."""
    geom = rw.build_geometry(128, 128, radius=5)
    g = np.random.default_rng(c)
    edge = torch.from_numpy(g.random((128, 128), dtype=np.float32)).to(cuda)
    w, inv = rw.build_diag_operator(geom, edge)
    x = torch.from_numpy(g.random((c, geom.n_pad), dtype=np.float32)).to(cuda)
    doffs = rw.diag_offsets(geom)
    got = rw.apply_diag_chain(x, w, inv, doffs, 32)
    want = rw.apply_diag_chain_plain(x, w, inv, doffs, 32)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["diag_chain"] == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- K11 and K12 ------------------------------------------------------------


def _dp_field(kind, grid, hw4, seed=0):
    """A random field or a basin field (two attractors plus noise), zero
    beyond the (h4, w4) extent, as the forward hands it over."""
    g = np.random.default_rng(seed)
    h, w = grid
    if kind == "random":
        dp = (g.standard_normal((2, h, w)) * 3.0).astype(np.float32)
    else:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        left = xx < hw4[1] / 2
        cy = np.where(left, hw4[0] * 0.3, hw4[0] * 0.7)
        cx = np.where(left, hw4[1] * 0.25, hw4[1] * 0.75)
        dp = np.stack([(cy - yy) * 0.3, (cx - xx) * 0.3]).astype(np.float32)
        dp += (g.standard_normal(dp.shape) * 0.05).astype(np.float32)
    dp[:, hw4[0]:] = 0
    dp[:, :, hw4[1]:] = 0
    return torch.from_numpy(dp)


@pytest.mark.parametrize("kind", ["random", "basin"])
@pytest.mark.parametrize("grid,hw4", [((128, 128), (128, 128)),
                                      ((128, 128), (97, 128)),
                                      ((32, 32), (19, 27))])
def test_advect_bit_equal(cuda, kind, grid, hw4):
    """K11: end points and basin bit-equal to the twin after 300 steps, in
    one launch."""
    from irn_tpu_torch.ops import centroids

    dp = _dp_field(kind, grid, hw4).to(cuda)
    cent, basin = centroids.advect(dp, *hw4)
    want_cent, want_basin = centroids.advect_plain(dp, *hw4)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["advect"] == 1
    assert torch.equal(cent, want_cent) and torch.equal(basin, want_basin)
    assert int(cent[0].max()) < hw4[0] and int(cent[1].max()) < hw4[1]


def _spiral(h):
    mask = np.zeros((h, h), bool)
    top, bot, lef, rig = 0, h - 1, 0, h - 1
    while top <= bot and lef <= rig:
        mask[top, lef : rig + 1] = True
        mask[top : bot + 1, rig] = True
        mask[bot, lef : rig + 1] = True
        mask[top + 2 : bot + 1, lef] = True
        top, bot, lef, rig = top + 2, bot - 2, lef + 2, rig - 2
    return mask


@pytest.mark.parametrize("case", ["sparse", "dense", "spiral", "extent"])
def test_ccl_label_masks(cuda, case):
    """K12a on 128x128 masks (the basin plane) equals its twin, the extent
    cut included."""
    from irn_tpu_torch.ops import ccl

    g = np.random.default_rng(1)
    mask = {"sparse": g.random((128, 128)) < 0.3,
            "dense": g.random((128, 128)) < 0.6,
            "spiral": _spiral(128),
            "extent": g.random((128, 128)) < 0.55}[case]
    hw = (97, 113) if case == "extent" else (128, 128)
    m = torch.from_numpy(mask).to(cuda)
    got = ccl.min_label_plane(m, *hw)
    want = ccl.min_label_plane(m.cpu(), *hw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ccl_label"] == 3
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", ["blobby", "speckle", "spiral_touching"])
def test_ccl_label_maps(cuda, case):
    """K12a on 512x512 label maps (the decoded walk at the 128x128 bucket):
    same-value components only, equal to its twin."""
    from irn_tpu_torch.ops import ccl

    g = np.random.default_rng(2)
    labels = {
        "blobby": np.kron(g.integers(0, 9, (32, 32)), np.ones((16, 16), int)),
        "speckle": g.integers(0, 4, (512, 512)),
        "spiral_touching": np.where(_spiral(512), 1, 2),
    }[case].astype(np.int32)
    t = torch.from_numpy(labels).to(cuda)
    got = ccl.min_label_plane_multi(t)
    want = ccl.min_label_plane_multi_plain(t)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["random", "overflow", "escape", "empty"])
def test_cluster_masks_exact(cuda, case):
    """K12b cluster masks and n_found at the basin plane (128x128, k_cap 8)
    equal the twin's, overflow (n_found = k_cap + 1) included."""
    from irn_tpu_torch.ops import ccl

    g = np.random.default_rng(3)
    h4, w4 = 97, 121
    basin = g.random((128, 128)) < {"random": 0.3, "overflow": 0.05,
                                     "escape": 0.02, "empty": 0.0}[case]
    if case == "random":  # a few large basins
        basin = np.kron(g.random((8, 8)) < 0.4, np.ones((16, 16), bool))
    cent = np.stack([g.integers(0, h4, (128, 128)),
                     g.integers(0, w4, (128, 128))]).astype(np.int32)
    b, c = torch.from_numpy(basin).to(cuda), torch.from_numpy(cent).to(cuda)
    masks, n_found = ccl.cluster_from_basin(b, c, h4, w4, 8)
    want_masks, want_n = ccl.cluster_from_basin(b.cpu(), c.cpu(), h4, w4, 8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ccl_tables"] == 3
    assert torch.equal(masks.cpu(), want_masks)
    assert int(n_found) == int(want_n)
    if case == "overflow":
        assert int(n_found) == 9


@pytest.mark.parametrize("case,cap", [("blobby", 128), ("blobby", 8),
                                      ("speckle", 128), ("empty", 128)])
def test_component_tables_exact(cuda, case, cap):
    """K12b component tables at 512x512: all five outputs equal the twin's,
    overflow (cap 8 on the blobby map, 128 on speckle) included."""
    from irn_tpu_torch.ops import ccl

    g = np.random.default_rng(4)
    labels = {
        "blobby": np.kron(g.integers(0, 5, (16, 16)), np.ones((32, 32), int)),
        "speckle": g.integers(0, 4, (512, 512)),
        "empty": np.zeros((512, 512), int),
    }[case].astype(np.int32)
    best = g.random((512, 512), dtype=np.float32)
    lt, bt = torch.from_numpy(labels).to(cuda), torch.from_numpy(best).to(cuda)
    got = ccl.component_tables(lt, bt, cap)
    want = ccl.component_tables_plain(lt, bt, cap)
    torch.cuda.synchronize()
    for name, a, b in zip(("comp_map", "rows", "sizes", "scores", "n_comp"),
                          got, want):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    if case != "empty" and not (case == "blobby" and cap == 128):
        assert int(got[4]) == cap + 1


def _edge_map(kind, shape, seed=0):
    """An edge map in [0, 1]: a sigmoid of normals, the same quantized to 8
    levels (ties everywhere), exact zeros, or the sigmoid with NaN and -inf
    planted."""
    g = np.random.default_rng(seed)
    e = 1.0 / (1.0 + np.exp(-g.standard_normal(shape)))
    if kind == "quantized":
        e = np.round(e * 7) / 7
    elif kind == "zeros":
        e = np.zeros(shape)
    elif kind == "nan":
        e.flat[::37] = np.nan
        e.flat[5::41] = -np.inf
    return torch.from_numpy(e.astype(np.float32))


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", ["sigmoid", "quantized", "zeros", "nan"])
@pytest.mark.parametrize("radius,shape", [(10, (2, 32, 32)),
                                          (5, (3, 37, 29)),
                                          (4, (1, 16, 40)),
                                          (10, (2, 128, 128)),
                                          (5, (32, 128, 128)),
                                          (4, (32, 128, 128)),
                                          (10, (1, 128, 128)),
                                          (10, (2, 40, 40))])
def test_path_max_bit_equal(cuda, kind, radius, shape):
    """K13a's values and winners and K13b's gradient bit-equal to their
    twins, one launch each: ties (the quantized map, all-zero map) keep the
    first cell, NaN and -inf in the map, odd shapes leave ragged blocks,
    radii 5 and 4 at train_irn's batch and grid, B 1, and a window
    narrower than one tile."""
    from irn_tpu_torch.ops import affinity, paths

    table = affinity.path_table(paths.build_path_set(radius))
    edge = _edge_map(kind, shape, seed=radius)
    maxed, winner = affinity.path_max_fwd(edge.to(cuda), table)
    want_m, want_w = affinity.path_max_plain(edge, table)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(want_m.shape)).astype(np.float32))
    got_g = affinity.path_max_bwd(g.to(cuda), winner, table, shape[1:])
    want_g = affinity.path_max_bwd_plain(g, want_w, table, shape[1:])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["path_max_fwd"] == 1
    assert _build.LAUNCHES["path_max_bwd"] == 1
    assert torch.equal(_bits(maxed.cpu()), _bits(want_m))
    assert torch.equal(winner.cpu(), want_w)
    assert torch.equal(got_g.cpu(), want_g)


@pytest.mark.parametrize("radius,shape", [(10, (2, 128, 128)),
                                          (5, (3, 37, 29)),
                                          (10, (2, 40, 40))])
def test_path_max_bwd_special_values(cuda, radius, shape):
    """K13b with signed zeros, +-inf and a planted NaN in the cotangent:
    the misses it skips do not show (NaN compared as NaN)."""
    from irn_tpu_torch.ops import affinity, paths

    table = affinity.path_table(paths.build_path_set(radius))
    _, winner = affinity.path_max_plain(_edge_map("quantized", shape), table)
    r = np.random.default_rng(2)
    g = r.standard_normal(tuple(winner.shape))
    u = r.random(g.shape)
    g[u < 0.1] = 0.0
    g[(u >= 0.1) & (u < 0.2)] = -0.0
    g[(u >= 0.2) & (u < 0.25)] = np.inf
    g[(u >= 0.25) & (u < 0.3)] = -np.inf
    g.flat[g.size // 3] = np.nan
    g = torch.from_numpy(g.astype(np.float32))
    got = affinity.path_max_bwd(g.to(cuda), winner.to(cuda), table,
                                shape[1:])
    want = affinity.path_max_bwd_plain(g, winner, table, shape[1:])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["path_max_bwd"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0,
                               equal_nan=True)


def test_path_max_autograd(cuda):
    """The autograd Function on the card: one K13a in the forward, one K13b
    in the backward, the edge gradient bit-equal to the host's."""
    from irn_tpu_torch.ops import affinity, paths

    table = affinity.path_table(paths.build_path_set(5))
    edge = _edge_map("quantized", (2, 24, 30), seed=3)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, table.n_pairs, 20, 22)).astype(np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        e = edge.to(dev).requires_grad_(True)
        (affinity.path_max(e, table) * g.to(dev)).sum().backward()
        grads.append(e.grad.cpu())
    torch.cuda.synchronize()
    assert _build.LAUNCHES["path_max_fwd"] == 1
    assert _build.LAUNCHES["path_max_bwd"] == 1
    assert torch.equal(grads[0], grads[1])


def _loss_inputs(kind, radius, shape, seed):
    """K16's inputs: maxed (K13a's twin over a sigmoid map), dp of normals,
    labels of {0, 1, 2, 255} or, with no foreground, {0, 255}; "NaN in dp"
    plants NaN in both dp channels."""
    from irn_tpu_torch.ops import affinity, paths

    table = affinity.path_table(paths.build_path_set(radius))
    b, h, w = shape
    g = np.random.default_rng(seed)
    maxed, _ = affinity.path_max_plain(_edge_map("sigmoid", shape, seed),
                                       table)
    dp = g.standard_normal((b, 2, h, w)).astype(np.float32)
    values, p = ((0, 255), (0.8, 0.2)) if kind == "no foreground" else (
        (0, 1, 2, 255), (0.4, 0.25, 0.25, 0.1))
    lab = g.choice(np.array(values, np.int32), size=shape, p=p)
    if kind == "NaN in dp":
        dp.reshape(-1)[::101] = np.nan
    return (table, maxed, torch.from_numpy(dp), torch.from_numpy(lab))


@pytest.mark.parametrize("kind", ["labels with 255", "no foreground",
                                  "NaN in dp"])
@pytest.mark.parametrize("radius,shape", [(10, (32, 128, 128)),
                                          (5, (32, 128, 128)),
                                          (4, (32, 128, 128)),
                                          (10, (3, 37, 29)),
                                          (10, (2, 36, 29)),
                                          (4, (2, 20, 150)),
                                          (5, (2, 40, 300)),
                                          (14, (2, 40, 60)),
                                          (20, (1, 540, 39))])
def test_irn_loss_bit_equal(cuda, kind, radius, shape):
    """K16 forward (two launches) and backward (one) against their twins
    run on the card: the f64 stats (five sums, three counts) and the five
    loss values bit-equal (the twins emulate the kernels' f64 block and
    warp trees, so no ulp of slack is needed), d_maxed and d_dp bit-equal,
    NaN where the twin has NaN; the backward also bit-equal to the host
    twin given the same stats (it takes no transcendental). Beyond the
    default: [3, 37, 29] (window width 11, odd: the forward's pixel pairs
    straddle rows, the backward's items are single columns), [2, 36, 29]
    (an odd plane: the forward's 4-byte path and a thread with one pixel),
    [2, 20, 150] and [2, 40, 300] (two and three backward column tiles,
    odd rf), radius 14 (rf 13) and a one-column window at radius 20
    whose 512-pixel blocks reach more grid rows than shared memory holds
    (the forward reads them through L1)."""
    from chip_smoke import _same_bits
    from irn_tpu_torch.ops import affinity

    table, maxed, dp, lab = _loss_inputs(kind, radius, shape, radius)
    args = (maxed.to(cuda), dp.to(cuda), lab.to(cuda), table)
    loss, stats = affinity.irn_loss_fwd(*args)
    want_loss, want_stats = affinity.irn_loss_fwd_plain(*args)
    g = torch.tensor([1.0, 0.25, -0.5, 0.125, 2.0], device=cuda)
    d_maxed, d_dp = affinity.irn_loss_bwd(g, stats, *args)
    want_dm, want_dd = affinity.irn_loss_bwd_plain(g, stats, *args)
    host_dm, host_dd = affinity.irn_loss_bwd_plain(
        g.cpu(), stats.cpu(), maxed, dp, lab, table)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["irn_loss_fwd"] == 2
    assert _build.LAUNCHES["irn_loss_bwd"] == 1
    assert _same_bits(stats, want_stats)
    assert _same_bits(loss, want_loss)
    assert _same_bits(d_maxed, want_dm) and _same_bits(d_dp, want_dd)
    assert (_same_bits(d_maxed.cpu(), host_dm)
            and _same_bits(d_dp.cpu(), host_dd))
    if kind == "NaN in dp":
        assert torch.isnan(loss[[0, 3, 4]]).all()
        assert not torch.isnan(loss[1:3]).any()


def test_irn_loss_autograd_step(cuda):
    """One autograd step through PathMax and IrnLoss, card against host:
    one K13a, two K16 forward, one K16 backward and one K13b launch; the
    gradients of the edge map and of dp bit-equal (d_maxed takes only the
    exact counts and the upstream 1), the losses within 1e-6 (the host's
    log may differ from the card's by an ulp)."""
    from irn_tpu_torch.ops import affinity

    table, _, dp, lab = _loss_inputs("labels with 255", 10, (4, 64, 72), 5)
    edge = _edge_map("sigmoid", (4, 64, 72), seed=6)
    out = []
    for dev in (cuda, torch.device("cpu")):
        e = edge.to(dev).requires_grad_(True)
        d = dp.to(dev).requires_grad_(True)
        total, terms = affinity.irn_loss(affinity.path_max(e, table), d,
                                         lab.to(dev), table)
        total.backward()
        out.append((float(total.detach()),
                    {k: float(v.detach()) for k, v in terms.items()},
                    e.grad.cpu(), d.grad.cpu()))
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] for k in (
        "path_max_fwd", "path_max_bwd", "irn_loss_fwd", "irn_loss_bwd")} == {
        "path_max_fwd": 1, "path_max_bwd": 1, "irn_loss_fwd": 2,
        "irn_loss_bwd": 1}
    (t_c, m_c, ge_c, gd_c), (t_h, m_h, ge_h, gd_h) = out
    assert t_c == pytest.approx(t_h, rel=1e-6)
    for k, v in m_h.items():
        assert m_c[k] == pytest.approx(v, rel=1e-6), k
    assert torch.equal(ge_c, ge_h) and torch.equal(gd_c, gd_h)


def _walk_edge(kind, shape, seed):
    """A capped edge map for K10: a sigmoid of normals, the same quantized
    to 8 levels (ties along every path), or all ones (w 0, inv 1)."""
    if kind == "ones":
        return torch.ones(shape)
    return _edge_map(kind, shape, seed)


@pytest.mark.parametrize("beta", [1, 3, 10])
@pytest.mark.parametrize("kind", ["sigmoid", "quantized", "ones"])
@pytest.mark.parametrize("radius,cap", [(5, (96, 128)), (5, (128, 96)),
                                        (5, (128, 128)), (5, (20, 28)),
                                        (2, (24, 24)), (10, (32, 40))])
def test_diag_operator_bit_equal(cuda, radius, cap, kind, beta):
    """K10 bit-equal to its twin on the card and on the host, one launch:
    the three buckets of the default grid cap, an odd small grid, radius 2
    and 10, ties, beta a run-time integer; the edge passed as the stage's
    non-contiguous slice."""
    geom = rw.build_geometry(*cap, radius=radius)
    full = torch.ones((cap[0] + 3, cap[1] + 5))
    full[: cap[0], : cap[1]] = _walk_edge(kind, cap, seed=cap[0] + beta)
    edge = full.to(cuda)[: cap[0], : cap[1]]
    w, inv = rw.build_diag_operator(geom, edge, beta)
    want_w, want_inv = rw.build_diag_operator_plain(geom, edge.contiguous(),
                                                    beta)
    host_w, host_inv = rw.build_diag_operator_plain(
        geom, full[: cap[0], : cap[1]], beta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["diag_operator"] == 1
    assert torch.equal(w, want_w) and torch.equal(inv, want_inv)
    assert torch.equal(w.cpu(), host_w) and torch.equal(inv.cpu(), host_inv)


def _decode_case(case, c, shape=(96, 128), seed=0):
    """(rw [C, ch, cw], h4, w4, h0, w0, bg_thres): random scores at odd
    extents, all zeros, equal leading rows (the first wins), or a row at
    exactly bg_thres after the normalization (the background wins)."""
    g = np.random.default_rng(seed)
    ch, cw = shape
    h4, w4 = ch - 3, cw - 5
    h0, w0 = 4 * h4 - 2, 4 * w4 - 3
    rw_ = np.zeros((c, ch, cw), np.float32)
    bg = 0.35
    if case == "random":
        rw_[:, :h4, :w4] = g.random((c, h4, w4))
    elif case == "equal_rows":
        rw_[:, :h4, :w4] = g.random((c, h4, w4)) * 0.5
        rw_[1, :h4, :w4] = rw_[0, :h4, :w4] = 1 + g.random((h4, w4))
    elif case == "bg_tie":
        bg = 0.25
        rw_[0, :h4, :w4] = 0.25
        rw_[-1, 10:40, 20:60] = 1.0
    return torch.from_numpy(rw_), h4, w4, h0, w0, bg


@pytest.mark.parametrize("case", ["random", "zeros", "equal_rows",
                                  "bg_tie"])
@pytest.mark.parametrize("c", [8, 128])
def test_decode_bit_equal(cuda, c, case):
    """K15 bit-equal to its twin on the card (labels, max, normalized
    scores, best) in two launches, and its labels equal to the host's; the
    upsample alone in one launch; without scores no [C, 4H, 4W] tensor."""
    x, h4, w4, h0, w0, bg = _decode_case(case, c)
    xd = x.to(cuda)
    full = rw.decode(xd, h4, w4, h0, w0, bg, scores=True, best=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode"] == 2
    want = rw.decode_plain(xd, h4, w4, h0, w0, bg, scores=True, best=True)
    for got, exp in zip(full, want):
        assert torch.equal(got, exp)
    lean = rw.decode(xd, h4, w4, h0, w0, bg, best=True)
    assert lean.scores is None
    assert torch.equal(lean.labels, want.labels)
    assert torch.equal(lean.best, want.best)
    host = rw.decode_plain(x, h4, w4, h0, w0, bg)
    assert torch.equal(lean.labels.cpu(), host.labels)
    up = rw.upsample_scores(xd, h4, w4, h0, w0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode"] == 5
    assert torch.equal(up, rw.upsample_scores_plain(xd, h4, w4, h0, w0))
    if case == "equal_rows":
        assert not (want.labels == 2).any()
    if case == "bg_tie":
        assert not (want.labels == 1).any()


def test_walk_kernels_refuse(cuda):
    """K10 and K15 take f32 only; a CUDA tensor never reaches a twin."""
    geom = rw.build_geometry(24, 24, radius=5)
    with pytest.raises(TypeError):
        rw.build_diag_operator(geom, torch.ones((24, 24), dtype=torch.float64,
                                                device=cuda))
    with pytest.raises(TypeError):
        rw.decode(torch.zeros((2, 8, 8), dtype=torch.float64, device=cuda),
                  8, 8, 32, 32, 0.3)
    assert not any(_build.LAUNCHES.values())


def _crf_image(kind, h, w, seed=0):
    """[3, h, w] uint8: color regions with noise, all black, or uniform."""
    if kind == "black":
        return torch.zeros((3, h, w), dtype=torch.uint8)
    if kind == "uniform":
        return torch.full((3, h, w), 128, dtype=torch.uint8)
    g = np.random.default_rng(seed)
    img = np.full((3, h, w), 60.0)
    img[:, :, : w // 2] = np.array([190, 70, 60])[:, None, None]
    img[:, h // 2:, w // 2:] = np.array([70, 170, 90])[:, None, None]
    img = np.clip(img + g.normal(0, 8, img.shape), 0, 255)
    return torch.from_numpy(img.astype(np.uint8))


CRF_STORES = {"int8": torch.int8, "bf16": torch.bfloat16,
              "f32": torch.float32}


@pytest.mark.parametrize("mode", ["full", "rows", "sums"])
@pytest.mark.parametrize("store", sorted(CRF_STORES))
@pytest.mark.parametrize("kind,bucket,extent", [
    ("scene", (64, 128), (64, 128)), ("scene", (92, 84), (89, 81)),
    ("scene", (24, 28), (21, 25)), ("black", (64, 64), (61, 57)),
    ("uniform", (64, 64), (64, 64))])
def test_crf_landmark_bit_equal(cuda, kind, bucket, extent, store, mode):
    """K14 bit-equal to its twin on the card in two launches (the table
    pass, the rows), store and row sums (int8 and dense): a full bucket,
    odd extents whose S (483, 42) leaves int8 and bf16 rows off 16-byte
    alignment and a ragged last tile, an all-black and a uniform image (u
    = 0 at the landmarks' own pixels); all rows, an odd row range, or the
    sums alone. The f32 store within 1e-6 of the host twin (exp2 differs
    by an ulp or two there)."""
    planes = _crf_image(kind, *bucket)
    n = bucket[0] * bucket[1]
    kw = dict(store=CRF_STORES[store])
    if mode == "rows":
        kw["rows"] = (37, n - 5)
    if mode == "sums":
        kw["sums_only"] = True
    got_k, got_d = crf_device.landmark_rows(planes.to(cuda), *extent, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["crf_landmark"] == 2
    want_k, want_d = crf_device.landmark_rows_plain(planes.to(cuda), *extent,
                                                    **kw)
    assert torch.equal(got_d, want_d)
    if mode == "sums":
        assert got_k is None and want_k is None
        return
    assert torch.equal(got_k, want_k)
    if store == "f32":
        host_k, _ = crf_device.landmark_rows_plain(planes, *extent, **kw)
        torch.testing.assert_close(got_k.cpu(), host_k, rtol=1e-6,
                                   atol=1e-30)


@pytest.mark.parametrize("kind,bucket,extent", [
    ("scene", (92, 84), (89, 81)), ("scene", (24, 28), (21, 25)),
    ("uniform", (64, 64), (64, 64))])
def test_crf_landmark_table(cuda, kind, bucket, extent):
    """K14's table pass alone (one launch) equal to its twin: F, b, +inf
    for the landmarks outside the extent and the padded columns."""
    planes = _crf_image(kind, *bucket).to(cuda)
    got = crf_device.landmark_table(planes, *extent)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["crf_landmark"] == 1
    assert torch.equal(got, crf_device.landmark_table_plain(planes, *extent))
    assert not torch.isnan(got).any()


@pytest.mark.parametrize("store", sorted(CRF_STORES))
def test_crf_landmark_warp_rows(cuda, store):
    """The pixel rows per warp compiled for each store (32 int8, 8 bf16 and
    f32) give the twin's bits on the odd bucket (a ragged last tile, rows
    off alignment, a last block's warps partly past the range) with a row
    range, and on a bucket of several tiles (S 1920: int8 four)."""
    for bucket, extent, rows in (((92, 84), (89, 81), (37, 92 * 84 - 5)),
                                 ((192, 160), (190, 151), None)):
        planes = _crf_image("scene", *bucket).to(cuda)
        kw = dict(store=CRF_STORES[store], rows=rows)
        got = crf_device.landmark_rows(planes, *extent, **kw)
        want = crf_device.landmark_rows_plain(planes, *extent, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_crf_landmark_refuses(cuda):
    """K14 stores int8, bf16 or f32; the planes are [3, H, W] uint8; a CUDA
    tensor never reaches the twin."""
    planes = torch.zeros((3, 24, 28), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        crf_device.landmark_rows(planes, 24, 28, store=torch.float16)
    with pytest.raises(ValueError):
        crf_device.landmark_rows(planes.float(), 24, 28)
    with pytest.raises(ValueError):
        crf_device.landmark_rows(planes, 24, 28, rows=(3, 3))
    assert not any(_build.LAUNCHES.values())


MF_BUCKETS = [((512, 512), (500, 497)), ((92, 84), (89, 81))]
MF_STORES = {"int8": torch.int8, "bf16": torch.bfloat16,
             "f32": torch.float32}


def _mf_state(cuda, bucket, extent, n_labels=6, cap=21, seed=0):
    """K17's inputs on the card: q (a softmax, channels >= n_labels at 0,
    map 1's channel 2, or its last below 3 channels, all zero), labels <
    n_labels, nr_g and nr_b > 0 inside the extent, the taps, the unary's
    logs."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    h, w = bucket
    logits = torch.randn((2, cap, h, w), generator=g, device=cuda) * 2
    logits[:, n_labels:] = -1e30
    logits[1, min(2, cap - 1)] = -1e30
    q = torch.softmax(logits, 1)
    valid = torch.zeros((h, w), device=cuda)
    valid[:extent[0], :extent[1]] = 1
    nr_g = (torch.rand((h, w), generator=g, device=cuda) + 0.05) * valid
    nr_b = (torch.rand((h, w), generator=g, device=cuda) + 0.05) * valid
    labels = torch.randint(0, n_labels, (2, h, w), generator=g, device=cuda,
                           dtype=torch.uint8)
    lg, lo = crf_device.unary_logs(0.7, n_labels)
    return q, labels, nr_g, nr_b, crf_device.gaussian_taps(3.0), lg, lo


@pytest.mark.parametrize("c", [1, 42])
@pytest.mark.parametrize("bucket,extent", MF_BUCKETS)
def test_crf_blur_bit_equal(cuda, bucket, extent, c):
    """K17's blur (one launch) bit-equal to its twin: the validity mask and
    42 planes zero outside the extent, at 512x512 and the odd 92x84; the
    13 taps of sxy 1.5 padded to the kernel's 25."""
    q, *_ = _mf_state(cuda, bucket, extent)
    x = q.reshape(-1, *bucket)[:c].contiguous()
    for taps in (crf_device.gaussian_taps(3.0), crf_device.gaussian_taps(1.5)):
        _build.reset_launches()
        got = crf_device.blur(x, taps)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["crf_mean_field"] == 1
        assert torch.equal(got, crf_device.blur_plain(x, taps))


@pytest.mark.parametrize("argmax", [False, True])
@pytest.mark.parametrize("bucket,extent", MF_BUCKETS)
def test_crf_start_bit_equal(cuda, bucket, extent, argmax):
    """K17's start (one launch): the first softmax of the unary, or its
    argmax, bit-equal to its twin; with gt 0.5 over 2 labels every channel
    ties and the argmax is channel 0."""
    _, labels, *_, lg, lo = _mf_state(cuda, bucket, extent)
    for n_labels, (a, b) in ((6, (lg, lo)),
                             (2, crf_device.unary_logs(0.5, 2))):
        lab = labels % n_labels
        _build.reset_launches()
        got = crf_device.start(lab, 21, n_labels, a, b, argmax=argmax)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["crf_mean_field"] == 1
        assert torch.equal(got, crf_device.start_plain(lab, 21, n_labels, a,
                                                       b, argmax=argmax))
        if argmax and n_labels == 2:
            assert not got.any()


@pytest.mark.parametrize("store", sorted(MF_STORES))
@pytest.mark.parametrize("bucket,extent", MF_BUCKETS)
def test_crf_quantize_bit_equal(cuda, bucket, extent, store):
    """K17's quantize (one launch): the int8, bf16 and f32 operands and the
    int8 qscale bit-equal to the twin's, with all-zero landmark columns
    (channels past n_labels, map 1's channel 2) whose qscale is clamped to
    1e-20, the padding rows and columns left zero."""
    q, _, _, nr_b, *_ = _mf_state(cuda, bucket, extent)
    s = len(range(2, bucket[0], 4)) * len(range(2, bucket[1], 4))
    bufs = [crf_device.operand_buffers(s, 21, MF_STORES[store], cuda)
            for _ in range(2)]
    _build.reset_launches()
    crf_device.quantize(q, nr_b, *bufs[0])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["crf_mean_field"] == 1
    crf_device.quantize_plain(q, nr_b, *bufs[1])
    assert torch.equal(bufs[0][0], bufs[1][0])
    assert torch.equal(bufs[0][1], bufs[1][1])
    if store == "int8":
        assert bufs[0][1][24 + 2] == np.float32(1e-20)
        assert bufs[0][1][6:21].eq(np.float32(1e-20)).all()


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("store", ["int8", "f32"])
@pytest.mark.parametrize("bucket,extent", MF_BUCKETS)
def test_crf_combine_bit_equal(cuda, bucket, extent, store, last):
    """K17's combine (one launch) bit-equal to its twin: q_{i+1}, or the
    last iteration's labels, from an int32 product with qscale or an f32
    product, read in place from a [N, 48] output."""
    q, labels, nr_g, nr_b, taps, lg, lo = _mf_state(cuda, bucket, extent)
    g = torch.Generator(device=cuda).manual_seed(1)
    n = bucket[0] * bucket[1]
    if store == "int8":
        prod = torch.randint(0, 2 ** 28, (n, 48), generator=g, device=cuda,
                             dtype=torch.int32)
        qscale = torch.rand(48, generator=g, device=cuda)
    else:
        prod = torch.rand((n, 48), generator=g, device=cuda) * 200
        qscale = None
    outs = [torch.empty((2, *bucket), dtype=torch.uint8, device=cuda) if last
            else torch.empty_like(q) for _ in range(2)]
    _build.reset_launches()
    crf_device.combine(q, labels, nr_g, nr_b, taps, prod, qscale, 6, lg, lo,
                       outs[0])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["crf_mean_field"] == 1
    crf_device.combine_plain(q, labels, nr_g, nr_b, taps, prod, qscale, 6,
                             lg, lo, outs[1])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("sxy", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("cap", [2, 5, 21, 32])
@pytest.mark.parametrize("bucket,extent", [((92, 84), (89, 81)),
                                           ((20, 24), (17, 22))])
def test_crf_combine_caps_taps(cuda, bucket, extent, cap, sxy):
    """K17's combine at 2, 5, 21 and 32 channels per map (cp = cap rounded
    up to 4: 4, 8, 24, 32 columns per map), with the 9, 17 and 25 taps of
    sxy 1, 2 and 3, on a bucket that is no multiple of the 32 x 32 tile and
    on one narrower and shorter than a tile: q_{i+1} and the labels from an
    int32 product with qscale and from an f32 product bit-equal to the
    twin, one launch each."""
    n_labels = min(cap, 4)
    q, labels, nr_g, nr_b, _, lg, lo = _mf_state(cuda, bucket, extent,
                                                 n_labels=n_labels, cap=cap)
    taps = crf_device.gaussian_taps(sxy)
    g = torch.Generator(device=cuda).manual_seed(cap)
    n = bucket[0] * bucket[1]
    m = 2 * crf_device.map_columns(cap)
    prods = ((torch.randint(0, 2 ** 20, (n, m), generator=g, device=cuda,
                            dtype=torch.int32),
              torch.rand(m, generator=g, device=cuda)),
             (torch.rand((n, m), generator=g, device=cuda) * 200, None))
    for prod, qscale in prods:
        for last in (False, True):
            outs = [torch.empty((2, *bucket), dtype=torch.uint8, device=cuda)
                    if last else torch.empty_like(q) for _ in range(2)]
            _build.reset_launches()
            crf_device.combine(q, labels, nr_g, nr_b, taps, prod, qscale,
                               n_labels, lg, lo, outs[0])
            torch.cuda.synchronize()
            assert _build.LAUNCHES["crf_mean_field"] == 1
            crf_device.combine_plain(q, labels, nr_g, nr_b, taps, prod,
                                     qscale, n_labels, lg, lo, outs[1])
            assert torch.equal(outs[0], outs[1]), (prod.dtype, last)


def test_crf_combine_refuses_tensor_map(cuda):
    """The combine reads q through a TMA tensor map: a width that is no
    multiple of 4 and a q whose base is not 16-byte aligned are refused
    before a launch, naming the shape."""
    q, labels, nr_g, nr_b, taps, lg, lo = _mf_state(cuda, (24, 30), (24, 30))
    prod = torch.zeros((24 * 30, 48), device=cuda)
    with pytest.raises(ValueError, match="tensor map"):
        crf_device.combine(q, labels, nr_g, nr_b, taps, prod, None, 6, lg, lo,
                           torch.empty_like(q))
    q, labels, nr_g, nr_b, taps, lg, lo = _mf_state(cuda, (24, 28), (24, 28))
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    prod = torch.zeros((24 * 28, 48), device=cuda)
    with pytest.raises(ValueError, match="tensor map"):
        crf_device.combine(shifted, labels, nr_g, nr_b, taps, prod, None, 6,
                           lg, lo, torch.empty_like(q))
    assert not any(_build.LAUNCHES.values())


def test_crf_combine_argmax_ties(cuda):
    """Planted ties on the last iteration: gt 0.5 over 2 labels, no
    messages outside the extent and a product of zeros; every channel
    below n_labels ties there and the first wins, as torch.argmax."""
    bucket, extent = (92, 84), (40, 30)
    q, labels, nr_g, nr_b, taps, *_ = _mf_state(cuda, bucket, extent,
                                                n_labels=2)
    lg, lo = crf_device.unary_logs(0.5, 2)
    prod = torch.zeros((bucket[0] * bucket[1], 48), dtype=torch.int32,
                       device=cuda)
    qscale = torch.ones(48, device=cuda)
    got, want = (torch.empty((2, *bucket), dtype=torch.uint8, device=cuda)
                 for _ in range(2))
    crf_device.combine(q, labels, nr_g, nr_b, taps, prod, qscale, 2, lg, lo,
                       got)
    crf_device.combine_plain(q, labels, nr_g, nr_b, taps, prod, qscale, 2,
                             lg, lo, want)
    assert torch.equal(got, want)
    assert not got[:, 60:].any() and not got[:, :, 60:].any()


@pytest.mark.parametrize("store", ["int8", "dense", "f32", "stream"])
def test_crf_mean_field_pair_bit_equal(cuda, store):
    """mean_field_pair on the card (1 + 2 t K17 launches, the products
    cuBLAS's) against the same loop through the twins on the card: equal
    labels after t = 5, at the odd bucket, 6 labels."""
    kw = dict(int8=dict(kernel_store="int8"), dense=dict(),
              f32=dict(matmul_dtype="float32"),
              stream=dict(stream_kernel=True))[store]
    planes = _crf_image("scene", 92, 84).to(cuda)
    kern = crf_device.LandmarkKernel(planes.permute(1, 2, 0), 89, 81, **kw)
    _, labels, *_ = _mf_state(cuda, (92, 84), (89, 81))
    _build.reset_launches()
    got = crf_device.mean_field_pair(kern, labels, 6, 0.7, t=5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["crf_mean_field"] == 11
    lg, lo = crf_device.unary_logs(0.7, 6)
    q = crf_device.start_plain(labels, 21, 6, lg, lo)
    opnd, qscale = kern.operand(21)
    out = torch.empty_like(labels)
    for i in range(5):
        crf_device.quantize_plain(q, kern.nr_b, opnd, qscale)
        q = crf_device.combine_plain(
            q, labels, kern.nr_g, kern.nr_b, kern.taps, kern.product(opnd),
            qscale if kern.int8 else None, 6, lg, lo,
            out if i == 4 else torch.empty_like(q))
    assert torch.equal(got, out)


@pytest.mark.parametrize("cap", [5, 32])
def test_crf_mean_field_caps(cuda, cap):
    """Other channel counts per map than 21: 5 (4 columns of padding per
    map, a [S', 16] operand) and the card's limit 32 (one block per SM):
    ten iterations' labels equal to the twins' loop, int8 and dense."""
    planes = _crf_image("scene", 92, 84).to(cuda)
    _, labels, *_ = _mf_state(cuda, (92, 84), (89, 81), n_labels=4)
    lg, lo = crf_device.unary_logs(0.7, 4)
    for kw in (dict(kernel_store="int8"), dict()):
        kern = crf_device.LandmarkKernel(planes.permute(1, 2, 0), 89, 81,
                                         **kw)
        _build.reset_launches()
        got = crf_device.mean_field_pair(kern, labels, 4, 0.7,
                                         n_label_cap=cap)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["crf_mean_field"] == 21
        q = crf_device.start_plain(labels, cap, 4, lg, lo)
        opnd, qscale = kern.operand(cap)
        assert opnd.shape[1] == 2 * crf_device.map_columns(cap)
        out = torch.empty_like(labels)
        for i in range(10):
            crf_device.quantize_plain(q, kern.nr_b, opnd, qscale)
            q = crf_device.combine_plain(
                q, labels, kern.nr_g, kern.nr_b, kern.taps,
                kern.product(opnd), qscale if kern.int8 else None, 4, lg,
                lo, out if i == 9 else torch.empty_like(q))
        assert torch.equal(got, out)


def test_crf_mean_field_refuses(cuda):
    """More than 32 channels per map, an output that is q itself, a
    product whose rows are not 16-byte aligned and more than 25 taps are
    refused before a launch."""
    q, labels, nr_g, nr_b, taps, lg, lo = _mf_state(cuda, (24, 28), (24, 28))
    prod = torch.zeros((24 * 28, 52), device=cuda)
    with pytest.raises(ValueError):
        crf_device.start(labels, 33, 6, lg, lo)
    with pytest.raises(ValueError):
        crf_device.combine(q, labels, nr_g, nr_b, taps, prod[:, :48], None, 6,
                           lg, lo, q)
    with pytest.raises(ValueError):
        crf_device.combine(q, labels, nr_g, nr_b, taps, prod[:, 1:49], None,
                           6, lg, lo, torch.empty_like(q))
    with pytest.raises(ValueError):
        crf_device.blur(q[0], crf_device.gaussian_taps(3.5))
    assert not any(_build.LAUNCHES.values())
