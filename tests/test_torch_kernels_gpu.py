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
from irn_tpu_torch.ops.affinity import path_table

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


# -- the bf16 operand mode of K2, K4, K5 and K6 (--rw_matmul_dtype bfloat16)

BF16 = torch.bfloat16


def _close_to_max(got, want, rtol=1e-5):
    """All finite and max |got - want| <= rtol max |want|: the kernels' f32
    sums of exact bf16 products in another order than the twin's."""
    assert bool(torch.isfinite(got).all())
    err = float((got.double() - want.double()).abs().max())
    assert err <= rtol * float(want.abs().max()), err


@pytest.mark.parametrize("n", [1024, 2048])
def test_square_banded_bf16(cuda, n):
    """K2's one-pass mode: the split pass (hi pieces, [2, n, W]) bit-equal
    to its twin; the product within rel 1e-5 of the f64 sum over those
    pieces and of the twin (bf16 operands, torch.matmul in f32) in band,
    with NaN in every input block beyond kb; two launches."""
    h, bs = 130, 128
    t = _banded(n, h).to(cuda)
    got = mk.square_banded(_poisoned(t, h, bs), h, bs, BF16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["square_banded"] == 2  # split, product
    r = torch.arange(n, device=cuda)
    inband = (r[:, None] - r[None, :]).abs() <= 2 * h
    for want in (mk.square_banded_split_plain(t, h, bs, BF16),
                 mk.square_banded_plain(t, h, bs, BF16)):
        _close_to_max(got[inband], want[inband])
    pieces = mk.split_banded(_poisoned(t, h, bs), h, bs, BF16)
    assert pieces.shape[0] == 2
    assert torch.equal(pieces, mk.split_banded_plain(t, h, bs, BF16))


@pytest.mark.parametrize("c", [8, 16])
def test_apply_banded_bf16(cuda, c):
    """K4's bf16 mode (x and T rounded as read) vs its twin, NaN beyond kb;
    one launch."""
    n, h, bs = 1024, 130, 128
    t = _banded(n, h).to(cuda)
    x = torch.rand((c, n), generator=torch.Generator().manual_seed(0)).to(cuda)
    got = mk.apply_banded(x, _poisoned(t, h, bs), h, bs, BF16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["apply_banded"] == 1
    _close_to_max(got, mk.apply_banded_plain(x, t, h, bs, BF16))


@pytest.mark.parametrize("n", [384, 1024])
def test_square_dense_bf16(cuda, n):
    """K5's one-pass mode: split pass bit-equal ([2, n, n]), the product
    within rel 1e-5 of the f64 hi.hi product and of the twin; two launches
    per squaring."""
    t = _banded(n, n).to(cuda)
    got = mk.square_dense(t, BF16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["square_dense"] == 2
    pieces = mk.split_identity(t, BF16)
    assert torch.equal(pieces, mk.split_identity_plain(t, BF16))
    _close_to_max(got, mk.split_product_plain(pieces))
    _close_to_max(got, mk.square_dense_plain(t, BF16))
    matpow.matrix_power_squarings(t, 3, BF16)
    assert _build.LAUNCHES["square_dense"] == 2 + 1 + 2 * 3


@pytest.mark.parametrize("n,lo", [(512, 0.3), (1024, 0.0), (4096, 0.3)])
def test_square_fused_first_bf16(cuda, n, lo):
    """K6's one-pass mode: the split pass (bf16 of A^beta and of
    A^beta * inv_k * inv_j) bit-equal to its twin, the product within rel
    1e-5 of the f64 product over those pieces and of the twin; two
    launches."""
    a = _affinity(n, lo).to(cuda)
    got = mk.square_fused_first(a, 10, BF16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["square_fused_first"] == 2
    inv = mk.fused_inv(a, 10)
    pieces = mk.split_operands(a, inv, 10, BF16)
    assert torch.equal(pieces, mk.split_operands_plain(a, inv, 10, BF16))
    _close_to_max(got, mk.split_product_plain(pieces))
    _close_to_max(got, mk.square_fused_first_plain(a, 10, BF16))


def test_walk_bf16_routes_on_the_card(cuda):
    """The bf16 routes launch the kernels' bf16 modes and no twin: the
    dense route (K6, then K5), e = E banded (K2, then K4); a chain of more
    applications raises before any launch."""
    geom = rw.build_geometry(16, 16, radius=5)
    g = np.random.default_rng(0)
    edge = torch.from_numpy(g.random((16, 16), dtype=np.float32)).to(cuda)
    rw.transition_matrix(rw.dense_affinity(geom, edge), 10, 4, BF16)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["square_fused_first"],
            _build.LAUNCHES["square_dense"]) == (2, 6)
    _build.reset_launches()
    small = rw.build_geometry(32, 32, radius=2)
    edge = torch.from_numpy(g.random((32, 32), dtype=np.float32)).to(cuda)
    cam = torch.from_numpy(g.random((3, 32, 32), dtype=np.float32)).to(cuda)
    got = rw.propagate_banded(small, cam, edge, 10, 3, square_times=3,
                              bs=128, matmul_dtype=BF16)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["square_banded"],
            _build.LAUNCHES["apply_banded"]) == (6, 1)
    want = rw.propagate_banded(small, cam.cpu(), edge.cpu(), 10, 3,
                               square_times=3, bs=128, matmul_dtype=BF16)
    _close_to_max(got.cpu(), want, 1e-2)
    _build.reset_launches()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rw.propagate_banded(small, cam, edge, 10, 3, square_times=1, bs=128,
                            matmul_dtype=BF16)
    assert not any(_build.LAUNCHES.values())


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
    beyond the (h4, w4) extent, as the forward hands it over; or one of
    ``tools/probe_advect``'s: a full-gain field (dp = centre - position,
    every particle still after a step or two), or particles running in
    cycles of 2 or 3 columns (a period that divides K11's chunk of 8, and
    one that does not)."""
    from irn_tpu_torch.tools import probe_advect as pa

    g = np.random.default_rng(seed)
    h, w = grid
    if kind == "full gain":
        dp = pa.pull_field(max(h, w), hw4, 1.0, 0.05, seed)[:, :h, :w]
        return torch.from_numpy(np.ascontiguousarray(dp))
    if kind.startswith("period"):
        return torch.from_numpy(pa.cycle_field(h, w, hw4, int(kind[-1])))
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


@pytest.mark.parametrize("kind", ["random", "basin", "full gain",
                                  "period 2", "period 3"])
@pytest.mark.parametrize("grid,hw4,staged", [
    ((128, 128), (128, 128), True), ((128, 128), (97, 128), True),
    ((32, 32), (19, 27), True), ((192, 192), (188, 181), False),
    ((36, 30), (29, 27), False)])
def test_advect_bit_equal(cuda, kind, grid, hw4, staged):
    """K11: end points and basin bit-equal to the twin after 300 steps, in
    one launch, by the instance the size picks (the 192 x 192 grid's
    staged rows exceed a CTA's shared memory, and a width of 30 is no
    multiple of 4: their taps go through L1)."""
    from irn_tpu_torch.ops import centroids

    dp = _dp_field(kind, grid, hw4).to(cuda)
    cent, basin = centroids.advect(dp, *hw4)
    want_cent, want_basin = centroids.advect_plain(dp, *hw4)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["advect"] == 1
    assert torch.equal(cent, want_cent) and torch.equal(basin, want_basin)
    assert int(cent[0].max()) < hw4[0] and int(cent[1].max()) < hw4[1]
    # the launch's own rule (chip_smoke reads the instance's name from the
    # profiler's device rows)
    assert centroids.advect_staged(grid[1], hw4[0]) == staged


@pytest.mark.parametrize("iterations", [0, 1, 7, 8, 9, 299])
@pytest.mark.parametrize("kind", ["basin", "full gain", "period 3"])
@pytest.mark.parametrize("grid,hw4", [((128, 128), (94, 125)),
                                      ((192, 192), (188, 181))])
def test_advect_iterations(cuda, kind, grid, hw4, iterations):
    """K11 at step counts around its chunk of 8 (the early stop's tail of
    ``left mod 8`` steps, and fewer than a chunk), both instances."""
    from irn_tpu_torch.ops import centroids

    dp = _dp_field(kind, grid, hw4).to(cuda)
    got = centroids.advect(dp, *hw4, iterations)
    want = centroids.advect_plain(dp, *hw4, iterations)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["advect"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_advect_unaligned(cuda):
    """K11 on a dp view whose storage starts 4 bytes past a 16-byte
    boundary (the staged rows are copied in 16-byte units): bit-equal."""
    from irn_tpu_torch.ops import centroids

    full = _dp_field("basin", (128, 128), (94, 125)).reshape(-1)
    buf = torch.empty(full.numel() + 1, device=cuda)
    buf[1:] = full.to(cuda)
    dp = buf[1:].view(2, 128, 128)
    assert dp.data_ptr() % 16 == 4
    got = centroids.advect(dp, 94, 125)
    want = centroids.advect_plain(dp, 94, 125)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
@pytest.mark.parametrize("grid,hw4", [((128, 128), (94, 125)),
                                      ((192, 192), (188, 181))])
def test_advect_nan(cuda, grid, hw4, value):
    """K11 with NaN or an infinity in dp, inside the extent and beyond the
    taps' reach (rows past h4, columns past w4), or beyond it alone:
    bit-equal to the twin, whose end points are JAX's
    (tests/test_torch_advect_nan.py), in one launch per call."""
    from irn_tpu_torch.ops import centroids
    from irn_tpu_torch.tools import probe_advect as pa

    dp = torch.from_numpy(pa.nan_field(grid[0], hw4, value=value)).to(cuda)
    got = centroids.advect(dp, *hw4)
    want = centroids.advect_plain(dp, *hw4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    outside = dp.clone()
    outside[:, : hw4[0] + 1, : hw4[1] + 1] = _dp_field(
        "basin", grid, hw4).to(cuda)[:, : hw4[0] + 1, : hw4[1] + 1]
    got = centroids.advect(outside, *hw4)
    want = centroids.advect_plain(outside, *hw4)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not bool(got[1][hw4[0] + 1:].any())
    assert _build.LAUNCHES["advect"] == 2


@pytest.mark.parametrize("seed", range(6))
def test_advect_nan_plants(cuda, seed):
    """K11 on small grids with NaN and infinities planted as
    tests/test_torch_advect_nan.py plants them (blocks of one-signed
    infinities that some particles tap with positive weight; several kinds
    at once; both instances): bit-equal to the twin; then on the clean
    field again, bit-equal (the scratch's next set was left ready)."""
    from irn_tpu_torch.ops import centroids

    g = np.random.default_rng(seed)
    for grid in ((32, 32), (36, 30), (6, 8)):
        h, w = grid
        hw4 = (int(g.integers(1, h + 1)), int(g.integers(1, w + 1)))
        clean = (g.standard_normal((2, h, w)) * 1.5).astype(np.float32)
        dp = clean.copy()
        v = g.choice([np.nan, np.inf, -np.inf])
        r, c = int(g.integers(0, hw4[0])), int(g.integers(0, hw4[1]))
        for k in ((0,), (1,), (0, 1))[seed % 3]:
            dp[k, r:r + 2, c:c + 2] = v if seed % 2 else np.inf
        for field in (dp, clean):
            t = torch.from_numpy(field).to(cuda)
            for iterations in (1, 2, 300):
                got = centroids.advect(t, *hw4, iterations)
                want = centroids.advect_plain(t, *hw4, iterations)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                    grid, hw4, iterations)


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


@pytest.mark.parametrize("case,grid,hw", [
    ("sparse", (128, 128), None), ("dense", (128, 128), None),
    ("spiral", (128, 128), None), ("extent", (128, 128), (97, 113)),
    ("dense", (92, 84), None), ("dense", (97, 113), None),
    ("dense", (128, 128), (92, 84)), ("dense", (2048, 2048), None),
    ("spiral", (2048, 2048), None)])
def test_ccl_label_masks(cuda, case, grid, hw):
    """K12a on masks equals its twin in one launch: the basin plane
    (128x128), the extent cut (97x113, 92x84), grids that are not
    multiples of the 32x32 tile (92x84, 97x113), and 2048x2048 (4096
    tiles, more than the card's resident CTAs: each CTA loops)."""
    from irn_tpu_torch.ops import ccl

    g = np.random.default_rng(1)
    mask = {"sparse": lambda: g.random(grid) < 0.3,
            "dense": lambda: g.random(grid) < 0.6,
            "spiral": lambda: _spiral(grid[0]),
            "extent": lambda: g.random(grid) < 0.55}[case]()
    hw = hw or grid
    m = torch.from_numpy(mask).to(cuda)
    got = ccl.min_label_plane(m, *hw)
    # the twin on the card: its sweeps at 2048x2048 take minutes on a host
    want = ccl.min_label_plane_plain(m & ccl._extent(*grid, *hw, cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ccl_label"] == 1
    assert _build.LAUNCHES["ccl_tables"] == 0
    assert torch.equal(got, want)


def _label_map(case, shape, g):
    h, w = shape
    return {
        "blobby": lambda: np.kron(g.integers(0, 9, (-(-h // 16), -(-w // 16))),
                                  np.ones((16, 16), int))[:h, :w],
        "speckle": lambda: g.integers(0, 4, shape),
        "spiral_touching": lambda: np.where(_spiral(h), 1, 2),
        "empty": lambda: np.zeros(shape, int),
    }[case]().astype(np.int32)


@pytest.mark.parametrize("case,shape", [
    ("blobby", (512, 512)), ("speckle", (512, 512)),
    ("spiral_touching", (512, 512)), ("blobby", (500, 500)),
    ("speckle", (500, 500)), ("speckle", (97, 113))])
def test_ccl_label_maps(cuda, case, shape):
    """K12a on label maps (the decoded walk at the 128x128 bucket, VOC's
    largest image, a grid that is not a multiple of the tile): same-value
    components only, equal to its twin."""
    from irn_tpu_torch.ops import ccl

    g = np.random.default_rng(2)
    t = torch.from_numpy(_label_map(case, shape, g)).to(cuda)
    got = ccl.min_label_plane_multi(t)
    want = ccl.min_label_plane_multi_plain(t)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ccl_label"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("case,k_cap", [
    ("random", 8), ("overflow", 8), ("escape", 8), ("empty", 8),
    ("escape", 1), ("overflow", 1), ("random", 1), ("speckle", 8)])
def test_cluster_masks_exact(cuda, case, k_cap):
    """K12b cluster masks and n_found at the basin plane (128x128, extent
    97x121) equal the twin's, K12a and K12b in one launch, overflow
    (n_found = k_cap + 1) included; k_cap 1 with the escape bucket (it
    takes the one mask) and past it; a speckled basin whose landing slots
    outnumber k_cap + 1 many times (the radix select)."""
    from irn_tpu_torch.ops import ccl

    g = np.random.default_rng(3)
    h4, w4 = 97, 121
    basin = g.random((128, 128)) < {"random": 0.3, "overflow": 0.05,
                                     "escape": 0.02, "empty": 0.0,
                                     "speckle": 0.3}[case]
    if case == "random":  # a few large basins
        basin = np.kron(g.random((8, 8)) < 0.4, np.ones((16, 16), bool))
    cent = np.stack([g.integers(0, h4, (128, 128)),
                     g.integers(0, w4, (128, 128))]).astype(np.int32)
    b, c = torch.from_numpy(basin).to(cuda), torch.from_numpy(cent).to(cuda)
    masks, n_found = ccl.cluster_from_basin(b, c, h4, w4, k_cap)
    want_masks, want_n = ccl.cluster_from_basin(b.cpu(), c.cpu(), h4, w4,
                                                k_cap)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ccl_tables"] == 1  # the one launch runs both
    assert _build.LAUNCHES["ccl_label"] == 1
    assert masks.shape == (k_cap, 128, 128) and masks.dtype == torch.uint8
    assert torch.equal(masks.cpu(), want_masks)
    assert int(n_found) == int(want_n)
    if case in ("overflow", "speckle") or (case == "escape" and k_cap == 1):
        assert int(n_found) == k_cap + 1
    if case == "escape":  # the escape bucket ranks first
        esc = (b.cpu() == 0) | (torch.arange(128)[:, None] >= h4)
        esc = esc[c[0].long().cpu(), c[1].long().cpu()]
        assert bool(esc.any()) and torch.equal(
            masks[0].cpu().bool()[:h4, :w4], esc[:h4, :w4])


def test_cluster_masks_on_a_given_plane(cuda):
    """K12b alone (cluster_masks on K12a's plane): one launch, no K12a,
    equal to the twin."""
    from irn_tpu_torch.ops import ccl

    g = np.random.default_rng(5)
    h4, w4 = 92, 84
    basin = torch.from_numpy(g.random((96, 96)) < 0.2).to(cuda)
    cent = torch.from_numpy(np.stack([g.integers(0, h4, (96, 96)),
                                      g.integers(0, w4, (96, 96))]).astype(
        np.int32)).to(cuda)
    lab = ccl.min_label_plane(basin, h4, w4)
    _build.reset_launches()
    masks, n_found = ccl.cluster_masks(lab, cent, h4, w4, 8)
    want_masks, want_n = ccl.cluster_masks_plain(lab, cent, h4, w4, 8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ccl_tables"] == 1
    assert _build.LAUNCHES["ccl_label"] == 0
    assert torch.equal(masks, want_masks) and int(n_found) == int(want_n)


@pytest.mark.parametrize("case,shape,cap", [
    ("blobby", (512, 512), 128), ("blobby", (512, 512), 8),
    ("speckle", (512, 512), 128), ("empty", (512, 512), 128),
    ("blobby", (500, 500), 128), ("speckle", (512, 512), 1),
    ("speckle", (512, 512), 4096), ("speckle", (97, 113), 4096),
    ("blobby", (92, 84), 1)])
def test_component_tables_exact(cuda, case, shape, cap):
    """K12b component tables: all five outputs equal the twin's, K12a and
    K12b in one launch; overflow (cap 8 on the blobby map, 1, 128 and 4096
    on speckle: tens of thousands of components through the radix select)
    included; VOC's largest image (500x500); a grid under the cap's
    count (97x113 at cap 4096: every component ranked)."""
    from irn_tpu_torch.ops import ccl

    g = np.random.default_rng(4)
    labels = _label_map(case, shape, g)
    best = g.random(shape, dtype=np.float32)
    lt, bt = torch.from_numpy(labels).to(cuda), torch.from_numpy(best).to(cuda)
    got = ccl.component_tables(lt, bt, cap)
    want = ccl.component_tables_plain(lt, bt, cap)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ccl_tables"] == 1
    assert _build.LAUNCHES["ccl_label"] == 1
    for name, a, b in zip(("comp_map", "rows", "sizes", "scores", "n_comp"),
                          got, want):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    roots = ccl.min_label_plane_multi_plain(lt) == torch.arange(
        lt.numel(), device=cuda, dtype=torch.int32).view(shape)
    n = int((roots & (lt > 0)).sum())  # the components
    assert int(got[4]) == min(n, cap + 1)


def test_rank_tables_on_a_given_plane(cuda):
    """K12b alone (rank_tables on K12a's plane): one launch, no K12a,
    equal to the twin."""
    from irn_tpu_torch.ops import ccl

    g = np.random.default_rng(6)
    lt = torch.from_numpy(_label_map("speckle", (200, 300), g)).to(cuda)
    bt = torch.from_numpy(g.random((200, 300), dtype=np.float32)).to(cuda)
    minidx = ccl.min_label_plane_multi(lt)
    _build.reset_launches()
    got = ccl.rank_tables(lt, minidx, bt, 128)
    want = ccl.rank_tables_plain(lt, minidx, bt, 128)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ccl_tables"] == 1
    assert _build.LAUNCHES["ccl_label"] == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ccl_caps_refused_on_the_card(cuda):
    """The card keeps the cap + 1 smallest keys in shared memory: a cap over
    4096 raises before any launch."""
    from irn_tpu_torch.ops import ccl

    b = torch.zeros((32, 32), dtype=torch.bool, device=cuda)
    c = torch.zeros((2, 32, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ccl.cluster_from_basin(b, c, 32, 32, ccl.TABLES_CAP_MAX + 1)
    lt = torch.ones((32, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ccl.component_tables(lt, torch.zeros((32, 32), device=cuda),
                             ccl.TABLES_CAP_MAX + 1)
    assert _build.LAUNCHES["ccl_label"] == _build.LAUNCHES["ccl_tables"] == 0


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


def _same_bits(a, b):
    """Equal, NaN where the other has NaN (any payload)."""
    return a.shape == b.shape and torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("beta", [1, 3, 10])
@pytest.mark.parametrize("kind", ["sigmoid", "quantized", "ones", "nan"])
@pytest.mark.parametrize("radius,cap", [(5, (96, 128)), (5, (128, 96)),
                                        (5, (128, 128)), (5, (20, 28)),
                                        (2, (24, 24)), (10, (32, 40)),
                                        (4, (40, 36)), (8, (30, 34)),
                                        (14, (40, 48))])
def test_diag_operator_bit_equal(cuda, radius, cap, kind, beta):
    """K10 bit-equal to its twin on the card and on the host, one launch
    and no table copy: the three buckets of the default grid cap, odd small
    grids, radii 2, 4, 5 and 8 (the staged schedule) and 10 and 14 (the
    direct one), ties, NaN and -inf planted (NaN where the twin has NaN),
    beta a run-time integer; the edge passed as the stage's non-contiguous
    slice."""
    geom = rw.build_geometry(*cap, radius=radius)
    assert (rw.diag_operator_schedule(path_table(geom.path_set)) is None) \
        == (radius >= 10)
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
    assert _same_bits(w, want_w) and _same_bits(inv, want_inv)
    assert _same_bits(w.cpu(), host_w) and _same_bits(inv.cpu(), host_inv)
    if kind != "nan":
        assert torch.equal(w, want_w) and torch.equal(inv, want_inv)


def test_diag_operator_one_device_operation(cuda):
    """K10 at the default walk's bucket is one kernel and nothing else on
    the card: no table copy, no memset (the profiler's device rows)."""
    geom = rw.build_geometry(96, 128, radius=5)
    edge = _walk_edge("sigmoid", (96, 128), seed=1).to(cuda)
    rw.build_diag_operator(geom, edge)
    torch.cuda.synchronize()
    rows = _device_rows(lambda: rw.build_diag_operator(geom, edge), 3)
    # the profiler may drop a call's events, never add one
    assert 0 < sum(rows.values()) <= 3 and len(rows) == 1, rows
    assert "diag_operator" in next(iter(rows))


def _device_rows(fn, reps):
    """The card's rows (kernels, copies, memsets) of ``reps`` calls of fn
    under torch.profiler: name -> count."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _decode_case(case, c, shape=(96, 128), seed=0):
    """(rw [C, ch, cw], h4, w4, h0, w0, bg_thres): random scores at odd
    extents, all zeros, equal leading rows (the first wins), a row at
    exactly bg_thres after the normalization (the background wins), or
    random scores with NaN planted."""
    g = np.random.default_rng(seed)
    ch, cw = shape
    h4, w4 = ch - 3, cw - 5
    h0, w0 = 4 * h4 - 2, 4 * w4 - 3
    rw_ = np.zeros((c, ch, cw), np.float32)
    bg = 0.35
    if case in ("random", "nan"):
        rw_[:, :h4, :w4] = g.random((c, h4, w4))
    elif case == "equal_rows":
        rw_[:, :h4, :w4] = g.random((c, h4, w4)) * 0.5
        rw_[min(1, c - 1), :h4, :w4] = rw_[0, :h4, :w4] = \
            1 + g.random((h4, w4))
    elif case == "bg_tie":
        bg = 0.25
        rw_[0, :h4, :w4] = 0.25
        rw_[-1, min(10, ch // 4): min(40, ch // 2),
            min(20, cw // 4): min(60, cw // 2)] = 1.0
    if case == "nan":
        rw_[c // 2, h4 // 2, w4 // 3] = np.nan
    return torch.from_numpy(rw_), h4, w4, h0, w0, bg


def _decode_equal(got, want):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and _same_bits(a.float(), b.float())
            assert a.dtype != torch.float32 or torch.equal(
                a.view(torch.int32)[~a.isnan()], b.view(torch.int32)[~b.isnan()])


@pytest.mark.parametrize("case", ["random", "zeros", "equal_rows",
                                  "bg_tie", "nan"])
@pytest.mark.parametrize("c,shape", [(8, (96, 128)), (128, (96, 128)),
                                     (1, (128, 128)), (16, (128, 128)),
                                     (17, (128, 128)), (1, (32, 32)),
                                     (16, (32, 32)), (17, (32, 32)),
                                     (16, (96, 128))])
def test_decode_bit_equal(cuda, c, shape, case):
    """K15 bit-equal to its twin on the card (labels, max, normalized
    scores, best) in one cooperative launch, at C 1, 8, 16 (values kept in
    registers across the grid barrier) and 17, 128 (recomputed), at the
    walk's buckets; its labels equal to the host's; the upsample alone in
    one launch; without scores no [C, 4H, 4W] tensor; int32 labels on
    request."""
    x, h4, w4, h0, w0, bg = _decode_case(case, c, shape)
    xd = x.to(cuda)
    full = rw.decode(xd, h4, w4, h0, w0, bg, scores=True, best=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode"] == 1
    want = rw.decode_plain(xd, h4, w4, h0, w0, bg, scores=True, best=True)
    _decode_equal(full, want)
    lean = rw.decode(xd, h4, w4, h0, w0, bg, best=True)
    assert lean.scores is None
    _decode_equal(lean, want._replace(scores=None))
    host = rw.decode_plain(x, h4, w4, h0, w0, bg)
    assert torch.equal(lean.labels.cpu(), host.labels)
    small = rw.decode(xd, h4, w4, h0, w0, bg, labels_dtype=torch.int32)
    assert small.labels.dtype == torch.int32 and small.best is None
    assert torch.equal(small.labels, want.labels.to(torch.int32))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode"] == 3
    up = rw.upsample_scores(xd, h4, w4, h0, w0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode"] == 4
    _decode_equal((up,), (rw.upsample_scores_plain(xd, h4, w4, h0, w0),))
    if case == "equal_rows" and c > 1:
        assert not (want.labels == 2).any()
    if case == "bg_tie" and c > 1:
        assert not (want.labels == 1).any()
    if case == "nan":
        assert want.max_score.isnan()


def test_decode_one_device_operation(cuda):
    """K15 at make_sem_seg's call (C 8, the 96 x 128 bucket) is one kernel
    and nothing else on the card once its scratch exists: no memset, and
    back-to-back calls find the barrier counters zeroed."""
    x, h4, w4, h0, w0, bg = _decode_case("random", 8)
    xd = x.to(cuda)
    want = rw.decode_plain(xd, h4, w4, h0, w0, bg)
    rw.decode(xd, h4, w4, h0, w0, bg)
    torch.cuda.synchronize()
    rows = _device_rows(lambda: rw.decode(xd, h4, w4, h0, w0, bg), 5)
    assert 0 < sum(rows.values()) <= 5 and len(rows) == 1, rows
    assert "decode" in next(iter(rows))
    outs = [rw.decode(xd, h4, w4, h0, w0, bg) for _ in range(20)]
    assert all(torch.equal(o.labels, want.labels) for o in outs)


def test_walk_labels_int32(cuda):
    """RandomWalkRunner.walk on the card: K15 writes the int32 labels
    itself (one decode launch, no conversion), equal to the twin's labels
    as int32, and best bit-equal."""
    from irn_tpu_torch.pipeline.config import Config
    from irn_tpu_torch.pipeline.stages_irn import RandomWalkRunner

    cfg = Config(voc12_root=".", train_list="-", infer_list="-")
    runner = RandomWalkRunner(cfg, 8, cuda)
    g = torch.Generator().manual_seed(0)
    seeds = torch.rand((5, 32, 64), generator=g).to(cuda)
    edge = torch.rand((cfg.rw_grid_cap, cfg.rw_grid_cap), generator=g)
    edge = edge.to(cuda)
    labels, best = runner.walk(seeds, edge, 30, 60, (118, 237), 0.25)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode"] == 1
    pad = torch.nn.functional.pad(seeds, (0, 0, 0, 0, 0, 3))
    y = runner._propagate(pad, edge, 32, 64)
    want = rw.decode_plain(y, 30, 60, 118, 237, 0.25, best=True)
    assert labels.dtype == torch.int32
    assert torch.equal(labels, want.labels.to(torch.int32))
    assert torch.equal(best, want.best)


@pytest.mark.parametrize("store", ["int8", "dense"])
@pytest.mark.parametrize("pm", [1, 50])
def test_crf_pair_any_pad_multiple(cuda, monkeypatch, pm, store):
    """The device CRF at a ``pad_multiple`` that is not a multiple of 4: a
    61 x 375 image pads to 61 x 376 at 1 and 100 x 400 at 50 (the width a
    multiple of lcm(pad_multiple, 4)), K17's tensor map takes q, and the
    labels equal the same pair with K17's start, quantize and combine
    through their twins on the card."""
    img = _crf_image("scene", 61, 375, seed=pm).permute(1, 2, 0).numpy()
    g = np.random.default_rng(pm)
    la = np.zeros((61, 375), np.int32)
    la[:, :180] = 2
    la[30:, 200:] = 4
    la[g.random(la.shape) < 0.05] = 1
    lb = (la > 0).astype(np.int32) * 3
    crf = crf_device.LandmarkCRF(pad_multiple=pm, kernel_store=store, t=5,
                                 device=cuda)
    assert crf._bucket(61, 375) == {1: (61, 376), 50: (100, 400)}[pm]
    got = crf.pair(img, la, lb, n_labels=5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["crf_mean_field"] == 2 + 2 * 5
    for name in ("start", "quantize", "combine"):
        monkeypatch.setattr(crf_device, name,
                            getattr(crf_device, name + "_plain"))
    want = crf.pair(img, la, lb, n_labels=5)
    torch.cuda.synchronize()
    # the twins' run launches only the validity mask's blur
    assert _build.LAUNCHES["crf_mean_field"] == 2 + 2 * 5 + 1
    for a, b in zip(got, want):
        assert a.shape == (61, 375) and np.array_equal(a, b)


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


# -- several workers on one card ---------------------------------------------

def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out if o is not None for t in _flat(o)]


def _two_streams(cuda, fn, kernels, reps=8):
    """fn() launched serially, then 2 x ``reps`` times from the two workers
    of a DeviceSpreader over [cuda, cuda] (two threads, two streams, their
    launches interleaved on the card): every result bit-equal to the
    serial one (NaN where it has NaN), and each of ``kernels`` counted once
    per call on either worker."""
    from irn_tpu_torch.pipeline import common

    want = _flat(fn())
    torch.cuda.synchronize()
    per_call = {k: _build.LAUNCHES[k] for k in kernels}
    _build.reset_launches()
    spread = common.DeviceSpreader([cuda, cuda])
    spread.setup(lambda d: [])
    outs = spread.run(range(2 * reps), lambda ctx, c, b: ctx.append(
        _flat(fn())))
    assert [len(o) for o in outs] == [reps, reps]
    assert spread.streams[0] != spread.streams[1]
    for got in outs[0] + outs[1]:
        for a, b in zip(got, want):
            assert torch.equal(a, b) or (
                a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(), b.nan_to_num()))
    for k in kernels:
        assert _build.LAUNCHES[k] == 2 * reps * per_call[k] > 0, k


def test_two_streams_diag_chain(cuda):
    """K10's build and K0's cluster chain (make_sem_seg's walk at the 96 x
    128 bucket, 8 seed rows, 256 applications) from two workers."""
    geom = rw.build_geometry(96, 128, radius=5)
    g = np.random.default_rng(0)
    edge = torch.from_numpy(g.random((96, 128), dtype=np.float32)).to(cuda)
    x = torch.from_numpy(g.random((8, geom.n_pad), dtype=np.float32)).to(cuda)
    doffs = rw.diag_offsets(geom)

    def fn():
        w, inv = rw.build_diag_operator(geom, edge)
        return rw.apply_diag_chain(x, w, inv, doffs, 256)

    _two_streams(cuda, fn, ("diag_operator", "diag_chain"))


def test_two_streams_advect(cuda):
    """K11's cooperative advection from two workers."""
    from irn_tpu_torch.ops import centroids

    dp = _dp_field("basin", (128, 128), (94, 125)).to(cuda)
    _two_streams(cuda, lambda: centroids.advect(dp, 94, 125), ("advect",))


def test_two_streams_ccl(cuda):
    """K12's cooperative labelling and tables (the instance stage's two
    calls) from two workers."""
    from irn_tpu_torch.ops import ccl, centroids

    dp = _dp_field("basin", (128, 128), (94, 125)).to(cuda)
    cent, basin = centroids.advect(dp, 94, 125)
    g = np.random.default_rng(4)
    labels = torch.from_numpy(_label_map("blobby", (512, 512), g)).to(cuda)
    best = torch.from_numpy(g.random((512, 512), dtype=np.float32)).to(cuda)

    def fn():
        return (ccl.cluster_from_basin(basin, cent, 94, 125, 8),
                ccl.component_tables(labels, best, 128))

    _two_streams(cuda, fn, ("ccl_label", "ccl_tables"))


def test_two_streams_decode(cuda):
    """K15's cooperative decode from two workers, its per-stream scratch
    made once per stream."""
    x, h4, w4, h0, w0, bg = _decode_case("random", 8)
    xd = x.to(cuda)
    _two_streams(cuda, lambda: rw.decode(xd, h4, w4, h0, w0, bg,
                                          best=True), ("decode",))


@pytest.mark.parametrize("c", [8, 128])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("largest", [False, True], ids=["m1", "mmax"])
def test_mesh_diag_apply_bit_equal(cuda, c, k, largest):
    """The column-split stencil on (cuda,) * k (``rw_sharded.diag_apply``):
    K0 on each device's window per round, bit-equal to K0 on the whole
    matrix, one launch per device and round (64x64 bucket, n 5120, 16
    applications; m = 1 and the largest, 1 at k 8)."""
    from irn_tpu_torch.parallel import rw_sharded as rs

    geom = rw.build_geometry(64, 64, radius=5)
    g = np.random.default_rng(k)
    edge = torch.from_numpy(g.random((64, 64), dtype=np.float32)).to(cuda)
    w, inv = rw.build_diag_operator(geom, edge)
    x = torch.from_numpy(g.random((c, geom.n_pad), dtype=np.float32)).to(cuda)
    doffs = rw.diag_offsets(geom)
    m = rs.diag_max_per_round(geom.n_pad, doffs, k) if largest else 1
    want = rw.apply_diag_chain(x, w, inv, doffs, 16)
    _build.reset_launches()
    got = rs.diag_apply(x, w, inv, doffs, 16, rs.ModelMesh([cuda] * k), m)
    torch.cuda.synchronize()
    plan = rs.diag_plan(geom.n_pad, doffs, k, 16, m)
    assert _build.LAUNCHES["diag_chain"] == plan.rounds * k
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_banded_matches_banded(cuda, k):
    """The row-split banded route (``propagate(..., mesh)`` at square_times
    1: ``torch.matmul`` products in f32) against the single-device banded
    route (K2, K1 + K3): scores within 1e-5 / 1e-4, labels equal."""
    from irn_tpu_torch.parallel import rw_sharded as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    geom = rw.build_geometry(64, 64, radius=5)
    g = np.random.default_rng(0)
    edge = torch.from_numpy(
        g.random((64, 64), dtype=np.float32) * 0.9).to(cuda)
    cam = torch.from_numpy(g.random((8, 64, 64), dtype=np.float32)).to(cuda)
    got = rw.propagate(geom, cam, edge, 10, 4, square_times=1,
                       mesh=rs.ModelMesh([cuda] * k))
    want = rw.propagate_banded(geom, cam, edge, 10, 4, square_times=1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert torch.equal(rw.decode(got, 60, 61, 240, 243, 0.25).labels,
                       rw.decode(want, 60, 61, 240, 243, 0.25).labels)
