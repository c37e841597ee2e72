"""``--rw_matmul_dtype bfloat16``: the bf16 operand mode of K2, K4, K5 and
K6 and of the walk routes over them, against the JAX package at
``matmul_dtype=jnp.bfloat16`` on the same seeded numpy inputs (CPU).

The port's kernels run their plain twins here (bf16-rounded operands
multiplied in f32); the Pallas kernels run in interpret mode, through
``pl.pallas_call(..., interpret=True)`` where the public function refuses
the CPU, as tests/test_torch_matpow.py runs them. Each product of two bf16
values is exact in f32, so a twin differs from the JAX kernel only by the
order of its f32 sums: within 2e-6 of the output's max.

The dense route's reference is the JAX package's TPU route, which the
port's dense route mirrors (``IRN_TPU_MATPOW=fused``: the first squaring
fused with the transition build, its operands rounded after the pow and
the column scale, then ``square_pallas``): on the CPU the JAX package takes
XLA's dot instead (bf16 of the normalized T), a rounding of its own that
lands some 0.3-0.5 of the scores' max from the port's after eight bf16
squarings, while both land some 0.2-0.5 from the f64 walk. The fixture
``jax_tpu_route`` runs that route on the CPU (``selected_path`` "fused",
its Pallas kernels in interpret mode); nothing in the JAX package changes.
Walk gates: scores within 1e-2 of their max, labels >= 99% equal, and no
farther from the f64 walk than 1.25x JAX bf16's own distance plus 1e-6.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from irn_tpu.data import synthetic
from irn_tpu.models.irn import IRNet as JaxIRNet
from irn_tpu.ops import matpow as jmatpow
from irn_tpu.ops import matpow_pallas as jmp
from irn_tpu.ops import random_walk as jrw
from irn_tpu.parallel import mesh as jmesh
from irn_tpu.parallel import rw_sharded as jrs
from irn_tpu.pipeline.config import Config
from irn_tpu.pipeline.stages_irn import (
    make_ins_seg_labels as jax_make_ins_seg,
    make_sem_seg_labels as jax_make_sem_seg,
)
from irn_tpu.utils import checkpoint as jax_ckpt
from irn_tpu_torch.data.image_io import imread
from irn_tpu_torch.data.synthetic import write_gt_cams
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import matpow as tmp
from irn_tpu_torch.ops import matpow_kernels as tmk
from irn_tpu_torch.ops import random_walk as trw
from irn_tpu_torch.parallel import rw_sharded as trs
from irn_tpu_torch.pipeline import run as port_run

torch.set_num_threads(2)

BF16 = torch.bfloat16
TWIN_RTOL = 2e-6
BG = 0.25  # make_sem_seg's bg threshold


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel_close(got, want, rtol, mask=None):
    """max |got - want| <= rtol * max |want| (over ``mask``), all finite."""
    if mask is not None:
        got, want = got[mask], want[mask]
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _banded(rng, n, h):
    """Column-stochastic T with band halfwidth h (true zeros outside)."""
    r = np.arange(n)
    band = np.abs(r[:, None] - r[None, :]) <= h
    t = np.zeros((n, n), np.float32)
    t[band] = rng.random(band.sum(), dtype=np.float32) * 0.01
    t /= t.sum(0, keepdims=True)
    return t, r


def _poison_blocks(t, r, h, bs):
    """T with every bs x bs block beyond kb = ceil(h/bs) NaN: where
    square_banded's output is unspecified, so neither side may read it."""
    kb = -(-h // bs)
    bi = r // bs
    tp = t.copy()
    tp[np.abs(bi[:, None] - bi[None, :]) > kb] = np.nan
    return tp


def _interpret(orig):
    def call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)
    return call


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach a kernel: every launch counter stays 0."""
    _build.reset_launches()
    yield
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


@pytest.fixture
def jax_tpu_route(monkeypatch):
    """The JAX package's fused TPU route on the CPU: ``selected_path``
    "fused" and every Pallas kernel in interpret mode."""
    monkeypatch.setattr(jmatpow, "selected_path", lambda: "fused")
    monkeypatch.setattr(pl, "pallas_call", _interpret(pl.pallas_call))


# -- the split passes -------------------------------------------------------

def test_one_pass_pieces_are_the_hi_pieces(rng):
    """The one-pass split of K5, K6 and K2 writes bf16(x) (JAX's
    ``astype(bfloat16)``), exactly the hi pieces of the six-pass split, in
    the same layouts."""
    n, bs, h, beta = 256, 128, 70, 10
    t = _t(rng.random((n, n), dtype=np.float32))
    one = tmk.split_identity(t, BF16)
    six = tmk.split_identity(t)
    assert one.shape == (2, n, n) and one.dtype == BF16
    assert torch.equal(one, six[[0, 3]])
    assert torch.equal(one[0], t.to(BF16))
    a = _t(rng.uniform(0.3, 1.0, (n, n)).astype(np.float32))
    inv = tmk.fused_inv(a, beta)
    one = tmk.split_operands(a, inv, beta, BF16)
    assert torch.equal(one, tmk.split_operands(a, inv, beta)[[0, 3]])
    left, right = tmk.fused_operands(a, inv, beta)
    assert torch.equal(one[0], left.to(BF16))
    assert torch.equal(one[1], right.t().to(BF16))
    one = tmk.split_banded(t, h, bs, BF16)
    assert torch.equal(one, tmk.split_banded(t, h, bs)[[0, 3]])
    assert tmk.split_products(2) == ((0, 0),)
    assert tmk.split_products(6) == tmk.SPLIT_PRODUCTS


# -- the twins against the JAX kernels ---------------------------------------

def _differs_from_f32(got, f32):
    """The bf16 result is not the f32 one: a wrapper that dropped the mode
    would fail here."""
    assert np.abs(got - f32).max() > 1e-4 * np.abs(f32).max()


@pytest.mark.parametrize("n", [256, 384])
def test_square_dense_bf16_matches_jax(rng, n):
    """K5's bf16 twin vs square_pallas's kernel body on the bf16 operand
    (interpret mode) and JAX's ``matmul_square`` at bf16 (XLA's dot);
    K5's own arithmetic, the hi.hi product of its one-pass split (f64),
    and ``matmul_square`` vs both."""
    t = rng.random((n, n), dtype=np.float32)
    t /= t.sum(0, keepdims=True)
    kernel = pl.pallas_call(
        functools.partial(jmp._square_kernel, matmul_dtype=None),
        interpret=True, **jmp._grid_spec(n, 128, 128, 128))
    tb = jnp.asarray(t).astype(jnp.bfloat16)
    want = np.asarray(kernel(tb, tb))
    dot = np.asarray(jmatpow.matmul_square(jnp.asarray(t), jnp.bfloat16))
    got = tmk.square_dense(_t(t), BF16).numpy()
    _rel_close(got, want, TWIN_RTOL)
    _rel_close(got, dot, TWIN_RTOL)
    split = tmk.split_product_plain(tmk.split_identity(_t(t), BF16)).numpy()
    _rel_close(split, want, TWIN_RTOL)
    np.testing.assert_array_equal(tmp.matmul_square(_t(t), BF16).numpy(), got)
    _differs_from_f32(got, tmk.square_dense(_t(t)).numpy())


@pytest.mark.parametrize("n", [256, 384])
def test_square_fused_first_bf16_matches_jax(rng, n):
    """K6's bf16 arithmetic (its operands, each rounded after the f32 pow
    and scale, then multiplied in f32) on JAX's column scale vs
    square_fused_first's kernel body at matmul_dtype bfloat16 with its two
    inv_colsum BlockSpecs (interpret mode), beta 10, within the twins'
    2e-6; its one-pass split product vs the same. The wrapper's twin
    computes its own column scale: torch sums the columns in another order
    than XLA (about half of the n scales differ in their last bit), so some
    operands round to the other bf16 neighbour, each moving its (non-
    negative) term by at most 2^-8 of it: within 2^-8 of the max."""
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
        functools.partial(jmp._fused_kernel, beta=beta,
                          matmul_dtype=jnp.bfloat16),
        interpret=True, **jmp._grid_spec(n, 128, 128, 128, extra_in=extra))
    want = np.asarray(kernel(jnp.asarray(a), jnp.asarray(a), inv, inv))
    jinv = _t(np.asarray(inv)[0])
    same = tmk.matmul(*tmk.fused_operands(_t(a), jinv, beta), BF16).numpy()
    _rel_close(same, want, TWIN_RTOL)
    pieces = tmk.split_operands(_t(a), jinv, beta, BF16)
    _rel_close(tmk.split_product_plain(pieces).numpy(), want, TWIN_RTOL)
    got = tmk.square_fused_first(_t(a), beta, BF16).numpy()
    _rel_close(got, want, 2.0 ** -8)
    _differs_from_f32(got, tmk.square_fused_first(_t(a), beta).numpy())


@pytest.mark.parametrize("n,h", [(1024, 130), (512, 130)],
                         ids=["band", "covers"])
def test_square_banded_bf16_matches_jax(rng, n, h):
    """K2's bf16 twin vs the Pallas square_banded at matmul_dtype bfloat16
    (interpret mode) within the 2h output band, with NaN in every input
    block beyond kb where the band fits; where it covers the matrix both
    take the dense bf16 dot. The one-pass split product vs the same."""
    bs = 128
    t, r = _banded(rng, n, h)
    nb, kb, jb, covers = tmk._square_bands(n, h, bs)
    assert covers == (n == 512)
    tp = t if covers else _poison_blocks(t, r, h, bs)
    want = np.asarray(jmp.square_banded(jnp.asarray(tp), h,
                                        matmul_dtype=jnp.bfloat16, bs=bs,
                                        interpret=True))
    got = tmk.square_banded(_t(tp), h, bs, BF16).numpy()
    inband = np.abs(r[:, None] - r[None, :]) <= 2 * h
    _rel_close(got, want, TWIN_RTOL, inband)
    split = tmk.square_banded_split_plain(_t(tp), h, bs, BF16).numpy()
    _rel_close(split, want, TWIN_RTOL, inband)
    _differs_from_f32(got[inband], tmk.square_banded(_t(t), h, bs).numpy()[
        inband])


@pytest.mark.parametrize("n,h,c", [(1024, 130, 8), (1024, 130, 16),
                                   (512, 130, 8)],
                         ids=["band-c8", "band-c16", "covers"])
def test_apply_banded_bf16_matches_jax(rng, n, h, c):
    """K4's bf16 twin vs the Pallas apply_banded at matmul_dtype bfloat16
    (interpret mode): x and T rounded, NaN in the blocks beyond kb where
    the band fits; a band covering the matrix is the dense bf16 dot."""
    bs = 128
    t, r = _banded(rng, n, h)
    covers = 2 * -(-h // bs) + 1 >= n // bs
    tp = t if covers else _poison_blocks(t, r, h, bs)
    x = rng.random((c, n), dtype=np.float32)
    want = np.asarray(jmp.apply_banded(jnp.asarray(x), jnp.asarray(tp), h,
                                       matmul_dtype=jnp.bfloat16, bs=bs,
                                       interpret=True))
    got = tmk.apply_banded(_t(x), _t(tp), h, bs, BF16).numpy()
    _rel_close(got, want, TWIN_RTOL)
    xb = x.astype(jnp.bfloat16).astype(np.float64)
    tb = t.astype(jnp.bfloat16).astype(np.float64)
    _rel_close(got, xb @ tb, TWIN_RTOL)
    _differs_from_f32(got, tmk.apply_banded(_t(x), _t(tp), h, bs).numpy())


def test_apply_banded_chain_bf16(rng):
    """The chain at bf16: one application is K4; a band that covers the
    matrix is the masked dense chain with the carry rounded to bf16 before
    each product, as matpow_pallas.apply_banded_chain; a chain over a band
    under the matrix (K1 + K3, K7) and the batched chain (K8) raise,
    naming ROADMAP."""
    n, bs = 1024, 128
    x = rng.random((8, n), dtype=np.float32)
    t, r = _banded(rng, n, 500)
    tp = t.copy()
    tp[np.abs(r[:, None] - r[None, :]) > 500] = np.nan
    want = np.asarray(jmp.apply_banded_chain(
        jnp.asarray(x), jnp.asarray(tp), 500, 3, matmul_dtype=jnp.bfloat16,
        bs=bs, interpret=True))
    got = tmk.apply_banded_chain(_t(x), _t(tp), 500, 3, bs=bs,
                                 matmul_dtype=BF16).numpy()
    _rel_close(got, want, TWIN_RTOL)
    t, r = _banded(rng, n, 130)
    tp = _poison_blocks(t, r, 130, bs)
    one = tmk.apply_banded_chain(_t(x), _t(tp), 130, 1, bs=bs,
                                 matmul_dtype=BF16)
    assert torch.equal(one, tmk.apply_banded(_t(x), _t(tp), 130, bs, BF16))
    for bj in (bs, 2 * bs):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmk.apply_banded_chain(_t(x), _t(tp), 130, 4, bs=bs, bj=bj,
                                   matmul_dtype=BF16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmk.apply_banded_chain_batched(_t(x)[None], [_t(tp)], 130, 4, bs,
                                       BF16)
    with pytest.raises(ValueError, match="matmul_dtype"):
        tmk.square_dense(_t(t), torch.float16)


# -- the walk routes ---------------------------------------------------------

def _scene(rng, cap, c=3, extent=(28, 28)):
    """Capped (cam, edge): random inside the extent, edge 1 beyond it."""
    h4, w4 = extent
    edge = np.ones((cap, cap), np.float32)
    edge[:h4, :w4] = rng.random((h4, w4)).astype(np.float32)
    cam = np.zeros((c, cap, cap), np.float32)
    cam[:, :h4, :w4] = rng.random((c, h4, w4))
    return cam, edge


def _walk_f64(geom, cam, edge, exp_times, sq, beta=10):
    """x @ T^(2^E) in f64 (dense T, the squarings then the applications)."""
    t = trw.dense_affinity(geom, _t(edge)).double() ** beta
    t = t / t.sum(0, keepdim=True)
    for _ in range(sq):
        t = t @ t
    x = trw._flat_seeds(geom, _t(cam), _t(edge)).double()
    for _ in range(1 << (exp_times - sq)):
        x = x @ t
    return trw._unflatten_rw(geom, x).numpy()


def _labels(rw, extent):
    h4, w4 = extent
    return trw.decode_plain(torch.from_numpy(np.asarray(rw, np.float32)),
                            h4, w4, 4 * h4 - 2, 4 * w4 - 3, BG).labels.numpy()


def _walk_gates(got, want, ref, extent):
    """Scores within 1e-2 of their max, labels >= 99% equal, and no farther
    from the f64 walk than 1.25x JAX's distance + 1e-6."""
    _rel_close(got, want, 1e-2)
    agree = float(np.mean(_labels(got, extent) == _labels(want, extent)))
    assert agree >= 0.99, agree
    d_got = float(np.abs(got - ref).max())
    d_want = float(np.abs(want - ref).max())
    assert d_got <= 1.25 * d_want + 1e-6, (d_got, d_want)


@pytest.mark.parametrize("exp_times", [3, 4])
def test_propagate_banded_bf16_matches_jax(rng, exp_times):
    """The banded route at e = E (K2 squarings, then one K4 application) in
    bf16 against JAX's ``propagate_banded`` at bf16 (interpret mode),
    bs 128 at the 32x32 bucket, radius 2 (n_pad 1536)."""
    cap, bs = 32, 128
    cam, edge = _scene(rng, cap)
    tg = trw.build_geometry(cap, cap, radius=2)
    jg = jrw.build_geometry(cap, cap, radius=2)
    assert trw.banded_fits(tg, exp_times, exp_times, bs)
    got = trw.propagate_banded(tg, _t(cam), _t(edge), 10, exp_times,
                               square_times=exp_times, bs=bs,
                               matmul_dtype=BF16).numpy()
    want = np.asarray(jrw.propagate_banded(
        jg, cam, edge, beta=10, exp_times=exp_times,
        matmul_dtype=jnp.bfloat16, square_times=exp_times, bs=bs,
        interpret=True))
    _walk_gates(got, want, _walk_f64(tg, cam, edge, exp_times, exp_times),
                (28, 28))


@pytest.mark.parametrize("exp_times,sq", [(3, 3), (8, 8), (8, None)],
                         ids=["e3", "pure", "auto"])
def test_propagate_dense_bf16_matches_jax(rng, jax_tpu_route, exp_times,
                                          sq):
    """The dense route in bf16 (K6, then K5; the applications on bf16
    operands) at e = E and at the bf16 cost-model split, against JAX's
    fused TPU route at bf16, 32x32 bucket, radius 5 (n_pad 2048)."""
    cap = 32
    cam, edge = _scene(rng, cap)
    tg = trw.build_geometry(cap, cap, radius=5)
    jg = jrw.build_geometry(cap, cap, radius=5)
    if sq is None:
        sq = trw.pick_square_times(tg.n_pad, exp_times, matmul_dtype=BF16)
        assert sq != trw.pick_square_times(tg.n_pad, exp_times)
    assert not trw.banded_fits(tg, exp_times, sq)
    got = trw.propagate(tg, _t(cam), _t(edge), 10, exp_times,
                        square_times=sq, matmul_dtype=BF16).numpy()
    want = np.asarray(jrw.propagate(jg, cam, edge, beta=10,
                                    exp_times=exp_times,
                                    matmul_dtype=jnp.bfloat16,
                                    square_times=sq))
    _walk_gates(got, want, _walk_f64(tg, cam, edge, exp_times, sq), (28, 28))
    # propagate_banded takes the same dense route where the band does not
    # fit, and so does the batch
    banded = trw.propagate_banded(tg, _t(cam), _t(edge), 10, exp_times,
                                  square_times=sq, matmul_dtype=BF16)
    np.testing.assert_array_equal(banded.numpy(), got)
    batch = trw.propagate_banded_batch(tg, _t(cam)[None], _t(edge)[None],
                                       10, exp_times, square_times=sq,
                                       matmul_dtype=BF16)
    np.testing.assert_array_equal(batch[0].numpy(), got)


def test_default_route_ignores_the_dtype(rng):
    """At e = 0 the walk is the stencil: no product, so bf16 gives the f32
    walk bit for bit (JAX ``propagate_banded`` ignores the dtype there
    too), on one image and on a batch."""
    cap = 32
    cam, edge = _scene(rng, cap)
    tg = trw.build_geometry(cap, cap, radius=5)
    f32 = trw.propagate_banded(tg, _t(cam), _t(edge), 10, 8, square_times=0)
    bf16 = trw.propagate_banded(tg, _t(cam), _t(edge), 10, 8, square_times=0,
                                matmul_dtype=BF16)
    assert torch.equal(f32, bf16)
    batch = trw.propagate_banded_batch(tg, _t(cam)[None], _t(edge)[None], 10,
                                       8, square_times=0, matmul_dtype=BF16)
    assert torch.equal(batch[0], f32)


def test_pick_square_times_matches_jax():
    """The cost-model split equals JAX's for both dtypes, over n_pad,
    exp_times and seed-row chunks; bf16 moves it where the band does not
    fit at e = 0 (the production bucket's n_pad 14336: 1 in f32, 2 in
    bf16)."""
    for n in range(512, 20481, 512):
        for e in (3, 8):
            for chunks in (1, 4):
                for td, jd in ((None, None), (BF16, jnp.bfloat16)):
                    assert trw.pick_square_times(
                        n, e, chunks, matmul_dtype=td) == \
                        jrw.pick_square_times(n, e, chunks,
                                              matmul_dtype=jd), (n, e, td)
    assert (trw.pick_square_times(14336, 8),
            trw.pick_square_times(14336, 8, matmul_dtype=BF16)) == (1, 2)


# -- the mesh routes ---------------------------------------------------------

def test_sharded_products_bf16_match_jax(rng):
    """``banded_power``, ``banded_apply`` and ``sharded_matrix_power`` at
    bf16 on two devices against JAX's ``banded_matrix_power``,
    ``banded_propagate_rows`` and ``sharded_matrix_power`` at bf16: one
    squaring within the twins' 2e-6, the chains within 1e-2; the carry
    stays f32."""
    n, h = 256, 20
    t = _banded(rng, n, h)[0]
    mesh, jm = trs.ModelMesh(["cpu"] * 2), jmesh.make_mesh(n_data=1,
                                                           n_model=2)
    for e, rtol in ((1, TWIN_RTOL), (3, 1e-2)):
        blocks = trs.banded_power(mesh.split(_t(t), 0), e, h, mesh, BF16)
        assert all(b.dtype == torch.float32 for b in blocks)
        got = mesh.gather(blocks, 0).numpy()
        want = np.asarray(jrs.banded_matrix_power(jnp.asarray(t), e, h, jm,
                                                  jnp.bfloat16))
        _rel_close(got, want, rtol)
        dense = mesh.gather(trs.sharded_matrix_power(_t(t), e, mesh, BF16),
                            0).numpy()
        jdense = np.asarray(jrs.sharded_matrix_power(jnp.asarray(t), e, jm,
                                                     jnp.bfloat16))
        _rel_close(dense, jdense, rtol)
    seeds = rng.random((8, n), dtype=np.float32)
    got = trs.banded_apply(_t(seeds), mesh.split(_t(t), 0), 4, mesh,
                           BF16).numpy()
    want = np.asarray(jrs.banded_propagate_rows(
        jnp.asarray(seeds), jnp.asarray(t), 4, jm, jnp.bfloat16))
    _rel_close(got, want, 1e-2)
    one = trs.sharded_propagate_rows(_t(seeds), _t(t), mesh, BF16).numpy()
    xb = seeds.astype(jnp.bfloat16).astype(np.float64)
    _rel_close(one, xb @ t.astype(jnp.bfloat16).astype(np.float64),
               TWIN_RTOL)


@pytest.mark.parametrize("route,sq,mesh_banded", [
    ("mesh_banded", 1, True), ("dense", 1, False), ("dense_pure", 3, False)])
def test_propagate_mesh_routes_bf16(rng, route, sq, mesh_banded):
    """``propagate(..., mesh)`` at rw_mesh_model 2 in bf16 against JAX's
    ``propagate(..., mesh=)`` at bf16 on two of its virtual devices
    (32x32 bucket, radius 2, exp_times 3): scores within 1e-2 of their
    max, labels >= 99% equal."""
    cap, exp_times = 32, 3
    cam, edge = _scene(rng, cap)
    geom = trw.build_geometry(cap, cap, radius=2)
    assert trw.banded_sharded_fits(geom, exp_times, sq, 2) or not mesh_banded
    got = trw.propagate(geom, _t(cam), _t(edge), 10, exp_times,
                        square_times=sq, mesh=trs.ModelMesh(["cpu"] * 2),
                        mesh_banded=mesh_banded, matmul_dtype=BF16).numpy()
    jg = jrw.build_geometry(cap, cap, radius=2)
    jm = jmesh.make_mesh(n_data=1, n_model=2)
    want = np.asarray(jax.jit(lambda c, e: jrw.propagate(
        jg, c, e, beta=10, exp_times=exp_times, matmul_dtype=jnp.bfloat16,
        mesh=jm, square_times=sq, mesh_banded=mesh_banded))(cam, edge))
    _rel_close(got, want, 1e-2)
    agree = float(np.mean(_labels(got, (28, 28)) == _labels(want, (28, 28))))
    assert agree >= 0.99, agree


# -- the stages --------------------------------------------------------------

CAP = 32
PURE = ("--rw_square_times", "8", "--rw_matmul_dtype", "bfloat16")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic tree (4 images, 96-128 px), GT cams, a JAX-init IRN
    checkpoint, and the JAX stages' outputs at pure squaring in f32 and
    bf16 on their fused TPU route (make_sem_seg PNGs, make_ins_seg npy)."""
    tmp = tmp_path_factory.mktemp("walk_bf16")
    root = str(tmp / "voc")
    train, _ = synthetic.generate(root, n_images=4, size=96,
                                  max_side_jitter=32, seed=5)
    names = [f"2007_{i:06d}" for i in range(4)]
    with open(train, "w") as f:
        f.write("\n".join(names) + "\n")
    write_gt_cams(root, names, str(tmp / "cam"))
    variables = jax.tree.map(np.asarray, JaxIRNet().init(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32)))
    weights = str(tmp / "irn.ckpt")
    jax_ckpt.save_checkpoint(weights, variables)
    base = Config(
        voc12_root=root, train_list=train, infer_list=train,
        cam_out_dir=str(tmp / "cam"), irn_weights_name=weights,
        rw_grid_cap=CAP, session_dir=str(tmp / "sess"),
        log_name=str(tmp / "log"), edge_infer_batch=4, rw_square_times=8,
    ).resolve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmatpow, "selected_path", lambda: "fused")
        mp.setattr(pl, "pallas_call", _interpret(pl.pallas_call))
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(
                base, rw_matmul_dtype=dtype,
                sem_seg_out_dir=str(tmp / f"jax_sem_{dtype}"),
                ins_seg_out_dir=str(tmp / f"jax_ins_{dtype}"))
            jax_make_sem_seg(cfg)
            jax_make_ins_seg(cfg)
    return tmp, base, names


def _argv(cfg, tmp, tag, extra):
    return [
        "--voc12_root", cfg.voc12_root, "--infer_list", cfg.infer_list,
        "--train_list", cfg.train_list, "--cam_out_dir", cfg.cam_out_dir,
        "--irn_weights_name", cfg.irn_weights_name,
        "--rw_grid_cap", str(CAP), "--session_dir", cfg.session_dir,
        "--log_name", cfg.log_name,
        "--sem_seg_out_dir", str(tmp / f"port_sem_{tag}"),
        "--ins_seg_out_dir", str(tmp / f"port_ins_{tag}"),
        "--device", "cpu", *extra,
    ]


def _pngs(d, names):
    return {n: imread(os.path.join(d, n + ".png")) for n in names}


def _ins(d, names):
    return {n: np.load(os.path.join(d, n + ".npy"), allow_pickle=True).item()
            for n in names}


def _ins_agreement(a, b):
    """Mask-pixel agreement of two instance dicts: the mean over instances
    of equal mask pixels when both hold the same classes in order, else 0."""
    if not np.array_equal(a["class"], b["class"]):
        return 0.0
    if not len(a["class"]):
        return 1.0
    return float(np.mean([np.mean(x == y)
                          for x, y in zip(a["mask"], b["mask"])]))


def test_make_sem_seg_bf16_matches_jax(tree):
    """make_sem_seg at ``--rw_square_times 8 --rw_matmul_dtype bfloat16``
    (the dense route: K6 + 7 x K5 in bf16 through their twins) against the
    JAX stage at the same flags: labels agree per image at >= min(JAX
    bf16's own agreement with JAX f32, 99%)."""
    tmp, cfg, names = tree
    res = port_run.main(_argv(cfg, tmp, "pure", (*PURE,
                                                 "--make_sem_seg_pass")))
    summary = res["make_sem_seg_labels"]
    assert summary["n_images"] == len(names)
    assert set(summary["modes"].values()) == {"dense"}
    got = _pngs(str(tmp / "port_sem_pure"), names)
    j16 = _pngs(str(tmp / "jax_sem_bfloat16"), names)
    j32 = _pngs(str(tmp / "jax_sem_float32"), names)
    for n in names:
        gate = min(float(np.mean(j16[n] == j32[n])), 0.99)
        agree = float(np.mean(got[n] == j16[n]))
        assert agree >= gate, (n, agree, gate)


def test_make_ins_seg_bf16_matches_jax(tree):
    """make_ins_seg at the same flags against the JAX stage: per image the
    same classes and mask pixels agreeing at >= min(JAX bf16's own
    agreement with JAX f32, 99%)."""
    tmp, cfg, names = tree
    res = port_run.main(_argv(cfg, tmp, "pure", (*PURE, "--edge_infer_batch",
                                                 "4", "--make_ins_seg_pass")))
    summary = res["make_ins_seg_labels"]
    assert summary["n_images"] == len(names)
    assert set(summary["modes"].values()) == {"dense"}
    got = _ins(str(tmp / "port_ins_pure"), names)
    j16 = _ins(str(tmp / "jax_ins_bfloat16"), names)
    j32 = _ins(str(tmp / "jax_ins_float32"), names)
    for n in names:
        gate = min(_ins_agreement(j16[n], j32[n]), 0.99)
        agree = _ins_agreement(got[n], j16[n])
        assert agree >= gate, (n, agree, gate)


@pytest.mark.parametrize("flags", [
    dict(exp_times=3, rw_square_times=3),
    dict(rw_mesh_model=2, rw_square_times=8),
], ids=["e3", "mesh"])
def test_cli_bf16_routes(tree, flags):
    """The CLI at ``--rw_matmul_dtype bfloat16`` runs make_sem_seg and
    make_ins_seg on e3 (at this bucket e3's band does not fit: the dense
    route) and on the dense mesh route (rw_mesh_model 2, the CPU twice),
    against the JAX stages at the same flags (the mesh on two of JAX's
    virtual devices, whose squarings round T to bf16 as the port's mesh
    does): labels and mask pixels at >= min(JAX bf16's own agreement with
    JAX f32, 99%)."""
    tmp, base, names = tree
    tag = "mesh" if "rw_mesh_model" in flags else "e3"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmatpow, "selected_path", lambda: "fused")
        mp.setattr(pl, "pallas_call", _interpret(pl.pallas_call))
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(
                base, rw_matmul_dtype=dt, **flags,
                sem_seg_out_dir=str(tmp / f"jax_sem_{tag}_{dt}"),
                ins_seg_out_dir=str(tmp / f"jax_ins_{tag}_{dt}"))
            jax_make_sem_seg(cfg)
            jax_make_ins_seg(cfg)
    extra = [x for k, v in flags.items() for x in (f"--{k}", str(v))]
    res = port_run.main(_argv(base, tmp, tag, (
        *extra, "--rw_matmul_dtype", "bfloat16", "--edge_infer_batch", "4",
        "--make_sem_seg_pass", "--make_ins_seg_pass")))
    for stage in ("make_sem_seg_labels", "make_ins_seg_labels"):
        assert set(res[stage]["modes"].values()) == {"dense"}, stage
    sem = [_pngs(str(tmp / d), names) for d in (
        f"port_sem_{tag}", f"jax_sem_{tag}_bfloat16",
        f"jax_sem_{tag}_float32")]
    ins = [_ins(str(tmp / d), names) for d in (
        f"port_ins_{tag}", f"jax_ins_{tag}_bfloat16",
        f"jax_ins_{tag}_float32")]
    for n in names:
        gate = min(float(np.mean(sem[1][n] == sem[2][n])), 0.99)
        agree = float(np.mean(sem[0][n] == sem[1][n]))
        assert agree >= gate, (n, agree, gate)
        gate = min(_ins_agreement(ins[1][n], ins[2][n]), 0.99)
        agree = _ins_agreement(ins[0][n], ins[1][n])
        assert agree >= gate, (n, agree, gate)


def test_default_route_bf16_is_f32(tree):
    """make_sem_seg with only ``--rw_matmul_dtype bfloat16``: the default
    walk is the stencil, so every PNG is byte-equal to the f32 run's."""
    tmp, cfg, names = tree
    for tag, extra in (("f32", ()), ("bf16", ("--rw_matmul_dtype",
                                              "bfloat16"))):
        res = port_run.main(_argv(cfg, tmp, f"default_{tag}",
                                  (*extra, "--make_sem_seg_pass")))
        assert set(res["make_sem_seg_labels"]["modes"].values()) == {"diag"}
    for n in names:
        with open(tmp / "port_sem_default_f32" / f"{n}.png", "rb") as f:
            want = f.read()
        with open(tmp / "port_sem_default_bf16" / f"{n}.png", "rb") as f:
            assert f.read() == want, n


def test_bf16_refusal_where_the_flags_decide():
    """At bf16 the stage refuses at config time only where every bucket of
    the grid cap takes a chain without a bf16 mode (e = 1: the band fits
    each bucket); at e = 2 the 32x32 bucket goes dense and runs, while a
    96x128 bucket keeps the band and its walk raises; pure squaring, the
    default split and the mesh run everywhere."""
    from irn_tpu_torch.pipeline import stages_irn
    from irn_tpu_torch.pipeline.config import Config as PortConfig

    cfg = PortConfig(rw_matmul_dtype="bfloat16")
    assert stages_irn.walk_buckets(128) == [32, 64, 96, 128]
    assert stages_irn.walk_buckets(40) == [32, 40]
    cpu = torch.device("cpu")
    e1 = dataclasses.replace(cfg, rw_square_times=1)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 13"):
        stages_irn.check_slice_flags(e1)
    e2 = dataclasses.replace(cfg, rw_square_times=2)
    stages_irn.check_slice_flags(e2)
    walker = stages_irn.RandomWalkRunner(e2, 20, cpu)
    assert walker.resolve_mode(32, 32) == "dense"
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 13"):
        walker.resolve_mode(96, 128)
    for sq, mode in ((8, "dense"), (-1, "diag")):
        c = dataclasses.replace(cfg, rw_square_times=sq)
        stages_irn.check_slice_flags(c)
        assert stages_irn.RandomWalkRunner(c, 20, cpu).resolve_mode(
            96, 128) == mode
    mesh = dataclasses.replace(e1, rw_mesh_model=2)
    stages_irn.check_slice_flags(mesh)
    assert stages_irn.RandomWalkRunner(
        mesh, 20, cpu, trs.ModelMesh(["cpu"] * 2)).resolve_mode(
            96, 128) == "mesh_banded"
