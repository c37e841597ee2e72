"""K10 (the default walk's operator build) and K15 (the decode): their plain
twins against the JAX package on the same numpy inputs (CPU).

On the CPU ``random_walk.build_diag_operator``, ``upsample_scores`` and
``decode`` run the twins (the launch counters stay 0); on the card they run
the kernels, which tests/test_torch_kernels_gpu.py holds bit-equal to these
twins. Tolerances: w and inv within rtol 1e-6 (the same operations in the
same order; XLA's CPU code may round a power or a sum differently in the
last bit), the upsampled scores within rtol 1e-5 / atol 1e-7 (JAX resizes
through a weight contraction, the twin by gathers), labels equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import random_walk as jrw
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import random_walk as trw

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach a kernel: every launch counter stays 0."""
    _build.reset_launches()
    yield
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


def _edge(kind, shape, seed):
    """A capped edge map: a sigmoid of normals, the same quantized to 8
    levels (ties along every path), or all ones."""
    g = np.random.default_rng(seed)
    e = 1.0 / (1.0 + np.exp(-g.standard_normal(shape)))
    if kind == "quantized":
        e = np.round(e * 7) / 7
    elif kind == "ones":
        e = np.ones(shape)
    return e.astype(np.float32)


@pytest.mark.parametrize("beta", [1, 3, 10])
@pytest.mark.parametrize("kind", ["sigmoid", "quantized", "ones"])
@pytest.mark.parametrize("cap", [(24, 24), (32, 32), (20, 28)],
                         ids=["24", "32", "20x28"])
@pytest.mark.parametrize("radius", [2, 5])
def test_diag_operator_twin_matches_jax(radius, cap, kind, beta):
    """K10's twin against JAX ``build_diag_operator``: w and inv within
    rtol 1e-6; an all-ones map gives w = 0 and inv = 1 everywhere."""
    edge = _edge(kind, cap, seed=radius * 100 + cap[0] + cap[1])
    jg = jrw.build_geometry(*cap, radius=radius)
    tg = trw.build_geometry(*cap, radius=radius)
    jw, jinv = jrw.build_diag_operator(jg, jnp.asarray(edge), beta=beta)
    tw, tinv = trw.build_diag_operator(tg, _t(edge), beta=beta)
    assert tw.shape == (tg.path_set.n_pairs, tg.n_pad)
    assert tinv.shape == (tg.n_pad,)
    assert tw.dtype == tinv.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6)
    if kind == "ones":
        assert not tw.any() and bool((tinv == 1).all())
    else:
        assert tw.any() and bool((tinv < 1).any())


def test_diag_operator_twin_is_the_plain_body():
    """The wrapper on a CPU tensor returns the twin's bits, whether the
    edge slice is contiguous or not (the stage passes edge[:ch, :cw])."""
    full = _edge("sigmoid", (32, 32), seed=7)
    geom = trw.build_geometry(24, 20, radius=5)
    view = _t(full)[:24, :20]
    assert not view.is_contiguous()
    w, inv = trw.build_diag_operator(geom, view, 10)
    pw, pinv = trw.build_diag_operator_plain(geom, view.contiguous(), 10)
    assert torch.equal(w, pw) and torch.equal(inv, pinv)


def test_diag_operator_refuses():
    geom = trw.build_geometry(24, 24, radius=5)
    with pytest.raises(ValueError, match="diag_operator"):
        trw.build_diag_operator(geom, torch.zeros((24, 20)))
    with pytest.raises(ValueError, match="beta"):
        trw.build_diag_operator(geom, torch.zeros((24, 24)), beta=0)
    with pytest.raises(ValueError, match="meta"):
        trw.build_diag_operator(geom, torch.zeros((24, 24), device="meta"))


def _scores(case):
    """(rw [C, ch, cw], h4, w4, h0, w0, bg_thres) of each decode case."""
    g = np.random.default_rng(sum(map(ord, case)))
    if case in ("c1", "c4", "c32"):
        c = int(case[1:])
        ch, cw, h4, w4, h0, w0 = {1: (12, 10, 10, 9, 37, 33),
                                  4: (12, 12, 11, 7, 41, 25),
                                  32: (8, 12, 7, 11, 27, 41)}[c]
        rw = np.zeros((c, ch, cw), np.float32)
        rw[:, :h4, :w4] = g.random((c, h4, w4))
        return rw, h4, w4, h0, w0, 0.35
    if case == "zeros":
        return np.zeros((4, 10, 12), np.float32), 9, 10, 33, 38, 0.25
    if case == "equal_rows":
        rw = (g.random((4, 12, 12)) * 0.5).astype(np.float32)
        rw[1] = rw[2] = 1.0 + 0.5 * g.random((12, 12))
        rw[:, 10:] = 0
        rw[:, :, 11:] = 0
        return rw, 10, 11, 38, 43, 0.35
    if case == "bg_tie":
        # row 0 is 0.25 = bg_thres everywhere inside the extent, row 1 is
        # 1.0 on a block: normalized by the max 1.0, row 0 ties the
        # background plane exactly in both frameworks
        rw = np.zeros((3, 12, 12), np.float32)
        rw[0, :10, :11] = 0.25
        rw[1, 2:6, 3:8] = 1.0
        return rw, 10, 11, 40, 42, 0.25
    raise ValueError(case)


CASES = ["c1", "c4", "c32", "zeros", "equal_rows", "bg_tie"]


@pytest.mark.parametrize("case", CASES)
def test_decode_twin_matches_jax(case):
    """K15's twin against JAX ``upsample_and_decode`` and
    ``upsample_scores``: labels equal, scores and max within rtol 1e-5 /
    atol 1e-7; ``best`` is the plain path's ``rw_up.amax(0)``."""
    rw, h4, w4, h0, w0, bg = _scores(case)
    jl, jup, jmax = jrw.upsample_and_decode(rw, h4, w4, h0, w0, bg)
    jraw = jrw.upsample_scores(rw, h4, w4, h0, w0)
    out = trw.decode(_t(rw), h4, w4, h0, w0, bg, scores=True, best=True)
    assert out.labels.dtype == torch.int64
    assert out.labels.shape == (4 * rw.shape[1], 4 * rw.shape[2])
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(jup),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(out.max_score), float(jmax), rtol=1e-5)
    assert torch.equal(out.best, out.scores.amax(0))
    raw = trw.upsample_scores(_t(rw), h4, w4, h0, w0)
    np.testing.assert_allclose(raw.numpy(), np.asarray(jraw), rtol=1e-5,
                               atol=1e-7)
    assert torch.equal(raw, trw.upsample_scores_plain(_t(rw), h4, w4, h0, w0))
    labels = out.labels.numpy()
    assert not labels[h0:].any() and not labels[:, w0:].any()
    if case == "zeros":
        assert float(out.max_score) == 0 and not labels.any()
    if case == "equal_rows":
        # rows 1 and 2 are equal and win everywhere inside the extent: the
        # first (label 2) takes every pixel, the second (label 3) none
        assert (labels[:h0, :w0] == 2).all()
    if case == "bg_tie":
        norm = out.scores.numpy()
        tie = (norm[0] == np.float32(bg)) & (norm[1] <= np.float32(bg))
        assert tie[:h0, :w0].sum() > 100 and not labels[tie].any()
        assert not (labels == 1).any() and (labels == 2).any()


@pytest.mark.parametrize("scores,best", [(False, False), (False, True),
                                         (True, False)])
def test_decode_optional_outputs(scores, best):
    """Only the outputs asked for come back; the labels and max do not
    depend on them; upsample_and_decode is decode with the scores."""
    rw, h4, w4, h0, w0, bg = _scores("c4")
    full = trw.decode_plain(_t(rw), h4, w4, h0, w0, bg, True, True)
    out = trw.decode(_t(rw), h4, w4, h0, w0, bg, scores=scores, best=best)
    assert torch.equal(out.labels, full.labels)
    assert torch.equal(out.max_score, full.max_score)
    assert (out.scores is not None) == scores
    assert (out.best is not None) == best
    if scores:
        assert torch.equal(out.scores, full.scores)
    if best:
        assert torch.equal(out.best, full.best)
    labels, rw_up, max_score = trw.upsample_and_decode(_t(rw), h4, w4, h0, w0,
                                                       bg)
    assert torch.equal(labels, full.labels) and torch.equal(rw_up,
                                                            full.scores)
    assert torch.equal(max_score, full.max_score)


def test_decode_twin_matches_interpolate():
    """The gather twin against ``F.interpolate``'s bilinear (the port's
    ``resize_bilinear``, the twin until K15) on the same masked rows:
    equal within rtol 1e-6."""
    from irn_tpu_torch.ops.resize import resize_bilinear

    rw, h4, w4, h0, w0, _ = _scores("c32")
    x = _t(rw)
    m4 = trw._extent_mask(h4, w4, x.shape[1:], "cpu")
    num = resize_bilinear(x * m4[None], (4 * x.shape[1], 4 * x.shape[2]))
    den = resize_bilinear(m4, (4 * x.shape[1], 4 * x.shape[2]))
    want = torch.where(den > 1e-6, num / torch.clamp(den, min=1e-6), 0.0)
    want = want * trw._extent_mask(h0, w0, want.shape[1:], "cpu")[None]
    got = trw.upsample_scores(x, h4, w4, h0, w0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_decode_refuses():
    with pytest.raises(ValueError, match="meta"):
        trw.decode(torch.zeros((2, 4, 4), device="meta"), 4, 4, 16, 16, 0.3)
    with pytest.raises(ValueError, match="meta"):
        trw.upsample_scores(torch.zeros((2, 4, 4), device="meta"), 4, 4, 16,
                            16)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_decode_labels_dtype(dtype):
    """K15 writes the labels in the caller's dtype (the instance walk's
    int32, as the JAX walk hands them on); the values do not change, and
    any other dtype is refused."""
    rw, h4, w4, h0, w0, bg = _scores("c4")
    want = trw.decode_plain(_t(rw), h4, w4, h0, w0, bg)
    out = trw.decode(_t(rw), h4, w4, h0, w0, bg, labels_dtype=dtype)
    assert out.labels.dtype == dtype
    assert torch.equal(out.labels, want.labels.to(dtype))
    with pytest.raises(ValueError, match="int64 or int32"):
        trw.decode(_t(rw), h4, w4, h0, w0, bg, labels_dtype=torch.uint8)


def test_walk_labels_int32_on_the_cpu():
    """RandomWalkRunner.walk hands on int32 labels (no conversion after the
    decode), equal to the twin's labels, with best."""
    from irn_tpu_torch.pipeline.config import Config
    from irn_tpu_torch.pipeline.stages_irn import RandomWalkRunner

    cfg = Config(voc12_root=".", train_list="-", infer_list="-",
                 rw_grid_cap=32)
    runner = RandomWalkRunner(cfg, 8, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    seeds = torch.rand((3, 32, 32), generator=g)
    edge = torch.rand((32, 32), generator=g)
    labels, best = runner.walk(seeds, edge, 30, 27, (118, 105), 0.25)
    pad = torch.nn.functional.pad(seeds, (0, 0, 0, 0, 0, 5))
    want = trw.decode_plain(runner._propagate(pad, edge, 32, 32), 30, 27,
                            118, 105, 0.25, best=True)
    assert labels.dtype == torch.int32 and labels.shape == (128, 128)
    assert torch.equal(labels, want.labels.to(torch.int32))
    assert torch.equal(best, want.best)
