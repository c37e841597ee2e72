"""K17, the device CRF's mean-field iteration (``irn_tpu_torch/ops/
crf_device.py``: ``blur``, ``start``, ``quantize``, ``combine`` and their
plain twins, which the CPU runs) against the JAX package's
``irn_tpu/ops/crf_tpu.py`` on numpy inputs made from a seed.

- The blur sums the 25 taps of each pass where JAX's ``_sep_gauss`` takes
  two dense Toeplitz products: relative <= 1e-5.
- The quantize twin's int8 operand and qscale are JAX's expression
  (crf_tpu.py:280-282) bit for bit; the bf16 operand is JAX's cast.
- ``LandmarkCRF.pair`` >= 99.9% equal labels per map at t = 1, 3 and 10
  with the int8 and the dense store, with n_labels below the cap and with
  padded landmarks (36 -> 40 under int8).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import crf_tpu
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import crf_device as cd

torch.set_num_threads(2)

GATE = 0.999


def _planes(g, c, h, w, extent):
    """[c, h, w] f32 in [0, 1), zero outside the extent."""
    x = g.random((c, h, w), dtype=np.float32)
    x[:, extent[0]:] = 0
    x[:, :, extent[1]:] = 0
    return x


@pytest.mark.parametrize("c", [1, 6])
@pytest.mark.parametrize("bucket,extent", [((48, 60), (45, 53)),
                                           ((48, 48), (41, 48))])
def test_blur_matches_jax(bucket, extent, c):
    """The blur twin (row pass, column pass, 25 taps) against JAX's two
    Toeplitz products, relative <= 1e-5, zero beyond 12 pixels outside the
    extent on both sides."""
    g = np.random.default_rng(c)
    h, w = bucket
    x = _planes(g, c, h, w, extent)
    taps = cd.gaussian_taps(3.0)
    assert taps.shape == (cd.BLUR_TAPS,)
    got = cd.blur(torch.from_numpy(x), taps).numpy()
    jt = jnp.asarray(taps.numpy())
    want = np.asarray(crf_tpu._sep_gauss(
        jnp.asarray(x), crf_tpu._toeplitz(h, jt), crf_tpu._toeplitz(w, jt)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
    assert got.dtype == np.float32 and (got >= 0).all()


def test_blur_short_taps_pad_to_the_kernels():
    """Fewer taps (sxy 1.5: 13) zero-padded to the kernel's 25 at both
    ends give the same bits; more than 25 taps are refused for the card."""
    g = np.random.default_rng(3)
    x = torch.from_numpy(_planes(g, 2, 40, 36, (37, 33)))
    short = cd.gaussian_taps(1.5)
    assert short.shape == (13,)
    padded = cd._card_taps(short)
    assert padded.shape == (cd.BLUR_TAPS,) and padded[:6].eq(0).all()
    assert torch.equal(cd.blur_plain(x, short), cd.blur_plain(x, padded))
    with pytest.raises(ValueError):
        cd._card_taps(cd.gaussian_taps(3.5))
    with pytest.raises(ValueError):
        cd._check_cap(cd.MAX_CAP_CARD + 1)


def _jax_unary(lab, n_labels, gt_prob, cap):
    """crf_tpu.crf_pair_program's unary_of and first softmax."""
    @jax.jit
    def f(lab):
        p_other = (1.0 - gt_prob) / jnp.maximum(
            jnp.float32(n_labels) - 1.0, 1.0)
        one = jax.nn.one_hot(lab, cap, axis=0, dtype=jnp.float32)
        u = one * jnp.log(jnp.float32(gt_prob)) + (1.0 - one) * jnp.log(
            p_other)
        u = jnp.where((jnp.arange(cap) < n_labels)[:, None, None], u, -1e30)
        return u, jax.nn.softmax(u, axis=0)
    return [np.asarray(v) for v in jax.vmap(f)(jnp.asarray(lab))]


@pytest.mark.parametrize("n_labels,gt_prob", [(6, 0.7), (21, 0.7),
                                              (2, 0.5)])
def test_unary_and_start_match_jax(n_labels, gt_prob):
    """The unary made from the uint8 label maps and the first softmax
    against JAX's; the start's argmax is the label where gt_prob wins, and
    channel 0 where every channel ties (gt 0.5 over 2 labels)."""
    g = np.random.default_rng(n_labels)
    lab = g.integers(0, n_labels, (2, 12, 20)).astype(np.uint8)
    lg, lo = cd.unary_logs(gt_prob, n_labels)
    labels = torch.from_numpy(lab)
    u = cd.unary_plain(labels, 21, n_labels, lg, lo)
    want_u, want_q = _jax_unary(lab.astype(np.int32), n_labels, gt_prob, 21)
    np.testing.assert_allclose(u.numpy(), want_u, rtol=1e-6)
    q = cd.start(labels, 21, n_labels, lg, lo)
    assert q.shape == (2, 21, 12, 20) and q.dtype == torch.float32
    np.testing.assert_allclose(q.numpy(), want_q, rtol=1e-5, atol=1e-7)
    best = cd.start(labels, 21, n_labels, lg, lo, argmax=True)
    assert best.dtype == torch.uint8
    np.testing.assert_array_equal(
        best.numpy(), lab if lg > lo else np.zeros_like(lab))


@functools.partial(jax.jit, static_argnames=("stride",))
def _jax_quantize(q, nr_b, valid, stride):
    """crf_tpu.py:265-266 and :280-282 (the int8 store), and the dense
    store's cast (:290)."""
    cap = q.shape[1]
    off = stride // 2
    qb = nr_b * (q * valid)
    q_land = qb[:, :, off::stride, off::stride].reshape(2 * cap, -1)
    qlT = q_land.T
    qscale = jnp.maximum(jnp.max(qlT, axis=0), 1e-20)
    q8 = jnp.round(qlT * (127.0 / qscale)).astype(jnp.int8)
    return q8, qscale, qlT.astype(jnp.bfloat16)


def _mean_field_state(g, h, w, extent, n_labels, cap=21):
    """(q [2, cap, h, w] softmax with the channels >= n_labels at 0, nr_b
    [h, w] > 0 inside the extent, valid)."""
    logits = g.normal(0, 2, (2, cap, h, w)).astype(np.float32)
    logits[:, n_labels:] = -1e30
    e = np.exp(logits - logits.max(1, keepdims=True))
    q = (e / e.sum(1, keepdims=True)).astype(np.float32)
    valid = np.zeros((h, w), np.float32)
    valid[:extent[0], :extent[1]] = 1
    nr_b = (g.random((h, w), dtype=np.float32) + 0.05) * valid
    return q, nr_b, valid


@pytest.mark.parametrize("bucket,extent", [((48, 60), (45, 53)),
                                           ((24, 24), (20, 20))],
                         ids=["S180", "S36_padded"])
def test_quantize_matches_jax(bucket, extent):
    """The int8 operand (column-major, each map's 21 columns at 0 and 24,
    S padded to a multiple of 8 with zero rows) and qscale bit-equal to
    JAX's on the same q: channels past n_labels are all-zero columns whose
    qscale is clamped to 1e-20; the bf16 operand is JAX's cast, the f32
    operand the activations."""
    g = np.random.default_rng(bucket[0])
    h, w = bucket
    q, nr_b, valid = _mean_field_state(g, h, w, extent, n_labels=6)
    q8, qscale, qb16 = (np.asarray(v) for v in _jax_quantize(
        jnp.asarray(q), jnp.asarray(nr_b), jnp.asarray(valid), stride=4))
    s = q8.shape[0]
    cols = cd._columns(21, "cpu").numpy()
    opnd, scale = cd.operand_buffers(s, 21, torch.int8, "cpu")
    cd.quantize(torch.from_numpy(q), torch.from_numpy(nr_b), opnd, scale)
    assert opnd.shape == (s + (-s) % 8, 48) and opnd.stride() == (1, s + (
        -s) % 8)
    np.testing.assert_array_equal(opnd[:s, cols].numpy(), q8)
    np.testing.assert_array_equal(scale[cols].numpy(), qscale)
    assert (scale[cols].numpy()[6:21] == np.float32(1e-20)).all()
    rest = np.ones(48, bool)
    rest[cols] = False
    assert not opnd[s:].any() and not opnd[:, rest].any()
    assert not scale[rest].any()
    for store in (torch.bfloat16, torch.float32):
        opnd, _ = cd.operand_buffers(s, 21, store, "cpu")
        cd.quantize(torch.from_numpy(q), torch.from_numpy(nr_b), opnd, scale)
        assert opnd.shape == (s, 48) and not opnd[:, rest].any()
        got = opnd[:, cols].float().numpy()
        want = (qb16.astype(np.float32) if store == torch.bfloat16 else
                (nr_b * q)[:, :, 2::4, 2::4].reshape(42, -1).T)
        np.testing.assert_array_equal(got, want)


def _scene(g, h, w):
    """tests/test_crf_tpu.py's scene: colour regions, a stripe, 6% label
    noise."""
    img = np.full((h, w, 3), 50.0)
    img[:, : w // 2] = (190, 70, 60)
    img[h // 2:, w // 2:] = (70, 170, 90)
    img[10:12, :] = (240, 230, 40)
    img = np.clip(img + g.normal(0, 10, (h, w, 3)), 0, 255)
    labels = np.zeros((h, w), np.int32)
    labels[:, : w // 2 - 2] = 5
    labels[h // 2 + 2:, w // 2:] = 12
    labels[10:12, ::3] = 7
    labels[g.random((h, w)) < 0.06] = 18
    return img.astype(np.uint8), labels


@pytest.mark.parametrize("t", [1, 3, 10])
@pytest.mark.parametrize("store", ["int8", "dense"])
def test_pair_matches_jax(store, t):
    """LandmarkCRF.pair, port vs JAX, after 1, 3 and 10 iterations: >=
    99.9% equal labels per map, 6 labels below the cap of 21."""
    g = np.random.default_rng(t)
    img, labels = _scene(g, 45, 53)
    la, lb = labels % 6, (labels > 0).astype(np.int32) * 3
    kw = dict(stride=4, pad_multiple=16, t=t, kernel_store=store)
    want = crf_tpu.LandmarkCRF(**kw).pair(img, la, lb, n_labels=6)
    got = cd.LandmarkCRF(device="cpu", **kw).pair(img, la, lb, n_labels=6)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (45, 53) and a.dtype == np.uint8
        assert (a == b).mean() >= GATE, (store, t, (a == b).mean())


@pytest.mark.parametrize("store", ["int8", "dense"])
def test_pair_padded_landmarks(store):
    """A 24x24 bucket (36 landmarks, 40 stored columns under int8) with 5
    labels: >= 99.9% equal to JAX per map; t = 0 is the unary's argmax,
    equal to JAX's."""
    g = np.random.default_rng(9)
    img, labels = _scene(g, 20, 20)
    la, lb = labels % 5, (labels % 3 == 0).astype(np.int32) * 4
    for t in (0, 4):
        kw = dict(stride=4, pad_multiple=12, t=t, kernel_store=store)
        want = crf_tpu.LandmarkCRF(**kw).pair(img, la, lb, n_labels=5)
        port = cd.LandmarkCRF(device="cpu", **kw)
        packed = port.upload(img, la, lb)
        kern = port.build(packed, 20, 20)
        assert kern.n_land == 36 and kern.operand(21)[0].shape == (
            40 if store == "int8" else 36, 48)
        got = port.pair(img, la, lb, n_labels=5)
        for a, b in zip(got, want):
            if t == 0:
                np.testing.assert_array_equal(a, b)
            assert (a == b).mean() >= GATE, (store, t, (a == b).mean())


def test_mean_field_pair_runs_the_pieces(monkeypatch):
    """t iterations are one start, t quantizes and t combines, the last
    writing the labels; no kernel is launched on the CPU."""
    calls = []
    for name in ("start", "quantize", "combine"):
        fn = getattr(cd, name)

        def seen(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(cd, name, seen)
    g = np.random.default_rng(4)
    img, labels = _scene(g, 20, 28)
    crf = cd.LandmarkCRF(device="cpu", pad_multiple=8, t=3,
                         kernel_store="int8")
    _build.reset_launches()
    a, b = crf.pair(img, labels % 4, labels % 3, n_labels=4)
    assert calls == ["start"] + ["quantize", "combine"] * 3
    assert a.shape == b.shape == (20, 28) and a.max() < 4 and b.max() < 3
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("shape,offset,ok", [
    ((2, 21, 92, 84), 0, True), ((2, 5, 20, 24), 0, True),
    ((2, 21, 92, 86), 0, False), ((2, 3, 24, 30), 0, False),
    ((2, 5, 24, 28), 1, False)])
def test_combine_tensor_map_check(shape, offset, ok):
    """The card's combine reads q through a TMA tensor map, so
    ``check_q_map`` takes q only with W a multiple of 4 and a 16-byte
    aligned base (the pipeline's 64-multiple buckets pass), and names the
    shape when it refuses; the twin on the CPU takes any width."""
    n = int(np.prod(shape))
    q = torch.zeros(n + 4)[offset:offset + n].view(shape)
    if ok:
        cd.check_q_map(q)
    else:
        with pytest.raises(ValueError, match=str(shape[-1])):
            cd.check_q_map(q)
    for h, w in ((64, 128), (512, 512), (448, 320)):
        cd.check_q_map(torch.zeros((2, 21, h, w)))
