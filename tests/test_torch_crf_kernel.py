"""K14, the device CRF's landmark-kernel build (``crf_device.landmark_rows``),
through its plain twin on the CPU, against a float64 NumPy oracle.

The twin evaluates u = 2 <F_p, F_j> - (|F_p|^2 + |F_j|^2) in f32 on the
scaled features F = RN(SIGMA f), SIGMA = f32(sqrt(log2(e) / 2)), each
five-term dot a chain of fmas, and k = exp2(min(u, 0)); so u carries the
expansion's cancellation error: at rgb / 5 up to 51 (|f|^2 up to ~8000),
k is off by up to ~2e-4 where it is near 1. A flat 1e-6 holds only where
|f|^2 + |l|^2 is small, so the oracle checks each entry against the
forward-error bound of the twin's own operations. With mag = |f|^2 +
|l|^2 + 2 <f, l> (every feature is >= 0), in units of SIGMA^2 mag: the
features' roundings (the division, the scale, SIGMA itself: 3u on each F)
move u by at most 6u; the three chains (five roundings each, gamma_5 of
the sum of magnitudes) 5u; the sum a + b and the difference 2c - t u
each. That is 13u SIGMA^2 mag in u, and k = 2^u turns it into a relative
error ln(2) SIGMA^2 13u mag = 0.5 * 13u mag; the exp2 (f64, rounded once
to f32) adds at most ~u. So |dk| <= k (0.5 * 13u mag + 2u), u = 2^-24
(measured: up to ~1.1 u mag on the images below). The labels of the
whole CRF against JAX stay in tests/test_torch_crf.py.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import crf_device as cd

U = 2.0 ** -24
STORES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
# (bucket h, w, true extent eh, ew): a full 48x60 bucket, the odd 45x41
# extent in a 48x48 bucket, and a 24x28 bucket whose 42 landmarks int8 pads
# to 48
CASES = {"48x60": (48, 60, 48, 60), "45x41_in_48x48": (48, 48, 45, 41),
         "21x25_in_24x28": (24, 28, 21, 25)}


def _image(h, w, seed=0):
    """Color regions with noise (many pixels close to a landmark in all
    five features, so k spans [0, 1])."""
    rng = np.random.default_rng(seed)
    img = np.full((3, h, w), 60.0)
    img[:, :, : w // 2] = np.array([190, 70, 60])[:, None, None]
    img[:, h // 2:, w // 2:] = np.array([70, 170, 90])[:, None, None]
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
    return img.astype(np.uint8)


def _oracle(img, eh, ew, stride=4):
    """float64 (k [N, S], the error bound [N, S], the valid columns [S])
    from the exact features."""
    _, h, w = img.shape
    ys, xs = np.divmod(np.arange(h * w), w)
    f = np.stack([xs / 50.0, ys / 50.0, *(img[c].reshape(-1) / 5.0
                                          for c in range(3))], -1)
    off = stride // 2
    jy, jx = np.meshgrid(np.arange(off, h, stride), np.arange(off, w, stride),
                         indexing="ij")
    jy, jx = jy.reshape(-1), jx.reshape(-1)
    lf = f[jy * w + jx]
    valid = (jy < eh) & (jx < ew)
    d2 = ((f[:, None, :] - lf[None]) ** 2).sum(-1)
    k = np.exp(-0.5 * d2) * valid
    mag = (f ** 2).sum(1)[:, None] + (lf ** 2).sum(1)[None] + 2.0 * f @ lf.T
    return k, k * (0.5 * 13 * U * mag + 2 * U), valid


def _build_rows(img, eh, ew, store, **kw):
    return cd.landmark_rows(torch.from_numpy(img), eh, ew, store=store, **kw)


@pytest.fixture(autouse=True)
def counters():
    _build.reset_launches()
    yield
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_against_float64_oracle(case):
    """The f32 store within the twin's forward-error bound of k64 (the
    padded columns 0); the int8 store equal to rint(127 k64) except within
    that bound (x 127) plus 1e-4 of a .5 boundary; bf16 and int8 the f32 k
    rounded."""
    h, w, eh, ew = CASES[case]
    img = _image(h, w)
    k64, tol, valid = _oracle(img, eh, ew)
    s = k64.shape[1]
    k32, _ = _build_rows(img, eh, ew, torch.float32)
    k32 = k32.double().numpy()
    assert k32.shape == k64.shape
    err = np.abs(k32 - k64)
    # below f32's smallest normal (2^-126) exp underflows
    assert (err <= tol * 1.001 + 2.0 ** -126).all(), float((err - tol).max())
    assert k64.max() > 0.9  # the bound was exercised near k = 1

    k8, _ = _build_rows(img, eh, ew, torch.int8)
    assert k8.shape == (h * w, s + (-s) % 8) and k8.dtype == torch.int8
    assert not k8[:, s:].any()
    q = k8[:, :s].numpy().astype(np.int64)
    x = 127.0 * k64
    near = np.abs(x - np.floor(x) - 0.5) <= 127.0 * tol * 1.001 + 1e-4
    assert (q[~near] == np.rint(x[~near])).all()
    assert (np.abs(q[near] - x[near]) <= 0.5 + 127 * tol[near] + 1e-4).all()
    assert near.mean() < 0.02, near.mean()  # the check still covers 98%
    k32t = torch.from_numpy(k32).float()
    assert torch.equal(k8[:, :s].float(), torch.round(k32t * 127.0))
    kb, _ = _build_rows(img, eh, ew, torch.bfloat16)
    assert torch.equal(kb, k32t.bfloat16())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("store", sorted(STORES))
def test_invalid_and_padded_columns_zero(case, store):
    """A landmark outside the true extent, or int8's padding, is a zero
    column in every store."""
    h, w, eh, ew = CASES[case]
    img = _image(h, w, seed=1)
    _, _, valid = _oracle(img, eh, ew)
    k, _ = _build_rows(img, eh, ew, STORES[store])
    s = valid.size
    cols = np.concatenate([valid, np.zeros(k.shape[1] - s, bool)])
    assert not k[:, torch.from_numpy(~cols)].any()
    assert k[:, torch.from_numpy(cols)].any(0).all()
    if case != "48x60":
        assert not valid.all()


@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("rows", [(0, 1), (37, 1111), (1000, 2304),
                                  (2303, 2304)])
def test_row_range_is_the_slice(store, rows):
    """Rows [r0, r1) bit-equal to that slice of the full build, store and
    sums."""
    h, w, eh, ew = CASES["45x41_in_48x48"]
    img = _image(h, w, seed=2)
    k, d = _build_rows(img, eh, ew, STORES[store])
    kr, dr = _build_rows(img, eh, ew, STORES[store], rows=rows)
    r0, r1 = rows
    assert torch.equal(kr, k[r0:r1]) and torch.equal(dr, d[r0:r1])


@pytest.mark.parametrize("store", sorted(STORES))
def test_sums_only_and_chunking(store, monkeypatch):
    """The sums-only mode keeps no store and gives the full mode's sums bit
    for bit; the twin's chunk size changes no bit."""
    h, w, eh, ew = CASES["48x60"]
    img = _image(h, w, seed=3)
    k, d = _build_rows(img, eh, ew, STORES[store])
    none, d_only = _build_rows(img, eh, ew, STORES[store], sums_only=True)
    assert none is None and torch.equal(d_only, d)
    monkeypatch.setattr(cd, "CHUNK_ROWS", 97)
    kc, dc = _build_rows(img, eh, ew, STORES[store], rows=(5, 2000))
    assert torch.equal(kc, k[5:2000]) and torch.equal(dc, d[5:2000])


def test_int8_row_sums_are_integers_over_127():
    """Under int8 the row sums are the stored integers' sums times
    f32(1/127), exactly."""
    h, w, eh, ew = CASES["45x41_in_48x48"]
    img = _image(h, w, seed=4)
    k, d = _build_rows(img, eh, ew, torch.int8)
    total = k.long().sum(1)
    assert total.max() > 127
    assert torch.equal(d, total.float() * np.float32(1.0 / 127.0))


@pytest.mark.parametrize("store", ["bf16", "f32"])
def test_dense_row_sums(store):
    """The dense row sums: the f32 k (not the bf16 values) in the lane
    order, within 1e-6 relative of the float64 sum of the same k."""
    h, w, eh, ew = CASES["48x60"]
    img = _image(h, w, seed=5)
    k32, _ = _build_rows(img, eh, ew, torch.float32)
    _, d = _build_rows(img, eh, ew, STORES[store])
    want = k32.double().sum(1)
    assert float(((d.double() - want).abs() / want).max()) <= 1e-6
    if store == "f32":
        assert torch.equal(d, cd._lane_sums(k32, 4))
    else:
        assert torch.equal(d, cd._lane_sums(k32, 8))


@pytest.mark.parametrize("v,s", [(16, 512), (8, 300), (4, 37), (16, 1)])
def test_lane_sums_order(v, s):
    """_lane_sums against a scalar float32 loop: lane l adds its columns
    ((j // v) % 32 == l) in increasing order from 0, then lane 0's
    butterfly (l + (l ^ o), o = 16 .. 1)."""
    rng = np.random.default_rng(s)
    k = rng.random((3, s)).astype(np.float32) * 1e3
    want = []
    for row in k:
        lanes = [np.float32(0.0)] * 32
        for j in range(s):
            lanes[(j // v) % 32] = np.float32(lanes[(j // v) % 32] + row[j])
        for o in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[i] + lanes[i + o]) for i in range(o)]
        want.append(lanes[0])
    got = cd._lane_sums(torch.from_numpy(k), v)
    assert torch.equal(got, torch.tensor(want, dtype=torch.float32))


def test_uniform_and_black_images():
    """A uniform image (d2 <= 0 wherever a pixel is a landmark's) and an
    all-black one: every valid entry in (0, 1], k = 1 on the landmarks'
    own pixels, the int8 value 127 there."""
    h, w = 24, 28
    for value in (0, 128):
        img = np.full((3, h, w), value, np.uint8)
        k, _ = _build_rows(img, h, w, torch.float32)
        k8, _ = _build_rows(img, h, w, torch.int8)
        jy, jx = np.meshgrid(np.arange(2, h, 4), np.arange(2, w, 4),
                             indexing="ij")
        own = torch.from_numpy(jy.reshape(-1) * w + jx.reshape(-1))
        cols = torch.arange(own.numel())
        assert (k[own, cols] == 1.0).all() and (k8[own, cols] == 127).all()
        assert (k > 0).all() and (k <= 1).all()


def test_landmark_kernel_uses_the_rows():
    """LandmarkKernel stores landmark_rows' kernel, takes its row norms
    from its sums, and its stream mode rebuilds the same rows."""
    img = _image(40, 48, seed=6)
    hwc = torch.from_numpy(img).permute(1, 2, 0)
    for store, kw in (("int8", dict(kernel_store="int8")),
                      ("bf16", dict()), ("f32", dict(matmul_dtype="float32"))):
        kern = cd.LandmarkKernel(hwc, 37, 45, **kw)
        k, d = _build_rows(img, 37, 45, STORES[store])
        assert torch.equal(kern.k_land, k)
        want = torch.rsqrt(d.clamp_min(1e-12)).reshape(40, 48) * kern.valid
        assert torch.equal(kern.nr_b, want)
    stream = cd.LandmarkKernel(hwc, 37, 45, stream_kernel=True)
    assert stream.k_land is None and stream.nbytes() == 0
    q = torch.rand((stream.n_land, 8),
                   generator=torch.Generator().manual_seed(0)).bfloat16()
    dense = cd.LandmarkKernel(hwc, 37, 45)
    assert torch.equal(stream.product(q), dense.product(q))


def _round32(x: Fraction) -> np.float32:
    """The exact rational x rounded once to f32, ties to even."""
    v = np.float32(float(x))
    cands = (np.nextafter(v, np.float32(-np.inf)), v,
             np.nextafter(v, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.uint32)) & 1))


def _chain_exact(p, q) -> np.float32:
    """chain(p, q) in exact rationals, rounded to f32 once per fma."""
    c = _round32(Fraction(float(p[0])) * Fraction(float(q[0])))
    for x, y in zip(p[1:], q[1:]):
        c = _round32(Fraction(float(x)) * Fraction(float(y))
                     + Fraction(float(c)))
    return c


SIGMA = np.uint32(cd.SIGMA_BITS).view(np.float32)


def test_sigma_and_chain_against_exact_rationals():
    """SIGMA is the f32 nearest sqrt(log2(e) / 2); the twin's chain on 400
    random feature pairs (the features' ranges, near pairs with
    cancellation, signs mixed in) equals exact rational arithmetic rounded
    to f32 once per fma, bit for bit."""
    assert SIGMA == np.float32(math.sqrt(math.log2(math.e) / 2.0))
    rng = np.random.default_rng(7)
    p = (rng.uniform(0, 45, (400, 5)) * SIGMA).astype(np.float32)
    q = (p + rng.normal(0, 0.5, p.shape)).astype(np.float32)
    q[:100] *= rng.choice([-1, 1], (100, 5)).astype(np.float32)
    q[300:] = rng.uniform(-1e-3, 1e-3, (100, 5)).astype(np.float32)
    got = cd._chain([torch.from_numpy(p[:, i]) for i in range(5)],
                    [torch.from_numpy(q[:, i]) for i in range(5)]).numpy()
    want = np.array([_chain_exact(a, b) for a, b in zip(p, q)], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_against_rounded_float64(case):
    """The landmark table: F = RN(SIGMA RN(f)) from IEEE f32 divisions and
    products, b = chain(F, F) in exact rationals rounded once per fma,
    +inf for a landmark outside the extent; the padded columns F = 0, b =
    +inf; the wrapper gives the twin's table on the CPU."""
    h, w, eh, ew = CASES[case]
    img = _image(h, w, seed=8)
    planes = torch.from_numpy(img)
    table = cd.landmark_table_plain(planes, eh, ew).numpy()
    jy, jx = np.meshgrid(np.arange(2, h, 4), np.arange(2, w, 4),
                         indexing="ij")
    jy, jx = jy.reshape(-1), jx.reshape(-1)
    s = jy.size
    assert table.shape == (6, cd.table_columns(s))
    assert table.shape[1] % 512 == 0
    f32 = np.float32
    f = [jx.astype(f32) / f32(50), jy.astype(f32) / f32(50),
         *(img[c][jy, jx].astype(f32) / f32(5) for c in range(3))]
    big_f = np.stack([(x * SIGMA).astype(f32) for x in f])
    valid = (jy < eh) & (jx < ew)
    b = np.array([_chain_exact(big_f[:, j], big_f[:, j]) if valid[j]
                  else np.inf for j in range(s)], f32)
    assert np.array_equal(table[:5, :s].view(np.uint32), big_f.view(np.uint32))
    assert np.array_equal(table[5, :s].view(np.uint32), b.view(np.uint32))
    assert not table[:5, s:].any() and (table[5, s:] == np.inf).all()
    assert np.isfinite(table[5, :s]).sum() == valid.sum() < s or valid.all()
    assert torch.equal(cd.landmark_table(planes, eh, ew),
                       torch.from_numpy(table))


@pytest.mark.parametrize("case", sorted(CASES))
def test_own_pixel_u_is_zero(case):
    """Where a pixel is its landmark's own, c = a_p = b_j, so u = 0 exactly
    and k = 1 (int8 127), on a scene, not only a uniform image."""
    h, w, eh, ew = CASES[case]
    img = _image(h, w, seed=9)
    planes = torch.from_numpy(img)
    table = cd.landmark_table_plain(planes, eh, ew)
    jy, jx = np.meshgrid(np.arange(2, h, 4), np.arange(2, w, 4),
                         indexing="ij")
    jy, jx = torch.from_numpy(jy.reshape(-1)), torch.from_numpy(jx.reshape(-1))
    valid = (jy < eh) & (jx < ew)
    f_pix = cd._scaled_features(planes, 50.0, 5.0)(jy, jx)
    s = jy.numel()
    a = cd._chain(f_pix, f_pix)
    c = cd._chain(f_pix, [x[:s] for x in table[:5]])
    u = 2.0 * c - (a + table[5, :s])
    assert (u[valid] == 0).all() and (u[~valid] == -math.inf).all()
    own = jy * w + jx
    cols = torch.arange(s)
    k, _ = _build_rows(img, eh, ew, torch.float32)
    k8, _ = _build_rows(img, eh, ew, torch.int8)
    assert (k[own, cols][valid] == 1.0).all()
    assert (k8[own, cols][valid] == 127).all()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("store", sorted(STORES))
def test_no_nan_with_invalid_columns(case, store):
    """Invalid and padded columns (b = +inf) give +0, never NaN: every
    stored value and row sum is finite, k in [0, 1]."""
    h, w, eh, ew = CASES[case]
    img = _image(h, w, seed=10)
    for rows in (None, (37, h * w - 5)):
        k, d = _build_rows(img, eh, ew, STORES[store], rows=rows)
        kf = k.float()
        assert torch.isfinite(kf).all() and torch.isfinite(d).all()
        top = 127 if store == "int8" else 1
        assert (kf >= 0).all() and (kf <= top).all()
        assert (d >= 0).all() and (d > 0).any()


def test_wrapper_refuses():
    """Planes that are not [3, H, W] uint8, an empty or outside row range,
    or a stride < 1 raise."""
    img = torch.from_numpy(_image(24, 28))
    for bad in (img.float(), img[:2], img[0]):
        with pytest.raises(ValueError):
            cd.landmark_rows(bad, 24, 28)
    for rows in ((5, 5), (-1, 3), (0, 24 * 28 + 1)):
        with pytest.raises(ValueError):
            cd.landmark_rows(img, 24, 28, rows=rows)
    with pytest.raises(ValueError):
        cd.landmark_rows(img, 24, 28, stride=0)
    assert cd.landmark_grid(24, 28, 4) == (6, 7)
    assert cd.landmark_columns(42, torch.int8) == 48
    assert cd.landmark_columns(42, torch.bfloat16) == 42
