"""cam_to_ir_label's two CRF backends in the port vs the JAX package (CPU).

- The native lattice: the port builds ``native/*.cpp`` itself
  (``irn_tpu_torch/ops/native.py``) with the flags of native/Makefile, so
  its labels, and the stage's PNGs, are bit-equal to the JAX package's
  ``native/libirn_native.so`` on the same host; the NumPy lattice
  (fallback) is held equal too.
- The device landmark CRF (``irn_tpu_torch/ops/crf_device.py``) vs
  ``irn_tpu.ops.crf_tpu``: labels >= 99.9% equal per image in each store
  (f32 and bf16 dense, int8) and with ``stream_kernel``. The int8
  products are exact integers on both sides; the f32 kernel build (one
  5-term product, an exp) rounds differently only in the last bit.
"""

import dataclasses
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from irn_tpu.data import synthetic, voc12
from irn_tpu.ops import crf as jax_crf
from irn_tpu.ops import crf_tpu
from irn_tpu.ops import native as jax_native
from irn_tpu.pipeline import stages_cam as jax_stages
from irn_tpu.pipeline.config import Config
from irn_tpu_torch.ops import crf, crf_device, native
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline import stages_cam

torch.set_num_threads(2)

GATE = 0.999


def _scene(rng, h, w):
    """tests/test_crf_tpu.py's scene: color regions, a thin stripe, 6%
    label noise."""
    img = np.full((h, w, 3), 50.0)
    img[:, : w // 2] = (190, 70, 60)
    img[h // 2:, w // 2:] = (70, 170, 90)
    img[10:12, :] = (240, 230, 40)
    img = np.clip(img + rng.normal(0, 10, (h, w, 3)), 0, 255)
    labels = np.zeros((h, w), np.int32)
    labels[:, : w // 2 - 2] = 5
    labels[h // 2 + 2:, w // 2:] = 12
    labels[10:12, ::3] = 7
    labels[rng.random((h, w)) < 0.06] = 18
    return img.astype(np.uint8), labels


def test_native_library_builds_and_matches_jax(rng):
    """The port's own build loads from irn_tpu_torch/_kernels and refines
    label pairs bit-equal to the JAX package's library, serial and
    threaded; the normalized lattice filter is bit-equal too."""
    assert native.load() is not None
    assert os.path.dirname(native.BUILD_INFO["path"]) == native.BUILD_DIR
    assert jax_native.load() is not None
    img, labels = _scene(rng, 45, 61)
    la, lb = labels % 6, (labels > 0).astype(np.int32) * 2
    torch_threads = torch.get_num_threads()
    try:
        for threads in (1, 3):
            native.set_num_threads(threads)
            jax_native.set_num_threads(threads)
            got = crf.crf_inference_label_pair(img, la, lb, n_labels=6)
            want = jax_crf.crf_inference_label_pair(img, la, lb, n_labels=6)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.int32
                np.testing.assert_array_equal(g, w)
    finally:
        # the lattice's OpenMP count is torch's too: leave the module's 2
        torch.set_num_threads(torch_threads)
    np.testing.assert_array_equal(
        crf.crf_inference_label(img, la, n_labels=6),
        jax_crf.crf_inference_label(img, la, n_labels=6))
    f = rng.random((300, 5)).astype(np.float32)
    v = rng.random((300, 3)).astype(np.float32)
    np.testing.assert_array_equal(crf.filter_normalized(f, v),
                                  jax_crf.filter_normalized(f, v))


def test_native_build_keyed_by_sources_and_cpu(monkeypatch):
    """The library's name carries the sources, the flags and the host CPU
    (-march=native code runs only there)."""
    flags = native.CXX_FLAGS
    a = native._digest("g++", flags)
    assert a == native._digest("g++", flags)
    assert a != native._digest("clang++", flags)
    assert a != native._digest("g++", flags + ("-fopenmp",))
    monkeypatch.setattr(native, "_host_cpu", lambda: "another cpu")
    assert native._digest("g++", flags) != a


def test_numpy_lattice_matches_jax(rng):
    """The NumPy fallback of the port's copy against the JAX package's."""
    img, labels = _scene(rng, 14, 17)
    got = crf._crf_label_np(img.astype(np.float64), labels % 4, 3, 4, 0.7,
                            3.0, 3.0, 50.0, 5.0, 10.0)
    want = jax_crf._crf_label_np(img.astype(np.float64), labels % 4, 3, 4,
                                 0.7, 3.0, 3.0, 50.0, 5.0, 10.0)
    np.testing.assert_array_equal(got, want)
    f = rng.random((50, 5))
    a, b = crf.permutohedral_prepare(f), jax_crf.permutohedral_prepare(f)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]


STORES = {
    "f32": dict(matmul_dtype="float32"),
    "bf16": dict(),
    "int8": dict(kernel_store="int8"),
    "stream": dict(stream_kernel=True),
}


@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("shape", [(48, 60, 32), (45, 41, 12)],
                         ids=["48x60", "45x41_odd_landmarks"])
def test_landmark_pair_matches_jax(store, shape, rng):
    """LandmarkCRF.pair, port vs JAX, per store: >= 99.9% equal labels per
    map. 45x41 at pad_multiple 12 is a 48x48 bucket with 144 landmarks,
    and 20x20 (shape below) 24x24 with 36: the int8 product pads them to
    multiples of 8."""
    h, w, pm = shape
    img, labels = _scene(rng, h, w)
    la, lb = labels % 6, (labels > 0).astype(np.int32) * 3
    kw = dict(stride=4, pad_multiple=pm, **STORES[store])
    want = crf_tpu.LandmarkCRF(**kw).pair(img, la, lb, n_labels=6)
    got = crf_device.LandmarkCRF(device="cpu", **kw).pair(img, la, lb,
                                                          n_labels=6)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape == (h, w) and g.dtype == np.uint8
        assert (g == w_).mean() >= GATE, (store, (g == w_).mean())


@pytest.mark.parametrize("store,gate", [("int8", 0.999), ("dense", 0.995)])
@pytest.mark.parametrize("pm", [1, 50])
def test_landmark_pad_multiple_matches_jax(store, gate, pm, rng):
    """Any ``pad_multiple`` the JAX package takes: at 1 and 50 a 45 x 47
    image pads to 45 x 48 and 50 x 100 in the port (w a multiple of
    lcm(pad_multiple, 4), as K17's tensor map needs) and to 45 x 47 and 50
    x 50 in JAX; padded pixels change no label, so the port meets the
    stores' gates against JAX all the same."""
    img, labels = _scene(rng, 45, 47)
    la, lb = labels % 6, (labels > 0).astype(np.int32) * 3
    kw = dict(stride=4, pad_multiple=pm, t=5, kernel_store=store)
    port = crf_device.LandmarkCRF(device="cpu", **kw)
    assert port._bucket(45, 47) == {1: (45, 48), 50: (50, 100)}[pm]
    want = crf_tpu.LandmarkCRF(**kw).pair(img, la, lb, n_labels=6)
    got = port.pair(img, la, lb, n_labels=6)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape == (45, 47) and g.dtype == np.uint8
        assert (g == w_).mean() >= gate, (store, pm, (g == w_).mean())


def test_landmark_int8_padding_and_single(rng):
    """36 landmarks (not a multiple of 8) under int8, and single()."""
    img, labels = _scene(rng, 20, 20)
    la = labels % 5
    kw = dict(stride=4, pad_multiple=12, kernel_store="int8", t=5)
    want = crf_tpu.LandmarkCRF(**kw).single(img, la, n_labels=5)
    port = crf_device.LandmarkCRF(device="cpu", **kw)
    kern = port.build(port.upload(img, la, la), 20, 20)
    assert kern.n_land == 36 and kern.k_land.shape == (24 * 24, 40)
    assert (port.single(img, la, n_labels=5) == want).mean() >= GATE


def test_stream_kernel_bit_equal_to_dense(rng):
    """stream_kernel recomputes the kernel chunks each iteration: the same
    bf16 values as the stored kernel, so the labels are equal; int8 cannot
    stream, and a label past the cap raises."""
    img = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
    la = rng.integers(0, 4, (40, 48)).astype(np.int32)
    lb = rng.integers(0, 4, (40, 48)).astype(np.int32)
    kw = dict(stride=4, t=3, pad_multiple=8, device="cpu")
    a0, b0 = crf_device.LandmarkCRF(**kw).pair(img, la, lb, n_labels=4)
    a1, b1 = crf_device.LandmarkCRF(stream_kernel=True, **kw).pair(
        img, la, lb, n_labels=4)
    np.testing.assert_array_equal(a0, a1)
    np.testing.assert_array_equal(b0, b1)
    with pytest.raises(ValueError):
        crf_device.LandmarkCRF(stream_kernel=True, kernel_store="int8",
                               **kw).pair(img, la, lb, n_labels=4)
    with pytest.raises(ValueError):
        crf_device.LandmarkCRF(n_label_cap=4, **kw).pair(img, la + 1, lb)


def test_products_on_the_cpu(rng):
    """The CPU forms of the two products: int8 through torch._int_mm equal
    to the exact integer product (S and the 42 columns padded), bf16 with
    exact products and f32 sums."""
    k8 = torch.from_numpy(rng.integers(0, 128, (64, 40)).astype(np.int8))
    q8 = torch.from_numpy(rng.integers(0, 128, (40, 42)).astype(np.int8))
    want = k8.long() @ q8.long()
    got = crf_device.product_int8(k8, q8)
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)
    kb = torch.from_numpy(rng.random((64, 40)).astype(np.float32)).bfloat16()
    q = torch.from_numpy(rng.random((40, 42)).astype(np.float32))
    got = crf_device.product_f32(kb, q)
    assert got.dtype == torch.float32
    want = kb.double() @ q.bfloat16().double()
    assert float((got.double() - want).abs().max()) < 1e-5


@pytest.fixture(scope="module")
def seed_tree(tmp_path_factory):
    """A synthetic tree with spatially coherent CAMs (color-proximity
    blobs, max-normalized), as tests/test_crf_tpu.py's stage A/B."""
    tmp = tmp_path_factory.mktemp("irl")
    root = str(tmp / "voc")
    train, _ = synthetic.generate(root, n_images=3, size=56,
                                  max_side_jitter=8, seed=5)
    cam_dir = tmp / "cam"
    cam_dir.mkdir()
    names = voc12.load_img_name_list(train)
    rng = np.random.default_rng(7)
    for name in names:
        img = np.asarray(imageio.imread(
            os.path.join(root, "JPEGImages", name + ".jpg")))
        k = int(rng.integers(1, 3))
        keys = np.sort(rng.choice(20, size=k, replace=False)).astype(np.int64)
        refs = rng.integers(0, 255, (k, 3))
        dist = np.linalg.norm(
            img[None].astype(np.float32) - refs[:, None, None, :], axis=-1)
        high = np.exp(-dist / 60.0).astype(np.float32)
        high /= high.max(axis=(1, 2), keepdims=True) + 1e-5
        np.save(str(cam_dir / f"{name}.npy"),
                {"keys": keys, "cam": None, "high_res": high})
    cfg = dataclasses.replace(
        Config(voc12_root=root, train_list=train, infer_list=train,
               cam_out_dir=str(cam_dir), session_dir=str(tmp / "sess"),
               log_name=str(tmp / "log")).resolve(),
        num_workers=2,
    )
    return tmp, cfg, names


def _pngs(d, names):
    return {n: np.asarray(imageio.imread(os.path.join(d, n + ".png")))
            for n in names}


@pytest.mark.parametrize("backend,store", [
    ("native", None), ("tpu", "int8"), ("tpu", "dense")])
def test_cam_to_ir_label_matches_jax(seed_tree, backend, store):
    """The port's stage (through its CLI) vs the JAX stage on the same
    CAM files: native PNGs bit-equal, device-CRF PNGs >= 99.9% equal per
    image in each store."""
    tmp, cfg, names = seed_tree
    tag = f"{backend}_{store}"
    jcfg = dataclasses.replace(cfg, crf_backend=backend,
                               crf_kernel_store=store or "int8",
                               ir_label_out_dir=str(tmp / f"jax_{tag}"))
    jax_stages.cam_to_ir_label(jcfg)
    out = str(tmp / f"port_{tag}")
    argv = ["--voc12_root", cfg.voc12_root, "--infer_list", cfg.infer_list,
            "--train_list", cfg.train_list, "--cam_out_dir", cfg.cam_out_dir,
            "--session_dir", cfg.session_dir, "--log_name", cfg.log_name,
            "--num_workers", "2", "--ir_label_out_dir", out,
            "--crf_backend", backend, "--cam_to_ir_label_pass",
            "--device", "cpu"]
    if store:
        argv += ["--crf_kernel_store", store]
    summ = port_run.main(argv)["cam_to_ir_label"]
    assert summ["n_images"] == len(names) and summ["backend"] == backend
    assert summ["kernel_store"] == store
    want, got = _pngs(jcfg.ir_label_out_dir, names), _pngs(out, names)
    for n in names:
        assert got[n].dtype == np.uint8 and got[n].shape == want[n].shape
        if backend == "native":
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        else:
            assert (got[n] == want[n]).mean() >= GATE, (n, tag)
    # an existing PNG is skipped before its decode
    assert port_run.main(argv)["cam_to_ir_label"]["n_images"] == 0


def test_crf_backend_auto(seed_tree):
    """'auto' is the native lattice on the CPU (the stage's PNGs are the
    native ones) and the device CRF on CUDA; explicit values pass; others
    raise."""
    tmp, cfg, names = seed_tree
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert stages_cam.resolve_crf_backend(cfg, cpu) == "native"
    assert stages_cam.resolve_crf_backend(cfg, cuda) == "tpu"
    for explicit in ("native", "tpu"):
        c = dataclasses.replace(cfg, crf_backend=explicit)
        assert stages_cam.resolve_crf_backend(c, cuda) == explicit
        assert stages_cam.resolve_crf_backend(c, cpu) == explicit
    with pytest.raises(ValueError):
        stages_cam.resolve_crf_backend(
            dataclasses.replace(cfg, crf_backend="lattice"), cpu)
    acfg = dataclasses.replace(cfg, ir_label_out_dir=str(tmp / "auto"))
    assert stages_cam.cam_to_ir_label(acfg, "cpu")["backend"] == "native"
    ncfg = dataclasses.replace(cfg, crf_backend="native",
                               ir_label_out_dir=str(tmp / "auto_native"))
    stages_cam.cam_to_ir_label(ncfg, "cpu")
    a, b = _pngs(acfg.ir_label_out_dir, names), _pngs(
        ncfg.ir_label_out_dir, names)
    for n in names:
        np.testing.assert_array_equal(a[n], b[n])
