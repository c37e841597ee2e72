"""make_cam and eval_cam of the port vs the JAX package (CPU, f32), at tiny
sizes: 40-48 px images, ``rw_grid_cap`` 16, ``pad_multiple`` 16, scales
(1.0, 0.5), a CAMNet from a seeded JAX init read by both stages from one
JAX-layout checkpoint.

Convolutions and the bilinear resizes sum in another order in XLA and in
PyTorch, so the CAM maps agree to max-abs 1e-3 (the north star's gate for
cam); the keys are equal, and eval_cam's scores on the same files are
equal. One cross-read: the JAX cam_to_ir_label on the port's CAM files
writes the port's PNGs."""

import dataclasses
import os

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from irn_tpu.data import synthetic
from irn_tpu.models.cam import CAMNet as JaxCAMNet
from irn_tpu.ops.resize import resize_bilinear_dynamic as jax_resize
from irn_tpu.pipeline import stages_cam as jax_stages
from irn_tpu.pipeline.config import Config
from irn_tpu.utils import checkpoint as jax_ckpt
from irn_tpu_torch.models.cam import CAMNet
from irn_tpu_torch.ops.resize import resize_bilinear_dynamic
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline import stages_cam
from irn_tpu_torch.utils.weights import cam_from_jax, cam_to_jax

torch.set_num_threads(2)

CAP = 16
# two size groups: four images of 48x48, two cropped to 40x44
SMALL = (4, 5)


def _jax_variables(seed=1):
    variables = JaxCAMNet().init(jax.random.PRNGKey(seed),
                                 np.zeros((1, 48, 48, 3), np.float32))
    variables = jax.tree.map(np.asarray, variables)
    # non-trivial frozen statistics in the stem, so every buffer maps
    rng = np.random.default_rng(seed)
    bn = variables["stats"]["resnet50"]["bn1"]
    bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32) * 0.1
    bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cam")
    root = str(tmp / "voc")
    train, _ = synthetic.generate(root, n_images=6, size=48,
                                  max_side_jitter=0, seed=3)
    names = [f"2007_{i:06d}" for i in range(6)]
    with open(train, "w") as f:
        f.write("\n".join(names) + "\n")
    for i in SMALL:
        for sub, ext in (("JPEGImages", ".jpg"), ("SegmentationClass", ".png")):
            path = os.path.join(root, sub, names[i] + ext)
            imageio.imwrite(path, np.asarray(imageio.imread(path))[:40, :44])
    weights = str(tmp / "cam.ckpt")
    jax_ckpt.save_checkpoint(weights, _jax_variables())
    cfg = Config(
        voc12_root=root, train_list=train, infer_list=train,
        cam_weights_name=weights, rw_grid_cap=CAP, pad_multiple=16,
        cam_scales=(1.0, 0.5), cam_infer_batch=1,
        cam_out_dir=str(tmp / "jax_cam"), session_dir=str(tmp / "sess"),
        log_name=str(tmp / "log"), num_workers=2,
    ).resolve()
    jax_stages.make_cam(cfg)
    return tmp, cfg, names


def _load(d, names):
    return {n: np.load(os.path.join(d, n + ".npy"), allow_pickle=True).item()
            for n in names}


def _port_argv(cfg, extra):
    return [
        "--voc12_root", cfg.voc12_root, "--infer_list", cfg.infer_list,
        "--train_list", cfg.train_list, "--cam_weights_name",
        cfg.cam_weights_name, "--rw_grid_cap", str(CAP), "--pad_multiple",
        "16", "--cam_scales", "1.0", "0.5", "--session_dir", cfg.session_dir,
        "--log_name", cfg.log_name, "--num_workers", "2", "--device", "cpu",
        *extra,
    ]


def test_weights_round_trip():
    """JAX variables -> the port's state dict -> JAX variables, exactly;
    and the port's state dict survives the trip back."""
    variables = _jax_variables()
    model = CAMNet()
    model.load_state_dict(cam_from_jax(variables))
    back = cam_to_jax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    sd = cam_from_jax(back)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("extent", [(48, 48), (37, 29), (20, 44)])
def test_cam_forward_matches_jax(extent, rng):
    """CAMNet.cam on a zero-padded 48x48 buffer with the true extent, and
    the logits of forward, port vs JAX: max-abs <= 1e-4 x max(1, max|JAX|)
    (f32 convolutions summed in another order)."""
    variables = _jax_variables()
    jmodel = JaxCAMNet()
    model = CAMNet()
    model.load_state_dict(cam_from_jax(variables))
    model.eval()
    x = np.zeros((2, 48, 48, 3), np.float32)
    x[:, : extent[0], : extent[1]] = rng.normal(
        size=(2,) + extent + (3,)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, x, extent=extent,
                                   method=jmodel.cam)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = model.cam(xt, extent=extent).numpy()
        logits = model(xt).numpy()
    vh, vw = -(-extent[0] // 16), -(-extent[1] // 16)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    # inside the extent; beyond it neither side is specified
    np.testing.assert_allclose(got[..., :vh, :vw], want[..., :vh, :vw],
                               atol=tol, rtol=0)
    want_logits = np.asarray(jmodel.apply(variables, x, train=False))
    np.testing.assert_allclose(
        logits, want_logits, rtol=0,
        atol=1e-4 * max(1.0, float(np.abs(want_logits).max())))


@pytest.mark.parametrize("seed", range(4))
def test_resize_bilinear_dynamic_matches_jax(seed):
    """Random source and output extents in fixed buffers: the same values
    inside the output extent (atol 1e-5) and exact zeros beyond it."""
    g = np.random.default_rng(seed)
    src = g.random((3, 2, 12, 14)).astype(np.float32)
    src_true = (int(g.integers(1, 13)), int(g.integers(1, 15)))
    out_true = (int(g.integers(1, 31)), int(g.integers(1, 33)))
    want = np.asarray(jax_resize(src, src_true, out_true, (30, 32)))
    got = resize_bilinear_dynamic(torch.from_numpy(src), src_true, out_true,
                                  (30, 32)).numpy()
    assert got.shape == want.shape == (3, 2, 30, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert not got[..., out_true[0]:, :].any()
    assert not got[..., :, out_true[1]:].any()


@pytest.mark.parametrize("batch", [1, 4])
def test_make_cam_matches_jax(tree, batch):
    """The port's make_cam through its CLI vs the JAX stage (batch 1) over
    two size groups: the same files, keys, dtypes and shapes, cam and
    high_res within max-abs 1e-3."""
    tmp, cfg, names = tree
    out = str(tmp / f"port_cam_{batch}")
    res = port_run.main(_port_argv(cfg, [
        "--cam_out_dir", out, "--make_cam_pass", "--cam_infer_batch",
        str(batch)]))
    assert res["make_cam"]["n_images"] == len(names)
    want, got = _load(cfg.cam_out_dir, names), _load(out, names)
    for n in names:
        assert sorted(got[n]) == ["cam", "high_res", "keys"]
        for key in ("keys", "cam", "high_res"):
            assert got[n][key].dtype == want[n][key].dtype, (n, key)
            assert got[n][key].shape == want[n][key].shape, (n, key)
        np.testing.assert_array_equal(got[n]["keys"], want[n]["keys"])
        for key in ("cam", "high_res"):
            err = float(np.abs(got[n][key] - want[n][key]).max(initial=0))
            assert err < 1e-3, (n, key, err)
    # a second run skips every finished image
    again = port_run.main(_port_argv(cfg, [
        "--cam_out_dir", out, "--make_cam_pass"]))
    assert again["make_cam"]["n_images"] == 0


def test_make_cam_raises_past_grid_cap(tree):
    _, cfg, _ = tree
    small = dataclasses.replace(cfg, rw_grid_cap=8, overwrite=True,
                                cam_out_dir=str(tree[0] / "cap8"))
    with pytest.raises(ValueError, match="rw_grid_cap"):
        stages_cam.make_cam(small, "cpu")


def test_eval_cam_sweep_matches_jax(tree):
    """eval_cam with the threshold sweep over the port's CAM files: the
    port's scores equal the JAX stage's on the same files."""
    tmp, cfg, names = tree
    out = str(tmp / "port_cam_eval")
    stages_cam.make_cam(dataclasses.replace(cfg, cam_out_dir=out), "cpu")
    ecfg = dataclasses.replace(cfg, cam_out_dir=out)
    got = stages_cam.eval_cam(ecfg, "cpu", sweep=True)
    want = jax_stages.eval_cam(ecfg, sweep=True)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["iou"], want["iou"])
    assert got["miou"] == want["miou"]
    assert got["sweep"] == want["sweep"]
    # and through the CLI, without the sweep
    res = port_run.main(_port_argv(cfg, ["--cam_out_dir", out,
                                         "--eval_cam_pass"]))
    np.testing.assert_array_equal(res["eval_cam"]["iou"], want["iou"])


def test_zero_cams_decode_background(tree):
    """A CAMNet whose head is zero: every map is zero, so finalize's
    max-normalization must give zeros (0 / (0 + 1e-5)), not NaN, and both
    decodes (eval_cam's and the ir-label seeds) give background, as the
    JAX side does."""
    from irn_tpu.eval import semseg as jax_semseg

    tmp, cfg, names = tree
    variables = _jax_variables()
    variables["params"]["classifier"]["kernel"] = np.zeros_like(
        variables["params"]["classifier"]["kernel"])
    weights = str(tmp / "zero.ckpt")
    jax_ckpt.save_checkpoint(weights, variables)
    ids = str(tmp / "one.txt")
    with open(ids, "w") as f:
        f.write(names[0] + "\n")
    zcfg = dataclasses.replace(cfg, cam_weights_name=weights, infer_list=ids,
                               cam_out_dir=str(tmp / "zero_cam"),
                               ir_label_out_dir=str(tmp / "zero_ir"),
                               crf_backend="native")
    stages_cam.make_cam(zcfg, "cpu")
    d = _load(zcfg.cam_out_dir, names[:1])[names[0]]
    assert len(d["keys"]) and not d["high_res"].any() and not d["cam"].any()
    for t in (0.05, cfg.cam_eval_thres):
        pred = stages_cam.stages_eval.decode_cam_to_labels(
            d["high_res"], d["keys"], t)
        assert not pred.any()
        np.testing.assert_array_equal(
            pred, jax_semseg.decode_cam_to_labels(d["high_res"], d["keys"], t))
    stages_cam.cam_to_ir_label(zcfg, "cpu")
    png = np.asarray(imageio.imread(
        os.path.join(zcfg.ir_label_out_dir, names[0] + ".png")))
    assert png.shape == d["high_res"].shape[1:] and not png.any()


def test_jax_ir_label_reads_port_cams(tree):
    """Cross-read: the JAX cam_to_ir_label (native lattice) over the port's
    CAM files writes the same PNGs as the port's stage."""
    tmp, cfg, names = tree
    cams = str(tmp / "port_cam_x")
    stages_cam.make_cam(dataclasses.replace(cfg, cam_out_dir=cams), "cpu")
    outs = {}
    for tag, run in (("jax", lambda c: jax_stages.cam_to_ir_label(c)),
                     ("port", lambda c: stages_cam.cam_to_ir_label(c, "cpu"))):
        c = dataclasses.replace(cfg, cam_out_dir=cams, crf_backend="native",
                                ir_label_out_dir=str(tmp / f"ir_{tag}"))
        run(c)
        outs[tag] = {n: np.asarray(imageio.imread(os.path.join(
            c.ir_label_out_dir, n + ".png"))) for n in names}
    for n in names:
        np.testing.assert_array_equal(outs["port"][n], outs["jax"][n],
                                      err_msg=n)
