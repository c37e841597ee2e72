"""The model stages at ``--model_dtype bfloat16``: the port's CLI (``--device
cpu``) against the JAX package's stages in bf16 on one synthetic tree (4
images of 96-128 px, their GT masks as CAMs and IR labels), from JAX-init
checkpoints, which both frameworks read in f32 whatever the dtype.

bf16 moves a forward by ~1% (tests/test_torch_bf16.py), so the labels of
two bf16 runs differ where a pixel's scores are close; the gates hold the
port to JAX's own bf16 noise:

- make_sem_seg, make_ins_seg (the class of the instance covering each
  pixel): per image, the port's agreement with JAX bf16 is at least JAX
  bf16's own agreement with JAX f32, or 99%, whichever is lower;
- make_cam: the port's stride-4 CAMs lie within [0.5, 1.25] x JAX bf16's
  relative distance from JAX f32's;
- train_irn and train_cam, one step each in bf16 through the CLI: the
  checkpoint is f32 with JAX's keys and shapes, JAX's bf16 make stage
  reads the port's and the port's reads JAX's."""

import dataclasses
import os

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from irn_tpu.data import synthetic
from irn_tpu.models.cam import CAMNet as JaxCAMNet
from irn_tpu.models.irn import IRNet as JaxIRNet
from irn_tpu.pipeline import common as jax_common
from irn_tpu.pipeline import stages_cam as jax_cam
from irn_tpu.pipeline import stages_irn as jax_irn
from irn_tpu.pipeline.config import Config
from irn_tpu.utils import checkpoint as jax_ckpt
from irn_tpu_torch.data.synthetic import write_gt_cams
from irn_tpu_torch.ops import _build
from irn_tpu_torch.pipeline import run as port_run

torch.set_num_threads(2)

CAP, N_TRAIN, N_VAL = 32, 4, 2


def _jit_init(model, cfg, example, **kw):
    """The JAX stage's init through jit (seed 0)."""
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), example))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bf16")
    root = str(tmp / "voc")
    names = [f"2007_{i:06d}" for i in range(N_TRAIN + N_VAL)]
    train, val = synthetic.generate(root, n_images=len(names), size=96,
                                    max_side_jitter=32, seed=5)
    with open(train, "w") as f:
        f.write("\n".join(names[:N_TRAIN]) + "\n")
    with open(val, "w") as f:
        f.write("\n".join(names[N_TRAIN:]) + "\n")
    names = names[:N_TRAIN]
    write_gt_cams(root, names, str(tmp / "cam"))
    irn = _jit_init(JaxIRNet(), None, np.zeros((1, 64, 64, 3), np.float32))
    # a stronger displacement head, so particles travel and basins form
    irn["params"]["fc_dp7b"]["kernel"] = irn["params"]["fc_dp7b"][
        "kernel"] * 3
    jax_ckpt.save_checkpoint(str(tmp / "irn.ckpt"), irn)
    cam = _jit_init(JaxCAMNet(), None, np.zeros((1, 64, 64, 3), np.float32))
    jax_ckpt.save_checkpoint(str(tmp / "cam.ckpt"), cam)
    cfg = Config(
        voc12_root=root, train_list=train, val_list=val, infer_list=train,
        cam_out_dir=str(tmp / "cam"), ir_label_out_dir=os.path.join(
            root, "SegmentationClass"),
        irn_weights_name=str(tmp / "irn.ckpt"),
        cam_weights_name=str(tmp / "cam.ckpt"), rw_grid_cap=CAP,
        pad_multiple=32, cam_scales=(1.0,), edge_infer_batch=4,
        num_workers=2, mesh_data=1, coco_seg_format="rle",
        irn_crop_size=64, irn_batch_size=N_TRAIN, irn_num_epoches=1,
        path_radius=4, cam_crop_size=64, cam_batch_size=N_TRAIN,
        cam_num_epoches=1, cam_learning_rate=1e-3,
        session_dir=str(tmp / "sess"), log_name=str(tmp / "log"),
    ).resolve()
    return tmp, cfg, names


def _argv(cfg, *extra):
    return ["--voc12_root", cfg.voc12_root, "--train_list", cfg.train_list,
            "--val_list", cfg.val_list, "--infer_list", cfg.infer_list,
            "--cam_out_dir", cfg.cam_out_dir,
            "--ir_label_out_dir", cfg.ir_label_out_dir,
            "--irn_weights_name", cfg.irn_weights_name,
            "--cam_weights_name", cfg.cam_weights_name,
            "--rw_grid_cap", str(CAP), "--pad_multiple", "32",
            "--cam_scales", "1.0", "--edge_infer_batch", "4",
            "--num_workers", "2", "--coco_seg_format", "rle",
            "--irn_crop_size", "64", "--irn_batch_size", str(N_TRAIN),
            "--irn_num_epoches", "1", "--path_radius", "4",
            "--cam_crop_size", "64", "--cam_batch_size", str(N_TRAIN),
            "--cam_num_epoches", "1", "--cam_learning_rate", "1e-3",
            "--session_dir", cfg.session_dir, "--log_name", cfg.log_name,
            "--model_dtype", "bfloat16", "--device", "cpu", *extra]


def _port(cfg, *extra):
    _build.reset_launches()
    res = port_run.main(_argv(cfg, *extra))
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    return res


def _pngs(d, names):
    return {n: np.asarray(imageio.imread(os.path.join(d, n + ".png")))
            for n in names}


def _npys(d, names):
    return {n: np.load(os.path.join(d, n + ".npy"), allow_pickle=True).item()
            for n in names}


def _agree_at_gate(port, jax16, jax32, names):
    for n in names:
        assert port[n].shape == jax16[n].shape == jax32[n].shape, n
        own = float(np.mean(jax16[n] == jax32[n]))
        agree = float(np.mean(port[n] == jax16[n]))
        assert agree >= min(own, 0.99), (n, agree, own)


def test_make_sem_seg(tree):
    tmp, cfg, names = tree
    want = {}
    for dt in ("float32", "bfloat16"):
        out = str(tmp / f"sem_jax_{dt}")
        jax_irn.make_sem_seg_labels(dataclasses.replace(
            cfg, model_dtype=dt, sem_seg_out_dir=out))
        want[dt] = _pngs(out, names)
    out = str(tmp / "sem_port")
    res = _port(cfg, "--make_sem_seg_pass", "--sem_seg_out_dir", out)
    assert res["make_sem_seg_labels"]["n_images"] == len(names)
    _agree_at_gate(_pngs(out, names), want["bfloat16"], want["float32"],
                   names)


def _class_map(d):
    """Each pixel's class + 1 under the instance masks (disjoint
    components of one label map), 0 where none covers it."""
    out = np.zeros(d["mask"].shape[1:] if len(d["mask"]) else d["size"],
                   np.int32)
    for m, c in zip(d["mask"], d["class"]):
        out[m] = c + 1
    return out


def test_make_ins_seg(tree):
    tmp, cfg, names = tree
    want = {}
    for dt in ("float32", "bfloat16"):
        out = str(tmp / f"ins_jax_{dt}")
        jax_irn.make_ins_seg_labels(dataclasses.replace(
            cfg, model_dtype=dt, ins_seg_out_dir=out))
        want[dt] = {n: _class_map(v) for n, v in _npys(out, names).items()}
    out = str(tmp / "ins_port")
    _port(cfg, "--make_ins_seg_pass", "--ins_seg_out_dir", out)
    got = _npys(out, names)
    for v in got.values():
        assert sorted(v) == ["class", "mask", "score", "size"]
        assert v["mask"].dtype == bool and v["score"].dtype == np.float32
    got = {n: _class_map(v) for n, v in got.items()}
    _agree_at_gate(got, want["bfloat16"], want["float32"], names)


def test_make_cam(tree):
    tmp, cfg, names = tree
    want = {}
    for dt in ("float32", "bfloat16"):
        out = str(tmp / f"cam_jax_{dt}")
        jax_cam.make_cam(dataclasses.replace(cfg, model_dtype=dt,
                                             cam_out_dir=out))
        want[dt] = _npys(out, names)
    out = str(tmp / "cam_port")
    _port(cfg, "--make_cam_pass", "--cam_out_dir", out)
    got = _npys(out, names)

    def stack(d, key):
        return np.concatenate([d[n][key].reshape(-1) for n in names])

    for key in ("cam", "high_res"):
        for n in names:
            assert got[n][key].shape == want["bfloat16"][n][key].shape
            assert got[n][key].dtype == np.float32, key
        own = np.linalg.norm(stack(want["bfloat16"], key)
                             - stack(want["float32"], key))
        dist = np.linalg.norm(stack(got, key) - stack(want["float32"], key))
        assert 0.5 * own <= dist <= 1.25 * own, (key, dist, own)


def _same_layout(a_path, b_path):
    def leaves(t, p=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], p + (k,))
        else:
            yield p, np.asarray(t)

    a = dict(leaves(jax_ckpt.load_checkpoint(a_path)))
    b = dict(leaves(jax_ckpt.load_checkpoint(b_path)))
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        assert v.shape == b[k].shape and v.dtype == b[k].dtype == np.float32, k


def test_train_irn_checkpoints_cross(tree):
    """One bf16 step of each framework's train_irn; each make_sem_seg (bf16)
    reads the other's checkpoint."""
    tmp, cfg, names = tree
    jax_w, port_w = str(tmp / "trained_jax_irn.ckpt"), str(
        tmp / "trained_port_irn.ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "init_model_variables", _jit_init)
        jax_irn.train_irn(dataclasses.replace(
            cfg, model_dtype="bfloat16", irn_weights_name=jax_w))
    res = _port(cfg, "--train_irn_pass", "--irn_weights_name", port_w)
    assert res["train_irn"]["n_steps"] == 1
    assert all(np.isfinite(v) for v in res["train_irn"]["losses"][0].values())
    _same_layout(port_w, jax_w)
    out = str(tmp / "sem_jax_on_port")
    jax_irn.make_sem_seg_labels(dataclasses.replace(
        cfg, model_dtype="bfloat16", irn_weights_name=port_w,
        sem_seg_out_dir=out))
    out2 = str(tmp / "sem_port_on_jax")
    _port(cfg, "--make_sem_seg_pass", "--irn_weights_name", jax_w,
          "--sem_seg_out_dir", out2)
    a, b = _pngs(out, names), _pngs(out2, names)
    for n in names:
        assert a[n].shape == b[n].shape == imageio.imread(os.path.join(
            cfg.voc12_root, "JPEGImages", n + ".jpg")).shape[:2]


def test_train_cam_checkpoints_cross(tree):
    """One bf16 step of each framework's train_cam (calibration on); each
    make_cam (bf16) reads the other's checkpoint."""
    tmp, cfg, names = tree
    jax_w, port_w = str(tmp / "trained_jax_cam.ckpt"), str(
        tmp / "trained_port_cam.ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "init_model_variables", _jit_init)
        jax_cam.train_cam(dataclasses.replace(
            cfg, model_dtype="bfloat16", cam_weights_name=jax_w))
    res = _port(cfg, "--train_cam_pass", "--cam_weights_name", port_w)
    assert res["train_cam"]["n_steps"] == 1
    assert all(np.isfinite(v) for v in res["train_cam"]["losses"])
    _same_layout(port_w, jax_w)
    out = str(tmp / "cam_jax_on_port")
    jax_cam.make_cam(dataclasses.replace(
        cfg, model_dtype="bfloat16", cam_weights_name=port_w,
        cam_out_dir=out))
    out2 = str(tmp / "cam_port_on_jax")
    _port(cfg, "--make_cam_pass", "--cam_weights_name", jax_w,
          "--cam_out_dir", out2)
    a, b = _npys(out, names), _npys(out2, names)
    for n in names:
        assert a[n]["cam"].shape == b[n]["cam"].shape
        assert np.isfinite(b[n]["high_res"]).all()


def test_float16_is_refused(tree, tmp_path):
    _, cfg, _ = tree
    argv = _argv(cfg, "--make_sem_seg_pass", "--sem_seg_out_dir",
                 str(tmp_path))
    argv[argv.index("bfloat16")] = "float16"
    with pytest.raises(NotImplementedError, match="float16"):
        port_run.main(argv)
