"""train_cam end to end: the JAX stage vs the port's CLI (``--device cpu``)
on one synthetic tree (96-128 px images; a train list of 4, so an epoch
is 2 steps; a val list of 3, so the validate loop ends on a tail batch of
1), crop 64, batch 2, one epoch, calibration on (no pretrained backbone),
both from JAX's initial variables (the port's init patched to them).

The learning rate is 1e-3, as in tests/test_torch_cam_train_steps.py: at
the reference's 0.1 this random backbone on 64 px crops diverges in both
frameworks within two steps (0.01 reaches a validate loss of ~157).

- The checkpoints have the same keys, shapes and dtypes; the frozen
  parameters (stem, layers 1-2) are bit-equal to their initial values in
  both; the calibrated statistics agree (tests/test_torch_train_cam.py's
  gate); the trained tensors agree within the f32 gate below.
- Each framework's make_cam reads the other's checkpoint: CAM max-abs
  below 1e-3 against the other framework's make_cam on the same file.
- The port's resume is bit-equal to a straight run, and a JAX ``.train``
  file (optax states) is refused with an error that names it."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from irn_tpu.data import synthetic
from irn_tpu.models.cam import CAMNet as JaxCAMNet
from irn_tpu.pipeline import common as jax_common
from irn_tpu.pipeline import stages_cam as jax_stages
from irn_tpu.pipeline.config import Config
from irn_tpu.utils import checkpoint as jax_ckpt
from irn_tpu_torch.ops import _build
from irn_tpu_torch.pipeline import common
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline import stages_cam
from irn_tpu_torch.utils.checkpoint import CheckpointError, load_checkpoint
from irn_tpu_torch.utils.weights import cam_from_jax

torch.set_num_threads(2)

CROP, BATCH, LR = 64, 2, 1e-3
N_TRAIN, N_VAL = 4, 3
FROZEN = ("conv1", "bn1", "layer1_", "layer2_")


def _jit_init(model, cfg, example, **kw):
    """The JAX stage's init through jit: the same variables as its eager
    ``model.init`` (seed 0), in less compile time."""
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), example))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _argv(cfg, weights, *extra):
    return ["--voc12_root", cfg.voc12_root, "--train_list", cfg.train_list,
            "--val_list", cfg.val_list, "--infer_list", cfg.infer_list,
            "--cam_crop_size", str(CROP), "--cam_batch_size", str(BATCH),
            "--cam_num_epoches", "1", "--cam_learning_rate", str(LR),
            "--num_workers", "2", "--cam_weights_name", weights,
            "--session_dir", cfg.session_dir, "--log_name", cfg.log_name,
            "--train_cam_pass", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tree, the JAX stage's config, the initial variables, and each
    framework's checkpoint after one epoch."""
    tmp = tmp_path_factory.mktemp("train_cam")
    root = str(tmp / "voc")
    names = [f"2007_{i:06d}" for i in range(N_TRAIN + N_VAL)]
    train, val = synthetic.generate(root, n_images=len(names), size=96,
                                    max_side_jitter=32, seed=7)
    with open(train, "w") as f:
        f.write("\n".join(names[:N_TRAIN]) + "\n")
    with open(val, "w") as f:
        f.write("\n".join(names[N_TRAIN:]) + "\n")
    infer = str(tmp / "infer.txt")
    with open(infer, "w") as f:
        f.write("\n".join(names[:2]) + "\n")
    cfg = Config(
        voc12_root=root, train_list=train, val_list=val, infer_list=infer,
        cam_crop_size=CROP, cam_batch_size=BATCH, cam_num_epoches=1,
        cam_learning_rate=LR, num_workers=2, mesh_data=1,
        cam_weights_name=str(tmp / "jax" / "cam.ckpt"),
        session_dir=str(tmp / "sess"), log_name=str(tmp / "log"),
        rw_grid_cap=32, pad_multiple=32, cam_scales=(1.0,),
    ).resolve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "init_model_variables", _jit_init)
        jax_stages.train_cam(cfg)
    init = _jit_init(JaxCAMNet(), cfg,
                     np.zeros((1, CROP, CROP, 3), np.float32))

    def port_init(model, cfg_, generator=None, backbone_key="resnet50"):
        model.load_state_dict(cam_from_jax(init))
        return model

    port_weights = str(tmp / "port" / "cam.ckpt")
    _build.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "init_model_variables", port_init)
        summary = port_run.main(_argv(cfg, port_weights))["train_cam"]
    assert not any(_build.LAUNCHES.values())
    return tmp, cfg, names, init, port_weights, summary


# The trained tensors after two f32 steps. tests/test_torch_cam_train_steps
# shows the updates are ill-conditioned: after two steps (c3) each
# framework's f32 run is 4.6e-2 from the f64 run in norm and the two are
# 1.9e-2 apart; here the calibrated statistics (up to 1e-4 apart in layer4)
# enter too. Measured: 2.5e-2 over the trained tensors together
# (||port - JAX|| / ||JAX - init||): the gate is 5e-2.
def test_checkpoint_matches_jax(trained):
    tmp, cfg, _, init, port_weights, summary = trained
    got = dict(_leaves(jax_ckpt.load_checkpoint(port_weights)))
    want = dict(_leaves(jax_ckpt.load_checkpoint(cfg.cam_weights_name)))
    init_l = dict(_leaves(init))
    assert sorted(got) == sorted(want)
    num = den = 0.0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        frozen = path[1] == "resnet50" and path[2].startswith(FROZEN)
        if path[0] == "stats":
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= (1e-5 if frozen else 2e-4), (path, err)
        elif frozen:
            np.testing.assert_array_equal(g, init_l[path], err_msg=str(path))
            np.testing.assert_array_equal(w, init_l[path], err_msg=str(path))
        else:
            num += float(np.sum((g.astype(np.float64) - w) ** 2))
            den += float(np.sum((w.astype(np.float64) - init_l[path]) ** 2))
            assert not np.array_equal(g, init_l[path]), path
    assert den > 0 and (num / den) ** 0.5 <= 5e-2, (num / den) ** 0.5
    assert (summary["n_steps"], summary["max_step"],
            summary["start_epoch"]) == (2, 2, 0)
    assert len(summary["val_losses"]) == 1
    assert all(np.isfinite(summary["losses"] + summary["val_losses"]))


def _make_cam(cfg, weights, out, port):
    if port:
        port_run.main([
            "--voc12_root", cfg.voc12_root, "--infer_list", cfg.infer_list,
            "--train_list", cfg.train_list, "--cam_weights_name", weights,
            "--cam_out_dir", out, "--rw_grid_cap", str(cfg.rw_grid_cap),
            "--pad_multiple", str(cfg.pad_multiple), "--cam_scales", "1.0",
            "--session_dir", cfg.session_dir, "--log_name", cfg.log_name,
            "--make_cam_pass", "--device", "cpu"])
    else:
        jax_stages.make_cam(dataclasses.replace(
            cfg, cam_weights_name=weights, cam_out_dir=out))
    return out


def test_make_cam_reads_either_checkpoint(trained):
    tmp, cfg, names, _, port_weights, _ = trained
    for weights, tag in ((cfg.cam_weights_name, "jax_ckpt"),
                         (port_weights, "port_ckpt")):
        a = _make_cam(cfg, weights, str(tmp / f"port_on_{tag}"), port=True)
        b = _make_cam(cfg, weights, str(tmp / f"jax_on_{tag}"), port=False)
        for n in names[:2]:
            da = np.load(os.path.join(a, n + ".npy"), allow_pickle=True).item()
            db = np.load(os.path.join(b, n + ".npy"), allow_pickle=True).item()
            np.testing.assert_array_equal(da["keys"], db["keys"])
            for k in ("cam", "high_res"):
                assert da[k].shape == db[k].shape, (tag, n, k)
                err = float(np.abs(da[k] - db[k]).max(initial=0))
                assert err < 1e-3, (tag, n, k, err)


def test_jax_train_file_refused(trained):
    """The JAX stage's ``.train`` (optax states) as the port's resume file:
    refused before any optax class is imported, naming the file."""
    tmp, cfg, _, _, _, _ = trained
    path = cfg.cam_weights_name + ".train"
    assert os.path.exists(path)
    with pytest.raises(CheckpointError, match=path):
        port_run.main(_argv(cfg, cfg.cam_weights_name))


class Stopped(Exception):
    pass


def test_resume_is_bit_equal(trained, monkeypatch):
    """Two epochs straight (with ``--profile_dir``: 4 steps, a trace of
    steps [2, 4)) against the same run stopped right after its first
    epoch's ``.train`` and resumed: the same bits, the resumed run's
    losses the straight run's second epoch."""
    tmp, cfg, _, _, _, _ = trained

    def run(tag, *extra):
        weights = str(tmp / tag / "cam.ckpt")
        argv = _argv(cfg, weights, *extra)
        argv[argv.index("--cam_num_epoches") + 1] = "2"
        return weights, port_run.main(argv)["train_cam"]

    prof = str(tmp / "prof")
    whole, s_whole = run("whole", "--profile_dir", prof)
    traces = os.listdir(os.path.join(prof, "train_cam"))
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    save = stages_cam.save_checkpoint

    def save_then_stop(path, tree):
        save(path, tree)
        if path.endswith(".train"):
            raise Stopped(path)

    with monkeypatch.context() as mp:
        mp.setattr(stages_cam, "save_checkpoint", save_then_stop)
        with pytest.raises(Stopped):
            run("split")
    split, s_resumed = run("split")
    assert (s_whole["n_steps"], s_resumed["n_steps"]) == (4, 2)
    assert s_resumed["start_epoch"] == 1
    assert s_resumed["losses"] == s_whole["losses"][2:]
    assert s_resumed["val_losses"] == s_whole["val_losses"][1:]
    for suffix in ("", ".train"):
        a = dict(_leaves(load_checkpoint(whole + suffix)))
        b = dict(_leaves(load_checkpoint(split + suffix)))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    saved = load_checkpoint(whole + ".train")
    assert int(saved["step"]) == 4 and int(saved["epoch"]) == 2
    # momentum for every trained tensor: the backbone and the head
    assert sorted(saved["momentum"]) == ["classifier", "resnet50"]
    mom = dict(_leaves(saved["momentum"]))
    for path, v in mom.items():
        frozen = path[0] == "resnet50" and path[1].startswith(FROZEN)
        assert (not v.any()) == frozen, path
