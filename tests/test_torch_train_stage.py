"""train_irn end to end: the JAX stage vs the port's CLI (``--device
cpu``) on one synthetic tree (4 images of 96-128 px, their GT masks as
the ir labels), crop 64, batch 2, radius 4, one epoch (2 steps), both from
JAX's initial variables (the port's init patched to them).

- The checkpoints have the same keys, shapes and dtypes; the backbone is
  bit-equal to its initial values; each head tensor is within 1e-3 of
  JAX's, relative to its largest magnitude (f32: the backward's reductions
  round differently, tests/test_torch_train_steps.py); dp_mean within 1e-4.
- Each framework's make_sem_seg reads the other's checkpoint: the port's
  labels on the JAX checkpoint >= 99% equal to the JAX stage's on it, and
  the JAX stage's on the port's checkpoint >= 99% equal to the port's.
- A JAX ``.train`` file (optax states) is refused with an error that names
  it. Resume: tests/test_torch_train_resume.py."""

import dataclasses
import os
import shutil

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from irn_tpu.data import synthetic
from irn_tpu.models.irn import IRNet as JaxIRNet
from irn_tpu.pipeline import common as jax_common
from irn_tpu.pipeline.config import Config
from irn_tpu.pipeline.stages_irn import (
    make_sem_seg_labels as jax_make_sem_seg,
    train_irn as jax_train_irn,
)
from irn_tpu.utils import checkpoint as jax_ckpt
from irn_tpu_torch.data.synthetic import write_gt_cams
from irn_tpu_torch.ops import _build
from irn_tpu_torch.pipeline import common
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.utils.checkpoint import CheckpointError
from irn_tpu_torch.utils.weights import irn_from_jax

torch.set_num_threads(2)

CAP = 32
N_IMAGES = 4


def _jit_init(model, cfg, example, **kw):
    """The JAX stage's init through jit: the same variables as its eager
    ``model.init`` (seed 0), in half the compile time."""
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), example))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tree, the JAX stage's config, the initial variables, and each
    framework's checkpoint after one epoch."""
    tmp = tmp_path_factory.mktemp("train")
    root = str(tmp / "voc")
    train, _ = synthetic.generate(root, n_images=N_IMAGES, size=96,
                                  max_side_jitter=32, seed=5)
    names = [f"2007_{i:06d}" for i in range(N_IMAGES)]
    with open(train, "w") as f:
        f.write("\n".join(names) + "\n")
    shutil.copytree(os.path.join(root, "SegmentationClass"), tmp / "ir")
    write_gt_cams(root, names, str(tmp / "cam"))
    cfg = Config(
        voc12_root=root, train_list=train, infer_list=train,
        ir_label_out_dir=str(tmp / "ir"), cam_out_dir=str(tmp / "cam"),
        irn_crop_size=64, irn_batch_size=2, irn_num_epoches=1,
        path_radius=4, num_workers=2, rw_grid_cap=CAP, mesh_data=1,
        irn_weights_name=str(tmp / "jax" / "irn.ckpt"),
        session_dir=str(tmp / "sess"), log_name=str(tmp / "log"),
    ).resolve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "init_model_variables", _jit_init)
        jax_train_irn(cfg)
    init = _jit_init(JaxIRNet(), cfg, np.zeros((1, 64, 64, 3), np.float32))

    def port_init(model, cfg_, generator=None, backbone_key="resnet50"):
        model.load_state_dict(irn_from_jax(init))
        return model

    port_weights = str(tmp / "port" / "irn.ckpt")
    _build.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "init_model_variables", port_init)
        summary = port_run.main(_argv(cfg, port_weights))["train_irn"]
    assert not any(_build.LAUNCHES.values())
    return tmp, cfg, names, init, port_weights, summary


def _argv(cfg, weights, *extra):
    return ["--voc12_root", cfg.voc12_root, "--train_list", cfg.train_list,
            "--infer_list", cfg.infer_list,
            "--ir_label_out_dir", cfg.ir_label_out_dir,
            "--cam_out_dir", cfg.cam_out_dir, "--irn_crop_size", "64",
            "--irn_batch_size", "2", "--irn_num_epoches", "1",
            "--path_radius", "4", "--num_workers", "2",
            "--rw_grid_cap", str(CAP), "--irn_weights_name", weights,
            "--session_dir", cfg.session_dir, "--log_name", cfg.log_name,
            "--train_irn_pass", "--device", "cpu", *extra]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def test_checkpoint_matches_jax(trained):
    tmp, cfg, _, init, port_weights, summary = trained
    got = jax_ckpt.load_checkpoint(port_weights)
    want = jax_ckpt.load_checkpoint(cfg.irn_weights_name)
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got_l) == sorted(want_l)
    init_l = dict(_leaves(init))
    for path, w in want_l.items():
        g = got_l[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path[1] == "resnet50":
            np.testing.assert_array_equal(g, init_l[path], err_msg=str(path))
            np.testing.assert_array_equal(w, init_l[path], err_msg=str(path))
        elif path[1] == "dp_mean":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        else:
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= 1e-3, (path, err)
    assert summary["n_steps"] == 2 and summary["max_step"] == 2
    assert all(np.isfinite(v) for row in summary["losses"]
               for v in row.values())


def _sem_seg(cfg, out, weights, port):
    if port:
        port_run.main([
            "--voc12_root", cfg.voc12_root, "--infer_list", cfg.infer_list,
            "--train_list", cfg.train_list, "--cam_out_dir", cfg.cam_out_dir,
            "--irn_weights_name", weights, "--rw_grid_cap", str(CAP),
            "--session_dir", cfg.session_dir, "--log_name", cfg.log_name,
            "--sem_seg_out_dir", out, "--make_sem_seg_pass",
            "--device", "cpu"])
    else:
        jax_make_sem_seg(dataclasses.replace(
            cfg, irn_weights_name=weights, sem_seg_out_dir=out))
    return out


def test_make_sem_seg_reads_either_checkpoint(trained):
    tmp, cfg, names, _, port_weights, _ = trained
    for weights, tag in ((cfg.irn_weights_name, "jax_ckpt"),
                         (port_weights, "port_ckpt")):
        a = _sem_seg(cfg, str(tmp / f"port_on_{tag}"), weights, port=True)
        b = _sem_seg(cfg, str(tmp / f"jax_on_{tag}"), weights, port=False)
        for n in names:
            la = imageio.imread(os.path.join(a, n + ".png"))
            lb = imageio.imread(os.path.join(b, n + ".png"))
            assert la.shape == lb.shape, (tag, n)
            agree = float(np.mean(la == lb))
            assert agree >= 0.99, (tag, n, agree)


def test_jax_train_file_refused(trained):
    """The JAX stage's ``.train`` (optax states) as the port's resume file:
    refused before any optax class is imported, naming the file."""
    tmp, cfg, _, _, _, _ = trained
    path = cfg.irn_weights_name + ".train"
    assert os.path.exists(path)
    with pytest.raises(CheckpointError, match=path):
        port_run.main(_argv(cfg, cfg.irn_weights_name))
