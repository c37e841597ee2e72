"""make_sem_seg and make_ins_seg with each image's walk split over a mesh
(``--rw_mesh_model k``), end to end on the CPU: the port's CLI against the
JAX stages at ``rw_mesh_model 2`` (on JAX's virtual 8-device CPU mesh,
tests/conftest.py) and against the port's own single-device run, on one
synthetic tree (4 images of 96-128 px, ``rw_grid_cap`` 32), one JAX-format
IRN checkpoint (seeded JAX init, the displacement head x3: one basin per
image, as tests/test_torch_ins_stage.py's gate run) and GT cams.

The port's mesh is the CPU k times; its walk takes the column-split
stencil (K0's twin per device and round), bit-equal to the single-device
stencil, so its files equal the single-device run's byte for byte. The
JAX stages' gates are those of the single-device slices: sem labels >= 99%
per image (in practice all pixels), instance masks and classes equal,
scores within 2e-3."""

import dataclasses
import os

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from irn_tpu.data import synthetic
from irn_tpu.models.irn import IRNet as JaxIRNet
from irn_tpu.pipeline.config import Config
from irn_tpu.pipeline.stages_irn import (
    make_ins_seg_labels as jax_make_ins_seg,
    make_sem_seg_labels as jax_make_sem_seg,
)
from irn_tpu.utils import checkpoint as jax_ckpt
from irn_tpu_torch.data.synthetic import write_gt_cams
from irn_tpu_torch.ops import _build
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline import stages_irn
from irn_tpu_torch.pipeline.config import Config as PortConfig

torch.set_num_threads(2)

CAP = 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    root = str(tmp / "voc")
    train, _ = synthetic.generate(root, n_images=4, size=96,
                                  max_side_jitter=32, seed=5)
    names = [f"2007_{i:06d}" for i in range(4)]
    with open(train, "w") as f:
        f.write("\n".join(names) + "\n")
    write_gt_cams(root, names, str(tmp / "cam"))
    v = jax.tree.map(np.asarray, JaxIRNet().init(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32)))
    v["params"]["fc_dp7b"]["kernel"] = v["params"]["fc_dp7b"]["kernel"] * 3
    weights = str(tmp / "irn.ckpt")
    jax_ckpt.save_checkpoint(weights, v)
    cfg = Config(
        voc12_root=root, train_list=train, infer_list=train,
        cam_out_dir=str(tmp / "cam"), irn_weights_name=weights,
        rw_grid_cap=CAP, session_dir=str(tmp / "sess"),
        log_name=str(tmp / "log"), edge_infer_batch=4,
    ).resolve()
    return tmp, cfg, names


def _argv(cfg, out, stage, extra=()):
    flag = "sem_seg" if stage == "sem" else "ins_seg"
    return [
        "--voc12_root", cfg.voc12_root, "--infer_list", cfg.infer_list,
        "--train_list", cfg.train_list, "--cam_out_dir", cfg.cam_out_dir,
        "--irn_weights_name", cfg.irn_weights_name,
        "--rw_grid_cap", str(CAP), "--session_dir", cfg.session_dir,
        "--log_name", cfg.log_name, f"--{flag}_out_dir", out,
        f"--make_{flag}_pass", "--device", "cpu", *extra,
    ]


def _files(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _port(tree, stage, tag, extra=()):
    """The port's CLI run of one make stage; (summary, files by name)."""
    tmp, cfg, _ = tree
    out = str(tmp / f"port_{stage}_{tag}")
    _build.reset_launches()
    res = port_run.main(_argv(cfg, out, stage, extra))
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    key = "make_sem_seg_labels" if stage == "sem" else "make_ins_seg_labels"
    return res[key], _files(out)


@pytest.fixture(scope="module")
def single(tree):
    """The port's single-device runs of both stages."""
    return {s: _port(tree, s, "single") for s in ("sem", "ins")}


@pytest.mark.parametrize("k", [2, 4, 8])
def test_make_sem_seg_mesh_equals_single(tree, single, k):
    summary, got = _port(tree, "sem", f"mesh{k}", ("--rw_mesh_model", str(k)))
    assert summary["n_images"] == 4
    assert set(summary["modes"].values()) == {"mesh_diag"}
    assert set(single["sem"][0]["modes"].values()) == {"diag"}
    assert got == single["sem"][1]


def test_make_sem_seg_mesh_matches_jax(tree, single):
    tmp, cfg, names = tree
    jcfg = dataclasses.replace(cfg, rw_mesh_model=2,
                               sem_seg_out_dir=str(tmp / "jax_sem"))
    jax_make_sem_seg(jcfg)
    _, got = _port(tree, "sem", "mesh2_jax", ("--rw_mesh_model", "2"))
    for n in names:
        want = np.asarray(imageio.imread(os.path.join(jcfg.sem_seg_out_dir,
                                                      n + ".png")))
        mine = np.asarray(imageio.imread(
            os.path.join(tmp / "port_sem_mesh2_jax", n + ".png")))
        assert mine.shape == want.shape, n
        agree = float(np.mean(mine == want))
        assert agree >= 0.99, (n, agree)
    assert len(got) == len(names)


def _read_ins(d, names):
    return {n: np.load(os.path.join(d, n + ".npy"), allow_pickle=True).item()
            for n in names}


def test_make_ins_seg_mesh_matches_jax(tree, single):
    """The instance stage at rw_mesh_model 2: the port's single-device
    files byte for byte, and the JAX mesh stage's masks and classes
    exactly, scores within 2e-3."""
    tmp, cfg, names = tree
    summary, got = _port(tree, "ins", "mesh2", ("--rw_mesh_model", "2"))
    assert got == single["ins"][1]
    assert set(summary["modes"].values()) == {"mesh_diag"}
    assert summary["device_ccl"] == summary["device_split"] == len(names)
    jcfg = dataclasses.replace(cfg, rw_mesh_model=2,
                               ins_seg_out_dir=str(tmp / "jax_ins"))
    jax_make_ins_seg(jcfg)
    want = _read_ins(jcfg.ins_seg_out_dir, names)
    mine = _read_ins(tmp / "port_ins_mesh2", names)
    for n in names:
        assert mine[n]["size"] == want[n]["size"], n
        np.testing.assert_array_equal(mine[n]["mask"], want[n]["mask"],
                                      err_msg=n)
        np.testing.assert_array_equal(mine[n]["class"], want[n]["class"],
                                      err_msg=n)
        np.testing.assert_allclose(mine[n]["score"], want[n]["score"],
                                   rtol=0, atol=2e-3, err_msg=n)
    assert sum(len(d["score"]) for d in mine.values()) > len(names)


@pytest.mark.parametrize("stage", ["sem", "ins"])
def test_infer_devices_ignored_under_mesh(tree, single, stage):
    """--infer_devices 2 beside --rw_mesh_model 2: one worker takes every
    image (one image occupies the whole mesh), the same files."""
    summary, got = _port(tree, stage, "mesh2_infer2", (
        "--infer_devices", "2", "--rw_mesh_model", "2"))
    assert len(summary["assigned"]) == 1
    assert got == single[stage][1]


def test_library_mesh_devices(tree, single):
    """make_sem_seg through the library: the mesh's devices from
    ``devices`` (as many as --rw_mesh_model); another count raises."""
    tmp, cfg, _ = tree
    out = str(tmp / "port_sem_lib")
    pcfg = PortConfig(
        voc12_root=cfg.voc12_root, infer_list=cfg.infer_list,
        cam_out_dir=cfg.cam_out_dir, irn_weights_name=cfg.irn_weights_name,
        rw_grid_cap=CAP, sem_seg_out_dir=out, rw_mesh_model=2)
    summary = stages_irn.make_sem_seg_labels(pcfg, "cpu",
                                             devices=["cpu", "cpu"])
    assert summary["assigned"] == [4]
    assert set(summary["modes"].values()) == {"mesh_diag"}
    assert _files(out) == single["sem"][1]
    with pytest.raises(ValueError, match="rw_mesh_model 2: 3 devices"):
        stages_irn.make_sem_seg_labels(
            dataclasses.replace(pcfg, overwrite=True), "cpu",
            devices=["cpu"] * 3)


@pytest.mark.parametrize("stage", ["sem", "ins"])
def test_mesh_past_visible_cards_raises(tree, tmp_path, monkeypatch, stage):
    """--rw_mesh_model 2 on CUDA with one visible card raises (the JAX
    mesh could not place it either)."""
    _, cfg, _ = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="rw_mesh_model 2: 1 CUDA device"):
        port_run.main(_argv(cfg, str(tmp_path / "out"), stage, (
            "--rw_mesh_model", "2", "--device", "cuda")))
