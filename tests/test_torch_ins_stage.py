"""make_ins_seg, eval_ins_seg and make_cocoann end to end: the JAX stages
vs the port's CLI (``--device cpu``) on one synthetic tree (4 images of
96-128 px, ``rw_grid_cap`` 32), JAX-format IRN checkpoints (seeded JAX
init) and the same GT cams.

Two checkpoints differ only in the displacement head's scale. At x3 the
random field is one basin per image; at x10 it has 3-7 basins, whose
random (not contracting, as a trained field's are) trajectories amplify
a 1-ulp change of dp over the 300 steps. The JAX stage runs its CPU
routes (the dense walk; two images per forward, which writes the dicts of
its per-image flow). The port runs K11, K12 and the K0 stencil through
their twins.

- x3, the stage gate: per image the same instances and classes, every mask
  >= 99.9% equal (here all pixels), scores within 2e-3.
- x10: the port's per-image tail on the JAX forward's own (edge, dp) writes
  the JAX stage's masks and classes exactly, scores within 2e-3, so what
  the port's own forward changes (its f32 rounding against XLA's) is the
  forward's alone; every flow of the port (host clustering, host split,
  the host redo of an overflowing cluster cap, the chunked walk) writes the
  default flow's dicts exactly; the port's AP and rle COCO json equal the
  JAX stages' on the same npy files.
- Two images per forward (``--edge_infer_batch 2``) meet the stage gate
  against one per forward at x3: a convolution's rounding may change with
  the batch (the library picks its algorithm per shape and thread count),
  which the x10 field would amplify."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from irn_tpu.data import synthetic
from irn_tpu.models.irn import IRNet as JaxIRNet
from irn_tpu.pipeline import stages_eval as jax_eval
from irn_tpu.pipeline.config import Config
from irn_tpu.pipeline.stages_irn import (
    EdgeDisplacementRunner as JaxEdgeRunner,
    make_ins_seg_labels as jax_make_ins_seg,
)
from irn_tpu.utils import checkpoint as jax_ckpt
from irn_tpu_torch.data.synthetic import write_gt_cams
from irn_tpu_torch.ops import _build
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline import stages_irn
from irn_tpu_torch.pipeline.config import Config as PortConfig

torch.set_num_threads(2)

CAP = 32
FLOWS = {
    "host_cluster": ("--no-ins_device_ccl",),
    "host_split": ("--ins_comp_cap", "0"),
    "overflow_redo": ("--ins_cluster_cap", "1"),
    "chunked": ("--ins_seed_cap", "8"),
}


def _checkpoint(path, variables, scale):
    v = jax.tree.map(lambda x: x, variables)
    v["params"]["fc_dp7b"]["kernel"] = variables["params"]["fc_dp7b"][
        "kernel"] * scale
    jax_ckpt.save_checkpoint(path, v)
    return v


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tree and, per head scale, (JAX config, variables) after the JAX
    make_ins_seg (edge_infer_batch 4: one forward compile)."""
    tmp = tmp_path_factory.mktemp("ins")
    root = str(tmp / "voc")
    train, _ = synthetic.generate(root, n_images=4, size=96,
                                  max_side_jitter=32, seed=5)
    names = [f"2007_{i:06d}" for i in range(4)]
    with open(train, "w") as f:
        f.write("\n".join(names) + "\n")
    write_gt_cams(root, names, str(tmp / "cam"))
    init = jax.tree.map(np.asarray, JaxIRNet().init(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32)))
    runs = {}
    for scale in (3, 10):
        weights = str(tmp / f"irn_x{scale}.ckpt")
        variables = _checkpoint(weights, init, scale)
        cfg = Config(
            voc12_root=root, train_list=train, infer_list=train,
            cam_out_dir=str(tmp / "cam"), irn_weights_name=weights,
            rw_grid_cap=CAP, session_dir=str(tmp / "sess"),
            log_name=str(tmp / "log"), edge_infer_batch=4,
            ins_seg_out_dir=str(tmp / f"jax_x{scale}"),
            coco_ann_path=str(tmp / f"jax_x{scale}.json"),
            coco_seg_format="rle",
        ).resolve()
        jax_make_ins_seg(cfg)
        runs[scale] = (cfg, variables)
    return tmp, names, runs


def _argv(cfg, out_dir, extra=(), passes=("--make_ins_seg_pass",)):
    return [
        "--voc12_root", cfg.voc12_root, "--infer_list", cfg.infer_list,
        "--train_list", cfg.train_list, "--cam_out_dir", cfg.cam_out_dir,
        "--irn_weights_name", cfg.irn_weights_name,
        "--rw_grid_cap", str(CAP), "--session_dir", cfg.session_dir,
        "--log_name", cfg.log_name, "--ins_seg_out_dir", out_dir,
        "--coco_ann_path", os.path.join(out_dir, "coco.json"),
        "--coco_seg_format", "rle", *passes, "--device", "cpu", *extra,
    ]


def _read(d, names):
    return {n: np.load(os.path.join(d, n + ".npy"), allow_pickle=True).item()
            for n in names}


def _port_default(tree, scale):
    tmp, names, runs = tree
    cfg = runs[scale][0]
    out = str(tmp / f"port_x{scale}")
    _build.reset_launches()
    res = port_run.main(_argv(cfg, out, passes=(
        "--make_ins_seg_pass", "--eval_ins_seg_pass", "--make_cocoann_pass")))
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    return out, res, _read(out, names)


@pytest.fixture(scope="module")
def port_x3(tree):
    return _port_default(tree, 3)


@pytest.fixture(scope="module")
def port_x10(tree):
    return _port_default(tree, 10)


def _assert_dicts_equal(got, want, what):
    assert sorted(got) == sorted(want) == ["class", "mask", "score", "size"]
    assert got["size"] == want["size"], what
    for k in ("score", "mask", "class"):
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _assert_at_gate(got, want, what):
    """The stage gate: same instances and classes, masks >= 99.9% equal
    (in practice all pixels), scores within 2e-3."""
    assert got["size"] == want["size"], what
    assert got["mask"].shape == want["mask"].shape, what
    assert got["mask"].dtype == bool and got["score"].dtype == np.float32
    assert got["class"].dtype == np.int32, what
    np.testing.assert_array_equal(got["class"], want["class"], err_msg=what)
    for m, (a, b) in enumerate(zip(got["mask"], want["mask"])):
        assert np.mean(a == b) >= 0.999, (what, m, np.mean(a == b))
    np.testing.assert_allclose(got["score"], want["score"], rtol=0,
                               atol=2e-3, err_msg=what)


def test_default_flow_matches_jax(tree, port_x3):
    _, names, runs = tree
    _, res, got = port_x3
    want = _read(runs[3][0].ins_seg_out_dir, names)
    for n in names:
        _assert_at_gate(got[n], want[n], n)
    summary = res["make_ins_seg_labels"]
    assert summary["n_images"] == len(names)
    assert summary["device_ccl"] == summary["device_split"] == len(names)
    assert summary["redo"] == summary["chunked"] == 0
    assert set(summary["modes"].values()) == {"diag"}
    assert sum(len(d["score"]) for d in got.values()) > len(names)


def test_eval_and_coco_match_jax(tree, port_x10):
    """The JAX eval_ins_seg and make_cocoann on the port's npy files: the
    same AP and the same rle json."""
    cfg = tree[2][10][0]
    out, res, _ = port_x10
    jcfg = dataclasses.replace(cfg, ins_seg_out_dir=out,
                               coco_ann_path=os.path.join(out, "jax.json"))
    want_ap = jax_eval.eval_ins_seg(jcfg)
    got_ap = res["eval_ins_seg"]
    np.testing.assert_array_equal(got_ap["ap"], want_ap["ap"])
    assert got_ap["map"] == want_ap["map"] or (
        np.isnan(got_ap["map"]) and np.isnan(want_ap["map"]))
    jax_eval.make_cocoann(jcfg)
    with open(os.path.join(out, "coco.json")) as f:
        got = json.load(f)
    with open(jcfg.coco_ann_path) as f:
        want = json.load(f)
    assert got == want
    assert got["annotations"] and got == res["make_cocoann"]


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_port_flows_write_the_default_dicts(tree, port_x10, flow):
    tmp, names, runs = tree
    cfg = runs[10][0]
    _, _, want = port_x10
    out = str(tmp / f"port_{flow}")
    summary = port_run.main(_argv(cfg, out, FLOWS[flow]))[
        "make_ins_seg_labels"]
    got = _read(out, names)
    for n in names:
        _assert_dicts_equal(got[n], want[n], f"{flow} {n}")
    assert summary["n_images"] == len(names)
    if flow == "host_cluster":
        assert summary["host_cluster"] == len(names)
        assert summary["device_ccl"] == 0
    if flow == "host_split":
        assert summary["host_split"] == len(names)
        assert summary["device_split"] == 0
    if flow == "overflow_redo":
        assert summary["redo"] >= 1
        assert summary["host_split"] == summary["redo"]
    if flow == "chunked":
        assert summary["chunked"] >= 1


def test_edge_infer_batch_2(tree, port_x3):
    """The forward over two images at once: per image the default flow's
    instances and classes, masks >= 99.9% equal, scores within 2e-3."""
    tmp, names, runs = tree
    _, _, want = port_x3
    out = str(tmp / "port_batch2")
    summary = port_run.main(_argv(runs[3][0], out, (
        "--edge_infer_batch", "2")))["make_ins_seg_labels"]
    got = _read(out, names)
    assert summary["n_images"] == len(names)
    for n in names:
        _assert_at_gate(got[n], want[n], f"batch2 {n}")


def test_tail_on_jax_forward_matches_jax(tree):
    """The port's per-image tail (K11, K12, seeds, walk, split, save) on the
    JAX forward's own (edge, dp) at x10: the JAX stage's masks and classes
    exactly, scores within 2e-3 (the walk routes differ: dense on the JAX
    side's CPU, the stencil here)."""
    from irn_tpu_torch.data import voc12

    tmp, names, runs = tree
    cfg, variables = runs[10]
    jrunner = JaxEdgeRunner(cfg, variables)
    pcfg = PortConfig(cam_out_dir=cfg.cam_out_dir, rw_grid_cap=CAP)
    walker = stages_irn.RandomWalkRunner(pcfg, pcfg.ins_seed_cap,
                                         torch.device("cpu"))
    tail = stages_irn.InstanceTail(pcfg, walker)
    ds = voc12.ImageDataset(cfg.infer_list, cfg.voc12_root, img_normal=False)
    want = _read(cfg.ins_seg_out_dir, names)
    assert max(len(want[n]["score"]) for n in names) >= 4
    os.makedirs(tmp / "tail", exist_ok=True)
    for i, n in enumerate(names):
        img = ds[i]["img"]
        edge, dp, (h4, w4) = jrunner(img, img.shape[:2])
        rec = tail.run(n, img.shape[:2], torch.from_numpy(np.array(edge)),
                       torch.from_numpy(np.array(dp)), int(h4), int(w4))
        got = tail.finish(rec, str(tmp / "tail" / (n + ".npy")))
        assert got["mask"].shape == want[n]["mask"].shape, n
        np.testing.assert_array_equal(got["mask"], want[n]["mask"], err_msg=n)
        np.testing.assert_array_equal(got["class"], want[n]["class"],
                                      err_msg=n)
        np.testing.assert_allclose(got["score"], want[n]["score"], rtol=0,
                                   atol=2e-3, err_msg=n)


def test_infer_devices_raises(tree, tmp_path, monkeypatch):
    """--infer_devices past the visible cards raises instead of running on
    fewer (the fan-out itself runs since it was ported: two CPU workers in
    tests/test_torch_multiprocess.py)."""
    cfg = tree[2][3][0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="infer_devices 2: 1 CUDA device"):
        port_run.main(_argv(cfg, str(tmp_path / "out"),
                            ("--infer_devices", "2", "--device", "cuda")))
