"""train_irn and train_cam data-parallel on the CPU: the port over two
gloo ranks (DDP) against the JAX stages at ``mesh_data 2`` on the 8-device
virtual mesh of conftest.py, and against the port's own one-process run,
from JAX's initial variables (written as the port's ``.train`` state at
epoch 0, which every rank resumes from). One IRN run goes through the CLI
at ``--mesh_data 2`` (the stage spawns its two ranks); the others run the
stage functions on the ranks of one spawned group
(tests/torch_rank_workers.py), as each process of a multi-process run
does.

train_irn: a train list of 2 (one step an epoch, a row on each rank),
crop 64, batch 2, radius 4, lr 0.1.
- The losses of each step within 1e-3 of JAX's (tests/test_torch_train_
  steps.py's f32 gate); the heads' update within 1e-3 of JAX's after one
  step and 2e-2 after three (||port - JAX|| / ||JAX - init||); dp_mean
  within 1e-4; the backbone bit-equal to its initial values.
- Two ranks against one process: the heads' update within 1e-5, each
  step's losses within 1e-5 relative.
- Rank 0 alone wrote the checkpoints; two ranks resumed from the one-step
  ``.train`` are bit-equal to the straight run.

train_cam: a train list of 4 (two steps), a val list of 2, crop 64, batch
2, lr 1e-3, JAX's calibrated statistics in the starting state.
- The first loss within 1e-4 of JAX's, the trained tensors within 5e-2 of
  JAX's update (tests/test_torch_cam_train_steps.py's and
  tests/test_torch_cam_train_stage.py's gates), the frozen ones
  bit-equal; one validate loss, from rank 0; rank 0 alone wrote.
- Two ranks against one process in f32: the first loss within 1e-5, the
  trained tensors' update within the same 5e-2: two f32 steps of this
  model are ill-conditioned (tests/test_torch_cam_train_steps.py: a 1e-7
  change of the input moves the update by 2.5e-3 after one step and
  4.7e-2 after three), and the ranks' half batches round differently.

The data-parallel steps themselves, in f64 (tests/torch_rank_workers.
dp_steps: two steps of each model from a seeded init, CAMNet calibrated on
the whole first batch on every rank): two ranks within 1e-10 of one
process, losses and update, for both models."""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from irn_tpu.data import synthetic
from irn_tpu.models.cam import CAMNet as JaxCAMNet
from irn_tpu.models.irn import IRNet as JaxIRNet
from irn_tpu.pipeline import common as jax_common
from irn_tpu.pipeline import stages_cam as jax_stages_cam
from irn_tpu.pipeline import stages_irn as jax_stages_irn
from irn_tpu.pipeline.config import Config
from irn_tpu.utils import checkpoint as jax_ckpt
from irn_tpu_torch.models.cam import CAMNet
from irn_tpu_torch.models.irn import IRNet
from irn_tpu_torch.parallel import mesh
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.train import optim
from irn_tpu_torch.utils.checkpoint import save_checkpoint
from irn_tpu_torch.utils.weights import (cam_from_jax, cam_to_jax,
                                         irn_from_jax, irn_to_jax)

import torch_rank_workers as workers

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Every run of this module on 2 torch threads, each spawned rank too
    (``run_ranks`` hands a rank the parent's count): torch's intra-op
    threads and the native lattice's OpenMP threads are one setting of the
    process, so a test that ran the lattice earlier in this process may
    have left another count: at 8 threads per spawned rank the runs of
    tests/test_torch_dp_train.py passed their 120 s deadlines on a loaded
    host, and 8 threads moved its one-process f64 CAM forward by 2e-9."""
    torch.set_num_threads(2)


CROP = 64
FROZEN_CAM = ("conv1", "bn1", "layer1_", "layer2_")


_INITS = {}


def _jit_init(model, cfg, example, **kw):
    """The JAX stage's init (seed 0) through jit, once per model and shape
    (the stage and the test ask for the same variables)."""
    key = (type(model).__name__, example.shape)
    if key not in _INITS:
        _INITS[key] = jax.tree.map(np.asarray, jax.jit(model.init)(
            jax.random.PRNGKey(0), example))
    return jax.tree.map(np.array, _INITS[key])


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


class _Recorder:
    """A DeviceMeter that keeps every step's values (the JAX stages' meter,
    which only prints every 50th)."""

    steps = []

    def __init__(self):
        self._vals = {}

    def add(self, metrics):
        _Recorder.steps.append({k: float(v) for k, v in metrics.items()})
        for k, v in metrics.items():
            self._vals.setdefault(k, []).append(float(v))

    def pop(self, key):
        vals = self._vals.pop(key, [0.0])
        return sum(vals) / len(vals)


def _jax_stage(stage_mod, stage, cfg):
    """Run a JAX train stage from its seeded init; returns its per-step
    meter values and every ``.train`` tree it saved, in order."""
    saved = []
    save = stage_mod.ckpt.save_checkpoint

    def keep(path, tree):
        if path.endswith(".train"):
            saved.append(jax.tree.map(np.array, tree))
        save(path, tree)

    _Recorder.steps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "init_model_variables", _jit_init)
        mp.setattr(stage_mod, "DeviceMeter", _Recorder)
        mp.setattr(stage_mod.ckpt, "save_checkpoint", keep)
        stage(cfg)
    return list(_Recorder.steps), saved


def _start_state(path, model, from_jax, to_jax, variables, mult_fn):
    """The port's ``.train`` at epoch 0 holding ``variables``."""
    model.load_state_dict(from_jax(variables))
    opt = optim.poly_sgd(model.named_parameters(), 0.1, max_step=1,
                         momentum=1e-4, weight_decay=1e-4, mult_fn=mult_fn)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_checkpoint(path, optim.train_state(model, opt, 0, to_jax))


def _update_error(got, want, init, trained):
    """||got - want|| / ||want - init|| over the trained leaves."""
    num = den = 0.0
    for path, w in want.items():
        if not trained(path):
            continue
        w64 = w.astype(np.float64)
        num += float(np.sum((got[path] - w64) ** 2))
        den += float(np.sum((w64 - init[path]) ** 2))
    assert den > 0
    return (num / den) ** 0.5


# -- train_irn ----------------------------------------------------------------

def _irn_head(path):
    return path[0] == "params" and path[1] != "resnet50"


def _irn_argv(tmp, root, train, run, epochs, *extra):
    return ["--voc12_root", root, "--train_list", train,
            "--infer_list", train, "--ir_label_out_dir", str(tmp / "ir"),
            "--irn_crop_size", str(CROP), "--irn_batch_size", "2",
            "--irn_num_epoches", str(epochs), "--path_radius", "4",
            "--num_workers", "2",
            "--irn_weights_name", str(tmp / run / "irn.ckpt"),
            "--session_dir", str(tmp / "sess"), "--log_name",
            str(tmp / "log"), "--train_irn_pass", "--device", "cpu", *extra]


def _irn_tree(tmp):
    root = str(tmp / "voc")
    train, _ = synthetic.generate(root, n_images=2, size=96,
                                  max_side_jitter=32, seed=5)
    with open(train, "w") as f:
        f.write("2007_000000\n2007_000001\n")
    shutil.copytree(os.path.join(root, "SegmentationClass"), tmp / "ir")
    return root, train


def _cam_tree(tmp):
    root = str(tmp / "voc")
    names = [f"2007_{i:06d}" for i in range(6)]
    train, val = synthetic.generate(root, n_images=6, size=96,
                                    max_side_jitter=32, seed=7)
    with open(train, "w") as f:
        f.write("\n".join(names[:4]) + "\n")
    with open(val, "w") as f:
        f.write("\n".join(names[4:]) + "\n")
    return root, train, val


def _cam_argv(tmp, root, train, val, run, ranks):
    return ["--voc12_root", root, "--train_list", train, "--val_list", val,
            "--infer_list", train, "--cam_crop_size", str(CROP),
            "--cam_batch_size", "2", "--cam_num_epoches", "1",
            "--cam_learning_rate", "1e-3", "--num_workers", "2",
            "--cam_weights_name", str(tmp / run / "cam.ckpt"),
            "--session_dir", str(tmp / "sess"), "--log_name",
            str(tmp / "log"), "--train_cam_pass", "--device", "cpu",
            "--mesh_data", ranks]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX stages, then the port's runs: one spawned group of two ranks
    running the f64 steps, IRN's one-step run, its resume and CAM's run; the
    CLI's IRN run at --mesh_data 2; the one-process runs."""
    ti = tmp_path_factory.mktemp("dp_irn")
    iroot, itrain = _irn_tree(ti)
    icfg = Config(
        voc12_root=iroot, train_list=itrain, infer_list=itrain,
        ir_label_out_dir=str(ti / "ir"), irn_crop_size=CROP,
        irn_batch_size=2, irn_num_epoches=3, path_radius=4, num_workers=2,
        mesh_data=2, irn_weights_name=str(ti / "jax" / "irn.ckpt"),
        session_dir=str(ti / "sess"), log_name=str(ti / "log"),
    ).resolve()
    jax_irn = _jax_stage(jax_stages_irn, jax_stages_irn.train_irn, icfg)
    irn_init = _jit_init(JaxIRNet(), icfg, np.zeros((1, CROP, CROP, 3),
                                                    np.float32))
    for run in ("one_step", "two", "one"):
        _start_state(str(ti / run / "irn.ckpt.train"), IRNet(),
                     irn_from_jax, irn_to_jax, irn_init, optim.irn_lr_mult)

    tc = tmp_path_factory.mktemp("dp_cam")
    croot, ctrain, cval = _cam_tree(tc)
    ccfg = Config(
        voc12_root=croot, train_list=ctrain, val_list=cval,
        infer_list=ctrain, cam_crop_size=CROP, cam_batch_size=2,
        cam_num_epoches=1, cam_learning_rate=1e-3, num_workers=2,
        mesh_data=2, cam_weights_name=str(tc / "jax" / "cam.ckpt"),
        session_dir=str(tc / "sess"), log_name=str(tc / "log"),
    ).resolve()
    jax_cam = _jax_stage(jax_stages_cam, jax_stages_cam.train_cam, ccfg)
    cam_init = _jit_init(JaxCAMNet(), ccfg, np.zeros((1, CROP, CROP, 3),
                                                     np.float32))
    # JAX's calibrated statistics (frozen in training: the final file's)
    start = {"params": cam_init["params"], "stats": jax_ckpt.load_checkpoint(
        ccfg.cam_weights_name)["stats"]}
    for run in ("two", "one"):
        _start_state(str(tc / run / "cam.ckpt.train"), CAMNet(),
                     cam_from_jax, cam_to_jax, start, optim.cam_lr_mult)

    def irn_cfg(run, epochs):
        return port_run.parse(_irn_argv(ti, iroot, itrain, run, epochs))[0]

    os.makedirs(ti / "resumed")
    jobs = [("dp_steps", "cam"), ("dp_steps", "irn"),
            ("train_irn", irn_cfg("one_step", 1)),
            ("copy", str(ti / "one_step" / "irn.ckpt.train"),
             str(ti / "resumed" / "irn.ckpt.train")),
            ("train_irn", irn_cfg("resumed", 3)),
            ("train_cam", port_run.parse(_cam_argv(
                tc, croot, ctrain, cval, "two", "0"))[0])]
    group = mesh.run_ranks(workers.train_stage_jobs, (jobs,),
                           mesh.RankSpec(("cpu", "cpu"), timeout_s=120),
                           deadline_s=120)
    out = dict(f64_two=dict(cam=group[0][0], irn=group[0][1]),
               f64_one=dict(cam=workers.dp_steps("cam"),
                            irn=workers.dp_steps("irn")),
               one_step=group[0][2], resumed=group[0][4],
               resumed_rank1=group[1][4], cam_two=group[0][5],
               cam_two_rank1=group[1][5])
    spawn = mesh.run_ranks

    def bounded(fn, args, spec, deadline_s=None):
        """The stage's own spawn, each collective and the run within 120 s."""
        return spawn(fn, args, dataclasses.replace(spec, timeout_s=120),
                     deadline_s=120)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "run_ranks", bounded)
        for run, ranks in (("two", "2"), ("one", "1")):
            out[run] = port_run.main(_irn_argv(
                ti, iroot, itrain, run, 3, "--mesh_data",
                ranks))["train_irn"]
    out["cam_one"] = port_run.main(_cam_argv(
        tc, croot, ctrain, cval, "one", "1"))["train_cam"]
    return dict(irn=(ti, icfg, irn_init) + jax_irn,
                cam=(tc, ccfg, cam_init, jax_cam[0]), out=out)


def _ckpt(tmp, run, suffix=""):
    return dict(_leaves(jax_ckpt.load_checkpoint(
        str(tmp / run / "irn.ckpt") + suffix)))


def test_irn_two_ranks_match_jax(runs):
    tmp, cfg, init, jax_losses, jax_saved = runs["irn"]
    out = runs["out"]
    init_l = dict(_leaves(init))
    assert len(jax_saved) == 3 and len(jax_losses) == 3
    two = out["two"]
    assert (two["world"], two["n_steps"], two["max_step"]) == (2, 3, 3)
    for s, (got, want) in enumerate(zip(two["losses"], jax_losses)):
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-3), (s, k)
    for run, saved, gate in (("one_step", jax_saved[0], 1e-3),
                             ("two", jax_saved[2], 2e-2)):
        got = _ckpt(tmp, run, ".train")
        want = {p: v for p, v in _leaves({"params": saved["params"]})}
        err = _update_error(got, want, init_l, _irn_head)
        assert err <= gate, (run, err)
    got, want = _ckpt(tmp, "two"), dict(_leaves(jax_ckpt.load_checkpoint(
        cfg.irn_weights_name)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if path[1] == "resnet50":
            np.testing.assert_array_equal(got[path], init_l[path])
        elif path[1] == "dp_mean":
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-4)


def test_irn_two_ranks_match_one_process(runs):
    tmp, _, init, _, _ = runs["irn"]
    out = runs["out"]
    init_l = dict(_leaves(init))
    one, two = _ckpt(tmp, "one"), _ckpt(tmp, "two")
    assert _update_error(two, one, init_l, _irn_head) <= 1e-5
    assert out["one"]["world"] == 1
    for a, b in zip(out["two"]["losses"], out["one"]["losses"]):
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-5), k


def test_irn_rank_0_writes_and_resumes(runs):
    """Rank 0 wrote the per-epoch ``.train`` and the final checkpoint, rank
    1 nothing; two ranks resumed after the first step write the straight
    run's bits."""
    tmp = runs["irn"][0]
    out = runs["out"]
    w = str(tmp / "two" / "irn.ckpt")
    assert out["two"]["written_by_rank"] == [[w + ".train"] * 3 + [w], []]
    assert out["resumed_rank1"]["written"] == []
    assert out["resumed"]["start_epoch"] == 1
    assert out["resumed"]["n_steps"] == 2
    for suffix in (".train", ""):
        a, b = _ckpt(tmp, "resumed", suffix), _ckpt(tmp, "two", suffix)
        assert sorted(a) == sorted(b)
        for path in b:
            np.testing.assert_array_equal(a[path], b[path], str(path))


# -- train_cam ----------------------------------------------------------------

def _cam_trained(path):
    return path[0] == "params" and not (
        path[1] == "resnet50" and path[2].startswith(FROZEN_CAM))


def _cam_ckpt(tmp, run):
    return dict(_leaves(jax_ckpt.load_checkpoint(str(tmp / run /
                                                     "cam.ckpt"))))


def test_cam_two_ranks_match_jax(runs):
    tmp, cfg, init, jax_losses = runs["cam"]
    two = runs["out"]["cam_two"]
    init_l = dict(_leaves(init))
    assert (two["world"], two["n_steps"], two["max_step"]) == (2, 2, 2)
    assert len(jax_losses) == 2
    assert two["losses"][0] == pytest.approx(jax_losses[0]["loss1"],
                                             rel=1e-4)
    assert len(two["val_losses"]) == 1 and np.isfinite(two["val_losses"][0])
    got = _cam_ckpt(tmp, "two")
    want = dict(_leaves(jax_ckpt.load_checkpoint(cfg.cam_weights_name)))
    assert sorted(got) == sorted(want)
    assert _update_error(got, want, init_l, _cam_trained) <= 5e-2
    for path, w in want.items():
        if path[0] == "stats":
            np.testing.assert_array_equal(got[path], w, str(path))
        elif not _cam_trained(path):
            np.testing.assert_array_equal(got[path], init_l[path], str(path))
    w = str(tmp / "two" / "cam.ckpt")
    assert two["written"] == [w + ".train", w]
    assert runs["out"]["cam_two_rank1"]["written"] == []


def test_cam_two_ranks_match_one_process(runs):
    tmp, _, init, _ = runs["cam"]
    out = runs["out"]
    init_l = dict(_leaves(init))
    one, two = _cam_ckpt(tmp, "one"), _cam_ckpt(tmp, "two")
    assert _update_error(two, one, init_l, _cam_trained) <= 5e-2
    assert out["cam_two"]["losses"][0] == pytest.approx(
        out["cam_one"]["losses"][0], rel=1e-5)
    assert out["cam_one"]["world"] == 1


@pytest.mark.parametrize("kind", ["cam", "irn"])
def test_dp_steps_f64_two_ranks_match_one_process(runs, kind):
    """Two f64 DDP steps over two ranks: the one-process steps' losses
    within 1e-12 relative and their update within 1e-10 (||two - one|| /
    ||one - init|| over the trained tensors)."""
    two = runs["out"]["f64_two"][kind]
    one = runs["out"]["f64_one"][kind]
    assert two["losses"] == pytest.approx(one["losses"], rel=1e-12)
    from irn_tpu_torch.models.cam import CAMNet as PortCAM
    from irn_tpu_torch.models.irn import init_irnet
    model = PortCAM() if kind == "cam" else IRNet()
    init = init_irnet(model, torch.Generator().manual_seed(
        1 if kind == "cam" else 2)).double().state_dict()
    num = den = 0.0
    moved = 0
    for k, w in one["state"].items():
        if not np.array_equal(w, init[k].numpy()):
            moved += 1
            num += float(np.sum((two["state"][k] - w) ** 2))
            den += float(np.sum((w - init[k].numpy()) ** 2))
        else:
            np.testing.assert_array_equal(two["state"][k], w, k)
    assert moved and (num / den) ** 0.5 <= 1e-10, (num / den) ** 0.5
