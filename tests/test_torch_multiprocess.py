"""The make stages over several processes and several workers, on the CPU:
the port's CLI as one process and as two (``--dist_coordinator
127.0.0.1:<port> --dist_num_processes 2 --dist_process_id r --device cpu``,
gloo) over one synthetic tree with seeded random CAMNet and IRNet
checkpoints, through make_cam, eval_cam, cam_to_ir_label, make_ins_seg,
eval_ins_seg, make_sem_seg, eval_sem_seg and make_cocoann.

- Every output file of the two processes is byte-equal to the one-process
  run's, and each rank wrote its strided share.
- eval_cam, eval_ins_seg, eval_sem_seg and make_cocoann run once, on rank
  0, with the one-process run's results.
- The spreader over two CPU workers in one process writes the same files,
  each worker taking its share.
- A batch that the fixed process count does not split raises in both
  processes.

Each process runs under a 120 s timeout."""

import filecmp
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from irn_tpu_torch.data import synthetic
from irn_tpu_torch.models.cam import CAMNet
from irn_tpu_torch.models.irn import IRNet, init_irnet
from irn_tpu_torch.parallel import mesh
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline import stages_cam, stages_irn
from irn_tpu_torch.utils.checkpoint import save_checkpoint
from irn_tpu_torch.utils.weights import cam_to_jax, irn_to_jax

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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
N = 6
OUTS = ("cam", "ir", "ins", "sem")
EVALS = ("eval_cam", "eval_ins_seg", "eval_sem_seg", "make_cocoann")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multi")
    root = str(tmp / "voc")
    synthetic.generate(root, n_images=N, size=48, max_side_jitter=16, seed=3)
    names = [f"2007_{i:06d}" for i in range(N)]
    ids = str(tmp / "ids.txt")
    with open(ids, "w") as f:
        f.write("\n".join(names) + "\n")
    save_checkpoint(str(tmp / "cam.ckpt"), cam_to_jax(init_irnet(
        CAMNet(), torch.Generator().manual_seed(1)).state_dict()))
    save_checkpoint(str(tmp / "irn.ckpt"), irn_to_jax(init_irnet(
        IRNet(), torch.Generator().manual_seed(2)).state_dict()))
    return tmp, root, ids, names


def _argv(tree, out, *passes):
    tmp, root, ids, _ = tree
    os.makedirs(out, exist_ok=True)
    return ["--voc12_root", root, "--infer_list", ids, "--train_list", ids,
            "--cam_weights_name", str(tmp / "cam.ckpt"),
            "--irn_weights_name", str(tmp / "irn.ckpt"),
            "--cam_out_dir", f"{out}/cam", "--ir_label_out_dir", f"{out}/ir",
            "--sem_seg_out_dir", f"{out}/sem",
            "--ins_seg_out_dir", f"{out}/ins",
            "--coco_ann_path", f"{out}/coco.json",
            "--coco_seg_format", "rle", "--session_dir", f"{out}/sess",
            "--log_name", f"{out}/log", "--rw_grid_cap", "16",
            "--pad_multiple", "16", "--cam_scales", "1.0", "0.5",
            "--num_workers", "2", "--device", "cpu",
            *(passes or ("--make_cam_pass", "--eval_cam_pass",
                         "--cam_to_ir_label_pass", "--make_sem_seg_pass",
                         "--eval_sem_seg_pass", "--make_ins_seg_pass",
                         "--eval_ins_seg_pass", "--make_cocoann_pass"))]


def _cli(argvs):
    """Each argv as a process of the port's CLI, all at once; (return
    codes, stderr texts)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "irn_tpu_torch.pipeline.run", *a], env=env,
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for a in argvs]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=TIMEOUT_S)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], errs


def _dist(r, world=2, port=None):
    return ["--dist_coordinator", f"127.0.0.1:{port}",
            "--dist_num_processes", str(world), "--dist_process_id", str(r)]


@pytest.fixture(scope="module")
def runs(tree):
    """The one-process run's and the two processes' output folders."""
    tmp = tree[0]
    one, two = str(tmp / "one"), str(tmp / "two")
    rcs, errs = _cli([_argv(tree, one)])
    assert rcs == [0], errs[0][-3000:]
    port = mesh.free_port()
    rcs, errs = _cli([_argv(tree, two) + _dist(r, port=port)
                      for r in range(2)])
    assert rcs == [0, 0], "\n".join(e[-3000:] for e in errs)
    return one, two


def _same_files(a, b):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb and fa, (a, fa, fb)
    for f in fa:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), (a, f)
    return fa


@pytest.mark.parametrize("sub", OUTS)
def test_two_processes_write_the_one_process_files(runs, sub, tree):
    one, two = runs
    assert len(_same_files(f"{one}/{sub}", f"{two}/{sub}")) == N


def _log(path):
    with open(path) as f:
        return f.read()


def _done(text, stage):
    """The image indices a log's progress lines name for ``stage``."""
    return sorted(int(i) for i in re.findall(rf"^{stage} (\d+)/{N}$", text,
                                             re.M))


def test_each_rank_wrote_its_strided_share(runs):
    """Per-image stages: rank r wrote images r, r + 2, ...; make_cam: its
    strided share of the size chunks (here one image each), the two shares
    together every image once."""
    _, two = runs
    logs = [_log(f"{two}/log.log"), _log(f"{two}/log.p1.log")]
    for stage in ("cam_to_ir_label", "make_sem_seg", "make_ins_seg"):
        for r, text in enumerate(logs):
            assert _done(text, stage) == list(range(r, N, 2)), (stage, r)
    cams = [_done(text, "make_cam") for text in logs]
    assert sorted(cams[0] + cams[1]) == list(range(N))
    assert len(cams[0]) == len(cams[1]) == N // 2


def _eval_lines(text):
    """The eval and export stages' output lines, by stage."""
    out, stage = {}, None
    for line in text.splitlines():
        m = re.match(r"^step\.(\w+)( done in)?", line)
        if m:
            stage = None if m.group(2) else m.group(1)
        elif stage in EVALS:
            out.setdefault(stage, []).append(
                line.replace("/two/", "/one/"))
    return out


def test_eval_and_export_once_on_rank_0(runs):
    one, two = runs
    want = _eval_lines(_log(f"{one}/log.log"))
    assert sorted(want) == sorted(EVALS)
    assert _eval_lines(_log(f"{two}/log.log")) == want
    assert _eval_lines(_log(f"{two}/log.p1.log")) == {}
    assert filecmp.cmp(f"{one}/coco.json", f"{two}/coco.json",
                       shallow=False)


def test_spreader_over_two_cpu_workers(runs, tree):
    """make_cam, make_sem_seg and make_ins_seg with two CPU workers in one
    process: the one-process run's files; both workers took blocks."""
    one, _ = runs
    out = str(tree[0] / "spread")
    cfg, _ = port_run.parse(_argv(tree, out))
    workers = ["cpu", "cpu"]
    got = [stages_cam.make_cam(cfg, "cpu", devices=workers)]
    cfg.cam_out_dir = f"{one}/cam"
    for stage in (stages_irn.make_sem_seg_labels,
                  stages_irn.make_ins_seg_labels):
        got.append(stage(cfg, "cpu", devices=workers))
    for res in got:
        assert res["n_images"] == N and len(res["assigned"]) == 2
        assert min(res["assigned"]) > 0 and sum(res["assigned"]) <= N
    for sub in ("cam", "sem", "ins"):
        _same_files(f"{one}/{sub}", f"{out}/{sub}")


def test_batch_not_split_by_the_processes_raises(runs, tree):
    """train_irn's batch of 3 over two processes: both refuse it before
    training."""
    one, _ = runs
    out = str(tree[0] / "odd")
    port = mesh.free_port()
    rcs, errs = _cli([
        _argv(tree, out, "--train_irn_pass") + [
            "--ir_label_out_dir", f"{one}/ir", "--irn_batch_size", "3",
            "--irn_crop_size", "64", "--path_radius", "4"]
        + _dist(r, port=port) for r in range(2)])
    assert all(rc != 0 for rc in rcs), rcs
    for e in errs:
        assert "group has 2 processes" in e, e[-2000:]
    assert not os.path.exists(str(tree[0] / "irn.ckpt.train"))
    np.testing.assert_array_equal(rcs, [1, 1])
