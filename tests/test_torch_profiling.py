"""``--profile_dir``: the port's StageProfiler (torch.profiler over steps
[2, 5) into ``<profile_dir>/<stage>``, as ``irn_tpu.utils.profiling``'s
window) on the CPU, and train_irn writing its trace through the CLI.
train_cam's trace is checked in tests/test_torch_cam_train_stage.py."""

import json
import os
import shutil

import torch

from irn_tpu_torch.data import synthetic
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.utils.profiling import StageProfiler

torch.set_num_threads(2)


def _traces(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_stage_profiler_window(tmp_path):
    """Nothing before tick 2, a trace of the window's ops written when tick
    5 ends it, close() idempotent; no directory given, nothing at all."""
    out = tmp_path / "stage"
    prof = StageProfiler(str(tmp_path), "stage")
    for i in range(7):
        torch.ones(64).cumsum(0)
        prof.tick()
        if i < 2:
            assert not out.exists()
        elif i < 5:
            assert _traces(out) == []
        else:
            assert len(_traces(out)) == 1
    prof.close()
    prof.close()
    (name,) = _traces(out)
    assert name.endswith(".pt.trace.json")
    with open(out / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)

    early = StageProfiler(str(tmp_path), "early")
    for _ in range(3):
        early.tick()
    early.close()  # the loop ended inside the window: close writes it
    assert len(_traces(tmp_path / "early")) == 1
    off = StageProfiler("", "off")
    for _ in range(6):
        off.tick()
    off.close()
    assert off.dir is None


def test_train_irn_profile_dir(tmp_path):
    """train_irn through the CLI with --profile_dir over 4 steps: one trace
    under <profile_dir>/train_irn."""
    root = str(tmp_path / "voc")
    train, _ = synthetic.generate(root, n_images=4, size=96,
                                  max_side_jitter=32, seed=6)
    with open(train, "w") as f:
        f.write("\n".join(f"2007_{i:06d}" for i in range(4)) + "\n")
    shutil.copytree(os.path.join(root, "SegmentationClass"), tmp_path / "ir")
    prof = str(tmp_path / "prof")
    summary = port_run.main([
        "--voc12_root", root, "--train_list", train, "--infer_list", train,
        "--ir_label_out_dir", str(tmp_path / "ir"), "--irn_crop_size", "64",
        "--irn_batch_size", "2", "--irn_num_epoches", "2",
        "--path_radius", "4", "--num_workers", "2",
        "--irn_weights_name", str(tmp_path / "irn.ckpt"),
        "--session_dir", str(tmp_path / "sess"),
        "--log_name", str(tmp_path / "log"), "--profile_dir", prof,
        "--train_irn_pass", "--device", "cpu"])["train_irn"]
    assert summary["n_steps"] == 4
    traces = _traces(os.path.join(prof, "train_irn"))
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
