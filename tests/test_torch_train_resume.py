"""train_irn's resume, the port alone on the CPU: a two-epoch run writes
the same bits as the same run stopped right after its first epoch's
``.train`` checkpoint and then resumed (the checkpoint carries the
weights, the SGD momentum buffers under the JAX param paths, the step and
the epoch; the loader continues the shuffle and augmentation stream of
the true epoch)."""

import os
import shutil

import numpy as np
import pytest
import torch

from irn_tpu_torch.data import synthetic
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline import stages_irn
from irn_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


class Stopped(Exception):
    pass


def test_resume_is_bit_equal(tmp_path, monkeypatch):
    root = str(tmp_path / "voc")
    train, _ = synthetic.generate(root, n_images=4, size=96,
                                  max_side_jitter=32, seed=6)
    with open(train, "w") as f:
        f.write("\n".join(f"2007_{i:06d}" for i in range(4)) + "\n")
    shutil.copytree(os.path.join(root, "SegmentationClass"),
                    tmp_path / "ir")

    def run(tag, epochs):
        weights = str(tmp_path / tag / "irn.ckpt")
        return weights, port_run.main([
            "--voc12_root", root, "--train_list", train,
            "--infer_list", train, "--ir_label_out_dir",
            str(tmp_path / "ir"), "--irn_crop_size", "64",
            "--irn_batch_size", "2", "--irn_num_epoches", str(epochs),
            "--path_radius", "4", "--num_workers", "2",
            "--irn_weights_name", weights,
            "--session_dir", str(tmp_path / "sess"),
            "--log_name", str(tmp_path / "log"),
            "--train_irn_pass", "--device", "cpu"])["train_irn"]

    whole, s_whole = run("whole", 2)
    save = stages_irn.save_checkpoint

    def save_then_stop(path, tree):
        save(path, tree)
        if path.endswith(".train"):
            raise Stopped(path)

    with monkeypatch.context() as mp:
        mp.setattr(stages_irn, "save_checkpoint", save_then_stop)
        with pytest.raises(Stopped):
            run("split", 2)
    split, s_resumed = run("split", 2)
    assert (s_whole["n_steps"], s_resumed["n_steps"]) == (4, 2)
    assert s_resumed["start_epoch"] == 1
    # the resumed run's losses are the whole run's second epoch, bit-equal
    assert s_resumed["losses"] == s_whole["losses"][2:]
    for suffix in ("", ".train"):
        a = dict(_leaves(load_checkpoint(whole + suffix)))
        b = dict(_leaves(load_checkpoint(split + suffix)))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    saved = load_checkpoint(whole + ".train")
    assert int(saved["step"]) == 4 and int(saved["epoch"]) == 2
    assert sorted(saved["momentum"]) == sorted(
        k for k in saved["params"] if k != "resnet50")
