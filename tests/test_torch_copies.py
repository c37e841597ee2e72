"""The port's own copies of the JAX package's framework-free code, held to
their originals on the same inputs: ``Config`` and its CLI parser, the path
set, the weight converter, the semseg scores and the ImageNet constants.
The port imports none of the originals (tests/test_torch_imports.py); this
file imports both sides."""

import dataclasses

import numpy as np
import pytest
import torch

from irn_tpu.data import transforms as jax_transforms
from irn_tpu.eval import semseg as jax_semseg
from irn_tpu.ops import paths as jax_paths
from irn_tpu.pipeline import run as jax_run
from irn_tpu.pipeline.config import Config as JaxConfig
from irn_tpu.utils import weights as jax_weights
from irn_tpu_torch.models.irn import IRNet
from irn_tpu_torch.ops import paths
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline import stages_eval, stages_irn
from irn_tpu_torch.pipeline.config import Config
from irn_tpu_torch.utils import weights


def test_config_fields_and_defaults():
    port = [(f.name, f.type, f.default) for f in dataclasses.fields(Config)]
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(JaxConfig)]
    assert port == ref


@pytest.mark.parametrize("kw", [
    {},
    {"train_list": "voc12/train.txt", "infer_list": "voc12/val.txt"},
    {"voc12_root": "VOC_ROOT", "val_list": "no/such/list.txt",
     "cls_labels_path": ""},
    {"voc12_root": "VOC_ROOT", "cls_labels_path": "given.npy", "beta": 8},
])
def test_config_resolve(kw, tmp_path):
    """The same resolve() on the same kwargs: the shipped voc12/ lists found
    from another working directory, a root with its own cls_labels.npy."""
    root = tmp_path / "voc"
    root.mkdir()
    (root / "cls_labels.npy").write_bytes(b"")
    kw = {k: (str(root) if v == "VOC_ROOT" else v) for k, v in kw.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        port = dataclasses.asdict(Config(**kw).resolve())
        ref = dataclasses.asdict(JaxConfig(**kw).resolve())
    assert port == ref


def test_parser_options_and_defaults():
    """The port's parser: the JAX parser's option strings, types, actions
    and defaults, plus --device."""
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                         type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    port, ref = table(port_run.build_parser()), table(jax_run.build_parser())
    assert port.pop("device") == (("--device",), "cuda", None, None,
                                  "_StoreAction")
    assert port == ref
    argv = ["--beta", "8", "--cam_scales", "1.0", "0.5", "--no-rw_banded",
            "--make_sem_seg_pass", "--device", "cpu"]
    cfg, device = port_run.parse(argv)
    assert device == "cpu"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_run.config_from_args(argv[:-2]))


@pytest.mark.parametrize("radius", [5, 10])
def test_build_path_set(radius):
    port, ref = paths.build_path_set(radius), jax_paths.build_path_set(radius)
    assert (port.radius, port.radius_floor, port.n_pairs,
            port.max_path_length) == (ref.radius, ref.radius_floor,
                                      ref.n_pairs, ref.max_path_length)
    for name in ("dst_offsets", "cells", "lengths"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(port.paths_by_length) == len(ref.paths_by_length)
    for a, b in zip(port.paths_by_length, ref.paths_by_length):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("with_mean_shift", [True, False])
def test_convert_irn_net(with_mean_shift):
    """A seeded random IRNet state dict through both converters: the same
    keys, shapes, dtypes and values."""
    g = np.random.default_rng(0)
    sd = {k: g.standard_normal(tuple(v.shape)).astype(np.float32)
          for k, v in IRNet().state_dict().items()}
    if not with_mean_shift:
        sd.pop("mean_shift.running_mean")
    port, ref = _flat(weights.convert_irn_net(sd)), _flat(
        jax_weights.convert_irn_net(sd))
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and np.array_equal(
            port[k], ref[k]), k
    # irn_to_jax goes through the port's copy and round-trips
    model = IRNet()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}
                          | ({} if with_mean_shift else {
                              "mean_shift.running_mean": torch.zeros(2)}))
    back = weights.irn_from_jax(weights.irn_to_jax(model.state_dict()))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_semseg_scores():
    """accumulate_confusion + scores_from_confusion over several images
    with void, negative and out-of-range labels, against
    irn_tpu.eval.semseg."""
    g = np.random.default_rng(1)
    port, ref = np.zeros((21, 21), np.int64), np.zeros((21, 21), np.int64)
    for _ in range(5):
        gt = g.integers(-1, 24, (17, 13))
        gt[g.random(gt.shape) < 0.1] = 255
        pred = g.integers(-1, 23, (17, 13))
        stages_eval.accumulate_confusion(port, pred, gt)
        jax_semseg.accumulate_confusion(ref, pred, gt)
    assert np.array_equal(port, ref)
    port[3] = 0  # a class with an empty union: nan iou
    a = stages_eval.scores_from_confusion(port)
    b = jax_semseg.scores_from_confusion(port)
    assert sorted(a) == sorted(b) and a["miou"] == b["miou"]
    for k in ("iou", "fp", "fn"):
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        stages_eval.accumulate_confusion(port, np.zeros(3), np.zeros(4))


def test_imagenet_constants():
    for port, ref in ((stages_irn.IMAGENET_MEAN, jax_transforms.IMAGENET_MEAN),
                      (stages_irn.IMAGENET_STD, jax_transforms.IMAGENET_STD)):
        assert port.dtype == ref.dtype and np.array_equal(port, ref)
