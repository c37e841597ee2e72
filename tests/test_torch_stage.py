"""The make_sem_seg slice end to end: the JAX stage vs the port's CLI on
one synthetic tree, one JAX-format IRN checkpoint (seeded JAX init) and the
same cam files (CPU).

On the CPU the JAX stage takes its dense route (its banded kernels are
TPU-only), while the port takes its hand-kernel routes through the plain
twins: the stencil by default, the banded squaring and packed chain at
``--rw_square_times 1``, and at ``--rw_square_times 8`` (pure squaring, the
reference's evaluation order) the dense route on both sides, the port's
through the fused first squaring and the dense squarings. All compute
x @ T^256 in f32, so the label PNGs agree to >= 99% per image (in practice
all pixels)."""

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
from irn_tpu.pipeline.stages_eval import eval_sem_seg as jax_eval_sem_seg
from irn_tpu.pipeline.stages_irn import (
    EdgeDisplacementRunner as JaxEdgeRunner,
    make_sem_seg_labels as jax_make_sem_seg,
)
from irn_tpu.utils import checkpoint as jax_ckpt
from irn_tpu_torch.data.synthetic import write_gt_cams
from irn_tpu_torch.models.irn import IRNet
from irn_tpu_torch.ops import _build
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline import stages_irn
from irn_tpu_torch.utils.weights import irn_from_jax

torch.set_num_threads(2)

CAP = 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    root = str(tmp / "voc")
    train, _ = synthetic.generate(root, n_images=4, size=96,
                                  max_side_jitter=32, seed=5)
    with open(train, "w") as f:  # all four images
        f.write("\n".join(f"2007_{i:06d}" for i in range(4)) + "\n")
    names = [f"2007_{i:06d}" for i in range(4)]
    write_gt_cams(root, names, str(tmp / "cam"))
    variables = jax.tree.map(np.asarray, JaxIRNet().init(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32)))
    weights = str(tmp / "irn.ckpt")
    jax_ckpt.save_checkpoint(weights, variables)
    cfg = Config(
        voc12_root=root, train_list=train, infer_list=train,
        cam_out_dir=str(tmp / "cam"), irn_weights_name=weights,
        rw_grid_cap=CAP, session_dir=str(tmp / "sess"),
        log_name=str(tmp / "log"),
    ).resolve()
    return tmp, cfg, names, variables


def _read(d, names):
    return {n: np.asarray(imageio.imread(os.path.join(d, n + ".png")))
            for n in names}


def _port_argv(cfg, out_dir, extra=()):
    return [
        "--voc12_root", cfg.voc12_root, "--infer_list", cfg.infer_list,
        "--train_list", cfg.train_list,
        "--cam_out_dir", cfg.cam_out_dir,
        "--irn_weights_name", cfg.irn_weights_name,
        "--rw_grid_cap", str(CAP), "--session_dir", cfg.session_dir,
        "--log_name", cfg.log_name, "--sem_seg_out_dir", out_dir,
        "--make_sem_seg_pass", "--eval_sem_seg_pass", "--device", "cpu",
        *extra,
    ]


@pytest.mark.parametrize("extra,mode", [
    ((), "diag"), (("--rw_square_times", "1"), "banded"),
    (("--rw_square_times", "8"), "dense"),
], ids=["default", "banded", "pure"])
def test_make_sem_seg_matches_jax(tree, extra, mode):
    tmp, cfg, names, _ = tree
    tag = mode
    jcfg = dataclasses.replace(
        cfg, sem_seg_out_dir=str(tmp / f"jax_{tag}"),
        rw_square_times=int(extra[1]) if extra else -1,
    )
    jax_make_sem_seg(jcfg)
    want = _read(jcfg.sem_seg_out_dir, names)

    _build.reset_launches()
    out = str(tmp / f"port_{tag}")
    res = port_run.main(_port_argv(cfg, out, extra))
    got = _read(out, names)
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES

    summary = res["make_sem_seg_labels"]
    assert summary["n_images"] == len(names)
    assert set(summary["modes"].values()) == {mode}
    assert 0.0 <= summary["edge_mean"] <= 1.0
    # the port's eval_sem_seg (Pillow reads) scores its PNGs as the JAX one
    want_scores = jax_eval_sem_seg(dataclasses.replace(cfg, sem_seg_out_dir=out))
    got_scores = res["eval_sem_seg"]
    np.testing.assert_array_equal(got_scores["iou"], want_scores["iou"])
    assert got_scores["miou"] == want_scores["miou"]
    for n in names:
        assert got[n].shape == want[n].shape, n
        agree = float(np.mean(got[n] == want[n]))
        assert agree >= 0.99, (n, agree)


def test_edge_runner_matches_jax(tree, rng):
    """prep (normalize, mask, roll-aligned flip) + forward + flip fusion
    against the JAX runner on one odd-sized image."""
    _, cfg, _, variables = tree
    img = rng.integers(0, 255, (90, 75, 3)).astype(np.uint8)
    jedge, jdp, jhw = JaxEdgeRunner(cfg, variables)(img, img.shape[:2])
    model = IRNet()
    model.load_state_dict(irn_from_jax(variables))
    runner = stages_irn.EdgeDisplacementRunner(cfg, model,
                                               torch.device("cpu"))
    (edge, dp, hw), = runner.batch([img], [img.shape[:2]])
    assert hw == tuple(jhw)
    np.testing.assert_allclose(edge.numpy(), np.asarray(jedge), atol=1e-5)
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), atol=1e-4)


def test_walk_modes():
    """The routes the port takes per bucket: the stencil by default, the
    banded kernels at e = 1 where the band fits, dense otherwise."""
    dev = torch.device("cpu")
    cfg = Config()
    walker = stages_irn.RandomWalkRunner(cfg, 20, dev)
    assert walker.resolve_mode(96, 128) == "diag"
    assert walker.resolve_mode(128, 128) == "diag"
    pinned = stages_irn.RandomWalkRunner(
        dataclasses.replace(cfg, rw_square_times=1), 20, dev)
    assert pinned.resolve_mode(96, 128) == "banded"
    assert pinned.resolve_mode(32, 32) == "banded"
    assert stages_irn.RandomWalkRunner(
        dataclasses.replace(cfg, rw_square_times=4), 20, dev
    ).resolve_mode(32, 32) == "dense"
    assert stages_irn.RandomWalkRunner(
        dataclasses.replace(cfg, rw_banded=False), 20, dev
    ).resolve_mode(96, 128) == "dense"
    # the pure-squaring routes: 8 squarings outgrow the band (dense: K6 +
    # K5), 3 of exp_times 3 keep it (banded: K2, then K4 once)
    pure = stages_irn.RandomWalkRunner(
        dataclasses.replace(cfg, rw_square_times=8), 20, dev)
    e3 = stages_irn.RandomWalkRunner(
        dataclasses.replace(cfg, exp_times=3, rw_square_times=3), 20, dev)
    e3_diag = stages_irn.RandomWalkRunner(
        dataclasses.replace(cfg, exp_times=3), 20, dev)
    for bucket in ((96, 128), (128, 128)):
        assert pure.resolve_mode(*bucket) == "dense"
        assert e3.resolve_mode(*bucket) == "banded"
        assert e3_diag.resolve_mode(*bucket) == "diag"
    assert [walker._row_bucket(k) for k in (1, 8, 9, 17, 20)] == [
        8, 8, 16, 20, 20]


# --mesh_data and --infer_devices were cases here until they were ported
# (tests/test_torch_parallel.py, test_torch_dp_train.py and
# test_torch_multiprocess.py run them), and --rw_mesh_model
# (tests/test_torch_rw_sharded.py and test_torch_mesh_stage.py); the
# flags still unported stay, on make_sem_seg and make_ins_seg.
# --rw_matmul_dtype bfloat16 runs every route but the banded chain of more
# than one application (tests/test_torch_walk_bf16.py): at
# --rw_square_times 1 every bucket of the grid cap takes that chain, so the
# stage refuses it before anything runs
@pytest.mark.parametrize("flags", [
    ("--rw_square_times", "1", "--rw_matmul_dtype", "bfloat16"),
    ("--sem_monolith",),
    ("--make_ins_seg_pass", "--rw_square_times", "1", "--rw_matmul_dtype",
     "bfloat16"),
    ("--make_ins_seg_pass", "--sem_monolith"),
])
def test_unported_flags_raise(tree, tmp_path, flags):
    _, cfg, _, _ = tree
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_run.main(_port_argv(cfg, str(tmp_path / "out"), flags))


@pytest.mark.parametrize("call", ["batch", "bj"])
def test_unported_bf16_chains_raise(call, monkeypatch):
    """The library's bf16 chains without a bf16 mode raise, naming ROADMAP,
    before any squaring: the batched chain (K1 per image, then K8) and the
    rectangular-tile chain (``bj``, K7) at 0 < e < E."""
    from irn_tpu_torch.ops import matpow_kernels as mk
    from irn_tpu_torch.ops import random_walk as rw

    def refuse(*args, **kw):
        raise AssertionError("a squaring ran before the refusal")

    monkeypatch.setattr(mk, "square_banded", refuse)
    geom = rw.build_geometry(CAP, CAP, radius=5)
    g = np.random.default_rng(0)
    edge = torch.from_numpy(g.random((CAP, CAP), dtype=np.float32))
    cam = torch.from_numpy(g.random((3, CAP, CAP), dtype=np.float32))
    assert rw.banded_fits(geom, 8, 1) and rw.banded_fits(geom, 8, 1, bs=256)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if call == "batch":
            rw.propagate_banded_batch(geom, cam[None], edge[None], 10, 8,
                                      square_times=1,
                                      matmul_dtype=torch.bfloat16)
        else:  # 512-wide tiles over bs 256: the band stays under the matrix
            rw.propagate_banded(geom, cam, edge, 10, 8, square_times=1,
                                bs=256, bj=512, matmul_dtype=torch.bfloat16)


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stages_irn.resolve_device("cuda")


def test_synthetic_tree_matches_jax(tmp_path):
    """The port's tree generator draws the JAX generator's arrays, and its
    Pillow I/O decodes the pixels imageio decodes from the JAX tree."""
    from irn_tpu_torch.data import image_io
    from irn_tpu_torch.data import synthetic as port_synthetic

    synthetic.generate(str(tmp_path / "jax"), n_images=2, size=40, seed=3)
    port_synthetic.generate(str(tmp_path / "port"), n_images=2, size=40,
                            seed=3)
    for sub, ext in (("JPEGImages", ".jpg"), ("SegmentationClass", ".png"),
                     ("SegmentationObject", ".png")):
        for i in range(2):
            name = f"2007_{i:06d}{ext}"
            want = np.asarray(imageio.imread(tmp_path / "jax" / sub / name))
            got = image_io.imread(str(tmp_path / "port" / sub / name))
            np.testing.assert_array_equal(got, want, err_msg=name)
