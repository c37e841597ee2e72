"""CAMNet's training pieces, the port against the JAX package (CPU) on the
same variables (through ``cam_from_jax``), crop 64, batch 2, the full-width
ResNet-50: the training forward's logits, the frozen-BN calibration, the
multilabel soft-margin loss, the LR multipliers of every parameter under
both ``cam_stop_grad`` settings and the gradient stop at c3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from irn_tpu.models.cam import CAMNet as JaxCAMNet
from irn_tpu.models.cam import multilabel_soft_margin_loss as jax_loss
from irn_tpu.train import optim as jax_optim
from irn_tpu_torch.models.cam import CAMNet, multilabel_soft_margin_loss
from irn_tpu_torch.models.resnet import FEATURE_NAMES
from irn_tpu_torch.train import optim
from irn_tpu_torch.utils import weights
from irn_tpu_torch.utils.weights import cam_from_jax, cam_to_jax

torch.set_num_threads(2)

CROP, BATCH = 64, 2


@pytest.fixture(scope="module")
def variables():
    """JAX CAMNet's init variables, then calibrated on one batch (as the
    stage does without a pretrained backbone), numpy; and that batch."""
    model = JaxCAMNet()
    init = jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, CROP, CROP, 3), jnp.float32))
    x = np.random.default_rng(0).standard_normal(
        (BATCH, CROP, CROP, 3)).astype(np.float32)
    _, mutated = jax.jit(lambda v, x: model.apply(
        v, x, method=model.calibrate_stats, mutable=["stats"]))(init, x)
    init = jax.tree.map(np.asarray, init)
    calibrated = {"params": init["params"],
                  "stats": jax.tree.map(np.asarray, mutated["stats"])}
    return init, calibrated, x


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture
def exact_weights(monkeypatch):
    """cam_from_jax at the JAX values' own width (its converter casts to
    f32)."""
    monkeypatch.setattr(weights, "_t", lambda a: torch.from_numpy(
        np.array(a, dtype=np.asarray(a).dtype, copy=True)))


# f64 (JAX x64): the logits within 1e-9 relative to their largest magnitude,
# the proof of the same math. f32: oneDNN's and XLA's convolutions round
# apart over the 53 layers, 1.9e-5 of the largest logit (measured): the gate
# is test_torch_cam.py's logits gate, 1e-4 of max(1, |logit|).
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_train_forward_matches_jax(variables, exact_weights, dtype):
    """The logits of the training forward (both stop settings) and of the
    inference forward against JAX's: the stop changes no value."""
    _, calibrated, _ = variables
    x = np.random.default_rng(1).standard_normal(
        (BATCH, CROP, CROP, 3)).astype(dtype)
    var = jax.tree.map(lambda a: np.asarray(a, dtype), calibrated)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(JaxCAMNet(dtype=jnp.dtype(dtype)).apply(
            var, x, train=True))
    scale = max(1.0, float(np.abs(want).max()))
    tol = 1e-9 if dtype == "float64" else 1e-4
    for stop in ("c3", None):
        model = CAMNet(stop_grad_at=stop).to(getattr(torch, dtype))
        model.load_state_dict(weights.cam_from_jax(var))
        for train in (True, False):
            got = model(_nchw(x), train=train).detach().numpy()
            assert got.shape == (BATCH, 20) and got.dtype == want.dtype
            err = float(np.abs(got - want).max()) / scale
            assert err <= tol, (stop, train, err)


def test_frozen_bn_calibrate_matches_jax():
    """One batch norm in calibrate mode on the same input (channels with
    large means): the written mean and population variance within 1e-6 of
    JAX's, relative, and the output normalized with them within 1e-5."""
    from irn_tpu.models.resnet import FrozenBatchNorm
    from irn_tpu_torch.models.resnet import FrozenBatchNorm2d

    g = np.random.default_rng(4)
    c = 8
    x = (g.standard_normal((4, 16, 16, c)) * g.uniform(0.1, 3, c)
         + g.uniform(-5, 5, c)).astype(np.float32)
    scale = g.uniform(0.5, 2, c).astype(np.float32)
    bias = g.standard_normal(c).astype(np.float32)
    want, mutated = FrozenBatchNorm(c).apply(
        {"params": {"scale": scale, "bias": bias},
         "stats": {"mean": np.zeros(c, np.float32),
                   "var": np.ones(c, np.float32)}},
        x, calibrate=True, mutable=["stats"])
    bn = FrozenBatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        got = bn(_nchw(x), calibrate=True).permute(0, 2, 3, 1).numpy()
        again = bn(_nchw(x)).permute(0, 2, 3, 1).numpy()
    for buf, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(buf.numpy(), mutated["stats"][key],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(again, got)


# The calibration forward renormalizes every layer by its own batch
# statistics, which amplifies rounding with depth: the port against itself
# with the input perturbed by 1e-7 drifts as far as the port against JAX
# (stem 3e-7 / 1e-6, layer2 2e-6 / 3e-6, layer4 6e-5 / 9e-5; the pooled
# features 5e-5 / 7e-5). So the stem and layers 1-2, where both frameworks
# agree within 1e-5, are held there; every tensor and the pooled
# features within 2e-4 (the worst measured against JAX, 8.7e-5, x2).
def test_calibrate_stats_matches_jax(variables):
    """calibrate_stats writes every batch norm's mean and population
    variance (the frozen layers' too), relative to each tensor's largest
    magnitude; every statistic moves off its initial value."""
    init, calibrated, x = variables
    model = CAMNet()
    model.load_state_dict(cam_from_jax(init))
    pooled = model.calibrate_stats(_nchw(x))
    jmodel = JaxCAMNet()
    want_pooled = np.asarray(jmodel.apply(
        calibrated, x, method=jmodel.calibrate_stats, mutable=["stats"])[0])
    err = float(np.abs(pooled.numpy() - want_pooled).max()
                / np.abs(want_pooled).max())
    assert err <= 2e-4, err
    got = dict(_leaves(cam_to_jax(model.state_dict())["stats"]))
    want = dict(_leaves(calibrated["stats"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        err = np.abs(got[path] - w).max() / max(np.abs(w).max(), 1e-30)
        early = path[1].startswith(("bn1", "layer1_", "layer2_"))
        assert err <= (1e-5 if early else 2e-4), (path, err)
    for path, w in dict(_leaves(init["stats"])).items():
        assert not np.array_equal(got[path], w), path


def test_loss_matches_jax_and_torch():
    g = np.random.default_rng(2)
    logits = (4 * g.standard_normal((16, 20))).astype(np.float32)
    targets = (g.random((16, 20)) < 0.3).astype(np.float32)
    got = float(multilabel_soft_margin_loss(torch.from_numpy(logits),
                                            torch.from_numpy(targets)))
    want = float(jax_loss(jnp.asarray(logits), jnp.asarray(targets)))
    lib = float(F.multilabel_soft_margin_loss(torch.from_numpy(logits),
                                              torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
    assert got == pytest.approx(lib, rel=1e-6, abs=1e-6)


def jax_paths(model: CAMNet) -> dict:
    """Each parameter's name -> its path in the JAX params tree, through
    cam_to_jax (each parameter filled with its own index)."""
    sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters()]
    for i, n in enumerate(names):
        sd[n] = torch.full_like(sd[n], float(i + 1))
    by_value = {}
    for path, leaf in _leaves(cam_to_jax(sd)["params"]):
        assert np.all(leaf == leaf.flat[0]), path
        by_value[int(leaf.flat[0])] = path
    return {n: by_value[i + 1] for i, n in enumerate(names)}


@pytest.mark.parametrize("stop", ["c3", ""])
def test_lr_mults_match_jax(stop):
    """For every parameter, the port's multiplier on its name equals JAX's
    on its JAX path; "c3" freezes exactly the stem and layers 1-2."""
    port_fn = optim.cam_lr_mult if stop else optim.cam_lr_mult_full
    jax_fn = jax_optim.cam_lr_mult if stop else jax_optim.cam_lr_mult_full
    model = CAMNet()
    paths = jax_paths(model)
    assert len(paths) == len(set(paths.values())) == 160
    mults = {}
    for name, _ in model.named_parameters():
        mults[name] = port_fn(tuple(name.split(".")))
        assert mults[name] == jax_fn(paths[name]), (name, paths[name])
    frozen = {n for n, m in mults.items() if m == 0}
    if stop:
        assert frozen == {n for n in mults if n.startswith(
            ("resnet50.conv1.", "resnet50.bn1.", "resnet50.layer1.",
             "resnet50.layer2."))}
    else:
        assert not frozen
    assert {n for n, m in mults.items() if m == 10} == {"classifier.weight"}


@pytest.mark.parametrize("stop", ["c3", None])
def test_stop_grad_blocks_gradients(variables, stop):
    """Under "c3" no gradient reaches the stem or layers 1-2 (their
    forward keeps no autograd graph); layers 3-4 and the head get one.
    With no stop every parameter does."""
    _, calibrated, x = variables
    model = CAMNet(stop_grad_at=stop)
    model.load_state_dict(cam_from_jax(calibrated))
    feats = model.resnet50(_nchw(x), stop_grad_after=stop)
    cut = FEATURE_NAMES.index(stop) if stop else -1
    for i, name in enumerate(FEATURE_NAMES):
        assert feats[name].requires_grad == (i > cut), name
    targets = torch.from_numpy(
        (np.random.default_rng(3).random((BATCH, 20)) < 0.3).astype(
            np.float32))
    multilabel_soft_margin_loss(model(_nchw(x)), targets).backward()
    for name, p in model.named_parameters():
        blocked = stop is not None and name.split(".")[1] in (
            "conv1", "bn1", "layer1", "layer2")
        assert (p.grad is None) == blocked, name
        if not blocked:
            assert float(p.grad.abs().max()) > 0, name
    with pytest.raises(ValueError, match="unknown feature"):
        model.resnet50(_nchw(x), stop_grad_after="c6")
