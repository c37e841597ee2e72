"""``--model_dtype bfloat16`` in the port's models, against the JAX package
in bf16 on the CPU: the backbone computes in bf16 over f32 parameters, the
heads and the classifier in f32.

- Per op, bit for bit: frozen batch norm on a bf16 input (scale and shift
  in f32, cast to bf16), ReLU + extent mask + max pool; one convolution
  with at most 0.1% of its outputs one bf16 ulp apart (XLA rounds an f32
  sum once, oneDNN's bf16 kernel sums in another order: 0.012% measured
  at a 3x3, 64 -> 32 conv).
- Whole models (JAX's variables carried across by ``irn_from_jax`` /
  ``cam_from_jax``): rounding flips grow over ResNet-50's layers into bf16
  noise, so the port is held to JAX's own bf16 error. Its relative
  Frobenius distance from JAX in f32 lies within [0.5, 1.25] x JAX bf16's
  (the lower end catches a silent f32 path; measured at 64 px: IRNet's
  edge 1.09x, dp 1.02x, CAMNet's logits 0.99x, maps 1.00x, calibrated
  statistics 0.94-1.05x), and the outputs are f32 where JAX's are.
- One train step each (IRNet at radius 5, CAMNet at c3) in bf16: the
  port's update lies within 1.25x of JAX bf16's distance from JAX's f32
  update (measured 1.07x, 1.02x); every parameter and gradient stays f32.
- ``float16`` is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from irn_tpu.models import resnet as jax_resnet
from irn_tpu.models.cam import CAMNet as JaxCAMNet
from irn_tpu.models.irn import IRNet as JaxIRNet
from irn_tpu.train import cam_train as jax_cam_train
from irn_tpu.train import irn_train as jax_irn_train
from irn_tpu.train import optim as jax_optim
from irn_tpu.train.state import create_train_state
from irn_tpu_torch.models import resnet
from irn_tpu_torch.models.cam import CAMNet
from irn_tpu_torch.models.irn import IRNet
from irn_tpu_torch.pipeline import common
from irn_tpu_torch.pipeline.config import Config
from irn_tpu_torch.train import cam_train, irn_train, optim
from irn_tpu_torch.utils import weights

torch.set_num_threads(2)

BF16 = torch.bfloat16
SIZE, BATCH = 64, 2
# the port's distance from JAX f32, as a multiple of JAX bf16's
LOW, HIGH = 0.5, 1.25


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16, as numpy f32 (exact)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _bits(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)


def _tbits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


# -- per op ------------------------------------------------------------------


def test_frozen_batch_norm_bit_equal():
    g = np.random.default_rng(0)
    c = 24
    x = _bf16(g.standard_normal((2, 5, 7, c)).astype(np.float32) * 3)
    scale = g.uniform(0.2, 2.0, c).astype(np.float32)
    bias = g.standard_normal(c).astype(np.float32)
    mean = g.standard_normal(c).astype(np.float32)
    var = g.uniform(0.1, 3.0, c).astype(np.float32)
    bn = jax_resnet.FrozenBatchNorm(c)
    want = bn.apply({"params": {"scale": scale, "bias": bias},
                     "stats": {"mean": mean, "var": var}},
                    jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    port = resnet.FrozenBatchNorm2d(c)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean), ("running_var", var)):
            getattr(port, name).copy_(torch.from_numpy(v))
        got = port(_nchw(x).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_array_equal(
        _tbits(got.permute(0, 2, 3, 1)), _bits(want))


def test_relu_mask_max_pool_bit_equal():
    """The stem's tail in bf16: ReLU, the extent mask, the 3x3 / 2 max
    pool."""
    x = _bf16(np.random.default_rng(1).standard_normal(
        (2, 12, 14, 8)).astype(np.float32))
    extent = (9, 11)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = fnn.max_pool(
        jax_resnet._extent_mask_nhwc(fnn.relu(xj), extent), (3, 3),
        strides=(2, 2), padding=[(1, 1), (1, 1)])
    xt = _nchw(x).to(BF16)
    got = F.max_pool2d(resnet._extent_mask(F.relu(xt), extent), 3, stride=2,
                       padding=1)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        _tbits(got.permute(0, 2, 3, 1)), _bits(want))


def test_conv_within_one_ulp():
    """A 3x3, 64 -> 32 convolution in bf16 (f32 weight cast to bf16): at
    most 0.1% of the outputs differ from JAX's, each by one bf16 ulp."""
    g = np.random.default_rng(2)
    x = _bf16(g.standard_normal((2, 16, 16, 64)).astype(np.float32))
    w = (g.standard_normal((3, 3, 64, 32)) / 24).astype(np.float32)
    conv = jax_resnet._conv(32, 3, padding=1, dtype=jnp.bfloat16)
    want = conv.apply({"params": {"kernel": w}}, jnp.asarray(x))
    port = resnet.Conv2d(64, 32, 3, padding=1, dtype=BF16)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        got = port(_nchw(x).to(BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    a = _tbits(got.permute(0, 2, 3, 1)).astype(np.int32)
    b = _bits(want).astype(np.int32)
    differ = a != b
    assert differ.mean() <= 1e-3, differ.mean()
    assert np.abs(a - b).max() <= 1  # same sign: adjacent bit patterns
    with pytest.raises(TypeError, match="bfloat16 convolution"):
        port(_nchw(x))  # an f32 input: no quiet f32 path


# -- whole models ------------------------------------------------------------


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal(
        (BATCH, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def irn_vars():
    return jax.tree.map(np.asarray, jax.jit(JaxIRNet().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)))


@pytest.fixture(scope="module")
def cam_vars(images):
    """JAX CAMNet's init variables calibrated on the images (f32)."""
    model = JaxCAMNet()
    init = jax.jit(model.init)(jax.random.PRNGKey(1),
                               jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    _, mutated = jax.jit(lambda v, x: model.apply(
        v, x, method=model.calibrate_stats, mutable=["stats"]))(init, images)
    return {"params": jax.tree.map(np.asarray, init["params"]),
            "stats": jax.tree.map(np.asarray, mutated["stats"])}


def _gate(port, jax16, jax32, what):
    own = _rel(jax16, jax32)
    got = _rel(port, jax32)
    assert LOW * own <= got <= HIGH * own, (what, got, own)


def test_irnet_forward(irn_vars, images):
    def run(dtype):
        return jax.jit(lambda v, x: JaxIRNet(dtype=dtype).apply(
            v, x, apply_mean_shift=True))(irn_vars, images)

    (e32, d32), (e16, d16) = run(jnp.float32), run(jnp.bfloat16)
    port = IRNet(dtype=BF16)
    port.load_state_dict(weights.irn_from_jax(irn_vars))
    port.eval()
    with torch.no_grad():
        e, d = port(_nchw(images), apply_mean_shift=True)
    assert e.dtype == d.dtype == torch.float32
    assert e16.dtype == d16.dtype == jnp.float32
    _gate(_nhwc(e), e16, e32, "edge")
    _gate(_nhwc(d), d16, d32, "dp")
    assert all(p.dtype == torch.float32 for p in port.state_dict().values())


@pytest.mark.parametrize("what", ["logits", "cam", "calibrate"])
def test_camnet(cam_vars, images, what):
    """Logits (the pooled bf16 c5 into the f32 classifier), ``cam()`` over
    a padded buffer with an extent, and ``calibrate_stats`` (the batch
    statistics, f32 from the bf16 activations, and the pooled c5, bf16 as
    JAX's)."""
    extent = (SIZE - 13, SIZE - 5)

    def run(dtype):
        m = JaxCAMNet(dtype=dtype)
        if what == "logits":
            return jax.jit(lambda v, x: m.apply(v, x, train=False))(
                cam_vars, images)
        if what == "cam":
            return jax.jit(lambda v, x: m.apply(
                v, x, extent, method=m.cam))(cam_vars, images)
        out, mutated = jax.jit(lambda v, x: m.apply(
            v, x, method=m.calibrate_stats, mutable=["stats"]))(
                cam_vars, images)
        return out, mutated["stats"]["resnet50"]

    want32, want16 = run(jnp.float32), run(jnp.bfloat16)
    port = CAMNet(dtype=BF16)
    port.load_state_dict(weights.cam_from_jax(cam_vars))
    port.eval()
    x = _nchw(images)
    with torch.no_grad():
        if what == "logits":
            got = port(x, train=False)
            assert got.dtype == torch.float32 and want16.dtype == jnp.float32
            _gate(got.numpy(), want16, want32, what)
        elif what == "cam":
            got = port.cam(x, extent)
            assert got.dtype == torch.float32 and want16.dtype == jnp.float32
            _gate(_nhwc(got), want16, want32, what)
        else:
            got = port.calibrate_stats(x)
            assert want16[0].dtype == jnp.bfloat16 and got.dtype == BF16
            _gate(got.float().numpy(), want16[0], want32[0], "pooled c5")
            sd = weights.cam_to_jax(port.state_dict())["stats"]["resnet50"]
            for layer in ("layer3_5", "layer4_2"):
                for stat in ("mean", "var"):
                    a = sd[layer]["bn3"][stat]
                    assert a.dtype == np.float32
                    _gate(a, want16[1][layer]["bn3"][stat],
                          want32[1][layer]["bn3"][stat], (layer, stat))


# -- one train step each -----------------------------------------------------


def _update_error(got, want, init, keys):
    """||got - want|| / ||want - init|| over ``keys`` together."""
    num = den = 0.0
    for k in keys:
        w = want[k].double().numpy()
        num += float(np.sum((got[k].double().numpy() - w) ** 2))
        den += float(np.sum((w - init[k].double().numpy()) ** 2))
    return (num / den) ** 0.5


def test_irn_train_step(irn_vars, images):
    radius, lr, max_step = 5, 0.1, 10
    labels = np.random.default_rng(3).choice(
        np.array([0, 1, 2, 255], np.int32), size=(BATCH, SIZE // 4, SIZE // 4),
        p=[0.4, 0.25, 0.25, 0.1])
    geom = jax_irn_train.build_train_geometry(SIZE, radius)

    def jax_step(dtype):
        tx = jax_optim.poly_sgd(lr, max_step=max_step, power=0.9,
                                weight_decay=1e-4, momentum=1e-4,
                                mult_fn=jax_optim.irn_lr_mult)
        state = create_train_state(irn_vars, tx)
        step = jax_irn_train.make_train_step(JaxIRNet(dtype=dtype), tx, geom)
        state, _ = step(state, jnp.asarray(images), jnp.asarray(labels))
        return weights.irn_from_jax(jax.tree.map(
            np.asarray, {"params": state.params, "stats": state.stats}))

    want32, want16 = jax_step(jnp.float32), jax_step(jnp.bfloat16)
    model = IRNet(dtype=BF16)
    model.load_state_dict(weights.irn_from_jax(irn_vars))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optim.poly_sgd(model.named_parameters(), lr, max_step=max_step,
                         power=0.9, momentum=1e-4, weight_decay=1e-4,
                         mult_fn=optim.irn_lr_mult)
    step = irn_train.make_train_step(
        model, opt, irn_train.build_train_geometry(SIZE, radius))
    metrics = step(_nchw(images), torch.from_numpy(labels))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    heads = [k for k in init if not k.startswith(("resnet50.", "mean_shift."))]
    got = model.state_dict()
    port_err = _update_error(got, want32, init, heads)
    jax_err = _update_error(want16, want32, init, heads)
    assert port_err <= HIGH * jax_err, (port_err, jax_err)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is None or p.grad.dtype == torch.float32, name
    for k, v in init.items():
        if k.startswith("resnet50."):
            assert torch.equal(got[k], v), k


def test_cam_train_step(cam_vars, images):
    lr, max_step = 1e-3, 10
    labels = (np.random.default_rng(4).random((BATCH, 20)) < 0.2).astype(
        np.float32)

    def jax_step(dtype):
        tx = jax_optim.poly_sgd(lr, max_step=max_step, power=0.9,
                                weight_decay=1e-4, momentum=1e-4,
                                mult_fn=jax_optim.cam_lr_mult)
        state = create_train_state(cam_vars, tx)
        step = jax_cam_train.make_train_step(
            JaxCAMNet(dtype=dtype, stop_grad_at="c3"), tx)
        state, _ = step(state, jnp.asarray(images), jnp.asarray(labels))
        return weights.cam_from_jax(jax.tree.map(
            np.asarray, {"params": state.params, "stats": state.stats}))

    want32, want16 = jax_step(jnp.float32), jax_step(jnp.bfloat16)
    model = CAMNet(stop_grad_at="c3", dtype=BF16)
    model.load_state_dict(weights.cam_from_jax(cam_vars))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optim.poly_sgd(model.named_parameters(), lr, max_step=max_step,
                         power=0.9, momentum=1e-4, weight_decay=1e-4,
                         mult_fn=optim.cam_lr_mult)
    trained = [n for n, _ in model.named_parameters()
               if optim.cam_lr_mult(tuple(n.split(".")))]
    loss = cam_train.make_train_step(model, opt)(
        _nchw(images), torch.from_numpy(labels))
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    got = model.state_dict()
    port_err = _update_error(got, want32, init, trained)
    jax_err = _update_error(want16, want32, init, trained)
    assert port_err <= HIGH * jax_err, (port_err, jax_err)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        if name in trained:
            assert p.grad is not None and p.grad.dtype == torch.float32, name


# -- the flag ----------------------------------------------------------------


def test_model_dtype_values():
    assert common.model_dtype(Config()) == torch.float32
    assert common.model_dtype(Config(model_dtype="bfloat16")) == BF16
    for bad in ("float16", "float64", "bf16"):
        with pytest.raises(NotImplementedError, match="'float32' and "
                           "'bfloat16'"):
            common.model_dtype(Config(model_dtype=bad))
    with pytest.raises(NotImplementedError):
        resnet.ResNet50(dtype=torch.float16)
