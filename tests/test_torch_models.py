"""Port models and weights vs the JAX package (CPU, f32).

The JAX IRNet is initialised from a seed, its variables convert to the
port's state dict (``irn_from_jax``), and both forwards see the same numpy
batch. Convolutions sum in another order in XLA and in PyTorch, so the
outputs agree to atol 1e-4; the weight round trip is exact."""

import jax
import numpy as np
import pytest
import torch

from irn_tpu.models.irn import IRNet as JaxIRNet
from irn_tpu.models.resnet import ResNet50 as JaxResNet50
from irn_tpu.utils.weights import convert_irn_net
from irn_tpu_torch.models.irn import IRNet, init_irnet
from irn_tpu_torch.models.resnet import ResNet50
from irn_tpu_torch.utils import checkpoint
from irn_tpu_torch.utils.weights import irn_from_jax, resnet50_from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_irn():
    model = JaxIRNet()
    variables = model.init(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32)
    )
    variables = jax.tree.map(np.asarray, variables)
    # non-trivial frozen statistics and mean shift, so the mapping of every
    # buffer is exercised
    rng = np.random.default_rng(1)
    bn = variables["stats"]["resnet50"]["bn1"]
    bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32) * 0.1
    bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    variables["stats"]["dp_mean"] = np.asarray([0.25, -0.5], np.float32)
    return model, variables


def test_weights_round_trip_exact():
    port = init_irnet(IRNet(), torch.Generator().manual_seed(3))
    sd = port.state_dict()
    back = irn_from_jax(convert_irn_net(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


def test_checkpoint_round_trip(tmp_path, jax_irn):
    _, variables = jax_irn
    path = str(tmp_path / "irn.ckpt")
    checkpoint.save_checkpoint(path, variables)
    loaded = checkpoint.load_checkpoint(path)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = jax.tree_util.tree_leaves_with_path(loaded)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_irnet_forward_matches_jax(jax_irn):
    model, variables = jax_irn
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want_e, want_d = model.apply(variables, x, apply_mean_shift=True)
    port = IRNet()
    port.load_state_dict(irn_from_jax(variables))
    port.eval()
    with torch.no_grad():
        e, d = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                    apply_mean_shift=True)
    np.testing.assert_allclose(e.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_e), atol=1e-4)
    np.testing.assert_allclose(d.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_d), atol=1e-4)


def test_resnet_extent_masking_matches_jax(jax_irn):
    """A padded buffer with a true (h, w) extent: every stage feature
    matches the JAX backbone's extent-masked run."""
    _, variables = jax_irn
    params = variables["params"]["resnet50"]
    stats = variables["stats"]["resnet50"]
    x = np.zeros((1, 64, 64, 3), np.float32)
    x[0, :45, :38] = np.random.default_rng(2).normal(size=(45, 38, 3))
    want = JaxResNet50().apply({"params": params, "stats": stats}, x,
                               extent=(45, 38))
    port = ResNet50()
    port.load_state_dict(resnet50_from_jax(params, stats))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                   extent=(45, 38))
    for name, feat in got.items():
        ref = np.asarray(want[name])
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(feat.permute(0, 2, 3, 1).numpy() / scale,
                                   ref / scale, atol=1e-5, err_msg=name)
