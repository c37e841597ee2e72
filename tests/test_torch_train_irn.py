"""train_irn's pieces, the port against the JAX package on the same numpy
inputs (CPU): the path max (K13a / K13b's plain twins through the autograd
Function) against JAX's ``path_affinity`` and its custom VJP, the affinity
labels, loss maps and total loss, and poly SGD with the IRN groups. Whole
train steps: tests/test_torch_train_steps.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from irn_tpu.ops import affinity as jax_aff
from irn_tpu.ops import paths as jax_paths
from irn_tpu.train import optim as jax_optim
from irn_tpu_torch.models.irn import IRNet
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import affinity
from irn_tpu_torch.ops import paths
from irn_tpu_torch.train import irn_train, optim

torch.set_num_threads(2)


def _edge(shape, seed, ties=False):
    g = np.random.default_rng(seed)
    e = 1.0 / (1.0 + np.exp(-g.standard_normal(shape)))
    if ties:
        # quantized to 8 levels: most paths hold a tie for their max
        e = np.round(e * 7) / 7
    return e.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["sigmoid", "ties"])
@pytest.mark.parametrize("radius,shape", [(4, (2, 20, 24)), (5, (2, 24, 21)),
                                          (10, (2, 32, 32))])
def test_path_max_matches_jax(radius, shape, ties):
    """Values, winners and the VJP of JAX's ``path_affinity`` bit-equal
    (tolerance 0) to the port's ``1 - path_max`` through the autograd
    Function on the CPU twins; no kernel launches on the CPU."""
    _build.reset_launches()
    e = _edge(shape, radius, ties)
    jps = jax_paths.build_path_set(radius)
    table = affinity.path_table(paths.build_path_set(radius))
    rf = jps.radius_floor
    ch, cw = shape[1] - rf, shape[2] - 2 * rf

    want, vjp = jax.vjp(lambda x: jax_aff.path_affinity(x, jps),
                        jnp.asarray(e))
    ct = np.random.default_rng(7).standard_normal(
        want.shape).astype(np.float32)
    (want_grad,) = vjp(jnp.asarray(ct))
    _, want_arg = jax_aff._path_max_fwd(
        jnp.asarray(e), jax_aff._path_cells_meta(jps, ch, cw))

    x = torch.from_numpy(e).requires_grad_(True)
    aff = (1.0 - affinity.path_max(x, table)).reshape(
        shape[0], table.n_pairs, ch * cw)
    aff.backward(torch.from_numpy(ct))
    _, winner = affinity.path_max_plain(torch.from_numpy(e), table)

    np.testing.assert_array_equal(aff.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(winner.numpy(),
                                  np.moveaxis(np.asarray(want_arg), 0, 1))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want_grad))
    assert not any(_build.LAUNCHES.values())


def test_path_max_ties_keep_first_cell():
    """A flat map: every path's max is its destination cell (winner 0), and
    the whole cotangent of a pair lands on that cell."""
    table = affinity.path_table(paths.build_path_set(4))
    e = torch.full((1, 12, 14), 0.5)
    maxed, winner = affinity.path_max_plain(e, table)
    assert torch.equal(winner, torch.zeros_like(winner))
    g = torch.ones_like(maxed)
    grad = affinity.path_max_bwd_plain(g, winner, table, (12, 14))
    assert float(grad.sum()) == float(g.sum())


def test_path_max_gradcheck():
    """torch.autograd.gradcheck in f64 on a tie-free map (the twin, through
    the Function; gradcheck's own tolerances)."""
    table = affinity.path_table(paths.build_path_set(4))
    g = np.random.default_rng(3)
    # distinct values, spaced far beyond gradcheck's 1e-6 step
    e = g.permutation(8 * 12).reshape(1, 8, 12) / (8 * 12)
    x = torch.from_numpy(e).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: affinity.path_max(t, table), (x,), eps=1e-6, atol=1e-8)


def test_path_table_checks():
    """The int8 winner caps a path at 127 cells, and a grid must hold a
    window."""
    table = affinity.path_table(paths.build_path_set(10))
    assert table.n_pairs == 152 and max(len(c) for c in table.cells) == 22
    assert sum(len(c) for c in table.cells) == 2134
    with pytest.raises(ValueError, match="no valid window"):
        affinity.path_max_plain(torch.zeros((1, 9, 30)), table)
    with pytest.raises(ValueError, match="overflows"):
        affinity.path_table(paths.build_path_set(60))  # 131 cells
    with pytest.raises(ValueError, match="no valid window"):
        irn_train.build_train_geometry(crop_size=64, radius=10)


def _labels(shape, seed):
    return np.random.default_rng(seed).choice(
        np.array([0, 1, 2, 255], np.int32), size=shape,
        p=[0.4, 0.25, 0.25, 0.1])


@pytest.mark.parametrize("radius", [4, 5])
def test_affinity_labels_match_jax(radius):
    lab = _labels((2, 16, 20), radius)
    ps, jps = paths.build_path_set(radius), jax_paths.build_path_set(radius)
    got = affinity.affinity_labels_2d(torch.from_numpy(lab), ps)
    want = jax_aff.affinity_labels_2d(jnp.asarray(lab), jps)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("radius", [4, 5])
def test_loss_maps_and_total_match_jax(radius):
    """The four loss maps within rtol 1e-6 in f32 (elementwise; the same
    operations), the total and its four terms within rtol 1e-6 (sums over
    the maps in another order)."""
    g = np.random.default_rng(radius)
    b, h, w = 2, 20, 24
    logit = g.standard_normal((b, h, w, 1)).astype(np.float32)
    dp = g.standard_normal((b, h, w, 2)).astype(np.float32)
    lab = _labels((b, h, w), radius + 1)
    jps = jax_paths.build_path_set(radius)
    grid = jax_paths.build_grid_index(jps, (h, w))
    table = affinity.path_table(paths.build_path_set(radius))

    want = jax_aff.affinity_displacement_loss_maps(
        jnp.asarray(logit), jnp.asarray(dp), grid)
    got = affinity.affinity_displacement_loss_maps(
        torch.from_numpy(logit).permute(0, 3, 1, 2),
        torch.from_numpy(dp).permute(0, 3, 1, 2), table)
    for name, a, bb in zip(want._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    masks = affinity.affinity_labels_2d(torch.from_numpy(lab),
                                        table.path_set)
    jmasks = jax_aff.affinity_labels_2d(jnp.asarray(lab), jps)
    total, terms = affinity.irn_total_loss(got, *masks)
    jtotal, jterms = jax_aff.irn_total_loss(want, *jmasks)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    for k, v in jterms.items():
        np.testing.assert_allclose(float(terms[k]), float(v), rtol=1e-6,
                                   err_msg=k)


def test_pair_displacement_matches_jax():
    g = np.random.default_rng(0)
    dp = g.standard_normal((2, 18, 22, 2)).astype(np.float32)
    got = affinity.pair_displacement(torch.from_numpy(dp).permute(0, 3, 1, 2),
                                     paths.build_path_set(5))
    want = jax_aff.pair_displacement(jnp.asarray(dp),
                                     jax_paths.build_path_set(5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("step", [0, 3, 4, 5, 9])
def test_poly_schedule_matches_jax(step):
    """Frozen at max_step - 1 from there on; within 1e-12 in f64."""
    with jax.enable_x64(True):
        want = float(jax_optim.poly_schedule(0.1, 5)(jnp.asarray(step)))
    assert optim.poly_schedule(0.1, 5)(step) == pytest.approx(want, rel=1e-12)


def test_irn_lr_mult_matches_jax():
    port = dict(IRNet().named_parameters())
    for name in port:
        path = tuple(name.split("."))
        assert optim.irn_lr_mult(path) == jax_optim.irn_lr_mult(path), name
    assert {optim.irn_lr_mult(tuple(n.split("."))) for n in port} == {
        0.0, 1.0, 10.0}


def test_poly_sgd_matches_optax():
    """Six steps at max_step 5 (the last two at the frozen schedule) with
    weight decay 1e-4, stray momentum 1e-4 and the IRN multipliers (0, 1,
    10): params within 1e-12 relative in f64."""
    g = np.random.default_rng(0)
    shapes = {("resnet50", "w"): (3, 4), ("fc_edge1", "w"): (5,),
              ("fc_dp3", "w"): (2, 3)}
    init = {k: g.standard_normal(s) for k, s in shapes.items()}
    grads = [{k: g.standard_normal(s) for k, s in shapes.items()}
             for _ in range(6)]
    with jax.enable_x64(True):
        tx = jax_optim.poly_sgd(0.1, max_step=5, power=0.9,
                                weight_decay=1e-4, momentum=1e-4,
                                mult_fn=jax_optim.irn_lr_mult)
        jp = {a: {b: jnp.asarray(v)} for (a, b), v in init.items()}
        state = tx.init(jp)
        want = []
        for gr in grads:
            jg = {a: {b: jnp.asarray(v)} for (a, b), v in gr.items()}
            upd, state = tx.update(jg, state, jp)
            jp = optax.apply_updates(jp, upd)
            want.append({k: np.asarray(jp[k[0]][k[1]]) for k in shapes})
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = optim.poly_sgd(((".".join(k), p) for k, p in params.items()), 0.1,
                         max_step=5, power=0.9, momentum=1e-4,
                         weight_decay=1e-4, mult_fn=optim.irn_lr_mult)
    for s, gr in enumerate(grads):
        for k, p in params.items():
            p.grad = torch.from_numpy(gr[k].copy())
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[s][k],
                                       rtol=1e-12, atol=0, err_msg=str(k))
    assert torch.equal(params[("resnet50", "w")].detach(),
                       torch.from_numpy(init[("resnet50", "w")]))
    assert opt.step_count == 6


@pytest.mark.parametrize("fmt", ["pth", "pickle"])
def test_pretrained_backbone(fmt, tmp_path, capsys):
    """load_backbone_variables reads a torch .pth state dict (converted) or
    a JAX-layout pickle to the same variables as irn_tpu's, and
    init_model_variables grafts them into the seeded model's backbone;
    without a file it warns as irn_tpu does."""
    from irn_tpu.pipeline import common as jax_common
    from irn_tpu.pipeline.config import Config as JaxConfig
    from irn_tpu_torch.models.irn import init_irnet
    from irn_tpu_torch.models.resnet import ResNet50
    from irn_tpu_torch.pipeline import common
    from irn_tpu_torch.pipeline.config import Config
    from irn_tpu_torch.utils import weights
    from irn_tpu_torch.utils.checkpoint import save_checkpoint

    sd = init_irnet(ResNet50(), torch.Generator().manual_seed(5)).state_dict()
    sd = {k: v + 0.01 * torch.arange(v.numel()).reshape(v.shape)
          if v.is_floating_point() else v for k, v in sd.items()}
    path = str(tmp_path / ("r50.pth" if fmt == "pth" else "r50.ckpt"))
    if fmt == "pth":
        torch.save(dict(sd, **{"fc.weight": torch.zeros(3, 2048)}), path)
    else:
        save_checkpoint(path, weights.convert_resnet50(sd))
    got = common.load_backbone_variables(Config(pretrained_backbone=path))
    want = jax_common.load_backbone_variables(
        JaxConfig(pretrained_backbone=path))

    def flat(t, p=()):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in flat(t[k], p + (k,))]
        return [(p, np.asarray(t))]

    assert [p for p, _ in flat(got)] == [p for p, _ in flat(want)]
    for (p, a), (_, b) in zip(flat(got), flat(want)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))

    model = common.init_model_variables(IRNet(), Config(
        pretrained_backbone=path))
    msd = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(msd["resnet50." + k], v), k
    common.init_model_variables(IRNet(), Config())
    assert "WARNING: no pretrained_backbone" in capsys.readouterr().out
