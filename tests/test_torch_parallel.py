"""The port's multi-device layer against the JAX package's, on the CPU:
the rank-count rule and the batch rows of each rank (``parallel.mesh``
against ``irn_tpu.parallel.mesh`` over the 8-device virtual mesh of
conftest.py), the loader's ``local_rows`` (tests/test_torch_copies.py holds
it to JAX's loader), the make stages' strided share and round-robin
spreader against JAX's ``host_shard_range`` and ``DeviceSpreader``, and
``affinity.irn_loss`` over two gloo ranks against JAX's loss and gradients
over the whole batch. Every spawned rank runs under a 120 s deadline."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import affinity as jax_aff
from irn_tpu.ops import paths as jax_paths
from irn_tpu.parallel import mesh as jax_mesh
from irn_tpu.pipeline import common as jax_common
from irn_tpu_torch.parallel import mesh
from irn_tpu_torch.pipeline import common

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


DEADLINE_S = 120
GLOO2 = mesh.RankSpec(("cpu", "cpu"), timeout_s=DEADLINE_S)


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 6, 8, 12, 16])
def test_rank_count_matches_jax_mesh(batch):
    """ranks_for_batch(batch, n) is the size of JAX's mesh_for_batch(batch,
    n) for every n of the 8 virtual devices; 0 is every visible card (the
    CPU counts as one)."""
    for n in range(1, 9):
        want = jax_mesh.mesh_for_batch(batch, n).devices.size
        assert mesh.ranks_for_batch(batch, n, "cpu") == want, n
    assert mesh.ranks_for_batch(batch, 0, "cpu") == 1


def test_rank_rows_cover_the_batch():
    """Each rank's contiguous rows, in rank order, make up the batch; JAX's
    single-process slice is the whole batch, as the port's world of one."""
    for batch, world in ((8, 1), (8, 2), (8, 4), (12, 3)):
        rows = [mesh.local_batch_slice(batch, r, world) for r in range(world)]
        assert rows[0][0] == 0 and rows[-1][1] == batch
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
        assert len({hi - lo for lo, hi in rows}) == 1
    jmesh = jax_mesh.mesh_for_batch(8, 2)
    assert jax_mesh.local_batch_slice(jmesh, 8) == mesh.local_batch_slice(8)


def test_rank_rules_refuse(monkeypatch):
    """More CUDA ranks than cards, and a batch that a fixed process count
    does not split, raise instead of running on fewer."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks asked for, 1 CUDA"):
        mesh.ranks_for_batch(4, 2, "cuda")
    with pytest.raises(ValueError, match="infer_devices 3"):
        common.spread_devices("cuda", 3)
    with pytest.raises(ValueError, match="does not split over 2"):
        mesh.local_batch_slice(3, 0, 2)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="group has 2 processes"):
        mesh.group_ranks(3, 0)
    assert mesh.group_ranks(4, 0) == 2


def test_host_shard_range_matches_jax(monkeypatch):
    assert list(common.host_shard_range(7)) == list(
        jax_common.host_shard_range(7))
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    monkeypatch.setattr(mesh, "world_size", lambda: 3)
    assert list(common.host_shard_range(10)) == [1, 4, 7]
    assert common.shard_blocks(list("abcdefg"), "t") == ["b", "e"]


def test_spreader_matches_jax_device_spreader():
    """Block c goes to worker c % n, as JAX's spreader commits block c to
    device c % n over the 8 virtual devices; ``assigned`` counts each."""
    jspread = jax_common.DeviceSpreader()
    assert len(jspread) == 8
    spread = common.DeviceSpreader(["cpu"] * 8)
    devs = jax.local_devices()
    for c in range(20):
        assert devs.index(jspread(c)) == spread(c)
    assert [spread.assigned[w] for w in range(8)] == [
        jspread.assigned[d] for d in devs]
    two = common.make_spreader("cpu", 2)
    assert len(two) == 2 and not two.inline
    assert common.make_spreader("cpu", 0).inline


def test_spreader_runs_every_block_on_its_worker():
    spread = common.DeviceSpreader(["cpu", "cpu", "cpu"])
    seen = []
    spread.setup(lambda d: {"blocks": []})
    ctxs = spread.run(list(range(10)),
                      lambda ctx, c, b: ctx["blocks"].append(b),
                      lambda ctx: seen.append(len(ctx["blocks"])))
    assert [c["blocks"] for c in ctxs] == [[0, 3, 6, 9], [1, 4, 7],
                                           [2, 5, 8]]
    assert sorted(seen) == [3, 3, 4]
    assert [spread.assigned[w] for w in range(3)] == [4, 3, 3]

    def boom(ctx, c, b):
        if b == 4:
            raise KeyError("block 4")

    spread.setup(lambda d: None)
    with pytest.raises(KeyError, match="block 4"):
        spread.run(list(range(10)), boom)


def test_rank_failure_ends_the_run():
    """A rank that raises ends the run (with its own error, or the other
    rank's failed barrier, whichever process ends first) long before the
    group's timeout, instead of leaving the other at its barrier."""
    with pytest.raises(Exception,
                       match="rank 1 fails|'never' failed: .*Rank"):
        mesh.run_ranks(workers.failing_rank, (), GLOO2,
                       deadline_s=DEADLINE_S)


RADIUS, SHAPE = 4, (4, 20, 24)


def _jax_loss_from_aff(aff, dp, lab, radius):
    """JAX's total, terms and gradients in the affinities and
    displacements, the loss of ``irn_total_loss`` over the maps that
    ``affinity_displacement_loss_maps`` forms from ``aff`` (= 1 - maxed)."""
    jps = jax_paths.build_path_set(radius)
    masks = jax_aff.affinity_labels_2d(jnp.asarray(lab), jps)
    target = jnp.asarray(jps.dst_offsets.T.astype(np.float32))[
        None, :, :, None]

    def loss(a, d):
        pair = jax_aff.pair_displacement(d, jps)
        maps = jax_aff.AffinityLossMaps(
            -jnp.log(a + 1e-5), -jnp.log(1.0 + 1e-5 - a),
            jnp.abs(pair - target), jnp.abs(pair))
        return jax_aff.irn_total_loss(maps, *masks)

    (total, terms), (g_aff, g_dp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(aff),
                                            jnp.asarray(dp))
    return ({"loss": float(total), **{k: float(v) for k, v in terms.items()}},
            np.asarray(g_aff), np.asarray(g_dp))


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _loss_case(dtype):
    """A batch of 4 whose halves' label counts differ."""
    g = np.random.default_rng(11)
    b, h, w = SHAPE
    ps = jax_paths.build_path_set(RADIUS)
    ch, cw = h - ps.radius_floor, w - 2 * ps.radius_floor
    maxed = g.uniform(0.0, 0.999, (b, ps.n_pairs, ch, cw)).astype(dtype)
    dp = g.standard_normal((b, 2, h, w)).astype(dtype)
    lab = np.concatenate([
        g.choice(np.array([0, 1, 2, 255], np.int32), size=(2, h, w),
                 p=p) for p in ((0.7, 0.1, 0.1, 0.1), (0.1, 0.4, 0.4, 0.1))])
    return dict(maxed=maxed, dp=dp, labels=lab)


@pytest.fixture(scope="module")
def two_ranks():
    """Both dtypes' cases over one pair of spawned gloo ranks."""
    cases = {dt: _loss_case(dt) for dt in ("float64", "float32")}
    return cases, mesh.run_ranks(workers.irn_loss_ranks, (cases, RADIUS),
                                 GLOO2, deadline_s=DEADLINE_S)


def test_ranks_meet(two_ranks):
    """Both ranks passed their barriers and summed over the group."""
    assert [r["rank_sum"] for r in two_ranks[1]] == [1, 1]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_irn_loss_two_ranks_match_jax_batch(dtype, two_ranks):
    """A batch of 4 over two gloo ranks of 2 rows each, whose label counts
    differ: with the group, each rank's loss is JAX's loss over the whole
    batch and its d_maxed / d_dp are jax.grad's rows, within 1e-6 relative;
    DDP's plain averaging of the ranks' own losses (each over its own
    label counts) misses both by far more."""
    data = two_ranks[0][dtype]
    ranks = [r[dtype] for r in two_ranks[1]]
    maxed, dp, lab = data["maxed"], data["dp"], data["labels"]
    b, n_pairs, ch, cw = maxed.shape
    assert [r["rows"] for r in ranks] == [(0, 2), (2, 4)]

    aff = (1.0 - maxed).reshape(b, n_pairs, ch * cw)
    with jax.enable_x64(dtype == "float64"):
        want, g_aff, g_dp = _jax_loss_from_aff(
            aff, dp.transpose(0, 2, 3, 1), lab, RADIUS)
    want_maxed = -g_aff.reshape(maxed.shape)
    want_dp = g_dp.transpose(0, 3, 1, 2)

    for r in ranks:
        for k, v in want.items():
            assert r["group"][k] == pytest.approx(v, rel=1e-6), k
    got_maxed = np.concatenate([r["group"]["d_maxed"] for r in ranks])
    got_dp = np.concatenate([r["group"]["d_dp"] for r in ranks])
    assert _rel(got_maxed, want_maxed) <= 1e-6
    assert _rel(got_dp, want_dp) <= 1e-6

    # DDP's default: each rank's own loss, the losses and gradients
    # averaged over the two ranks
    avg_loss = np.mean([r["alone"]["loss"] for r in ranks])
    avg_maxed = np.concatenate([r["alone"]["d_maxed"] / 2 for r in ranks])
    avg_dp = np.concatenate([r["alone"]["d_dp"] / 2 for r in ranks])
    assert abs(avg_loss - want["loss"]) / abs(want["loss"]) > 1e-3
    assert _rel(avg_maxed, want_maxed) > 1e-2
    assert _rel(avg_dp, want_dp) > 1e-2


def test_irn_loss_group_of_one_is_the_plain_loss():
    """A group of one rank leaves irn_loss as it is, bit for bit."""
    g = np.random.default_rng(3)
    b, h, w = 2, 20, 24
    ps = jax_paths.build_path_set(RADIUS)
    data = dict(
        maxed=g.uniform(0, 0.999, (b, ps.n_pairs, h - ps.radius_floor,
                                   w - 2 * ps.radius_floor)).astype(
            np.float32),
        dp=g.standard_normal((b, 2, h, w)).astype(np.float32),
        labels=g.choice(np.array([0, 1, 2, 255], np.int32), size=(b, h, w)))
    (one,) = mesh.run_ranks(workers.irn_loss_rank, (data, RADIUS),
                            dataclasses.replace(GLOO2, devices=("cpu",)))
    for k in ("loss", "loss_pos_aff", "loss_neg_aff", "loss_dp_fg",
              "loss_dp_bg"):
        assert one["group"][k] == one["alone"][k], k
    for k in ("d_maxed", "d_dp"):
        np.testing.assert_array_equal(one["group"][k], one["alone"][k])
