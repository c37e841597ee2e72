"""The row-sharded random walk (``--rw_mesh_model k``): the port's
:mod:`irn_tpu_torch.parallel.rw_sharded`, the mesh routes of
``random_walk.propagate`` and the mesh mode of ``RandomWalkRunner``
against the JAX package on its virtual 8-device CPU mesh
(tests/conftest.py), on the same seeded numpy inputs.

The port's mesh is k copies of the CPU (one process drives every device,
as JAX's single controller does); its stencil route runs K0's plain twin
per device and round on windows, bit-equal to the whole matrix's chain.
Shapes stay tiny: the 32x32 bucket at radius 2 (n_pad 1536, largest
offset 37), exp_times 3, n 256 for the matrix cases."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irn_tpu.ops import random_walk as jrw
from irn_tpu.parallel import mesh as jmesh
from irn_tpu.parallel import rw_sharded as jrs
from irn_tpu.pipeline.config import Config as JaxConfig
from irn_tpu.pipeline.stages_irn import RandomWalkRunner as JaxRunner
from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import random_walk as trw
from irn_tpu_torch.parallel import rw_sharded as trs
from irn_tpu_torch.pipeline import stages_irn
from irn_tpu_torch.pipeline.config import Config

CPU = torch.device("cpu")
CAP, RADIUS, EXP = 32, 2, 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mesh(k):
    return trs.ModelMesh(["cpu"] * k)


def _jmesh(k):
    return jmesh.make_mesh(n_data=1, n_model=k)


def _scene(rng, c=3, extent=(28, 28)):
    """Capped (cam, edge) at the 32x32 bucket: random inside the extent,
    edge 1 beyond it."""
    h4, w4 = extent
    edge = np.ones((CAP, CAP), np.float32)
    edge[:h4, :w4] = rng.random((h4, w4)).astype(np.float32)
    cam = np.zeros((c, CAP, CAP), np.float32)
    cam[:, :h4, :w4] = rng.random((c, h4, w4))
    return cam, edge


def _banded(rng, n, h):
    r = np.arange(n)
    band = np.abs(r[:, None] - r[None, :]) <= h
    t = np.zeros((n, n), np.float32)
    t[band] = rng.random(band.sum(), dtype=np.float32) * 0.05
    return t


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every kernel runs its plain twin: no launch is counted."""
    _build.reset_launches()
    yield
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("largest", [False, True], ids=["m1", "mmax"])
def test_diag_apply(rng, k, largest):
    """The column-split stencil at m = 1 and the largest m: bit-equal to
    K0's twin on the whole matrix, and within the stencil's tolerance of
    JAX's ``diag_apply_in_jit`` on k devices."""
    cam, edge = _scene(rng, c=5)
    geom = trw.build_geometry(CAP, CAP, radius=RADIUS)
    w, inv = trw.build_diag_operator(geom, _t(edge))
    doffs = trw.diag_offsets(geom)
    x = trw._flat_seeds(geom, _t(cam), _t(edge))
    n_apply = 1 << EXP
    m = trs.diag_max_per_round(geom.n_pad, doffs, k) if largest else 1
    plan = trs.diag_plan(geom.n_pad, doffs, k, n_apply, m)
    assert plan.rounds == -(-n_apply // plan.per_round)
    got = trs.diag_apply(x, w, inv, doffs, n_apply, _mesh(k), m)
    want = trw.apply_diag_chain_plain(x, w, inv, doffs, n_apply)
    assert torch.equal(got, want)
    jgot = np.asarray(jax.jit(lambda a, b, c: jrs.diag_apply_in_jit(
        a, b, c, doffs, n_apply, _jmesh(k)))(x.numpy(), w.numpy(),
                                            inv.numpy()))
    np.testing.assert_allclose(got.numpy(), jgot, atol=1e-6, rtol=1e-5)


def test_diag_plan():
    """Windows: the device's columns plus m*H each side, clipped to the
    matrix and widened to a multiple of 4; a short last round; the gate's
    refusals."""
    geom = trw.build_geometry(CAP, CAP, radius=RADIUS)
    doffs = trw.diag_offsets(geom)
    n, h = geom.n_pad, max(doffs)
    assert (n, h) == (1536, 37)
    assert trs.diag_max_per_round(n, doffs, 8) == 192 // 37
    plan = trs.diag_plan(n, doffs, 8, 256, 3)
    assert plan.rounds == 86 and plan.per_round == 3
    halo = 0
    for j, (lo, hi) in enumerate(plan.windows):
        c0, c1 = 192 * j, 192 * (j + 1)
        assert (hi - lo) % 4 == 0
        assert lo <= max(0, c0 - 3 * h) and hi >= min(n, c1 + 3 * h)
        assert 0 <= lo and hi <= n and (c0 - lo) - 3 * h < 4
        halo += (c0 - lo) + (hi - c1)
    assert plan.halo_columns == halo
    assert trs.diag_plan(n, doffs, 2, 8).per_round == 8  # never past n_apply
    with pytest.raises(ValueError, match="applications per round"):
        trs.diag_plan(n, doffs, 8, 256, 6)
    with pytest.raises(ValueError, match="columns over"):
        trs.diag_plan(n, doffs, 7, 256)
    with pytest.raises(ValueError, match="columns over"):
        trs.diag_plan(n, doffs, 64, 256)  # blocks of 24 < H


@pytest.mark.parametrize("k,h", [(8, 10), (8, 40), (2, 40)],
                         ids=["one_hop", "multi_hop", "k2"])
def test_banded_power(rng, k, h):
    """Two row-split banded squarings (one hop at h 10, several at h 40 >
    n_loc 32): within 1e-5 / 1e-4 of JAX's, entries beyond the band exact
    zeros."""
    n = 256
    t = _banded(rng, n, h)
    mesh = _mesh(k)
    got = mesh.gather(trs.banded_power(mesh.split(_t(t), 0), 2, h, mesh),
                      0).numpy()
    want = np.asarray(jrs.banded_matrix_power(jnp.asarray(t), 2, h,
                                              _jmesh(k)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    r = np.arange(n)
    assert (got[np.abs(r[:, None] - r[None, :]) > 4 * h] == 0).all()


def test_banded_apply(rng):
    """Four row-split applications, and the hybrid: one squaring, then two
    applications (JAX ``test_banded_sharded_propagate_parity``)."""
    n, h = 256, 12
    t = _banded(rng, n, h)
    seeds = rng.standard_normal((4, n)).astype(np.float32)
    mesh, jm = _mesh(8), _jmesh(8)
    got = trs.banded_apply(_t(seeds), mesh.split(_t(t), 0), 4, mesh).numpy()
    want = np.asarray(jrs.banded_propagate_rows(jnp.asarray(seeds),
                                                jnp.asarray(t), 4, jm))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, seeds @ t @ t @ t @ t, atol=1e-3,
                               rtol=1e-3)
    t2 = trs.banded_power(mesh.split(_t(t), 0), 1, h, mesh)
    got2 = trs.banded_apply(_t(seeds), t2, 2, mesh).numpy()
    want2 = np.asarray(jrs.banded_propagate_rows(
        jnp.asarray(seeds), jrs.banded_matrix_power(jnp.asarray(t), 1, h, jm),
        2, jm))
    np.testing.assert_allclose(got2, want2, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got2, got, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("radius", [2, 5])
def test_assemble_and_normalize_rows(rng, radius):
    """Each device's rows of A from the band table equal the port's
    ``dense_affinity`` (at radius 5 the largest offset, 138, exceeds a
    block of 128 rows, so band entries land in the previous device's H
    row); the normalized rows within 1e-6 of JAX's."""
    geom = trw.build_geometry(24, 24, radius=radius)
    edge = rng.random((24, 24)).astype(np.float32)
    mesh = _mesh(8)
    vs, doffs = trw.band_values(geom, _t(edge))
    a = trs.assemble_rows(vs, doffs, geom.n_pad, mesh)
    dense = trw.dense_affinity(geom, _t(edge))
    assert torch.equal(mesh.gather(a, 0), dense)
    got = mesh.gather(trs.normalize_rows(a, 10, mesh), 0).numpy()

    jg = jrw.build_geometry(24, 24, radius=radius)

    @jax.jit
    def sharded(e):
        jvs, jd = jrw.band_values(jg, e)
        ja = jrs.assemble_rows_in_jit(jvs, jd, jg.n_pad, _jmesh(8))
        return jrs.normalize_rows_in_jit(ja, 10, _jmesh(8))

    np.testing.assert_allclose(got, np.asarray(sharded(jnp.asarray(edge))),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        got, trw.normalize_transition(dense, 10).numpy(), atol=1e-6,
        rtol=1e-6)


def test_sharded_matrix_power_and_rows(rng):
    """The dense route's row-split squarings and x @ T against JAX's."""
    n = 8 * 32
    a = np.abs(rng.standard_normal((n, n))).astype(np.float32)
    t = a / a.sum(axis=0, keepdims=True)
    mesh, jm = _mesh(8), _jmesh(8)
    got = mesh.gather(trs.sharded_matrix_power(_t(t), 3, mesh), 0).numpy()
    want = np.asarray(jrs.sharded_matrix_power(jnp.asarray(t), 3, jm))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    seeds = rng.standard_normal((4, n)).astype(np.float32)
    got = trs.sharded_propagate_rows(_t(seeds), _t(t), mesh).numpy()
    want = np.asarray(jrs.sharded_propagate_rows(jnp.asarray(seeds),
                                                 jnp.asarray(t), jm))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("route,sq,mesh_banded", [
    ("mesh_diag", 0, True), ("mesh_banded", 1, True), ("dense", 1, False)])
@pytest.mark.parametrize("k", [2, 8])
def test_propagate_mesh_routes(rng, route, sq, mesh_banded, k):
    """``propagate(..., mesh)`` on each route against JAX's
    ``propagate(..., mesh=)``; the stencil route bit-equal to the port's
    single-device stencil."""
    cam, edge = _scene(rng)
    geom = trw.build_geometry(CAP, CAP, radius=RADIUS)
    assert trw.diag_sharded_fits(geom, k)
    assert trw.banded_sharded_fits(geom, EXP, 1, k)
    got = trw.propagate(geom, _t(cam), _t(edge), 10, EXP, square_times=sq,
                        mesh=_mesh(k), mesh_banded=mesh_banded).numpy()
    jg = jrw.build_geometry(CAP, CAP, radius=RADIUS)
    want = np.asarray(jax.jit(lambda c, e: jrw.propagate(
        jg, c, e, beta=10, exp_times=EXP, square_times=sq, mesh=_jmesh(k),
        mesh_banded=mesh_banded))(cam, edge))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    if route == "mesh_diag":
        single = trw.propagate_diag(geom, _t(cam), _t(edge), 10, EXP)
        assert np.array_equal(got, single.numpy())


def test_sharded_fits_match_jax():
    """The two gates equal JAX's over buckets, radii, exponents and mesh
    sizes, and hold at the production bucket for k = 2, 4, 8."""
    for cap, radius in (((96, 128), 5), ((32, 32), 2), ((16, 16), 2),
                        ((128, 128), 5), ((64, 32), 8)):
        tg = trw.build_geometry(*cap, radius=radius)
        jg = jrw.build_geometry(*cap, radius=radius)
        for k in (1, 2, 3, 4, 7, 8, 16, 64):
            assert trw.diag_sharded_fits(tg, k) == jrw.diag_sharded_fits(
                jg, k), (cap, radius, k)
            for sq in range(4):
                assert trw.banded_sharded_fits(tg, 8, sq, k) == \
                    jrw.banded_sharded_fits(jg, 8, sq, k), (cap, k, sq)
    prod = trw.build_geometry(96, 128, radius=5)
    assert (prod.n_pad, max(trw.diag_offsets(prod)),
            trw.band_halfwidth(prod)) == (14336, 554, 556)
    for k in (2, 4, 8):
        assert trw.diag_sharded_fits(prod, k)
        assert all(trw.banded_sharded_fits(prod, 8, sq, k) for sq in range(3))


PROD = (96, 128)
SMALL = dict(rw_grid_cap=16, exp_times=3, rw_radius=2)
# the mesh rows of tests/test_walk_dispatch.py (the port reads no
# IRN_TPU_APPLY, so its stencil opt-out row has no counterpart), and the
# production bucket on meshes of 2 and 4
MESH_ROWS = [
    ("mesh-default", {"rw_mesh_model": 8}, PROD, "mesh_diag"),
    ("mesh-sq1", {"rw_mesh_model": 8, "rw_square_times": 1}, PROD,
     "mesh_banded"),
    ("mesh-banded-off", {"rw_mesh_model": 8, "rw_banded": False}, PROD,
     "dense"),
    ("mesh-sq8", {"rw_mesh_model": 8, "rw_square_times": 8}, PROD, "dense"),
    ("small-mesh", {"rw_mesh_model": 8, **SMALL}, (16, 16), "mesh_diag"),
    ("mesh2-default", {"rw_mesh_model": 2}, PROD, "mesh_diag"),
    ("mesh4-sq2", {"rw_mesh_model": 4, "rw_square_times": 2}, PROD,
     "mesh_banded"),
]


@pytest.mark.parametrize("kwargs,geom,expected", [r[1:] for r in MESH_ROWS],
                         ids=[r[0] for r in MESH_ROWS])
def test_resolve_mode_matches_jax(monkeypatch, kwargs, geom, expected):
    monkeypatch.delenv("IRN_TPU_APPLY", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = JaxRunner(JaxConfig(**kwargs), n_seed_rows=4).resolve_mode(*geom)
    walker = stages_irn.RandomWalkRunner(Config(**kwargs), 4, CPU)
    assert len(walker.mesh) == kwargs["rw_mesh_model"]
    assert walker.resolve_mode(*geom) == want == expected


@pytest.mark.parametrize("k", [2, 4, 8])
def test_all_production_buckets_resolve_mesh_diag(k):
    """Every bucket of the default geometry family takes the column-split
    stencil on a mesh of 2, 4 or 8."""
    walker = stages_irn.RandomWalkRunner(Config(rw_mesh_model=k), 20, CPU)
    b = walker.BUCKET
    for cap_h in range(b, walker.cap + 1, b):
        for cap_w in range(b, walker.cap + 1, b):
            assert walker.resolve_mode(cap_h, cap_w) == "mesh_diag"


@pytest.mark.parametrize("route,extra", [
    ("mesh_diag", {}), ("mesh_banded", {"rw_square_times": 1})])
def test_chunked_walk(rng, route, extra):
    """``propagate_all`` of 10 seed rows in chunks of 4, the operator built
    once per image: labels equal to the port's single-device walker and to
    JAX's mesh walker, best within 1e-5."""
    base = dict(rw_grid_cap=CAP, exp_times=EXP, rw_radius=RADIUS, **extra)
    h4 = w4 = 28
    size = (110, 106)
    edge = np.ones((CAP, CAP), np.float32)
    edge[:h4, :w4] = rng.random((h4, w4)).astype(np.float32)
    seeds = rng.random((10, h4, w4)).astype(np.float32)
    seeds_b = np.zeros((10, CAP, CAP), np.float32)
    seeds_b[:, :h4, :w4] = seeds

    single = stages_irn.RandomWalkRunner(Config(**base), 4, CPU)
    meshed = stages_irn.RandomWalkRunner(Config(rw_mesh_model=8, **base), 4,
                                         CPU)
    l1, b1 = single.propagate_all(_t(seeds_b), _t(edge), h4, w4, size, 0.25)
    l8, b8 = meshed.propagate_all(_t(seeds_b), _t(edge), h4, w4, size, 0.25)
    # one device takes the dense route here: the 512-row band blocks
    # outgrow this small matrix
    assert single.modes == {(CAP, CAP): "dense"}
    assert meshed.modes == {(CAP, CAP): route}
    jw = JaxRunner(JaxConfig(rw_mesh_model=8, **base), n_seed_rows=4)
    jl, jb = jw.propagate_all(seeds, jnp.asarray(edge), h4, w4, size, 0.25)
    np.testing.assert_array_equal(l8.numpy(), l1.numpy())
    np.testing.assert_array_equal(l8.numpy(), np.asarray(jl))
    np.testing.assert_allclose(b8.numpy(), b1.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(b8.numpy(), np.asarray(jb), atol=1e-5,
                               rtol=1e-5)


def test_walk_mesh_devices(monkeypatch):
    """The walk's devices: ``devices`` when given (k of them), the CPU k
    times, the first k visible cards; more than are visible raise."""
    cfg = Config(rw_mesh_model=4)
    assert stages_irn.walk_mesh(dataclasses.replace(cfg, rw_mesh_model=1),
                                CPU) is None
    assert stages_irn.walk_mesh(cfg, CPU).devices == (CPU,) * 4
    two = dataclasses.replace(cfg, rw_mesh_model=2)
    assert stages_irn.walk_mesh(two, CPU, ["cpu", "cpu"]).devices == (CPU,
                                                                      CPU)
    with pytest.raises(ValueError, match="rw_mesh_model 4: 2 devices"):
        stages_irn.walk_mesh(cfg, CPU, ["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [str(d) for d in stages_irn.walk_mesh(cfg, "cuda").devices] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="rw_mesh_model 4: 1 CUDA device"):
        stages_irn.walk_mesh(cfg, "cuda")
