"""Boundary-guided random-walk propagation — the counterpart of
:mod:`irn_tpu.ops.random_walk` (single device).

The edge map becomes radius-r path affinities, the affinities a symmetric
banded matrix A with a unit diagonal, and T = colnorm(A^beta) the
transition operator; the boundary-damped seed rows propagate as
x @ T^(2^exp_times), evaluated as 2^(E-e) applications of T^(2^e).

Routes, as the JAX package takes them on its TPU default (the port reads no
environment switches):

- e = 0: T in diagonal form (2*n_pairs+1 nonzero diagonals), applied by the
  stencil chain :func:`apply_diag_chain` (kernel K0) — f32 throughout, no
  matrix.
- e > 0 with the band fitting (:func:`banded_fits`): banded squarings
  (K2), then the application chain: one application through K4, square
  tiles through packed tiles (K1) and the packed chain (K3), rectangular
  tiles (``bj > bs``) through K7.
- otherwise: dense T, built the way the JAX package builds it under
  ``IRN_TPU_MATPOW=fused``: the first squaring fused with the transition
  build (K6), the others dense squarings (K5); the applications x @ T stay
  ``torch.matmul``, as the JAX package leaves them to XLA's dot.

:func:`propagate_banded_batch` takes the same routes for B images of one
bucket; on the banded route their application chains run together (K8).

The default route's operator build, :func:`build_diag_operator`, is K10
(one launch) and the decode, :func:`decode`, is K15 (one cooperative
launch), so make_sem_seg's walk is K10 -> K0 -> K15 on the card, three
device operations.

With a mesh (``--rw_mesh_model k``, :class:`irn_tpu_torch.parallel.
rw_sharded.ModelMesh`) :func:`propagate` splits one walk over k devices as
the JAX package does on its model axis: the stencil with its columns split
(K0 per device and round, :func:`propagate_mesh_diag`) at e = 0 where each
block covers the stencil's halo, else the banded T with its rows split
(:func:`build_transition_mesh_banded`) where the band stays under a
quarter of the matrix, else the dense route with its squarings' rows
split. The JAX switch ``IRN_TPU_APPLY`` is not read: the stencil is always
selected (JAX ``diag_selected()`` True).

``matmul_dtype`` (None or ``torch.bfloat16``, ``--rw_matmul_dtype``) is the
operand mode of every product of the matrix routes, as in the JAX package:
bf16 rounds each operand to bf16 and accumulates in f32 (K2, K4, K5, K6 in
their bf16 modes; the products outside them, :func:`matpow_kernels.
matmul`, the same way). The stencil routes (e = 0) have no product and
ignore it. The banded route's chain of more than one application (K1 + K3,
K7, K8) has no bf16 mode yet and raises :class:`NotImplementedError`
before anything is built.

Public functions keep the JAX layouts: [C, cap_h, cap_w] seeds,
[cap_h, cap_w] edge, [n_pairs, n_pad] band table.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops import matpow
from irn_tpu_torch.ops import matpow_kernels as mk
from irn_tpu_torch.ops import paths
from irn_tpu_torch.ops.affinity import check_table, path_affinity, path_table
from irn_tpu_torch.ops.matpow_kernels import normalize_transition, pow_int


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class RandomWalkGeometry:
    """Static geometry of the capped random-walk grid.

    cap: (H, W) stride-4 grid cap (true images occupy a top-left window);
    padded: (H + r, W + 2r), the reference's boundary pad; n_vertices:
    padded pixel count; n_pad: n_vertices rounded up to a multiple of 512.
    """

    cap: Tuple[int, int]
    radius: int
    padded: Tuple[int, int]
    n_vertices: int
    n_pad: int
    path_set: paths.PathSet


@functools.lru_cache(maxsize=None)
def build_geometry(cap_h: int = 128, cap_w: int = 128,
                   radius: int = 5) -> RandomWalkGeometry:
    padded = (cap_h + radius, cap_w + 2 * radius)
    ps = paths.build_path_set(radius)
    if padded[0] - ps.radius_floor <= 0 or padded[1] - 2 * ps.radius_floor <= 0:
        raise ValueError(f"grid {(cap_h, cap_w)} too small for radius {radius}")
    n_vertices = padded[0] * padded[1]
    return RandomWalkGeometry(
        cap=(cap_h, cap_w), radius=radius, padded=padded,
        n_vertices=n_vertices, n_pad=_round_up(n_vertices, 512), path_set=ps,
    )


def _extent_mask(h: int, w: int, shape: Tuple[int, int],
                 device) -> torch.Tensor:
    """[shape] f32 mask, 1.0 where (row < h) & (col < w)."""
    rows = torch.arange(shape[0], device=device)[:, None]
    cols = torch.arange(shape[1], device=device)[None, :]
    return ((rows < h) & (cols < w)).to(torch.float32)


def diag_offsets(geom: RandomWalkGeometry) -> Tuple[int, ...]:
    """The static flat-grid diagonal offsets (one per path direction)."""
    pw = geom.padded[1]
    return tuple(
        int(dy) * pw + int(dx) for dy, dx in np.asarray(geom.path_set.dst_offsets)
    )


def band_values(geom: RandomWalkGeometry, edge_capped: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(vs [n_pairs, n_pad], doffs): A[i, i + doffs[k]] = vs[k, i] and
    A[j, j - doffs[k]] = vs[k, j - doffs[k]], plus the unit diagonal — the
    whole content of the banded affinity matrix."""
    r = geom.radius
    ph, pw = geom.padded
    ps = geom.path_set
    rf = ps.radius_floor
    ch, cw = ph - rf, pw - 2 * rf
    dev = edge_capped.device
    edge_padded = torch.ones((ph, pw), dtype=torch.float32, device=dev)
    edge_padded[: geom.cap[0], r : r + geom.cap[1]] = edge_capped.float()
    aff = path_affinity(edge_padded, ps).reshape(ps.n_pairs, ch, cw)
    v = torch.zeros((ps.n_pairs, ph, pw), dtype=torch.float32, device=dev)
    v[:, :ch, rf : rf + cw] = aff
    vs = F.pad(v.reshape(ps.n_pairs, -1), (0, geom.n_pad - ph * pw))
    return vs, diag_offsets(geom)


def _shift_r(v: torch.Tensor, d: int) -> torch.Tensor:
    """out[..., c] = v[..., c - d] with zero fill."""
    if not d:
        return v
    return F.pad(v, (d, 0))[..., :-d]


def build_diag_operator_plain(geom: RandomWalkGeometry,
                              edge_capped: torch.Tensor, beta: int = 10
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's plain twin: the JAX function term for term (the where-chain
    path affinity, ``pow_int``, the shifted column sums)."""
    vs, doffs = band_values(geom, edge_capped)
    w = pow_int(vs, beta)
    total = torch.zeros_like(w[0])
    for k, d in enumerate(doffs):  # Python sum()'s order in the JAX source
        total = total + (_shift_r(w[k], d) + w[k])
    return w, 1.0 / (1.0 + total)


# K10's staged schedule: csrc/diag_operator.cu's tile (kTileH, kTileW),
# threads per CTA, parameter words and shared memory per CTA
K10_TILE = (8, 16)
K10_THREADS = 1024
K10_WORDS = 960
K10_SMEM = 232448


def _k10_split(costs: Sequence[int], groups: int) -> Tuple[int, ...]:
    """Cut the costs into ``groups`` contiguous runs of about equal sums:
    each run's first index, then len(costs)."""
    total, acc, cuts = sum(costs), 0, [0]
    for i, c in enumerate(costs):
        if len(cuts) < groups and i > cuts[-1] and \
                acc + c / 2 > total * len(cuts) / groups:
            cuts.append(i)
        acc += c
    return tuple(cuts) + (len(costs),)


def diag_operator_schedule(table) -> Optional[np.ndarray]:
    """K10's staged schedule for an :class:`affinity.PathTable`, int32 in
    host memory (built once per path set, cached on the table), or None
    when the path set is too large to stage (the kernel then runs its
    direct schedule).

    Layout (``csrc/diag_operator.cu``, ``Schedule``): groups G, stack
    levels, nodes N, head cells, each group's first node (G + 1 words),
    then N nodes of two words (pair | depth << 12 | flags << 20, flags 1 a
    suffix, 2 extensions, 4 stored; head begin | head end << 16), the head
    cells as offsets dy * (tile_w + 4 rf) + dx into the staged edge, and per
    pair its destination's offset dy * (tile_w + 2 rf) + dx in the staged
    region. The pairs run in ``table.order`` (depth first over shared
    suffixes), cut into the most groups that a CTA of ``K10_THREADS``
    holds, of about equal cost; a group that starts below a root first
    runs its first node's ancestors unstored."""
    if "k10" in table.packed:
        return table.packed["k10"]
    rf, n_pairs = table.rf, table.n_pairs
    th, tw = K10_TILE
    ew, rw = tw + 4 * rf, tw + 2 * rf
    nq = (th + rf) * rw
    nq_pad = _round_up(nq, 32)
    parents = {s for s in table.suffix if s >= 0}
    levels = 1 + max((table.depth[p] for p in parents), default=-1)
    heads, span = [], {}
    for p in table.order:
        span[p] = (len(heads), len(heads) + table.head_length(p))
        heads += [dy * ew + dx for dy, dx in
                  table.cells[p][: table.head_length(p)]]
    order = list(table.order)
    cuts = (0, n_pairs)
    for g in range(min(K10_THREADS // nq_pad, n_pairs), 0, -1):
        smem = 4 * (n_pairs * nq + (th + 2 * rf) * ew + levels * g * nq_pad)
        if smem <= K10_SMEM:
            cuts = _k10_split([table.head_length(p) + 3 for p in order], g)
            break
    else:
        table.packed["k10"] = None
        return None

    def node(p, store):
        flags = ((table.suffix[p] >= 0) | (p in parents) << 1
                 | store << 2)
        b, e = span[p]
        return (p | table.depth[p] << 12 | flags << 20, b | e << 16)

    nodes, starts = [], []
    for g in range(len(cuts) - 1):
        starts.append(len(nodes))
        chain, a = [], table.suffix[order[cuts[g]]]
        while a >= 0:
            chain.append(a)
            a = table.suffix[a]
        nodes += [node(a, 0) for a in reversed(chain)]
        nodes += [node(p, 1) for p in order[cuts[g]: cuts[g + 1]]]
    starts.append(len(nodes))
    nb = [dy * rw + dx for dy, dx in (c[0] for c in table.cells)]
    words = np.asarray(
        [len(starts) - 1, levels, len(nodes), len(heads), *starts,
         *(v for nd in nodes for v in nd), *heads, *nb], np.int32)
    table.packed["k10"] = words if words.size <= K10_WORDS else None
    return table.packed["k10"]


@functools.lru_cache(maxsize=None)
def k10_args(cap: Tuple[int, int], radius: int,
             device: torch.device) -> tuple:
    """K10's launch arguments between its three tensors and beta, built
    once per grid, radius and device: the staged schedule's host address
    and words (the array lives on the cached PathTable), or the direct
    schedule's device tables, then the grid."""
    geom = build_geometry(*cap, radius=radius)
    table = path_table(geom.path_set)
    sched = diag_operator_schedule(table)
    if sched is None:
        check_table(table)
        cells, starts = table.tables(device)[:2]
        head = (None, 0, cells.data_ptr(), starts.data_ptr())
        n_cells = cells.shape[0]
    else:
        head = (sched.ctypes.data, sched.size, None, None)
        n_cells = 0
    return head + (geom.cap[0], geom.cap[1], geom.radius, table.rf,
                   geom.n_pad, geom.path_set.n_pairs, n_cells)


def build_diag_operator(geom: RandomWalkGeometry, edge_capped: torch.Tensor,
                        beta: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """T as its nonzero diagonals: (w [n_pairs, n_pad], inv [n_pad]) with
    T[c-d, c] = w[k, c-d], T[c+d, c] = w[k, c], T[c, c] = 1, all divided by
    colsum[c] = 1 + sum_k (w[k, c-d_k] + w[k, c]). ``edge_capped``:
    [cap_h, cap_w] f32. On the card one launch and no other device
    operation (K10, ``csrc/diag_operator.cu``; its schedule from
    :func:`diag_operator_schedule`), bit-equal to
    :func:`build_diag_operator_plain`."""
    if tuple(edge_capped.shape) != geom.cap or beta < 1:
        raise ValueError(f"diag_operator: edge {tuple(edge_capped.shape)} "
                         f"for the {geom.cap} grid, beta {beta} (>= 1)")
    if _build.is_plain(edge_capped):
        return build_diag_operator_plain(geom, edge_capped, beta)
    edge = edge_capped.contiguous()
    _build.check_cuda("diag_operator", edge)
    dev = edge.device
    w = torch.empty((geom.path_set.n_pairs, geom.n_pad), device=dev)
    inv = torch.empty((geom.n_pad,), device=dev)
    _build.launch("diag_operator", dev, edge.data_ptr(), w.data_ptr(),
                  inv.data_ptr(), *k10_args(geom.cap, geom.radius, dev),
                  beta)
    return w, inv


def apply_diag_chain_plain(x: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                           doffs: Sequence[int], n_apply: int) -> torch.Tensor:
    """K0's plain twin: the padded-slice loop of the JAX ``one()``, term for
    term, ``n_apply`` times."""
    h = max(doffs)
    n = x.shape[-1]
    wpad = F.pad(w, (h, h))
    for _ in range(n_apply):
        xpad = F.pad(x, (h, h))
        acc = x
        for k, d in enumerate(doffs):
            acc = (
                acc
                + xpad[:, h - d : h - d + n] * wpad[k, h - d : h - d + n][None]
                + xpad[:, h + d : h + d + n] * w[k][None]
            )
        x = acc * inv[None]
    return x


# K0's launch plan (csrc/diag_chain.cu): a thread-block cluster of up to 16
# CTAs per group of seed rows, each CTA holding a column slice and its halo
# in shared memory for the whole chain.
DIAG_CLUSTERS = tuple(range(16, 7, -1))  # CTAs per cluster, tried in order
DIAG_SMEM_MAX = 232448  # dynamic shared memory one CTA may use (bytes)

# (rows per cluster, CTAs per cluster, column slice m, halo hpad, w in
# shared memory)
DiagChainPlan = Tuple[int, int, int, int, bool]


def _diag_smem(rows: int, m: int, hpad: int, w_floats: int = 0) -> int:
    """Bytes of K0's shared memory per CTA: two mbarriers, two ping-pong
    buffers of ``rows`` x (slice + 2 halo) f32, and ``w_floats`` of w."""
    return 16 + 4 * (2 * rows * (m + 2 * hpad) + w_floats)


def diag_chain_plan(c: int, n: int, doffs: Sequence[int],
                    max_clusters: Callable[[DiagChainPlan], int],
                    rows: Optional[int] = None,
                    cluster: Optional[int] = None,
                    w_shared: Optional[bool] = None) -> DiagChainPlan:
    """K0's launch plan for C seed rows over n columns with offsets
    ``doffs``. Among 1, 2 or 4 seed rows per cluster, the cluster sizes of
    :data:`DIAG_CLUSTERS` (slices m = n / size rounded up to 4, halo the
    largest offset rounded up to 4) and w in shared memory (one window of
    m + d_k columns per diagonal) or from L2, whose buffers fit in a CTA's
    shared memory, it takes w in shared memory where any plan allows it,
    then the fewest waves of clusters (``max_clusters(plan)``: how many
    clusters of the plan the card holds at once), then the least work per
    CTA (rows x m). ``rows``, ``cluster``, ``w_shared`` pin that choice.
    Raises ValueError, with the limit, when no plan fits."""
    hmax = max(doffs)
    if n % 4 or n < 4 or min(doffs) < 0:
        raise ValueError(f"diag_chain: n={n} must be a positive multiple of "
                         f"4, offsets >= 0 (max {hmax})")
    hpad = _round_up(hmax, 4)
    best = None
    for s in (DIAG_CLUSTERS if cluster is None else (cluster,)):
        m = _round_up(-(-n // s), 4)
        w_floats = sum(m + d for d in doffs)
        for r in ((1, 2, 4) if rows is None else (rows,)):
            for ws in ((True, False) if w_shared is None else (w_shared,)):
                if _diag_smem(r, m, hpad, w_floats if ws else 0) \
                        > DIAG_SMEM_MAX:
                    continue
                plan = (r, s, m, hpad, ws)
                held = max_clusters(plan)
                if held < 1:
                    continue
                waves = -(-(-(-c // r)) // held)  # ceil(ceil(c / r) / held)
                key = (not ws, waves, r * m)
                if best is None or key < best[0]:
                    best = (key, plan)
    if best is None:
        m = _round_up(-(-n // max(DIAG_CLUSTERS)), 4)
        m_max = ((DIAG_SMEM_MAX - 16) // 8 - 2 * hpad) // 4 * 4
        raise ValueError(
            f"diag_chain: n={n} with offsets up to {hmax} needs "
            f"{_diag_smem(1, m, hpad)} bytes of shared memory per CTA, over "
            f"the {DIAG_SMEM_MAX} a CTA may use (n up to "
            f"{max(m_max, 0) * max(DIAG_CLUSTERS)} at this offset)")
    return best[1]


def diag_chain_max_clusters(device: torch.device, c: int, n: int,
                            doffs: Sequence[int], plan: DiagChainPlan) -> int:
    """How many clusters of K0's ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``); launches nothing."""
    rows, cluster, m, hpad, w_shared = plan
    held = ctypes.c_int(0)
    d = np.ascontiguousarray(doffs, dtype=np.int32)
    with torch.cuda.device(device):
        status = _build.load().irn_diag_chain_clusters(
            d.ctypes.data, len(doffs), c, n, rows, cluster, m, hpad,
            int(w_shared), ctypes.byref(held))
    if status != 0:
        raise RuntimeError(f"diag_chain: occupancy query failed with "
                           f"cudaError {status} for plan {plan}")
    return held.value


@functools.lru_cache(maxsize=None)
def card_diag_chain_plan(device: torch.device, c: int, n: int,
                         doffs: Tuple[int, ...]) -> DiagChainPlan:
    """:func:`diag_chain_plan` with the card's own cluster occupancy
    (cached per device and shape)."""
    return diag_chain_plan(c, n, doffs, functools.partial(
        diag_chain_max_clusters, device, c, n, doffs))


def apply_diag_chain(x: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                     doffs: Sequence[int], n_apply: int) -> torch.Tensor:
    """x @ T^n_apply with T in diagonal form (K0, ``csrc/diag_chain.cu``):
    one launch for the whole chain, bit-equal to
    :func:`apply_diag_chain_plain`. ``x``: [C, n]; ``w``: [n_pairs, n];
    ``inv``: [n]; on the card n a multiple of 4 and within
    :func:`diag_chain_plan`'s limit."""
    c, n = x.shape
    if w.shape != (len(doffs), n) or inv.shape != (n,):
        raise ValueError(
            f"apply_diag_chain: x {tuple(x.shape)} w {tuple(w.shape)} "
            f"inv {tuple(inv.shape)} doffs {len(doffs)}"
        )
    if n_apply < 0:
        raise ValueError(f"n_apply={n_apply} must be >= 0")
    if _build.is_plain(x):
        return apply_diag_chain_plain(x, w, inv, doffs, n_apply)
    _build.check_cuda("diag_chain", x, w, inv)
    if n_apply == 0:
        return x.clone()
    if max(doffs) >= n or min(doffs) < 0:
        raise ValueError(f"diag_chain: offsets outside [0, {n})")
    return launch_diag_chain(
        x, w, inv, doffs, n_apply,
        card_diag_chain_plan(x.device, c, n, tuple(doffs)))


def launch_diag_chain(x: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                      doffs: Sequence[int], n_apply: int,
                      plan: DiagChainPlan) -> torch.Tensor:
    """K0's one launch under ``plan`` (:func:`diag_chain_plan`), for CUDA
    tensors that :func:`apply_diag_chain` has checked."""
    c, n = x.shape
    rows, cluster, m, hpad, w_shared = plan
    out = torch.empty_like(x)
    d = np.ascontiguousarray(doffs, dtype=np.int32)
    _build.launch("diag_chain", x.device,
                  x.data_ptr(), w.data_ptr(), inv.data_ptr(), d.ctypes.data,
                  out.data_ptr(), len(doffs), c, n, n_apply, rows, cluster,
                  m, hpad, int(w_shared))
    return out


def _flat_seeds(geom: RandomWalkGeometry, cam_capped: torch.Tensor,
                edge_capped: torch.Tensor) -> torch.Tensor:
    """Boundary-damped seeds embedded in the padded flat grid [C, n_pad]."""
    r = geom.radius
    ch, cw = geom.cap
    c = cam_capped.shape[0]
    damped = cam_capped * (1.0 - edge_capped)[None]
    seeds = torch.zeros((c,) + geom.padded, dtype=torch.float32,
                        device=cam_capped.device)
    seeds[:, :ch, r : r + cw] = damped
    return F.pad(seeds.reshape(c, geom.n_vertices),
                 (0, geom.n_pad - geom.n_vertices))


def _unflatten_rw(geom: RandomWalkGeometry, rw: torch.Tensor) -> torch.Tensor:
    r = geom.radius
    ch, cw = geom.cap
    c = rw.shape[0]
    rw = rw[:, : geom.n_vertices].reshape((c,) + geom.padded)
    return rw[:, :ch, r : r + cw]


def propagate_diag(geom: RandomWalkGeometry, cam_capped: torch.Tensor,
                   edge_capped: torch.Tensor, beta: int = 10,
                   exp_times: int = 8) -> torch.Tensor:
    """:func:`propagate` at square_times=0 through the diagonal stencil."""
    w, inv = build_diag_operator(geom, edge_capped, beta)
    x = _flat_seeds(geom, cam_capped, edge_capped)
    rw = apply_diag_chain(x, w, inv, diag_offsets(geom), 1 << exp_times)
    return _unflatten_rw(geom, rw)


def band_halfwidth(geom: RandomWalkGeometry) -> int:
    """Affinity band halfwidth in flat-grid elements."""
    off = geom.path_set.dst_offsets
    return int(off[:, 0].max()) * geom.padded[1] + int(off[:, 1].max())


def banded_fits(geom: RandomWalkGeometry, exp_times: int, square_times: int,
                bs: int = 512) -> bool:
    """True when the band after ``square_times`` doublings stays under the
    matrix (otherwise unspecified out-of-band blocks would leak)."""
    if not 0 <= square_times <= exp_times:
        raise ValueError(f"square_times={square_times} not in [0, {exp_times}]")
    n = geom.n_pad
    if n % bs:
        return False
    h_final = band_halfwidth(geom) << square_times
    return 2 * (-(-h_final // bs)) + 1 < n // bs


def banded_sharded_fits(geom: RandomWalkGeometry, exp_times: int,
                        square_times: int, n_model: int) -> bool:
    """Gate of the row-split banded route: the rows split evenly over
    ``n_model`` >= 2 devices and the final band stays within a quarter of
    the matrix (beyond it the halo rows approach the whole matrix)."""
    if not 0 <= square_times <= exp_times:
        raise ValueError(f"square_times={square_times} not in [0, {exp_times}]")
    n = geom.n_pad
    if n_model < 2 or n % n_model:
        return False
    return 4 * (band_halfwidth(geom) << square_times) <= n


def diag_sharded_fits(geom: RandomWalkGeometry, n_model: int) -> bool:
    """Gate of the column-split stencil: the columns split evenly over
    ``n_model`` >= 2 devices and each block covers the stencil's halo (one
    neighbour hop per round)."""
    n = geom.n_pad
    return (n_model >= 2 and n % n_model == 0
            and n // n_model >= band_halfwidth(geom))


def propagate_mesh_diag(geom: RandomWalkGeometry, cam_capped: torch.Tensor,
                        edge_capped: torch.Tensor, beta: int, exp_times: int,
                        mesh) -> torch.Tensor:
    """:func:`propagate_diag` with the seed columns split over ``mesh``:
    the operator built on ``mesh.first`` (K10), then
    :func:`apply_transition_mesh_diag`; bit-equal to :func:`propagate_diag`.
    """
    return apply_transition_mesh_diag(
        geom, cam_capped, edge_capped,
        build_diag_operator(geom, edge_capped, beta), 1 << exp_times, mesh)


def apply_transition_mesh_diag(geom: RandomWalkGeometry,
                               cam_capped: torch.Tensor,
                               edge_capped: torch.Tensor,
                               winv: Tuple[torch.Tensor, torch.Tensor],
                               n_apply: int, mesh) -> torch.Tensor:
    """The seeds through ``n_apply`` applications of the diagonal operator
    ``winv`` = (w, inv), columns split over ``mesh``
    (:func:`rw_sharded.diag_apply`: K0 per device and round); the result
    on ``mesh.first``. The operator is seed-independent, so chunks reuse
    it."""
    from irn_tpu_torch.parallel import rw_sharded

    w, inv = winv
    seeds = _flat_seeds(geom, cam_capped, edge_capped)
    rw = rw_sharded.diag_apply(seeds, w, inv, diag_offsets(geom), n_apply,
                               mesh)
    return _unflatten_rw(geom, rw)


def build_transition_mesh_banded(geom: RandomWalkGeometry,
                                 edge_capped: torch.Tensor, beta: int,
                                 square_times: int, mesh,
                                 matmul_dtype=None) -> List[torch.Tensor]:
    """T^(2^square_times) as row blocks over ``mesh``, from end to end:
    each device assembles its rows of A from the band table, the column
    sums are summed over the devices, the squarings ship only the band's
    rows (:mod:`rw_sharded`; bf16 operands at ``matmul_dtype`` bf16, the
    carry f32). Check :func:`banded_sharded_fits` first."""
    from irn_tpu_torch.parallel import rw_sharded

    vs, doffs = band_values(geom, edge_capped)
    a = rw_sharded.assemble_rows(vs, doffs, geom.n_pad, mesh)
    t = rw_sharded.normalize_rows(a, beta, mesh)
    return rw_sharded.banded_power(t, square_times, band_halfwidth(geom),
                                   mesh, matmul_dtype)


def apply_transition_mesh_banded(geom: RandomWalkGeometry,
                                 cam_capped: torch.Tensor,
                                 edge_capped: torch.Tensor,
                                 t_blocks: Sequence[torch.Tensor],
                                 n_apply: int, mesh,
                                 matmul_dtype=None) -> torch.Tensor:
    """The seeds through ``n_apply`` applications of the row-split T of
    :func:`build_transition_mesh_banded` (partials summed in device
    order); the result on ``mesh.first``."""
    from irn_tpu_torch.parallel import rw_sharded

    seeds = _flat_seeds(geom, cam_capped, edge_capped)
    return _unflatten_rw(geom, rw_sharded.banded_apply(
        seeds, t_blocks, n_apply, mesh, matmul_dtype))


def dense_affinity(geom: RandomWalkGeometry,
                   edge_capped: torch.Tensor) -> torch.Tensor:
    """[n_pad, n_pad] symmetric affinity with a unit diagonal, written
    diagonal by diagonal from :func:`band_values`."""
    vs, doffs = band_values(geom, edge_capped)
    n = geom.n_pad
    a = torch.eye(n, dtype=torch.float32, device=edge_capped.device)
    for k, d in enumerate(doffs):
        a.diagonal(d).copy_(vs[k, : n - d])
        a.diagonal(-d).copy_(vs[k, : n - d])
    return a


def build_transition_banded(geom: RandomWalkGeometry,
                            edge_capped: torch.Tensor, beta: int = 10,
                            square_times: int = 2, bs: int = 512,
                            matmul_dtype=None) -> Tuple[torch.Tensor, int]:
    """T^(2^square_times) via banded squarings (K2, at ``matmul_dtype``).
    Returns (t, band); the out-of-band blocks of ``t`` are unspecified.
    Check :func:`banded_fits` first."""
    h = band_halfwidth(geom)
    t = normalize_transition(dense_affinity(geom, edge_capped), beta)
    for _ in range(square_times):
        t = mk.square_banded(t, h, bs=bs, matmul_dtype=matmul_dtype)
        h *= 2
    return t, h


def apply_transition_banded(geom: RandomWalkGeometry,
                            cam_capped: torch.Tensor,
                            edge_capped: torch.Tensor, t: torch.Tensor,
                            band: int, n_apply: int, bs: int = 512,
                            bj: Optional[int] = None,
                            matmul_dtype=None) -> torch.Tensor:
    """Seed propagation through a banded T (:func:`mk.apply_banded_chain`:
    K4, K1 + K3 or K7; at bf16 K4 alone, the chains raise)."""
    seeds = _flat_seeds(geom, cam_capped, edge_capped)
    c = seeds.shape[0]
    seeds = F.pad(seeds, (0, 0, 0, _round_up(c, 8) - c))
    rw = mk.apply_banded_chain(seeds, t, band, n_apply, bs=bs, bj=bj,
                               matmul_dtype=matmul_dtype)
    return _unflatten_rw(geom, rw[:c])


def transition_matrix(affinity: torch.Tensor, beta: int = 10,
                      exp_times: int = 8, matmul_dtype=None) -> torch.Tensor:
    """A^beta, column-normalize, then ``exp_times`` squarings => T^(2^e):
    the first squaring fused with the normalization (K6), the rest dense
    squarings (K5), each at ``matmul_dtype``."""
    if exp_times < 1:
        return normalize_transition(affinity, beta)
    t = mk.square_fused_first(affinity, beta, matmul_dtype)
    return matpow.matrix_power_squarings(t, exp_times - 1, matmul_dtype)


def build_transition(geom: RandomWalkGeometry, edge_capped: torch.Tensor,
                     beta: int = 10, exp_times: int = 8,
                     mesh=None, matmul_dtype=None) -> torch.Tensor:
    """Dense T^(2^e) from the edge map (seed-independent). With a ``mesh``
    of two or more devices the squarings run with T's rows split
    (:func:`rw_sharded.sharded_matrix_power`, :func:`mk.operand` at
    ``matmul_dtype`` as the JAX package leaves them to XLA's dot under a
    sharding) and T is gathered on ``mesh.first``."""
    if mesh is None or len(mesh) < 2:
        return transition_matrix(dense_affinity(geom, edge_capped), beta,
                                 exp_times, matmul_dtype)
    from irn_tpu_torch.parallel import rw_sharded

    t = normalize_transition(dense_affinity(geom, edge_capped), beta)
    return mesh.gather(rw_sharded.sharded_matrix_power(
        t, exp_times, mesh, matmul_dtype), 0)


def propagate_with_transition(geom: RandomWalkGeometry,
                              cam_capped: torch.Tensor,
                              edge_capped: torch.Tensor, t: torch.Tensor,
                              n_apply: int = 1,
                              matmul_dtype=None) -> torch.Tensor:
    """Boundary-damp the seeds and right-multiply them by a prebuilt T
    ``n_apply`` times (``torch.matmul``, f32 out; at ``matmul_dtype`` bf16
    T is rounded once and the seeds before each product, as the JAX
    function casts them)."""
    rw = _flat_seeds(geom, cam_capped, edge_capped)
    t = mk.operand(t, matmul_dtype)
    for _ in range(n_apply):
        rw = torch.matmul(mk.operand(rw, matmul_dtype), t)
    return _unflatten_rw(geom, rw)


def propagate(geom: RandomWalkGeometry, cam_capped: torch.Tensor,
              edge_capped: torch.Tensor, beta: int = 10, exp_times: int = 8,
              square_times: Optional[int] = None, mesh=None,
              mesh_banded: bool = True, matmul_dtype=None) -> torch.Tensor:
    """Dense propagation: T^(2^e) from :func:`build_transition`, then
    2^(E-e) applications (:func:`propagate_with_transition`).
    ``square_times`` None is the reference's pure squaring (e = E).

    With ``mesh`` (a :class:`rw_sharded.ModelMesh` of two or more devices;
    seeds and edge on ``mesh.first``) the walk splits over it as the JAX
    ``propagate(..., mesh=)`` dispatches: when ``mesh_banded``, at e = 0
    the column-split stencil (:func:`propagate_mesh_diag`) where
    :func:`diag_sharded_fits`, else the row-split banded T where
    :func:`banded_sharded_fits`; otherwise the dense T with its squarings'
    rows split. ``matmul_dtype``: the operand mode of every product (the
    stencil has none).

    Returns [C, cap_h, cap_w] propagated scores (zero beyond extent)."""
    e = exp_times if square_times is None else square_times
    if not 0 <= e <= exp_times:
        raise ValueError(f"square_times={e} not in [0, {exp_times}]")
    k = len(mesh) if mesh is not None else 1
    if mesh_banded and k > 1 and e == 0 and diag_sharded_fits(geom, k):
        return propagate_mesh_diag(geom, cam_capped, edge_capped, beta,
                                   exp_times, mesh)
    if mesh_banded and k > 1 and banded_sharded_fits(geom, exp_times, e, k):
        t_blocks = build_transition_mesh_banded(geom, edge_capped, beta, e,
                                                mesh, matmul_dtype)
        return apply_transition_mesh_banded(geom, cam_capped, edge_capped,
                                            t_blocks, 1 << (exp_times - e),
                                            mesh, matmul_dtype)
    t = build_transition(geom, edge_capped, beta, e, mesh, matmul_dtype)
    return propagate_with_transition(geom, cam_capped, edge_capped, t,
                                     1 << (exp_times - e), matmul_dtype)


def check_banded_dtype(geom: RandomWalkGeometry, exp_times: int,
                       square_times: int, bs: int = 512,
                       bj: Optional[int] = None, matmul_dtype=None) -> None:
    """Raises :class:`NotImplementedError` when the banded route at
    ``square_times`` (its band fitting) would run an application chain
    without a bf16 mode (:func:`mk.check_chain_dtype`): 0 < e < E at bf16.
    Called before any squaring runs."""
    h = band_halfwidth(geom) << square_times
    mk.check_chain_dtype(geom.n_pad, h, 1 << (exp_times - square_times), bs,
                         bs if bj is None else bj, matmul_dtype)


def propagate_banded(geom: RandomWalkGeometry, cam_capped: torch.Tensor,
                     edge_capped: torch.Tensor, beta: int = 10,
                     exp_times: int = 8, square_times: Optional[int] = None,
                     bs: int = 512, bj: Optional[int] = None,
                     matmul_dtype=None) -> torch.Tensor:
    """:func:`propagate` through the hand kernels: the diagonal stencil at
    e = 0 (no product: ``matmul_dtype`` does not apply), the banded kernels
    when the band fits (``bj``: the output tile width of the application
    chain, default ``bs``), else dense. At bf16 the banded route runs K2
    and, at e = E, K4; a chain of more applications raises before anything
    is built (:func:`check_banded_dtype`)."""
    e = exp_times if square_times is None else square_times
    if not 0 <= e <= exp_times:
        raise ValueError(f"square_times={e} not in [0, {exp_times}]")
    mk.check_dtype(matmul_dtype)
    if e == 0:
        return propagate_diag(geom, cam_capped, edge_capped, beta, exp_times)
    if not banded_fits(geom, exp_times, e, bs):
        return propagate(geom, cam_capped, edge_capped, beta, exp_times,
                         square_times=e, matmul_dtype=matmul_dtype)
    check_banded_dtype(geom, exp_times, e, bs, bj, matmul_dtype)
    t, band = build_transition_banded(geom, edge_capped, beta, e, bs,
                                      matmul_dtype)
    return apply_transition_banded(geom, cam_capped, edge_capped, t, band,
                                   1 << (exp_times - e), bs, bj,
                                   matmul_dtype)


def propagate_banded_batch(geom: RandomWalkGeometry, cams_capped: torch.Tensor,
                           edges_capped: torch.Tensor, beta: int = 10,
                           exp_times: int = 8,
                           square_times: Optional[int] = None,
                           bs: int = 512, matmul_dtype=None) -> torch.Tensor:
    """B same-bucket images' walks, each equal to :func:`propagate_banded`
    of that image: at e = 0 the diagonal stencil (K0) per image, no matrix;
    when the band outgrows the matrix, dense :func:`propagate` per image;
    otherwise each image's banded T^(2^e) (K2) goes to one batched chain,
    :func:`mk.apply_banded_chain_batched` (K1 per image, then K8 for all).
    The dense T's are built one at a time and each freed once packed, where
    the JAX function stacks them. ``matmul_dtype`` bf16 runs the stencil
    and the dense routes; the batched chain has no bf16 mode yet and
    raises before anything is built.

    ``cams_capped``: [B, C, cap_h, cap_w]; ``edges_capped``:
    [B, cap_h, cap_w]. Returns [B, C, cap_h, cap_w]."""
    e = exp_times if square_times is None else square_times
    if not 0 <= e <= exp_times:
        raise ValueError(f"square_times={e} not in [0, {exp_times}]")
    mk.check_dtype(matmul_dtype)
    bimg = cams_capped.shape[0]
    if e == 0:
        return torch.stack([
            propagate_diag(geom, cams_capped[b], edges_capped[b], beta,
                           exp_times)
            for b in range(bimg)
        ])
    if not banded_fits(geom, exp_times, e, bs):
        return torch.stack([
            propagate(geom, cams_capped[b], edges_capped[b], beta, exp_times,
                      square_times=e, matmul_dtype=matmul_dtype)
            for b in range(bimg)
        ])
    if matmul_dtype is not None:
        raise NotImplementedError(mk.CHAIN_BF16_TODO)
    seeds = torch.stack([
        _flat_seeds(geom, cams_capped[b], edges_capped[b])
        for b in range(bimg)
    ])
    c = seeds.shape[1]
    seeds = F.pad(seeds, (0, 0, 0, _round_up(c, 8) - c))
    ts = (build_transition_banded(geom, edges_capped[b], beta, e, bs)[0]
          for b in range(bimg))
    rw = mk.apply_banded_chain_batched(seeds, ts, band_halfwidth(geom) << e,
                                       1 << (exp_times - e), bs)
    return torch.stack([_unflatten_rw(geom, rw[b, :c]) for b in range(bimg)])


def pick_square_times_banded(exp_times: int) -> int:
    """Squarings before the banded chain: e = 0 (the stencil), the
    measured choice of the JAX package."""
    return 0


def pick_square_times(n_pad: int, exp_times: int, n_chunks: int = 1,
                      matmul_dtype=None) -> int:
    """Cost-model split for the dense path (the JAX package's constants,
    for f32 or bf16 operands): each squaring costs 2n^3 FLOPs, each
    application one streaming read of T, ``n_chunks`` times (seed-row
    chunks that reuse one T)."""
    mk.check_dtype(matmul_dtype)
    bf16 = matmul_dtype is not None
    sq = 2 * n_pad**3 / (1.5e14 if bf16 else 2.8e13)
    ap = (2 if bf16 else 4) * n_pad**2 / 8.2e11 * 1.8
    return min(
        range(exp_times + 1),
        key=lambda e: e * sq + n_chunks * (1 << (exp_times - e)) * ap,
    )


def _taps(n_out: int, n_in: int, device):
    """One axis of the x4 half-pixel bilinear (align_corners=False): taps
    i0, i1 and weights l0, l1, computed in f32 as K15 computes them."""
    src = torch.clamp((torch.arange(n_out, dtype=torch.float32, device=device)
                       + 0.5) * 0.25 - 0.5, min=0.0)
    i0 = torch.floor(src)
    lam = src - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=n_in - 1), 1.0 - lam, lam


def _upsample4(x: torch.Tensor, ty, tx) -> torch.Tensor:
    """x4 bilinear of [..., h, w] by explicit gathers, combined as
    h0l (w0l x00 + w1l x01) + h1l (w0l x10 + w1l x11)."""
    (y0, y1, hl0, hl1), (x0, x1, wl0, wl1) = ty, tx
    r0, r1 = x[..., y0, :], x[..., y1, :]
    hl0, hl1 = hl0[:, None], hl1[:, None]
    return (hl0 * (wl0 * r0[..., x0] + wl1 * r0[..., x1])
            + hl1 * (wl0 * r1[..., x0] + wl1 * r1[..., x1]))


def upsample_scores_plain(rw_capped: torch.Tensor, h4: int, w4: int,
                          h0: int, w0: int) -> torch.Tensor:
    """K15 pass 1's plain twin, in the kernel's operation order: the
    mask-normalized x4 bilinear over the (h4, w4) valid cells, zero beyond
    the (h0, w0) pixels. Returns [C, 4H, 4W]."""
    c, ch, cw = rw_capped.shape
    dev = rw_capped.device
    m4 = _extent_mask(h4, w4, (ch, cw), dev)
    ty, tx = _taps(4 * ch, ch, dev), _taps(4 * cw, cw, dev)
    rw_up = _upsample4(rw_capped * m4[None], ty, tx)
    m_up = _upsample4(m4, ty, tx)
    rw_up = torch.where(m_up > 1e-6, rw_up / torch.clamp(m_up, min=1e-6),
                        torch.zeros((), device=dev))
    pix = _extent_mask(h0, w0, (4 * ch, 4 * cw), dev)
    return rw_up * pix[None]


class Decoded(NamedTuple):
    """:func:`decode`'s outputs: labels [4H, 4W] int64 (0 = background, k
    >= 1 = seed row k-1, 0 beyond the pixel extent); the max-normalized
    scores [C, 4H, 4W] (None unless asked); the global max of the
    un-normalized scores (0-dim); best [4H, 4W], the max over rows of the
    normalized scores (None unless asked)."""

    labels: torch.Tensor
    scores: Optional[torch.Tensor]
    max_score: torch.Tensor
    best: Optional[torch.Tensor]


def decode_plain(rw_capped: torch.Tensor, h4: int, w4: int, h0: int, w0: int,
                 bg_thres: float, scores: bool = False,
                 best: bool = False) -> Decoded:
    """K15's plain twin: :func:`upsample_scores_plain`, max-normalize, the
    bg-threshold plane, argmax (step/make_sem_seg_labels.py:44-47)."""
    c, ch, cw = rw_capped.shape
    dev = rw_capped.device
    rw_up = upsample_scores_plain(rw_capped, h4, w4, h0, w0)
    pix = _extent_mask(h0, w0, (4 * ch, 4 * cw), dev)
    max_score = torch.max(rw_up)
    rw_up = rw_up / torch.clamp(max_score, min=1e-12)
    stacked = torch.cat(
        [torch.full((1, 4 * ch, 4 * cw), bg_thres, dtype=rw_up.dtype,
                    device=dev), rw_up], dim=0,
    )
    labels = torch.argmax(stacked, dim=0)
    labels = torch.where(pix > 0, labels, torch.zeros((), dtype=labels.dtype,
                                                       device=dev))
    return Decoded(labels, rw_up if scores else None, max_score,
                   rw_up.amax(0) if best else None)


def _decode_input(rw_capped: torch.Tensor) -> torch.Tensor:
    """K15's input: a contiguous f32 CUDA [C, H, W] tensor."""
    if rw_capped.dim() != 3 or 0 in rw_capped.shape:
        raise ValueError(f"decode: scores must be [C, H, W], got "
                         f"{tuple(rw_capped.shape)}")
    rw = rw_capped.contiguous()
    _build.check_cuda("decode", rw)
    return rw


def upsample_scores(rw_capped: torch.Tensor, h4: int, w4: int, h0: int,
                    w0: int) -> torch.Tensor:
    """x4 bilinear upsample with true extents: mask-normalized bilinear
    over the (h4, w4) valid cells, zero beyond the (h0, w0) pixels.
    Returns [C, 4H, 4W]. On the card K15's values alone (one launch),
    bit-equal to :func:`upsample_scores_plain`."""
    if _build.is_plain(rw_capped):
        return upsample_scores_plain(rw_capped, h4, w4, h0, w0)
    rw = _decode_input(rw_capped)
    c, ch, cw = rw.shape
    out = torch.empty((c, 4 * ch, 4 * cw), device=rw.device)
    _build.launch("decode", rw.device, rw.data_ptr(), out.data_ptr(), c, ch,
                  cw, h4, w4, h0, w0, entry="upsample_scores")
    return out


# K15's scratch: its barrier and exit counters and the max key
DECODE_SCRATCH_WORDS = 3


def decode(rw_capped: torch.Tensor, h4: int, w4: int, h0: int, w0: int,
           bg_thres: float, scores: bool = False, best: bool = False,
           labels_dtype: torch.dtype = torch.int64) -> Decoded:
    """x4 upsample, max-normalize, bg-threshold plane, argmax of the walk's
    [C, H, W] scores; ``scores`` / ``best`` ask for those outputs, and the
    labels come as ``labels_dtype`` (int64 or int32). On the card one
    cooperative launch and no other device operation (K15,
    ``csrc/decode.cu``), bit-equal to :func:`decode_plain`; without
    ``scores`` the [C, 4H, 4W] tensor is never written. The call allocates
    only what it returns; the kernel's scratch is allocated once per device
    and stream."""
    if labels_dtype not in (torch.int64, torch.int32):
        raise ValueError(f"decode: labels int64 or int32, not {labels_dtype}")
    if _build.is_plain(rw_capped):
        out = decode_plain(rw_capped, h4, w4, h0, w0, bg_thres, scores, best)
        return out._replace(labels=out.labels.to(labels_dtype))
    rw = _decode_input(rw_capped)
    c, ch, cw = rw.shape
    dev = rw.device
    labels = torch.empty((4 * ch, 4 * cw), dtype=labels_dtype, device=dev)
    max_score = torch.empty((), device=dev)
    top = torch.empty((4 * ch, 4 * cw), device=dev) if best else None
    rw_up = (torch.empty((c, 4 * ch, 4 * cw), device=dev) if scores
             else None)
    scratch = _build.stream_scratch("decode", dev, DECODE_SCRATCH_WORDS)
    _build.launch("decode", dev, rw.data_ptr(), scratch.data_ptr(),
                  max_score.data_ptr(), labels.data_ptr(),
                  int(labels_dtype == torch.int64),
                  top.data_ptr() if best else None,
                  rw_up.data_ptr() if scores else None, c, ch, cw, h4, w4,
                  h0, w0, ctypes.c_float(bg_thres))
    return Decoded(labels, rw_up, max_score, top)


def upsample_and_decode(rw_capped: torch.Tensor, h4: int, w4: int, h0: int,
                        w0: int, bg_thres: float):
    """x4 upsample, max-normalize, bg-threshold plane, argmax
    (step/make_sem_seg_labels.py:44-47). Returns (labels [4H, 4W] int64,
    0 = background and k >= 1 = seed row k-1; rw_up [C, 4H, 4W]
    max-normalized scores; max_score). Out-of-extent pixels are
    background. :func:`decode` with the scores."""
    labels, rw_up, max_score, _ = decode(rw_capped, h4, w4, h0, w0, bg_thres,
                                         scores=True)
    return labels, rw_up, max_score
