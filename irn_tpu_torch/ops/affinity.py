"""Device ops over path geometry — the counterpart of
:mod:`irn_tpu.ops.affinity`: path affinities, affinity labels,
displacements and train_irn's loss maps.

- :func:`path_affinity`: per pair, affinity = 1 - max(edge over the path's
  cells), forward only, for the walk's operator build: an unrolled max
  chain over statically shifted window slices, strict ``>`` so ties keep
  the first cell (destination first), exactly as the JAX forward.
- :func:`path_max` (K13a forward, K13b backward, ``csrc/path_max.cu``): the
  same max with train_irn's winner-take-all gradient, a
  ``torch.autograd.Function`` that keeps only the int8 winning cell per
  (pair, pixel) for the backward (JAX ``_path_max``'s custom VJP).
- :func:`affinity_labels_2d`, :func:`pair_displacement`,
  :func:`affinity_displacement_loss_maps` and :func:`irn_total_loss`: the
  loss side (resnet50_irn.py:177-213, train_irn.py:58-69 of the
  reference), plain PyTorch over a few large tensors. The port's tensors
  are NCHW: edge logits [B, 1, H, W], displacements [B, 2, H, W]; the loss
  maps come out in the JAX functions' layouts.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from irn_tpu_torch.ops import _build
from irn_tpu_torch.ops.paths import PathSet, build_path_set

# the path sets the kernels take: path_max.cu's constant buffer holds two
# words per cell, diag_operator.cu's tables these sizes
MAX_CELLS = 6144
MAX_PAIRS = 1024
MAX_UNIQUE = 1024


def shifted_window(x: torch.Tensor, dy: int, dx: int, rf: int,
                   ch: int, cw: int) -> torch.Tensor:
    """Static slice of the (dy, dx)-shifted valid window of [..., H, W]."""
    return x[..., dy : dy + ch, rf + dx : rf + dx + cw]


def path_cells(path_set: PathSet) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Per pair, its (dy, dx) cells at their true length (padding repeats
    the destination and can never win the strict max)."""
    return tuple(
        tuple(
            (int(dy), int(dx))
            for dy, dx in path_set.cells[p][: int(path_set.lengths[p])]
        )
        for p in range(path_set.n_pairs)
    )


def path_affinity(edge2d: torch.Tensor, path_set: PathSet) -> torch.Tensor:
    """[..., H, W] edge map -> [..., n_pairs, (H - rf) * (W - 2rf)]
    affinities, pair order matching the concatenated length groups."""
    rf = path_set.radius_floor
    h, w = edge2d.shape[-2], edge2d.shape[-1]
    ch, cw = h - rf, w - 2 * rf
    vals = []
    for path in path_cells(path_set):
        dy, dx = path[0]
        m = shifted_window(edge2d, dy, dx, rf, ch, cw)
        for dy, dx in path[1:]:
            wl = shifted_window(edge2d, dy, dx, rf, ch, cw)
            m = torch.where(wl > m, wl, m)
        vals.append(m)
    aff = 1.0 - torch.stack(vals, dim=-3)  # [..., n_pairs, ch, cw]
    return aff.reshape(edge2d.shape[:-2] + (path_set.n_pairs, ch * cw))


# -- K13a / K13b: the path max with its winner-take-all gradient -----------

class PackedTables(NamedTuple):
    """A :class:`PathTable` on one device, as the kernels take it.

    ``cells`` int8 [n_cells, 2] and ``starts`` int32 [n_pairs + 1]: every
    pair's (dy, dx) cells, flat. ``fwd`` int32: K13a's schedule, per pair in
    ``order`` (pair, first head cell, end of its head cells, depth | has a
    suffix << 8 | has extensions << 9), then the head cells, dy << 16 | (dx
    + rf). ``levels``: K13a's stack depth, one level per depth that has a
    pair with extensions. ``bwd`` int32 [n_cells]: K13b's cells, per pair
    and position, u << 16 | dy << 8 | (dx + rf), u the cell's index in
    ``by_cell``."""

    cells: torch.Tensor
    starts: torch.Tensor
    fwd: torch.Tensor
    levels: int
    bwd: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class PathTable:
    """A path set's cells as :func:`path_max` walks them.

    ``cells``: per pair, its (dy, dx) cells (true length, destination
    first). ``by_cell``: each unique cell with its (pair, position) list,
    in the order JAX's ``_path_max_bwd`` builds its ``by_cell`` dict (pairs
    ascending, then positions): the backward's sum order. ``suffix``: per
    pair, the pair whose whole path is the longest proper tail of its own
    (at the same offsets), or -1; ``order``: the pairs depth first over
    those links (roots, then each pair's extensions ascending), so a suffix
    comes before every pair that extends it; ``depth``: links to a root.
    ``packed`` caches the kernels' tables per device."""

    path_set: PathSet
    cells: Tuple[Tuple[Tuple[int, int], ...], ...]
    by_cell: Tuple[Tuple[Tuple[int, int], Tuple[Tuple[int, int], ...]], ...]
    suffix: Tuple[int, ...]
    order: Tuple[int, ...]
    depth: Tuple[int, ...]
    packed: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def rf(self) -> int:
        return self.path_set.radius_floor

    @property
    def n_pairs(self) -> int:
        return len(self.cells)

    def head_length(self, p: int) -> int:
        """Cells of pair ``p`` before its suffix pair's path begins."""
        s = self.suffix[p]
        return len(self.cells[p]) - (len(self.cells[s]) if s >= 0 else 0)

    def tables(self, device: torch.device) -> PackedTables:
        """The kernels' tables on ``device``, built once (see
        :class:`PackedTables`)."""
        key = str(device)
        if key not in self.packed:
            rf = self.rf
            flat = [c for path in self.cells for c in path]
            starts = np.cumsum([0] + [len(p) for p in self.cells])
            parents = {s for s in self.suffix if s >= 0}
            nodes, heads = [], []
            for p in self.order:
                begin = len(heads)
                heads += [dy << 16 | (dx + rf)
                          for dy, dx in self.cells[p][: self.head_length(p)]]
                nodes.append((p, begin, len(heads),
                              self.depth[p] | (self.suffix[p] >= 0) << 8
                              | (p in parents) << 9))
            fwd = np.concatenate([np.asarray(nodes, np.int64).reshape(-1),
                                  np.asarray(heads, np.int64)])
            index = {c: u for u, (c, _) in enumerate(self.by_cell)}
            bwd = [index[c] << 16 | c[0] << 8 | (c[1] + rf) for c in flat]

            def put(a, dt):
                return torch.from_numpy(np.asarray(a, dt)).to(device)

            self.packed[key] = PackedTables(
                put(flat, np.int8), put(starts, np.int32),
                put(fwd, np.int32),
                1 + max((self.depth[p] for p in parents), default=-1),
                put(bwd, np.int32))
        return self.packed[key]


def _suffix_links(cells) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                  Tuple[int, ...]]:
    """(suffix, order, depth) of :class:`PathTable`."""
    index = {path: p for p, path in enumerate(cells)}
    suffix = tuple(
        next((index[path[k:]] for k in range(1, len(path))
              if path[k:] in index), -1)
        for path in cells)
    children: Dict[int, list] = {}
    for p, s in enumerate(suffix):
        children.setdefault(s, []).append(p)
    order, depth = [], [0] * len(cells)
    stack = list(reversed(children.get(-1, [])))
    while stack:
        p = stack.pop()
        order.append(p)
        if suffix[p] >= 0:
            depth[p] = depth[suffix[p]] + 1
        stack += reversed(children.get(p, []))
    return suffix, tuple(order), tuple(depth)


@functools.lru_cache(maxsize=None)
def _path_table(radius: int) -> PathTable:
    path_set = build_path_set(radius)
    # the winner is stored as int8: a path longer than 127 cells (radius
    # ~60+, production is 10) would wrap and route cotangents to the wrong
    # cells (JAX affinity.py:116)
    if path_set.max_path_length > 127:
        raise ValueError(f"path length {path_set.max_path_length} overflows "
                         "the int8 winner index of path_max")
    cells = path_cells(path_set)
    by_cell: Dict[Tuple[int, int], list] = {}
    for p, path in enumerate(cells):
        for l, c in enumerate(path):
            by_cell.setdefault(c, []).append((p, l))
    return PathTable(path_set, cells,
                     tuple((c, tuple(pl)) for c, pl in by_cell.items()),
                     *_suffix_links(cells))


def path_table(path_set: PathSet) -> PathTable:
    """The :class:`PathTable` of ``path_set`` (cached by radius)."""
    return _path_table(int(path_set.radius))


def _window_dims(table: PathTable, h: int, w: int) -> Tuple[int, int]:
    ch, cw = h - table.rf, w - 2 * table.rf
    if ch < 1 or cw < 1:
        raise ValueError(f"path_max: grid {(h, w)} has no valid window at "
                         f"radius floor {table.rf}")
    return ch, cw


def path_max_plain(edge: torch.Tensor, table: PathTable
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13a's plain twin: the strict-``>`` chain of :func:`path_affinity`,
    also returning the winning position. edge [B, H, W] -> (maxed [B,
    n_pairs, ch, cw], winner int8 [B, n_pairs, ch, cw])."""
    ch, cw = _window_dims(table, edge.shape[-2], edge.shape[-1])
    rf = table.rf
    vals, args = [], []
    for path in table.cells:
        dy, dx = path[0]
        m = shifted_window(edge, dy, dx, rf, ch, cw)
        a = torch.zeros(m.shape, dtype=torch.int8, device=edge.device)
        for l, (dy, dx) in enumerate(path[1:], 1):
            wl = shifted_window(edge, dy, dx, rf, ch, cw)
            take = wl > m
            m = torch.where(take, wl, m)
            a = a.masked_fill(take, l)
        vals.append(m)
        args.append(a)
    return torch.stack(vals, 1), torch.stack(args, 1)


def path_max_bwd_plain(g: torch.Tensor, winner: torch.Tensor,
                       table: PathTable, edge_hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """K13b's plain twin, JAX ``_path_max_bwd`` line for line: per unique
    cell, the sum of g over its (p, l) list where the winner is l, added
    into the cell's window of a zero edge gradient. g, winner [B, n_pairs,
    ch, cw] -> [B, H, W]."""
    h, w = edge_hw
    ch, cw = _window_dims(table, h, w)
    rf = table.rf
    grad = torch.zeros((g.shape[0], h, w), dtype=g.dtype, device=g.device)
    for (dy, dx), plist in table.by_cell:
        s = None
        for p, l in plist:
            contrib = torch.where(winner[:, p] == l, g[:, p], 0.0)
            s = contrib if s is None else s + contrib
        grad[..., dy : dy + ch, rf + dx : rf + dx + cw] += s
    return grad


def check_table(table: PathTable) -> None:
    n_cells = sum(len(p) for p in table.cells)
    if (n_cells > MAX_CELLS or table.n_pairs > MAX_PAIRS
            or len(table.by_cell) > MAX_UNIQUE):
        raise ValueError(
            f"path_max: {n_cells} cells, {table.n_pairs} pairs, "
            f"{len(table.by_cell)} unique cells exceed the kernels' tables "
            f"({MAX_CELLS}, {MAX_PAIRS}, {MAX_UNIQUE})")


def path_max_fwd(edge: torch.Tensor, table: PathTable
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13a: edge [B, H, W] f32 -> (maxed [B, n_pairs, ch, cw] f32, winner
    [B, n_pairs, ch, cw] int8), ch = H - rf, cw = W - 2 rf. One launch on
    the card, bit-equal to :func:`path_max_plain`."""
    if edge.dim() != 3:
        raise ValueError(f"path_max: edge must be [B, H, W], got "
                         f"{tuple(edge.shape)}")
    b, h, w = edge.shape
    ch, cw = _window_dims(table, h, w)
    if _build.is_plain(edge):
        return path_max_plain(edge, table)
    _build.check_cuda("path_max_fwd", edge)
    check_table(table)
    tab = table.tables(edge.device)
    maxed = torch.empty((b, table.n_pairs, ch, cw), device=edge.device)
    winner = torch.empty((b, table.n_pairs, ch, cw), dtype=torch.int8,
                         device=edge.device)
    _build.launch("path_max_fwd", edge.device, edge.data_ptr(),
                  maxed.data_ptr(), winner.data_ptr(), tab.fwd.data_ptr(), b,
                  h, w, table.rf, table.n_pairs, tab.fwd.shape[0], tab.levels)
    return maxed, winner


def path_max_bwd(g: torch.Tensor, winner: torch.Tensor, table: PathTable,
                 edge_hw: Tuple[int, int]) -> torch.Tensor:
    """K13b: the cotangent g [B, n_pairs, ch, cw] f32 of :func:`path_max_fwd`
    and its winners -> d_edge [B, H, W] f32. One launch on the card, no
    atomics, bit-equal to :func:`path_max_bwd_plain`."""
    h, w = edge_hw
    ch, cw = _window_dims(table, h, w)
    shape = (g.shape[0], table.n_pairs, ch, cw)
    if tuple(g.shape) != shape or tuple(winner.shape) != shape:
        raise ValueError(f"path_max_bwd: g {tuple(g.shape)} and winner "
                         f"{tuple(winner.shape)}, expected {shape}")
    if _build.is_plain(g):
        return path_max_bwd_plain(g, winner, table, edge_hw)
    _build.check_cuda("path_max_bwd", g)
    _build.check_cuda("path_max_bwd", winner, dtype=torch.int8)
    check_table(table)
    if table.n_pairs * ch * cw >= 2 ** 31:
        raise ValueError(f"path_max_bwd: {table.n_pairs} pairs of a {ch} x "
                         f"{cw} window overflow the kernel's int32 offsets")
    tab = table.tables(g.device)
    d_edge = torch.empty((g.shape[0], h, w), device=g.device)
    _build.launch("path_max_bwd", g.device, g.data_ptr(), winner.data_ptr(),
                  d_edge.data_ptr(), tab.starts.data_ptr(),
                  tab.bwd.data_ptr(), g.shape[0], h, w, table.rf,
                  table.n_pairs, tab.bwd.shape[0], len(table.by_cell))
    return d_edge


class PathMax(torch.autograd.Function):
    """maxed = K13a(edge); its backward is K13b over the saved int8
    winners (never the per-cell carries, JAX affinity.py:49-53)."""

    @staticmethod
    def forward(ctx, edge: torch.Tensor, table: PathTable) -> torch.Tensor:
        maxed, winner = path_max_fwd(edge, table)
        ctx.save_for_backward(winner)
        ctx.table = table
        ctx.edge_hw = tuple(edge.shape[-2:])
        return maxed

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (winner,) = ctx.saved_tensors
        return path_max_bwd(g.contiguous(), winner, ctx.table,
                            ctx.edge_hw), None


def path_max(edge: torch.Tensor, table: PathTable) -> torch.Tensor:
    """Differentiable per-pair path max: edge [B, H, W] -> [B, n_pairs,
    H - rf, W - 2 rf]; the gradient goes to each (pair, pixel)'s first
    maximal cell (the reference's max_pool2d backward)."""
    return PathMax.apply(edge, table)


# -- labels, displacements and the loss ------------------------------------

def label_pair_views(label2d: torch.Tensor, path_set: PathSet):
    """(src [..., 1, P], dst [..., n_pairs, P]) label views via slices."""
    rf = path_set.radius_floor
    h, w = label2d.shape[-2], label2d.shape[-1]
    ch, cw = h - rf, w - 2 * rf
    src = shifted_window(label2d, 0, 0, rf, ch, cw)
    src = src.reshape(label2d.shape[:-2] + (1, ch * cw))
    dst = torch.stack(
        [shifted_window(label2d, int(dy), int(dx), rf, ch, cw)
         for dy, dx in path_set.dst_offsets],
        dim=-3,
    )
    return src, dst.reshape(label2d.shape[:-2] + (path_set.n_pairs, ch * cw))


def affinity_labels_2d(label2d: torch.Tensor, path_set: PathSet,
                       n_classes_with_bg: int = 21):
    """{bg-pos, fg-pos, neg} float32 masks [..., n_pairs, P] from [..., H,
    W] int labels (0 bg, 1..20 classes, 255 ignore)."""
    lab_src, lab_dst = label_pair_views(label2d, path_set)
    valid = (lab_src < n_classes_with_bg) & (lab_dst < n_classes_with_bg)
    equal = lab_src == lab_dst
    pos = equal & valid
    bg_pos = (pos & (lab_src == 0)).float()
    fg_pos = (pos & (lab_src > 0)).float()
    neg = (~equal) & valid
    return bg_pos, fg_pos, neg.float()


def pair_displacement(dp: torch.Tensor, path_set: PathSet) -> torch.Tensor:
    """dp [B, 2, H, W] (dy, dx) -> [B, 2, n_pairs, P] src - dst differences
    over the valid window (one stack of the shifted views)."""
    rf = path_set.radius_floor
    b, _, h, w = dp.shape
    ch, cw = h - rf, w - 2 * rf
    src = dp[:, :, :ch, rf : rf + cw]
    dsts = torch.stack(
        [shifted_window(dp, int(dy), int(dx), rf, ch, cw)
         for dy, dx in path_set.dst_offsets],
        dim=2,
    )  # [B, 2, n_pairs, ch, cw]
    return (src[:, :, None] - dsts).reshape(b, 2, path_set.n_pairs, ch * cw)


class AffinityLossMaps(NamedTuple):
    pos_aff: torch.Tensor  # [B, n_pairs, P]
    neg_aff: torch.Tensor  # [B, n_pairs, P]
    dp_fg: torch.Tensor    # [B, 2, n_pairs, P]
    dp_bg: torch.Tensor    # [B, 2, n_pairs, P]


def affinity_displacement_loss_maps(edge_logit: torch.Tensor,
                                    dp: torch.Tensor, table: PathTable
                                    ) -> AffinityLossMaps:
    """The four raw per-pair loss maps (resnet50_irn.py:198-213) from edge
    logits [B, 1, H, W] and displacements [B, 2, H, W]; the path max runs
    through :func:`path_max` (K13a, K13b)."""
    edge = torch.sigmoid(edge_logit[:, 0])
    b, h, w = edge.shape
    ch, cw = _window_dims(table, h, w)
    maxed = path_max(edge.contiguous(), table)
    aff = (1.0 - maxed).reshape(b, table.n_pairs, ch * cw)
    pos_aff = -torch.log(aff + 1e-5)
    neg_aff = -torch.log(1.0 + 1e-5 - aff)

    pair = pair_displacement(dp, table.path_set)
    target = torch.from_numpy(
        table.path_set.dst_offsets.T.astype(np.float32)
    ).to(dp.device)[None, :, :, None]  # [1, 2, n_pairs, 1]
    dp_fg = torch.abs(pair - target)
    dp_bg = torch.abs(pair)
    return AffinityLossMaps(pos_aff, neg_aff, dp_fg, dp_bg)


def irn_total_loss(maps: AffinityLossMaps, bg_pos_label: torch.Tensor,
                   fg_pos_label: torch.Tensor, neg_label: torch.Tensor):
    """Masked reduction and weighting (train_irn.py:58-69). Labels are [B,
    n_pairs, P] float masks. Returns (total, the four loss scalars)."""
    eps = 1e-5
    bg_pos = torch.sum(bg_pos_label * maps.pos_aff) / (
        torch.sum(bg_pos_label) + eps)
    fg_pos = torch.sum(fg_pos_label * maps.pos_aff) / (
        torch.sum(fg_pos_label) + eps)
    pos = bg_pos / 2.0 + fg_pos / 2.0
    neg = torch.sum(neg_label * maps.neg_aff) / (torch.sum(neg_label) + eps)
    dp_fg = torch.sum(maps.dp_fg * fg_pos_label[:, None]) / (
        2.0 * torch.sum(fg_pos_label) + eps)
    dp_bg = torch.sum(maps.dp_bg * bg_pos_label[:, None]) / (
        2.0 * torch.sum(bg_pos_label) + eps)
    total = (pos + neg) / 2.0 + (dp_fg + dp_bg) / 2.0
    return total, {
        "loss_pos_aff": pos,
        "loss_neg_aff": neg,
        "loss_dp_fg": dp_fg,
        "loss_dp_bg": dp_bg,
    }
