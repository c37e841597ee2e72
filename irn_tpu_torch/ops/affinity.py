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
- :func:`irn_loss` (K16 forward and backward, ``csrc/irn_loss.cu``): the
  loss side after the path max, labels, maps, masked sums and weighted
  terms in one pass per direction, a ``torch.autograd.Function`` whose
  backward gives the cotangents of the path max's output and of the
  displacements; train_irn's step runs ``path_max`` then ``irn_loss``.
- :func:`affinity_labels_2d`, :func:`pair_displacement`,
  :func:`affinity_displacement_loss_maps` and :func:`irn_total_loss`: the
  same loss side (resnet50_irn.py:177-213, train_irn.py:58-69 of the
  reference) as an eager composition over a few large tensors, the
  counterpart of the JAX functions that the tests hold to them. The port's
  tensors are NCHW: edge logits [B, 1, H, W], displacements [B, 2, H, W];
  the loss maps come out in the JAX functions' layouts.
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

    def offsets(self, device: torch.device) -> torch.Tensor:
        """int32 [n_pairs, 2]: each pair's destination (dy, dx) on
        ``device`` (K16's constant table), built once."""
        key = ("offsets", str(device))
        if key not in self.packed:
            self.packed[key] = torch.from_numpy(np.ascontiguousarray(
                self.path_set.dst_offsets, dtype=np.int32)).to(device)
        return self.packed[key]

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
    return loss_maps(path_max(edge.contiguous(), table), dp, table)


def loss_maps(maxed: torch.Tensor, dp: torch.Tensor, table: PathTable
              ) -> AffinityLossMaps:
    """The four loss maps from the path max's output maxed [B, n_pairs,
    ch, cw] and dp [B, 2, H, W]: the eager composition that K16 replaces in
    the train step."""
    b, n, ch, cw = maxed.shape
    aff = (1.0 - maxed).reshape(b, n, ch * cw)
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


# -- K16: the loss side after the path max, forward and backward ----------

N_CLASSES_WITH_BG = 21
LOSS_KEYS = ("loss_pos_aff", "loss_neg_aff", "loss_dp_fg", "loss_dp_bg")
# K16 forward's blocks: 256 threads, two adjacent pixels of one image's
# flattened window each (512 pixels per block)
_LOSS_THREADS, _LOSS_PIXELS = 256, 2
# the second launch's threads (the block partials' f64 sum)
_LOSS_TOTAL_THREADS = 256


def _loss_checks(name: str, maxed: torch.Tensor, dp: torch.Tensor,
                 labels: torch.Tensor, table: PathTable) -> Tuple[int, int]:
    """(H, W) of ``dp`` after checking that maxed [B, n_pairs, ch, cw], dp
    [B, 2, H, W] and labels [B, H, W] agree with ``table``."""
    if dp.dim() != 4 or dp.shape[1] != 2:
        raise ValueError(f"{name}: dp must be [B, 2, H, W], got "
                         f"{tuple(dp.shape)}")
    b, _, h, w = dp.shape
    ch, cw = _window_dims(table, h, w)
    if tuple(maxed.shape) != (b, table.n_pairs, ch, cw):
        raise ValueError(f"{name}: maxed {tuple(maxed.shape)}, expected "
                         f"{(b, table.n_pairs, ch, cw)}")
    if tuple(labels.shape) != (b, h, w):
        raise ValueError(f"{name}: labels {tuple(labels.shape)}, expected "
                         f"{(b, h, w)}")
    return h, w


def _loss_masks(labels: torch.Tensor, table: PathTable, dtype: torch.dtype,
                n_classes: int):
    """K16's (bg, fg, neg) 0 / 1 masks [B, n_pairs, ch, cw] in ``dtype``
    (``affinity_labels_2d``'s)."""
    b, h, w = labels.shape
    ch, cw = _window_dims(table, h, w)
    return tuple(m.reshape(b, table.n_pairs, ch, cw).to(dtype)
                 for m in affinity_labels_2d(labels, table.path_set,
                                             n_classes))


def _loss_pairs(dp: torch.Tensor, table: PathTable) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
    """(pair = dp_src - dp_dst [B, 2, n_pairs, ch, cw], the offsets (dy,
    dx) [1, 2, n_pairs, 1, 1] in dp's dtype)."""
    b, _, h, w = dp.shape
    ch, cw = _window_dims(table, h, w)
    off = torch.from_numpy(np.ascontiguousarray(
        table.path_set.dst_offsets.T)).to(device=dp.device, dtype=dp.dtype)
    return (pair_displacement(dp, table.path_set).reshape(
        b, 2, table.n_pairs, ch, cw), off[None, :, :, None, None])


def _warp_tree(x: torch.Tensor) -> torch.Tensor:
    """The kernel's shuffle-down sum over the last dim (32 lanes): lane i
    adds lane i + 16, then i + 8, ..., lane 0 keeps the total."""
    for half in (16, 8, 4, 2, 1):
        x = x[..., :half] + x[..., half : 2 * half]
    return x[..., 0]


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """[..., warps, 32] -> [...]: each warp's tree, then the warps in
    order (K16's ``block_sum``)."""
    w = _warp_tree(x)
    acc = w[..., 0]
    for i in range(1, w.shape[-1]):
        acc = acc + w[..., i]
    return acc


def _loss_blocks(b: int, ch: int, cw: int) -> int:
    """K16 forward's first-launch blocks: ceil(ch cw / 512) per image."""
    return -(-(ch * cw) // (_LOSS_THREADS * _LOSS_PIXELS)) * b


def _loss_sum(per_pixel: torch.Tensor) -> torch.Tensor:
    """K16's f64 sum of per-pixel values [B, ch, cw]: per block of 512
    consecutive pixels of one image's flattened window, each thread's
    f64(pixel 2t) + f64(pixel 2t + 1), then the block's tree (pixels past
    the window add +0); then thread t of the second launch sums blocks t, t
    + 256, ... (image-major) from +0 in order, then the same tree."""
    b, ch, cw = per_pixel.shape
    span = _LOSS_THREADS * _LOSS_PIXELS
    nb = -(-(ch * cw) // span)
    x = torch.nn.functional.pad(per_pixel.double().reshape(b, ch * cw),
                                (0, nb * span - ch * cw))
    x = x.reshape(b, nb, _LOSS_THREADS, _LOSS_PIXELS)
    x = x[..., 0] + x[..., 1]
    parts = _block_sum(x.reshape(b, nb, _LOSS_THREADS // 32, 32)).reshape(-1)
    n = parts.shape[0]
    k = -(-n // _LOSS_TOTAL_THREADS)
    parts = torch.nn.functional.pad(parts, (0, k * _LOSS_TOTAL_THREADS - n))
    acc = torch.zeros(_LOSS_TOTAL_THREADS, dtype=torch.float64,
                      device=parts.device)
    for row in parts.reshape(k, _LOSS_TOTAL_THREADS):
        acc = acc + row
    return _block_sum(acc.reshape(_LOSS_TOTAL_THREADS // 32, 32))


def _loss_denominators(stats: torch.Tensor, dtype: torch.dtype):
    """(n_bg + eps, n_fg + eps, n_neg + eps, 2 n_fg + eps, 2 n_bg + eps),
    eps 1e-5, formed in f32 from the counts rounded to f32 once (JAX's
    masks are f32, so their sums and these sums are f32 in f64 runs too),
    then taken to ``dtype``."""
    eps = 1e-5
    n = stats[5:].float()
    return tuple(v.to(dtype) for v in (
        n[0] + eps, n[1] + eps, n[2] + eps, 2.0 * n[1] + eps,
        2.0 * n[0] + eps))


def _loss_terms(stats: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[total, pos, neg, dp_fg, dp_bg] in ``dtype`` from the f64 stats
    [s0..s4, n_bg, n_fg, n_neg], each sum rounded to ``dtype`` once
    (``irn_total_loss``'s formula)."""
    s = stats[:5].to(dtype)
    d_bg, d_fg, d_neg, d_dfg, d_dbg = _loss_denominators(stats, dtype)
    pos = (s[0] / d_bg) * 0.5 + (s[1] / d_fg) * 0.5
    neg = s[2] / d_neg
    dp_fg = s[3] / d_dfg
    dp_bg = s[4] / d_dbg
    total = (pos + neg) * 0.5 + (dp_fg + dp_bg) * 0.5
    return torch.stack([total, pos, neg, dp_fg, dp_bg])


def irn_loss_fwd_plain(maxed: torch.Tensor, dp: torch.Tensor,
                       labels: torch.Tensor, table: PathTable,
                       n_classes: int = N_CLASSES_WITH_BG
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16 forward's plain twin in the kernel's order (f32 or f64): per
    window pixel the five masked sums over the pairs in order, from +0
    (bg pos_aff, fg pos_aff, neg neg_aff, then fg |pair_c - off_c| and bg
    |pair_c| for c = dy, dx), their f64 sum by the kernel's blocks and
    trees, the exact label counts -> (loss [total, pos, neg, dp_fg, dp_bg]
    in maxed's dtype, stats f64 [s0..s4, n_bg, n_fg, n_neg])."""
    _loss_checks("irn_loss_fwd", maxed, dp, labels, table)
    bg, fg, neg = _loss_masks(labels, table, maxed.dtype, n_classes)
    a = 1.0 - maxed
    pos_aff = -torch.log(a + 1e-5)
    neg_aff = -torch.log(1.0 + 1e-5 - a)
    pair, off = _loss_pairs(dp, table)
    terms = (bg * pos_aff, fg * pos_aff, neg * neg_aff,
             fg[:, None] * torch.abs(pair - off), bg[:, None] * torch.abs(pair))
    s = [torch.zeros_like(maxed[:, 0]) for _ in range(5)]
    for p in range(table.n_pairs):
        for k in range(3):
            s[k] = s[k] + terms[k][:, p]
        for k in (3, 4):
            s[k] = s[k] + terms[k][:, 0, p]
            s[k] = s[k] + terms[k][:, 1, p]
    stats = torch.stack(
        [_loss_sum(v) for v in s]
        + [m.sum(dtype=torch.float64) for m in (bg, fg, neg)])
    return _loss_terms(stats, maxed.dtype), stats


def irn_loss_bwd_plain(g: torch.Tensor, stats: torch.Tensor,
                       maxed: torch.Tensor, dp: torch.Tensor,
                       labels: torch.Tensor, table: PathTable,
                       n_classes: int = N_CLASSES_WITH_BG
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16 backward's plain twin in the kernel's order: the cotangents g
    [5] of the forward's loss and its stats -> (d_maxed [B, n_pairs, ch,
    cw], d_dp [B, 2, H, W]). d_maxed = (bg k_bg + fg k_fg) / (a + 1e-5) -
    neg k_neg / (1.00001 - a); per pair t_c = (fg k_dfg) sgn(pair_c -
    off_c) + (bg k_dbg) sgn(pair_c), sgn(x) = x >= 0 ? 1 : -1 (JAX's abs
    JVP), added at the pair's source and subtracted at its destination,
    pairs ascending, from +0."""
    h, w = _loss_checks("irn_loss_bwd", maxed, dp, labels, table)
    dt = maxed.dtype
    d_bg, d_fg, d_neg, d_dfg, d_dbg = _loss_denominators(stats, dt)
    half_g = g[0] * 0.5
    g_pos = (half_g + g[1]) * 0.5
    k_bg = g_pos / d_bg
    k_fg = g_pos / d_fg
    k_neg = (half_g + g[2]) / d_neg
    k_dfg = (half_g + g[3]) / d_dfg
    k_dbg = (half_g + g[4]) / d_dbg
    bg, fg, neg = _loss_masks(labels, table, dt, n_classes)
    a = 1.0 - maxed
    d_maxed = ((bg * k_bg + fg * k_fg) / (a + 1e-5)
               - (neg * k_neg) / (1.0 + 1e-5 - a))
    pair, off = _loss_pairs(dp, table)

    def sgn(x):
        return torch.where(x >= 0, 1.0, -1.0).to(dt)

    t = ((fg * k_dfg)[:, None] * sgn(pair - off)
         + (bg * k_dbg)[:, None] * sgn(pair))  # [B, 2, n_pairs, ch, cw]
    rf = table.rf
    ch, cw = maxed.shape[-2:]
    d_dp = torch.zeros((dp.shape[0], 2, h, w), dtype=dt, device=dp.device)
    for p, (dy, dx) in enumerate(table.path_set.dst_offsets):
        dy, dx = int(dy), int(dx)
        d_dp[..., :ch, rf : rf + cw] += t[:, :, p]
        d_dp[..., dy : dy + ch, rf + dx : rf + dx + cw] -= t[:, :, p]
    return d_maxed, d_dp


def _loss_kernel_checks(name: str, table: PathTable, *tensors) -> None:
    _build.check_cuda(name, *tensors[:2])
    _build.check_cuda(name, tensors[2], dtype=torch.int32)
    if table.n_pairs > MAX_PAIRS or table.rf > 31:
        raise ValueError(f"{name}: {table.n_pairs} pairs at radius floor "
                         f"{table.rf} exceed the kernel's table (at most "
                         f"{MAX_PAIRS} pairs, radius floor 31)")


def irn_loss_fwd(maxed: torch.Tensor, dp: torch.Tensor,
                 labels: torch.Tensor, table: PathTable,
                 n_classes: int = N_CLASSES_WITH_BG
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16 forward: maxed [B, n_pairs, ch, cw] (K13a's output), dp [B, 2,
    H, W], labels [B, H, W] -> (loss [total, pos, neg, dp_fg, dp_bg],
    stats f64 [8]), on the device. Two launches on the card (the block
    sums, then their total and the terms), f32 and int32 labels only,
    equal to :func:`irn_loss_fwd_plain`."""
    h, w = _loss_checks("irn_loss_fwd", maxed, dp, labels, table)
    if _build.is_plain(maxed):
        return irn_loss_fwd_plain(maxed, dp, labels, table, n_classes)
    _loss_kernel_checks("irn_loss_fwd", table, maxed, dp, labels)
    b = dp.shape[0]
    n_blocks = _loss_blocks(b, *maxed.shape[-2:])
    dev = maxed.device
    partials = torch.empty((n_blocks, 8), dtype=torch.float64, device=dev)
    loss = torch.empty(5, device=dev)
    stats = torch.empty(8, dtype=torch.float64, device=dev)
    _build.launch("irn_loss_fwd", dev, maxed.data_ptr(), dp.data_ptr(),
                  labels.data_ptr(), table.offsets(dev).data_ptr(),
                  partials.data_ptr(), loss.data_ptr(), stats.data_ptr(), b,
                  h, w, table.rf, table.n_pairs, n_classes, n_blocks,
                  entry="loss_fwd")
    return loss, stats


def irn_loss_bwd(g: torch.Tensor, stats: torch.Tensor, maxed: torch.Tensor,
                 dp: torch.Tensor, labels: torch.Tensor, table: PathTable,
                 n_classes: int = N_CLASSES_WITH_BG
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16 backward: the cotangents g [5] of :func:`irn_loss_fwd`'s loss,
    its stats and inputs -> (d_maxed [B, n_pairs, ch, cw], d_dp [B, 2, H,
    W]). One launch on the card, no atomics, bit-equal to
    :func:`irn_loss_bwd_plain`."""
    _loss_checks("irn_loss_bwd", maxed, dp, labels, table)
    if tuple(g.shape) != (5,) or tuple(stats.shape) != (8,):
        raise ValueError(f"irn_loss_bwd: g {tuple(g.shape)} and stats "
                         f"{tuple(stats.shape)}, expected (5,) and (8,)")
    if _build.is_plain(maxed):
        return irn_loss_bwd_plain(g, stats, maxed, dp, labels, table,
                                  n_classes)
    _loss_kernel_checks("irn_loss_bwd", table, maxed, dp, labels)
    _build.check_cuda("irn_loss_bwd", g)
    _build.check_cuda("irn_loss_bwd", stats, dtype=torch.float64)
    b, _, h, w = dp.shape
    dev = maxed.device
    d_maxed = torch.empty_like(maxed)
    d_dp = torch.empty_like(dp)
    _build.launch("irn_loss_bwd", dev, maxed.data_ptr(), dp.data_ptr(),
                  labels.data_ptr(), table.offsets(dev).data_ptr(),
                  g.data_ptr(), stats.data_ptr(), d_maxed.data_ptr(),
                  d_dp.data_ptr(), b, h, w, table.rf, table.n_pairs,
                  n_classes, entry="loss_bwd")
    return d_maxed, d_dp


class IrnLoss(torch.autograd.Function):
    """loss [total, pos, neg, dp_fg, dp_bg] = K16 forward(maxed, dp,
    labels); its backward is K16's backward over the saved inputs and
    stats (no label mask or loss map is kept)."""

    @staticmethod
    def forward(ctx, maxed: torch.Tensor, dp: torch.Tensor,
                labels: torch.Tensor, table: PathTable) -> torch.Tensor:
        loss, stats = irn_loss_fwd(maxed, dp, labels, table)
        ctx.save_for_backward(maxed, dp, labels, stats)
        ctx.table = table
        return loss

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        maxed, dp, labels, stats = ctx.saved_tensors
        d_maxed, d_dp = irn_loss_bwd(g.contiguous(), stats, maxed, dp,
                                     labels, ctx.table)
        return d_maxed, d_dp, None, None


def irn_loss(maxed: torch.Tensor, dp: torch.Tensor, labels: torch.Tensor,
             table: PathTable):
    """train_irn's loss from the path max's output: maxed [B, n_pairs, ch,
    cw] (:func:`path_max`), dp [B, 2, H, W], the reduced labels [B, H, W]
    -> (total, the four loss scalars), as ``irn_total_loss`` over
    ``affinity_displacement_loss_maps`` and ``affinity_labels_2d``;
    differentiable in maxed and dp."""
    loss = IrnLoss.apply(maxed, dp.contiguous(), labels.contiguous(), table)
    return loss[0], {k: loss[i + 1] for i, k in enumerate(LOSS_KEYS)}
