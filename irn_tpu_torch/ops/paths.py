"""Radial pixel-pair path geometry ("PathIndex"): the port's own copy of
the path-set part of ``irn_tpu.ops.paths`` (numpy only; the same arrays for
the same radius). The grid-bound index (``GridPathIndex``) and the test
oracle ``unique_cells`` serve the affinity labels of train_irn and join the
port with that stage (ROADMAP queue 1 item 7).

A path set is a set of straight-line pixel paths from every source pixel to
all neighbours within a radius, used for the affinity labels and loss and,
at inference, the random-walk transition matrix. Its contract is the
reference geometry's (misc/indexing.py:6-88 of the reference):

- Direction vectors enumerate a half-plane so each unordered pair is counted
  once: first ``(0, x)`` for ``x in 1..r-1``, then ``(y, x)`` for ``y in
  1..r-1``, ``x in -(r-1)..(r-1)`` with ``x^2 + y^2 < r^2``.
- Each direction's path is the rasterized segment from (0,0) to (dy,dx): all
  integer cells of the bounding box whose squared perpendicular distance to
  the line is < 1, ordered far-to-near (destination first).
- Directions are grouped by path length; groups are ordered by increasing
  length; within a group, directions keep enumeration order.
- On an (H, W) grid the valid source window is
  ``H' = H - rf`` by ``W' = W - 2*rf`` with ``rf = ceil(radius) - 1``,
  offset ``(0, rf)``; a path cell (dy,dx) maps to the flat index of
  ``grid[dy : dy+H', rf+dx : rf+dx+W']``.

Radius 10 gives 152 pairs in 20 length groups (max path length 22); radius
5 gives 34 pairs in 9 groups. Besides the per-length-group arrays, a dense
``(n_pairs, L_max)`` cell table (padded with the destination cell, which is
idempotent under max) and per-pair destination offsets let the path-max
run as one unrolled chain of shifted-window maxes.
"""

from __future__ import annotations

import dataclasses
import functools
import numpy as np


@dataclasses.dataclass(frozen=True)
class PathSet:
    """Grid-independent path geometry for a given radius.

    Attributes:
      radius: search radius (pairs have squared distance < radius^2).
      radius_floor: window margin, ``ceil(radius) - 1``.
      paths_by_length: one int32 array ``[n_dirs_g, L_g, 2]`` of (dy, dx)
        path cells per length group, destination cell first.
      dst_offsets: int32 ``[n_pairs, 2]`` destination (dy, dx) per pair,
        concatenated over length groups (== each path's first cell).
      cells: int32 ``[n_pairs, L_max, 2]`` dense path-cell table, padded by
        repeating the destination cell (safe under max-reduction).
      lengths: int32 ``[n_pairs]`` true path lengths.
    """

    radius: float
    radius_floor: int
    paths_by_length: tuple
    dst_offsets: np.ndarray
    cells: np.ndarray
    lengths: np.ndarray

    @property
    def n_pairs(self) -> int:
        return int(self.dst_offsets.shape[0])

    @property
    def max_path_length(self) -> int:
        return int(self.cells.shape[1])


def _search_directions(radius: int) -> list:
    dirs = []
    for x in range(1, radius):
        dirs.append((0, x))
    for y in range(1, radius):
        for x in range(-radius + 1, radius):
            if x * x + y * y < radius * radius:
                dirs.append((y, x))
    return dirs


def _rasterize(direction) -> list:
    dy, dx = direction
    length_sq = dy * dy + dx * dx
    min_y, max_y = sorted((0, dy))
    min_x, max_x = sorted((0, dx))
    cells = []
    for y in range(min_y, max_y + 1):
        for x in range(min_x, max_x + 1):
            # squared perpendicular distance from cell to the segment's line
            dist_sq = (dy * x - dx * y) ** 2 / length_sq
            if dist_sq < 1:
                cells.append((y, x))
    # far-to-near: destination cell first (stable for ties, matching the
    # reference's stable sort by -(|y|+|x|))
    cells.sort(key=lambda c: -abs(c[0]) - abs(c[1]))
    return cells


@functools.lru_cache(maxsize=None)
def build_path_set(radius: int) -> PathSet:
    """Enumerate all half-plane paths within ``radius`` (pure host precompute).

    ``radius`` must be integral (the reference geometry enumerates
    integer direction grids, misc/indexing.py:18-30); a float-typed
    integral value (10.0 from a config) is accepted and normalized —
    it used to crash in range()."""
    if not float(radius).is_integer():
        raise ValueError(f"radius must be integral, got {radius!r}")
    radius = int(radius)
    radius_floor = int(np.ceil(radius) - 1)
    by_length: dict = {}
    for d in _search_directions(radius):
        cells = _rasterize(d)
        by_length.setdefault(len(cells), []).append(cells)

    lengths_sorted = sorted(by_length.keys())
    groups = tuple(
        np.asarray(by_length[L], dtype=np.int32) for L in lengths_sorted
    )
    dst = np.concatenate([g[:, 0] for g in groups], axis=0)

    n_pairs = int(dst.shape[0])
    l_max = max(lengths_sorted)
    cells = np.zeros((n_pairs, l_max, 2), dtype=np.int32)
    lengths = np.zeros((n_pairs,), dtype=np.int32)
    k = 0
    for g in groups:
        n_g, l_g, _ = g.shape
        cells[k : k + n_g, :l_g] = g
        # pad with the destination cell: max over the path is unchanged
        cells[k : k + n_g, l_g:] = g[:, :1]
        lengths[k : k + n_g] = l_g
        k += n_g

    return PathSet(
        radius=float(radius),
        radius_floor=radius_floor,
        paths_by_length=groups,
        dst_offsets=dst,
        cells=cells,
        lengths=lengths,
    )
