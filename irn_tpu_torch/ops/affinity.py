"""Path affinities from an edge map — the forward of
:func:`irn_tpu.ops.affinity.path_affinity`.

Per pair, affinity = 1 - max(edge over the path's cells): an unrolled max
chain over statically shifted window slices, strict ``>`` so ties keep the
first cell (destination first), exactly as the JAX forward. The
winner-take-all backward arrives with train_irn."""

from __future__ import annotations

from typing import Tuple

import torch

from irn_tpu_torch.ops.paths import PathSet


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
