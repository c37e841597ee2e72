"""Device connected components and the instance stage's rank tables — the
counterpart of :mod:`irn_tpu.ops.ccl_tpu`.

- K12a (:func:`min_label_plane`, :func:`min_label_plane_multi`,
  ``csrc/ccl.cu``): every nonzero pixel gets the smallest flat index of
  its 4-connected same-value component, background the sentinel ``H*W``.
  The fixpoint is unique, so the kernel's union-find (32 x 32 tiles
  labelled in shared memory, then the tile borders united in global
  memory by ``atomicMin`` links from larger to smaller roots, then the
  tile roots and the pixels compressed) and the twin's segmented
  min-scans give the same plane.
- K12b (:func:`cluster_masks`, :func:`rank_tables`, ``csrc/ccl.cu``): rank
  the distinct values ascending (the escape bucket, -1, first) into the
  ``[k_cap, H, W]`` cluster masks, and the components of a decoded label
  map by ``label * HW + minidx`` into the component id map, seed rows,
  sizes and max scores. The kernel compacts the candidates (the component
  roots), keeps the ``cap + 1`` smallest keys (a radix select when there
  are more), ranks those among themselves and scatters back (on the card
  ``cap`` is at most 4096); the twin is the JAX scan of ``k_cap + 1`` /
  ``comp_cap + 1`` masked minimums.

Every call is one cooperative launch (after a 4-byte memset of its grid
barrier's counter): K12a alone, K12b alone on a given labelling, or both,
as :func:`cluster_from_basin` and :func:`component_tables` run them. A
launch that runs both counts once under each in ``_build.LAUNCHES``. Each
call allocates one buffer, its outputs and scratch being views of it.

Counts (``n_found``, ``n_comp``) stay 0-dim device tensors: nothing here
waits for the host. A count of ``cap + 1`` flags overflow, and the stage
then redoes the image on the host path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from irn_tpu_torch.ops import _build

_BIG = int(np.iinfo(np.int32).max // 2)  # > any flat index or -1
# K12b keeps the cap + 1 smallest keys sorted in each block's shared
# memory, and the component tables sizes and scores per component there
TABLES_CAP_MAX = 4096


def _buffer(device, *words: int):
    """One int32 allocation cut into 1-D views of ``words`` elements each."""
    return torch.empty(sum(words), dtype=torch.int32,
                       device=device).split(words)


def _scratch_words(h: int, w: int, cap: int, clusters: bool) -> int:
    """K12b's scratch (csrc/ccl.cu: the launch's header, for the cluster
    masks the slot flags and each pixel's slot, candidates, kept keys)."""
    return int(_build.load().irn_ccl_scratch_words(h * w, cap,
                                                   int(clusters)))


def _check_cap(name: str, cap: int) -> None:
    if cap > TABLES_CAP_MAX:
        raise ValueError(f"{name}: cap {cap} over {TABLES_CAP_MAX} on the "
                         f"card")


def _seg_cummin(vals: torch.Tensor, brk: torch.Tensor, dim: int,
                reverse: bool) -> torch.Tensor:
    """Segmented running min along ``dim`` that restarts at every
    ``brk``-flagged element (out_i = brk_i ? v_i : min(out_{i-1}, v_i)).
    Each element's segment number rides the high 32 bits of an int64 key,
    decreasing along the scan, so ``cummin`` never carries a minimum past
    a segment start. ``vals`` lie in [0, 2^31)."""
    if reverse:
        vals, brk = vals.flip(dim), brk.flip(dim)
    seg = torch.cumsum(brk.to(torch.int64), dim)
    high = (seg.amax(dim, keepdim=True) + 1 - seg) << 32
    out = torch.cummin(high + vals.to(torch.int64), dim).values - high
    out = out.to(torch.int32)
    return out.flip(dim) if reverse else out


def _fixpoint(lab0: torch.Tensor, brks) -> torch.Tensor:
    """Sweeps of the four directional segmented min-scans until nothing
    changes (ccl_tpu.py:79-94)."""
    lab = lab0
    while True:
        nxt = lab
        for dim, reverse, brk in brks:
            nxt = _seg_cummin(nxt, brk, dim, reverse)
        if torch.equal(nxt, lab):
            return lab
        lab = nxt


def _iota(h: int, w: int, device) -> torch.Tensor:
    return torch.arange(h * w, dtype=torch.int32, device=device).reshape(h, w)


def min_label_plane_plain(mask: torch.Tensor) -> torch.Tensor:
    """K12a's twin on a bool mask (ccl_tpu.min_label_plane :55)."""
    h, w = mask.shape
    lab0 = torch.where(mask, _iota(h, w, mask.device),
                       torch.tensor(h * w, dtype=torch.int32,
                                    device=mask.device))
    brk = ~mask
    return _fixpoint(lab0, [(1, False, brk), (1, True, brk),
                            (0, False, brk), (0, True, brk)])


def min_label_plane_multi_plain(labels: torch.Tensor) -> torch.Tensor:
    """K12a's twin on an int32 label map, 0 (or below) background
    (ccl_tpu.min_label_plane_multi :180): segments also break wherever the
    neighbour before a pixel in the scan direction holds another value."""
    h, w = labels.shape
    bg = labels <= 0
    lab0 = torch.where(bg, torch.tensor(h * w, dtype=torch.int32,
                                        device=labels.device),
                       _iota(h, w, labels.device))
    pad = torch.nn.functional.pad(labels, (1, 1, 1, 1), value=-1)
    before = {(1, False): pad[1:-1, :-2], (1, True): pad[1:-1, 2:],
              (0, False): pad[:-2, 1:-1], (0, True): pad[2:, 1:-1]}
    return _fixpoint(lab0, [(d, r, bg | (labels != before[(d, r)]))
                            for d, r in ((1, False), (1, True), (0, False),
                                         (0, True))])


def _check_grid(name: str, h: int, w: int) -> None:
    if h * w >= 1 << 30:
        raise ValueError(f"{name}: grid {(h, w)} too large")


def _label(values: torch.Tensor, h_ext: int, w_ext: int) -> torch.Tensor:
    """One K12a launch: ``values`` uint8 (a mask, read inside the (h_ext,
    w_ext) extent) or int32 (a label map, 0 or below background)."""
    h, w = values.shape
    _check_grid("ccl_label", h, w)
    dtype = torch.uint8 if values.dtype == torch.uint8 else torch.int32
    _build.check_cuda("ccl_label", values, dtype=dtype)
    out, header = _buffer(values.device, h * w, 1)
    _build.launch("ccl_label", values.device, values.data_ptr(),
                  int(dtype == torch.uint8), out.data_ptr(),
                  header.data_ptr(), h, w, h_ext, w_ext)
    return out.view(h, w)


def min_label_plane(mask: torch.Tensor, h_ext: int = -1,
                    w_ext: int = -1) -> torch.Tensor:
    """[H, W] bool mask -> [H, W] int32 component-minimum flat indices,
    ``H*W`` off the mask (K12a). ``h_ext``, ``w_ext`` (default: the
    grid) clear the mask beyond that extent first."""
    h, w = mask.shape
    h_ext = h if h_ext < 0 else h_ext
    w_ext = w if w_ext < 0 else w_ext
    if _build.is_plain(mask):
        if (h_ext, w_ext) != (h, w):
            mask = mask & _extent(h, w, h_ext, w_ext, mask.device)
        return min_label_plane_plain(mask)
    return _label(mask.contiguous().view(torch.uint8), h_ext, w_ext)


def min_label_plane_multi(labels: torch.Tensor) -> torch.Tensor:
    """[H, W] int32 label map (0 = background) -> [H, W] int32: the
    minimum flat index of each pixel's 4-connected same-value component,
    ``H*W`` on the background (K12a)."""
    if _build.is_plain(labels):
        return min_label_plane_multi_plain(labels)
    h, w = labels.shape
    return _label(labels, h, w)


def _extent(h: int, w: int, h4: int, w4: int, device) -> torch.Tensor:
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    return (rows < h4) & (cols < w4)


def _rank_scan(v: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """The JAX scan: ``length`` successive minimums of ``v`` above the
    previous one, from ``start``; past exhaustion each is ``_BIG``."""
    big = torch.tensor(_BIG, dtype=v.dtype, device=v.device)
    prev = torch.tensor(start, dtype=v.dtype, device=v.device)
    us = []
    for _ in range(length):
        prev = torch.where(v > prev, v, big).min()
        us.append(prev)
    return torch.stack(us)


def cluster_masks_plain(lab: torch.Tensor, cent: torch.Tensor, h4: int,
                        w4: int, k_cap: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12b's twin of ccl_tpu.cluster_masks (:122), with uint8 masks."""
    h, w = lab.shape
    v = lab[cent[0].long(), cent[1].long()]
    v = torch.where(v >= h * w, -1, v)  # escape bucket, ranked first
    v = torch.where(_extent(h, w, h4, w4, lab.device), v, _BIG)
    us = _rank_scan(v, -2, k_cap + 1)
    found = us < _BIG
    masks = (v[None] == us[:k_cap, None, None]) & found[:k_cap, None, None]
    return masks.to(torch.uint8), found.sum().to(torch.int32)


def _cluster_launch(basin, lab: torch.Tensor, cent: torch.Tensor, h4: int,
                    w4: int, k_cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K12b cluster-mask launch: on the given K12a plane ``lab``, or
    with K12a on the uint8 ``basin`` first (``lab`` None)."""
    h, w = cent.shape[1:]
    _check_grid("cluster_masks", h, w)
    _check_cap("cluster_masks", k_cap)
    dev = cent.device
    masks, n_found, scratch, *plane = _buffer(
        dev, -(-k_cap * h * w // 4), 1, _scratch_words(h, w, k_cap, True),
        *([h * w] if lab is None else []))
    lab = plane[0] if lab is None else lab
    _build.launch("ccl_tables", dev,
                  None if basin is None else basin.data_ptr(),
                  lab.data_ptr(), cent.data_ptr(), masks.data_ptr(),
                  n_found.data_ptr(), scratch.data_ptr(), h, w, h4, w4,
                  k_cap, entry="cluster_masks",
                  also=() if basin is None else ("ccl_label",))
    masks = masks.view(torch.uint8)[: k_cap * h * w].view(k_cap, h, w)
    return masks, n_found[0]


def _check_cluster_args(h: int, w: int, cent: torch.Tensor, k_cap: int,
                        what: str) -> None:
    if cent.shape != (2, h, w) or k_cap < 1:
        raise ValueError(f"cluster_masks: {what} {(h, w)}, cent "
                         f"{tuple(cent.shape)}, k_cap {k_cap}")


def cluster_masks(lab: torch.Tensor, cent: torch.Tensor, h4: int, w4: int,
                  k_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank the distinct centroid-landing clusters ascending into a fixed
    stack (K12b): lab [H, W] int32 from :func:`min_label_plane`, cent
    [2, H, W] int32 end points inside the (h4, w4) extent (the kernel
    clamps an index past the grid; K11's end points never are). Returns (masks
    [k_cap, H, W] uint8, zero beyond the extent and past the distinct
    count; n_found int32 = min(distinct, k_cap + 1)). The escape bucket
    (a centroid on no basin) ranks first, then clusters by ascending min
    flat index: the host union-find's first-appearance order."""
    h, w = lab.shape
    _check_cluster_args(h, w, cent, k_cap, "lab")
    if _build.is_plain(lab):
        return cluster_masks_plain(lab, cent, h4, w4, k_cap)
    _build.check_cuda("ccl_tables", lab, cent, dtype=torch.int32)
    return _cluster_launch(None, lab, cent, h4, w4, k_cap)


def cluster_from_basin(basin: torch.Tensor, cent: torch.Tensor, h4: int,
                       w4: int, k_cap: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device twin of ``centroids.cluster_centroids_from_basin``: the
    basin [H, W] bool (the raw ``|dp| < thres`` predicate) is cut to the
    (h4, w4) extent and labelled (K12a), then the clusters are ranked
    (K12b), both in one launch on the card. Returns (masks [k_cap, H, W]
    uint8, n_found)."""
    h, w = basin.shape
    _check_cluster_args(h, w, cent, k_cap, "basin")
    if _build.is_plain(basin):
        return cluster_masks_plain(min_label_plane(basin, h4, w4), cent, h4,
                                   w4, k_cap)
    basin = basin.contiguous().view(torch.uint8)
    _build.check_cuda("ccl_label", basin, dtype=torch.uint8)
    _build.check_cuda("ccl_tables", cent, dtype=torch.int32)
    if cent.device != basin.device:
        raise ValueError(f"cluster_from_basin: basin on {basin.device}, "
                         f"cent on {cent.device}")
    return _cluster_launch(basin, None, cent, h4, w4, k_cap)


def _check_key_range(h: int, w: int) -> None:
    """key = label * HW + minidx must fit int32 for labels up to 256 (the
    JAX assert, ccl_tpu.py:255)."""
    if (1 << 31) // (h * w + 1) <= 256:
        raise ValueError(f"component_tables: grid {(h, w)} too large for "
                         f"int32 keys")


def rank_tables_plain(labels: torch.Tensor, minidx: torch.Tensor,
                      best: torch.Tensor, comp_cap: int):
    """K12b's twin of the table half of ccl_tpu.component_tables (:257-280):
    the scan of ``comp_cap + 1`` minimums of ``key = label * HW + minidx``,
    then ids, sizes and max scores by the ranked keys."""
    h, w = labels.shape
    _check_key_range(h, w)
    key = torch.where(labels > 0, labels * (h * w) + minidx, _BIG)
    us = _rank_scan(key, -1, comp_cap + 1)
    found = us < _BIG
    n_comp = found.sum().to(torch.int32)
    usk = us[:comp_cap]
    n_ranked = int(found[:comp_cap].sum())
    flat = key.reshape(-1)
    idx = torch.searchsorted(usk[:n_ranked], flat).clamp(max=max(
        n_ranked - 1, 0))
    hit = (usk[:n_ranked][idx] == flat) if n_ranked else torch.zeros_like(
        flat, dtype=torch.bool)
    comp_map = torch.where(hit, idx + 1, 0).to(torch.int32)
    sizes = torch.bincount(comp_map.long(), minlength=comp_cap + 1)[1:]
    scores = torch.zeros(comp_cap + 1, dtype=torch.float32,
                         device=labels.device).scatter_reduce(
        0, comp_map.long(), best.reshape(-1).float(), "amax")[1:]
    rows = torch.where(found[:comp_cap], usk // (h * w) - 1, 0)
    return (comp_map.reshape(h, w), rows.to(torch.int32),
            sizes.to(torch.int32), scores, n_comp)


def component_tables_plain(labels: torch.Tensor, best: torch.Tensor,
                           comp_cap: int):
    """The twin of ccl_tpu.component_tables (:230): K12a's twin, then
    K12b's."""
    return rank_tables_plain(labels, min_label_plane_multi_plain(labels),
                             best, comp_cap)


def _tables_launch(labels: torch.Tensor, minidx, best: torch.Tensor,
                   comp_cap: int):
    """One K12b table launch: on the given K12a plane ``minidx``, or with
    K12a on ``labels`` first (``minidx`` None)."""
    h, w = labels.shape
    _check_grid("component_tables", h, w)
    _check_cap("component_tables", comp_cap)
    _build.check_cuda("ccl_tables", labels, dtype=torch.int32)
    _build.check_cuda("ccl_tables", best)
    dev = labels.device
    if best.device != dev:
        raise ValueError(f"component_tables: labels on {dev}, best on "
                         f"{best.device}")
    comp_map, rows, sizes, scores, n_comp, scratch, *plane = _buffer(
        dev, h * w, comp_cap, comp_cap, comp_cap, 1,
        _scratch_words(h, w, comp_cap, False),
        *([h * w] if minidx is None else []))
    label = minidx is None
    minidx = plane[0] if label else minidx
    _build.launch("ccl_tables", dev, labels.data_ptr(), minidx.data_ptr(),
                  int(label), best.data_ptr(), comp_map.data_ptr(),
                  rows.data_ptr(), sizes.data_ptr(), scores.data_ptr(),
                  n_comp.data_ptr(), scratch.data_ptr(), h, w, comp_cap,
                  entry="component_tables",
                  also=("ccl_label",) if label else ())
    return (comp_map.view(h, w), rows, sizes, scores.view(torch.float32),
            n_comp[0])


def rank_tables(labels: torch.Tensor, minidx: torch.Tensor,
                best: torch.Tensor, comp_cap: int):
    """K12b's table half: ``minidx`` is K12a of ``labels``
    (:func:`min_label_plane_multi`). Returns what
    :func:`component_tables` returns."""
    h, w = labels.shape
    _check_key_range(h, w)
    if minidx.shape != (h, w) or best.shape != (h, w):
        raise ValueError(f"rank_tables: labels {tuple(labels.shape)}, minidx "
                         f"{tuple(minidx.shape)}, best {tuple(best.shape)}")
    if _build.is_plain(labels):
        return rank_tables_plain(labels, minidx, best, comp_cap)
    _build.check_cuda("ccl_tables", labels, minidx, dtype=torch.int32)
    return _tables_launch(labels, minidx, best, comp_cap)


def component_tables(labels: torch.Tensor, best: torch.Tensor,
                     comp_cap: int):
    """Components of a decoded label map [H, W] int32 (0 background),
    numbered by ascending (label, min flat index) — the host's per-row
    union-find ids concatenated — with the per-component tables:
    (comp_map [H, W] int32 ids 1..n, 0 on background and past the cap;
    rows [comp_cap] int32 seed row = label - 1; sizes [comp_cap] int32;
    scores [comp_cap] f32 = max of ``best`` over the component, floored
    at 0; n_comp int32 = min(components, comp_cap + 1)). K12a labels, K12b
    ranks: one launch on the card."""
    h, w = labels.shape
    _check_key_range(h, w)
    if best.shape != (h, w) or comp_cap < 1:
        raise ValueError(f"component_tables: labels {tuple(labels.shape)}, "
                         f"best {tuple(best.shape)}, comp_cap {comp_cap}")
    if _build.is_plain(labels):
        return component_tables_plain(labels, best, comp_cap)
    return _tables_launch(labels, None, best, comp_cap)
