"""Time K13b's two designs on one card: the pair-major kernel that the port
runs (``csrc/path_max.cu``, through ``affinity.path_max_bwd``) and the
per-pixel kernel with every pair's winners staged in shared memory
(``tools/path_max_bwd_staged.cu``, built here on its own), at train_irn's
default shape (B 32, a 128 x 128 edge grid, radius 10) and at radius 5:

  python irn_tpu_torch/tools/probe_path_max_bwd.py [--root DIR] [--reps 20]

The port is imported from ``--root`` (default: the checkout this file lies
in), so that two trees' K13b can be timed on one card in turns, each in
its own process; the staged kernel is always this file's.

Inputs, made from seed 0 on the card: a sigmoid edge map, its winners
from K13a, a normal cotangent. Every tile of the staged kernel is first
held bit for bit to the port's K13b on those inputs and on a cotangent
with signed zeros, +-inf and a NaN (NaN compared as NaN), and to the plain
twin on odd [3, 37, 29] maps; a disagreement fails the run. Times are mean
device milliseconds per call (CUDA events, after one warm-up call), the
two designs timed in turns (port, staged tiles, port). Prints one JSON
line: the card's name and power limit (nvidia-smi), the root, ptxas's
registers and spills for the staged kernel, and per radius the port's ms
and, per tile and load group, the staged kernel's ms, shared memory,
threads and blocks per SM. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import re
import subprocess
import sys
from typing import Dict, List, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "path_max_bwd_staged.cu")
PX = 4  # x-adjacent pixels per thread, one __vcmpeq4
# (tile columns, tile rows) of the staged kernel
TILES = ((32, 4), (32, 8), (64, 4), (64, 8), (32, 16), (128, 4))
GROUPS = (4, 8)  # entries whose cotangent loads go out together
SMEM_MAX = 232448


def staged_tables(table, tx: int, ty: int, hw: Tuple[int, int]
                  ) -> Tuple[np.ndarray, int, int, int]:
    """(words int32, n_entries, max_rows, smem bytes) of the staged kernel
    for a TX x TY tile and an [H, W] grid; the layout is the .cu header's."""
    rf = table.rf
    ch, cw = hw[0] - rf, hw[1] - 2 * rf
    boxes, pairs, off, max_rows = [], [], 0, 0
    for path in table.cells:
        dys = [c[0] for c in path]
        dxs = [c[1] + rf for c in path]
        rows = ty + max(dys) - min(dys)
        cols = tx + max(dxs) - min(dxs)
        rw = (cols + 3 + 3) // 4 + 1  # the row's byte shift, one word spare
        boxes.append((off, rw, max(dys), max(dxs)))
        pairs += [off | rw << 16,
                  max(dys) | max(dxs) << 8 | min(dxs) << 16 | rows << 24]
        off += rows * rw
        max_rows = max(max_rows, rows)
    if off >= 1 << 16 or max(b[1] for b in boxes) >= 64:
        raise ValueError(f"staged tables: {off} words overflow the fields")
    ents = []
    for (dy, dx), plist in table.by_cell:
        dxr = dx + rf
        for i, (p, l) in enumerate(plist):
            woff, rw, dy1, dx1r = boxes[p]
            ents += [4 * woff + 4 * rw * (dy1 - dy) + dx1r - dxr | rw << 18
                     | l << 24 | (i == len(plist) - 1) << 31,
                     p * ch * cw - dy * cw - dxr,
                     ((p * ch - dy) * cw - dx1r) & 3]
    words = np.asarray(ents + pairs, np.int64).astype(np.uint32)
    return words.view(np.int32), len(ents) // 3, max_rows, 4 * off


def build(build_mod) -> Tuple[str, Dict[str, str]]:
    """nvcc the probe source into its own shared library with the port's
    flags (``ops/_build.py``), next to the port's kernels; returns (path,
    ptxas's register and spill lines)."""
    os.makedirs(build_mod.BUILD_DIR, exist_ok=True)
    out = os.path.join(build_mod.BUILD_DIR, "probe_path_max_bwd.so")
    proc = subprocess.run(
        [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-shared", "-I",
         build_mod.CSRC, "-o", out, SOURCE],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    text = proc.stdout + proc.stderr
    return out, dict(
        registers=";".join(re.findall(r"Used \d+ registers[^\n]*", text)),
        spills=";".join(re.findall(r"\d+ bytes spill stores[^\n]*", text)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from irn_tpu_torch.ops import _build, affinity, paths

    if not torch.cuda.is_available():
        raise RuntimeError("probe_path_max_bwd: needs a CUDA card")
    if not affinity.__file__.startswith(root + os.sep):
        raise RuntimeError(f"probe_path_max_bwd: imported {affinity.__file__}"
                           f", not from {root}")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    path, ptxas = build(_build)
    lib = ctypes.CDLL(path)
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.irn_path_max_bwd_staged.argtypes = [p_] * 4 + [i_] * 12 + [
        p_, ctypes.POINTER(ctypes.c_int)]
    lib.irn_path_max_bwd_staged_occupancy.argtypes = [
        i_, i_, i_, ctypes.POINTER(ctypes.c_int)]

    def staged(g, winner, table, hw, tile, tabs, group=GROUPS[0]):
        words, n_ent, max_rows, smem = tabs
        d_edge = torch.empty((g.shape[0],) + hw, device=dev)
        launched = ctypes.c_int(0)
        status = lib.irn_path_max_bwd_staged(
            g.data_ptr(), winner.data_ptr(), d_edge.data_ptr(),
            words.data_ptr(), g.shape[0], *hw, table.rf, table.n_pairs,
            n_ent, words.shape[0], *tile, max_rows, smem, group,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
        if status != 0:
            raise RuntimeError(f"staged K13b {tile}: cudaError {status}")
        return d_edge

    def special(shape, gen):
        g = torch.randn(shape, generator=gen)
        u = torch.rand(shape, generator=gen)
        g[u < 0.1] = 0.0
        g[(u >= 0.1) & (u < 0.2)] = -0.0
        g[(u >= 0.2) & (u < 0.25)] = float("inf")
        g[(u >= 0.25) & (u < 0.3)] = -float("inf")
        g.view(-1)[g.numel() // 3] = float("nan")
        return g

    def cuda_ms(fn) -> float:
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    gen = torch.Generator().manual_seed(0)
    radii: Dict[str, dict] = {}
    for radius in (10, 5):
        table = affinity.path_table(paths.build_path_set(radius))
        # odd maps first: ragged tiles on every side, against the twin
        for tile, group in itertools.product(TILES, GROUPS):
            tabs = staged_tables(table, *tile, (37, 29))
            if tabs[3] > SMEM_MAX:
                continue
            tabs = (torch.from_numpy(tabs[0]).to(dev),) + tabs[1:]
            e = torch.sigmoid(torch.randn((3, 37, 29), generator=gen))
            _, w = affinity.path_max_plain(e, table)
            g = torch.randn(tuple(w.shape), generator=gen)
            got = staged(g.to(dev), w.to(dev), table, (37, 29), tile, tabs,
                         group)
            want = affinity.path_max_bwd_plain(g, w, table, (37, 29))
            if not torch.equal(got.cpu(), want):
                raise RuntimeError(f"staged K13b {tile}, group {group}, "
                                   f"radius {radius}: odd map not bit-equal "
                                   "to the twin")
        hw = (128, 128)
        edge = torch.sigmoid(torch.randn((32,) + hw, generator=gen)).to(dev)
        _, winner = affinity.path_max_fwd(edge, table)
        shape = tuple(winner.shape)
        g = torch.randn(shape, generator=gen).to(dev)
        g_sp = special(shape, gen).to(dev)
        port = affinity.path_max_bwd(g, winner, table, hw)
        port_sp = affinity.path_max_bwd(g_sp, winner, table, hw)
        runs: List[dict] = []
        t_port = [cuda_ms(lambda: affinity.path_max_bwd(g, winner, table,
                                                        hw))]
        for tile, group in itertools.product(TILES, GROUPS):
            words, n_ent, max_rows, smem = staged_tables(table, *tile, hw)
            threads = tile[0] // PX * tile[1]
            if smem > SMEM_MAX:
                runs.append(dict(tile=tile, group=group, smem=smem,
                                 threads=threads, ms=None,
                                 note="windows exceed shared memory"))
                continue
            tabs = (torch.from_numpy(words).to(dev), n_ent, max_rows, smem)
            got = staged(g, winner, table, hw, tile, tabs, group)
            if not torch.equal(got, port):
                raise RuntimeError(f"staged K13b {tile}, group {group}, "
                                   f"radius {radius}: not bit-equal to the "
                                   "port's K13b")
            torch.testing.assert_close(
                staged(g_sp, winner, table, hw, tile, tabs, group), port_sp,
                rtol=0, atol=0, equal_nan=True)
            blocks = ctypes.c_int(0)
            status = lib.irn_path_max_bwd_staged_occupancy(
                threads, smem, group, ctypes.byref(blocks))
            if status != 0:
                raise RuntimeError(f"occupancy query: cudaError {status}")
            runs.append(dict(
                tile=tile, group=group, smem=smem, threads=threads,
                blocks_per_sm=blocks.value,
                ms=cuda_ms(lambda: staged(g, winner, table, hw, tile, tabs,
                                          group))))
        t_port.append(cuda_ms(lambda: affinity.path_max_bwd(g, winner,
                                                            table, hw)))
        radii[str(radius)] = dict(
            shape=[32, table.n_pairs, shape[2], shape[3]],
            entries=sum(len(c) for c in table.cells), port_ms=t_port,
            staged=runs)
    row = dict(card=card, root=root, reps=args.reps, staged_ptxas=ptxas,
               radii=radii)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
