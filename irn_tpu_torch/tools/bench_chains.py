"""Time the walk's chains over T's band tiles at the smoke run's shapes:
K3 (``packed_chain``), K1 + K3, K7 (``banded_chain``, bj 1024), K8
(``packed_chain_batched``, 4 images) and K3 on those 4 images one by one.

The port is imported from ``--root`` (default: the checkout this file lies
in), so that two trees of the port can be timed on one card one after the
other, in turns (A, B, B, A), each in its own process:

  python irn_tpu_torch/tools/bench_chains.py [--root DIR] [--reps 10]

Inputs, made from seed 0 on the card: the (96, 128) bucket's geometry
(n_pad 14336, radius 5, h 556), seed rows x [8, n], T from a random edge
map, T^2 by K2 (h 1112) with NaN in every block beyond its block band, K1's
tiles of T^2; K8 takes those and 3 more edge maps' tiles. Times are mean
device milliseconds per call (CUDA events, after one warm-up call). Prints one
JSON line: the card's name and power limit (nvidia-smi), the root, and per
chain its ms and kernel launches per call; where the tree has K8's plan
(``launch_packed_chain_batched``), also K8 at 1, 2 and 4 images with its
plan, held share and the shares of its CTAs' clock by phase. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N_APPLY = 128
BJ = 1024
B_BATCH = 4


def main(argv=None) -> dict:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.ops import matpow_kernels as mk
    from irn_tpu_torch.ops import random_walk as rw

    if not torch.cuda.is_available():
        raise RuntimeError("bench_chains: needs a CUDA card")
    if not mk.__file__.startswith(root + os.sep):
        raise RuntimeError(f"bench_chains: imported {mk.__file__}, not from "
                           f"{root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    gen = torch.Generator().manual_seed(0)
    geom = rw.build_geometry(96, 128, radius=5)
    n, h, bs = geom.n_pad, rw.band_halfwidth(geom), 512

    def t2_of_edge():
        edge = torch.rand((96, 128), generator=gen).to(dev) * 0.9
        t = rw.normalize_transition(rw.dense_affinity(geom, edge))
        t2 = mk.square_banded(t, h, bs)
        bi = torch.arange(n, device=dev) // bs
        return torch.where((bi[:, None] - bi[None, :]).abs() > -(-2 * h // bs),
                           torch.full((), float("nan"), device=dev), t2)

    x = torch.rand((8, n), generator=gen).to(dev)
    t2 = t2_of_edge()
    tp = mk.pack_banded(t2, 2 * h, bs)
    tps = [tp]
    for _ in range(B_BATCH - 1):
        tps.append(mk.pack_banded(t2_of_edge(), 2 * h, bs))
    tps = torch.stack(tps)
    xs = torch.rand((B_BATCH, 8, n), generator=gen).to(dev)

    def timed(name, fn):
        fn()
        torch.cuda.synchronize()
        _build.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        launches = {k: v // args.reps for k, v in _build.LAUNCHES.items()
                    if v}
        return name, dict(ms=start.elapsed_time(end) / args.reps,
                          launches=launches)

    runs = dict([
        timed("K3", lambda: mk.packed_chain(x, tp, N_APPLY, bs)),
        timed("K1 + K3", lambda: mk.packed_chain(
            x, mk.pack_banded(t2, 2 * h, bs), N_APPLY, bs)),
        timed("K7", lambda: mk.banded_chain(x, t2, 2 * h, N_APPLY, bs, BJ)),
        timed("K8", lambda: mk.packed_chain_batched(xs, tps, N_APPLY, bs)),
        timed("K3 one by one", lambda: [
            mk.packed_chain(xs[b], tps[b], N_APPLY, bs)
            for b in range(B_BATCH)]),
    ])
    if hasattr(mk, "launch_packed_chain_batched"):
        # K8 at 1, 2 and B_BATCH images on the card's plan: ms, the share of
        # the ELL entries held in shared memory, the CTAs' clock by phase
        kh = (tps.shape[2] // bs - 1) // 2
        for b in (1, 2, B_BATCH):
            plan = mk.card_packed_chain_plan(dev, n, bs, kh, b)
            _, stats, timing = mk.launch_packed_chain_batched(
                xs[:b], tps[:b], N_APPLY, bs, plan)
            stats = stats.double()
            cycles = timing.double().sum(0)
            runs[f"K8 at B {b}"] = dict(
                timed("", lambda: mk.launch_packed_chain_batched(
                    xs[:b], tps[:b], N_APPLY, bs, plan))[1],
                plan=plan,
                held_share=float(stats[..., 2].sum() / stats[..., 1].sum()),
                phase_shares=dict(zip(
                    ("prologue", "grid barriers", "x waits", "products",
                     "sums"), (cycles / cycles.sum()).tolist())))
    row = dict(card=card, root=root, n=n, h=2 * h, bs=bs, C=8,
               n_apply=N_APPLY, images=B_BATCH, reps=args.reps, runs=runs)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
