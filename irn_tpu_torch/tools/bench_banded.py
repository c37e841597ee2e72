"""Banded random-walk propagation sweep: square_times (e) x apply j-block,
then the batched chain; the counterpart of ``tools/bench_banded.py``.

The banded chain's HBM traffic per application is about n*(bj + 2h_e)
floats with h_e = h << e, while the application count is 2^(E-e): e trades
banded squaring FLOPs against thin-application traffic, and bj trades read
contiguity against band over-read. Three sweeps, each timing the FULL
propagate (operator build, squarings, application chain) per image at one
grid bucket:

1. the dense hybrid at ``pick_square_times`` (K6, K5, ``torch.matmul``);
2. ``propagate_banded`` for every e whose band fits, at bj in
   {512, 1024, 2048} (e = 0: the K0 stencil; e >= 1: K2, then K1 + K3 at
   bj = bs and K7 above it);
3. ``propagate_banded_batch`` at B in {1, 2, 4, 8} images per call (e >= 1:
   K2 per image, K1, then one K8 chain for the batch).

Everything runs in f32: the port has no bf16 operand mode (the JAX tool
times bf16 operands). The JAX tool reaches its batched kernel at e = 0 only
under ``IRN_TPU_APPLY``; the port reads no environment switch, so the
batched sweep takes ``--square_times`` (default ``pick_square_times_banded``,
i.e. 0, the stencil per image) and runs K8 with e >= 1.

Inputs come from a seeded ``torch.Generator``, fresh for every timed run,
made before the clock starts. A time is the best over ``--reps`` runs (after
one warm-up run) of the host clock around 8 images ended by a synchronize,
per image.

Usage:
  python -m irn_tpu_torch.tools.bench_banded                  # (96,128) bucket
  python -m irn_tpu_torch.tools.bench_banded --cap 128 128    # 512 px worst case
  python -m irn_tpu_torch.tools.bench_banded --batch_only --square_times 1
"""

from __future__ import annotations

import argparse
import itertools
import time
from typing import Iterable, List, Optional

import torch

from irn_tpu_torch.ops import random_walk as rw_mod
from irn_tpu_torch.tools import device_label, resolve_device, sync

EXP_TIMES = 8
BETA = 10


def make_inputs(geom, seed: int, dev: torch.device, c: int = 24):
    """(cam [c, cap_h, cap_w], edge [cap_h, cap_w]) uniform in [0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    ch, cw = geom.cap
    edge = torch.rand((ch, cw), generator=gen)
    cam = torch.rand((c, ch, cw), generator=gen)
    return cam.to(dev), edge.to(dev)


def _best_per_image(dev, make_groups, run, reps: int) -> float:
    """Best over ``reps`` timed runs (one warm-up run first) of the seconds
    per image; ``make_groups()`` gives fresh [(args, n_images), ...]."""
    best = float("inf")
    for r in range(reps + 1):
        groups = make_groups()
        sync(dev)
        t0 = time.perf_counter()
        for args, _ in groups:
            run(*args)
        sync(dev)
        if r:  # run 0 warms up
            best = min(best, (time.perf_counter() - t0)
                       / sum(k for _, k in groups))
    return best


def timed(geom, dev, e: int, bj: Optional[int], banded: bool = True,
          reps: int = 2, n_images: int = 8, bs: int = 512) -> float:
    """Seconds per image of one propagate (banded or dense) at split e."""
    seeds = itertools.count(0)

    def run(cam, edge):
        if banded:
            return rw_mod.propagate_banded(geom, cam, edge, BETA, EXP_TIMES,
                                           square_times=e, bs=bs, bj=bj)
        return rw_mod.propagate(geom, cam, edge, BETA, EXP_TIMES,
                                square_times=e)

    return _best_per_image(
        dev, lambda: [(make_inputs(geom, next(seeds), dev), 1)
                      for _ in range(n_images)], run, reps)


def timed_batch(geom, dev, e: int, bimg: int, reps: int = 2,
                n_images: int = 8, bs: int = 512) -> float:
    """Seconds per image of ``propagate_banded_batch`` over groups of
    ``bimg`` images."""
    seeds = itertools.count(2000)

    def group():
        ins = [make_inputs(geom, next(seeds), dev) for _ in range(bimg)]
        return (torch.stack([c for c, _ in ins]),
                torch.stack([ed for _, ed in ins])), bimg

    def run(cams, edges):
        return rw_mod.propagate_banded_batch(geom, cams, edges, BETA,
                                             EXP_TIMES, square_times=e, bs=bs)

    return _best_per_image(
        dev, lambda: [group() for _ in range(max(1, n_images // bimg))], run,
        reps)


def dense_sweep(geom, dev, label: str, reps: int = 2,
                n_images: int = 8) -> List[dict]:
    e = rw_mod.pick_square_times(geom.n_pad, EXP_TIMES)
    dt = timed(geom, dev, e, None, banded=False, reps=reps, n_images=n_images)
    print(f"dense hybrid e={e}: {dt * 1000:9.3f} ms/img ({label})", flush=True)
    return [dict(sweep="dense", e=e, ms=dt * 1000)]


def banded_sweep(geom, dev, label: str, reps: int = 2, n_images: int = 8,
                 es: Iterable[int] = range(EXP_TIMES + 1),
                 bjs: Iterable[int] = (512, 1024, 2048),
                 bs: int = 512) -> List[dict]:
    rows = []
    for e in es:
        if not rw_mod.banded_fits(geom, EXP_TIMES, e, bs):
            print(f"banded e={e}: band outgrows matrix, skipped", flush=True)
            continue
        for bj in bjs:
            if geom.n_pad % bj or bj % bs:
                continue
            dt = timed(geom, dev, e, bj, reps=reps, n_images=n_images, bs=bs)
            print(f"banded e={e} bj={bj}: {dt * 1000:9.3f} ms/img ({label})",
                  flush=True)
            rows.append(dict(sweep="banded", e=e, bj=bj, ms=dt * 1000))
    return rows


def batched_sweep(geom, dev, label: str, e: int, reps: int = 2,
                  n_images: int = 8, batch_sizes: Iterable[int] = (1, 2, 4, 8),
                  bs: int = 512) -> List[dict]:
    rows = []
    for bimg in batch_sizes:
        dt = timed_batch(geom, dev, e, bimg, reps=reps, n_images=n_images,
                         bs=bs)
        print(f"batched e={e} B={bimg}: {dt * 1000:9.3f} ms/img ({label})",
              flush=True)
        rows.append(dict(sweep="batched", e=e, B=bimg, ms=dt * 1000))
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cap", type=int, nargs=2, default=(96, 128))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--batch_only", action="store_true")
    ap.add_argument("--batch_sizes", type=int, nargs="+", default=(1, 2, 4, 8))
    ap.add_argument("--square_times", type=int,
                    default=rw_mod.pick_square_times_banded(EXP_TIMES),
                    help="e of the batched sweep (>= 1 runs K8)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    geom = rw_mod.build_geometry(*args.cap, radius=5)
    label = device_label(dev)
    print(f"bucket {tuple(args.cap)}: n_pad={geom.n_pad}, band "
          f"h={rw_mod.band_halfwidth(geom)} ({label})", flush=True)
    rows = []
    if not args.batch_only:
        rows += dense_sweep(geom, dev, label, args.reps)
        rows += banded_sweep(geom, dev, label, args.reps)
    rows += batched_sweep(geom, dev, label, args.square_times, args.reps,
                          batch_sizes=args.batch_sizes)
    return rows


if __name__ == "__main__":
    main()
