"""Time make_ins_seg's connected components and rank tables (K12a, K12b)
call by call:

  python irn_tpu_torch/tools/probe_ccl.py [--root DIR] [--reps 20]
      [--device cuda] [--small] [--out FILE]

Cases, made from seed 0 with numpy:

- ``basin``: ``ccl.cluster_from_basin`` on the stage's basin plane, 128 x
  128 cut to the extent (94, 125), k_cap 8 (six disc basins with 2%
  speckle; each pixel's centroid lands at its nearest disc's centre);
- ``map 384x512``: ``ccl.component_tables`` on a decoded label map of the
  (96, 128) grid bucket (64 x 64 blocks of labels 0-8), comp_cap 128;
- ``map 500x500``: the same at VOC's largest image (50 x 50 blocks);
- ``speckle cap 128`` / ``speckle cap 4096``: a 512 x 512 map of labels
  0-3 drawn per pixel (tens of thousands of components), the worst case
  for the rank.

Per case and call: the CUDA-event time, wrapper included (mean over
``--reps`` calls after one, back to back); the host time of one call
between two synchronizes (median over ``--reps``: what chip_smoke's
``layers`` steps time); and, under torch.profiler, the card's own time of
each launch and memset by name with their counts (ctypes launches sit
under no torch op, so they are read from the device rows). Every
output is held to the plain twin (``equal``). ``--root`` imports
``irn_tpu_torch`` from another checkout (a parent's ``git archive``), so
one call profiles both trees; run the file by its path for that. Prints
the card's name and power limit (nvidia-smi) and one JSON line; ``--out``
writes the JSON there too.

``--device cpu`` runs the plain twins on the host clock (no device rows:
not a device time); ``--small`` cuts every side by 8, for a test.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BASIN = (128, 128)
EXTENT = (94, 125)
K_CAP = 8
COMP_CAP = 128


def basin_case(h: int, w: int, ext, seed: int = 0):
    """(basin [h, w] bool, cent [2, h, w] int32): six disc basins of radius
    ~h / 32 inside the extent plus 2% speckle; every pixel's centroid is
    its nearest disc's centre."""
    import numpy as np

    g = np.random.default_rng(seed)
    centres = g.uniform((0, 0), ext, (6, 2))
    yy, xx = np.mgrid[:h, :w]
    d = np.hypot(yy[None] - centres[:, 0, None, None],
                 xx[None] - centres[:, 1, None, None])
    near = d.argmin(0)
    basin = (d.min(0) < max(h / 32, 1.5)) | (g.random((h, w)) < 0.02)
    cent = np.stack([np.minimum(centres[near, 0].astype(int), ext[0] - 1),
                     np.minimum(centres[near, 1].astype(int), ext[1] - 1)])
    return basin, cent.astype(np.int32)


def label_map(h: int, w: int, block: int, n_labels: int, seed: int = 0):
    """[h, w] int32: labels 0..n_labels - 1, constant over block x block
    squares (block 1: drawn per pixel)."""
    import numpy as np

    g = np.random.default_rng(seed)
    tiles = g.integers(0, n_labels, (-(-h // block), -(-w // block)))
    return np.kron(tiles, np.ones((block, block), int))[:h, :w].astype(
        np.int32)


def cases(small: bool):
    """name -> ("clusters", (basin, cent, extent, k_cap)) or ("tables",
    (labels, best, comp_cap)), numpy arrays."""
    import numpy as np

    s = 8 if small else 1
    bh, bw = BASIN[0] // s, BASIN[1] // s
    ext = (EXTENT[0] // s, EXTENT[1] // s)
    basin, cent = basin_case(bh, bw, ext)
    g = np.random.default_rng(1)
    out = {"basin": ("clusters", (basin, cent, ext, K_CAP))}
    for name, (h, w, block, n_labels, cap) in {
            "map 384x512": (384, 512, 64, 9, COMP_CAP),
            "map 500x500": (500, 500, 50, 9, COMP_CAP),
            "speckle cap 128": (512, 512, 1, 4, COMP_CAP),
            "speckle cap 4096": (512, 512, 1, 4, 4096)}.items():
        lab = label_map(h // s, w // s, max(block // s, 1), n_labels)
        best = g.random(lab.shape, dtype=np.float32)
        out[name] = ("tables", (lab, best, cap))
    return out


def device_rows(fn, reps: int):
    """Per call of fn (after a warm-up call): the card's own microseconds
    and count of each device row (kernels, memsets) by name."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = collections.defaultdict(lambda: [0.0, 0.0])
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows[e.key[:90]][0] += e.self_device_time_total / reps
            rows[e.key[:90]][1] += e.count / reps
    return {k: dict(us=v[0], count=v[1]) for k, v in rows.items()}


def sync_ms(dev, fn, reps: int) -> float:
    """Median host milliseconds of one call between two synchronizes
    (after one)."""
    from irn_tpu_torch.tools import sync

    fn()
    ts = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def run_case(kind, args, dev, reps: int) -> dict:
    import torch

    from irn_tpu_torch.ops import ccl
    from irn_tpu_torch.tools import device_ms

    if kind == "clusters":
        basin, cent, ext, k_cap = args
        b = torch.from_numpy(basin).to(dev)
        c = torch.from_numpy(cent).to(dev)

        def call():
            return ccl.cluster_from_basin(b, c, *ext, k_cap)

        def twin():  # CPU tensors: the plain twins
            return ccl.cluster_from_basin(b.cpu(), c.cpu(), *ext, k_cap)
        shape = f"basin {tuple(basin.shape)} extent {ext}, k_cap {k_cap}"
    else:
        lab, best, cap = args
        lt = torch.from_numpy(lab).to(dev)
        bt = torch.from_numpy(best).to(dev)

        def call():
            return ccl.component_tables(lt, bt, cap)

        def twin():
            return ccl.component_tables(lt.cpu(), bt.cpu(), cap)
        shape = f"labels {tuple(lab.shape)}, comp_cap {cap}"
    got = [t.cpu() for t in call()]
    want = [t.cpu() for t in twin()]
    res = dict(shape=shape,
               equal=all(torch.equal(a, b_) for a, b_ in zip(got, want)),
               count=int(got[-1]), ms=device_ms(dev, call, reps),
               sync_ms=sync_ms(dev, call, reps))
    if dev.type == "cuda":
        rows = device_rows(call, reps)
        res.update(rows=rows,
                   device_us=sum(r["us"] for r in rows.values()),
                   launches=sum(r["count"] for k, r in rows.items()
                                if "emset" not in k),
                   memsets=sum(r["count"] for k, r in rows.items()
                               if "emset" in k))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="checkout whose irn_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="every side / 8 (a test's size)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    from irn_tpu_torch.tools import device_label, resolve_device

    dev = resolve_device(args.device)
    card = device_label(dev)
    print(card, flush=True)
    res = dict(card=card, root=os.path.abspath(args.root), reps=args.reps,
               cases={})
    for name, (kind, case) in cases(args.small).items():
        r = run_case(kind, case, dev, args.reps)
        res["cases"][name] = r
        print(f"{name}: {r['shape']}: {r['ms']:.4f} ms per call (events"
              f"{'' if dev.type == 'cuda' else ', host clock'}), "
              f"{r['sync_ms']:.4f} synchronized; device "
              f"{r.get('device_us', float('nan')):.2f} us, "
              f"{r.get('launches', 0):g} launches + {r.get('memsets', 0):g} "
              f"memsets; count {r['count']}, equal {r['equal']}",
              flush=True)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
