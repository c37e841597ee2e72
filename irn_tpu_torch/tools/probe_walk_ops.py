"""Time the default walk's operator build (K10) and decode (K15) call by
call:

  python irn_tpu_torch/tools/probe_walk_ops.py [--root DIR] [--reps 20]
      [--device cuda] [--small] [--out FILE]

Cases, made from seed 0 with numpy, at the walk's 96 x 128 bucket (the
smoke tree's images):

- ``diag_operator``: ``random_walk.build_diag_operator`` on a sigmoid edge
  map, radius 5, beta 10 (make_sem_seg's and make_ins_seg's call);
- ``decode C 8``: ``random_walk.decode`` of [8, 96, 128] scores at odd
  extents, int64 labels (make_sem_seg's call);
- ``decode C 8 scores best``: the same with the normalized scores and best;
- ``decode C 128 best int32``: the instance walk's call at its seed cap:
  best and int32 labels (a tree whose decode has no ``labels_dtype``
  converts its int64 labels, as its walk did);
- ``upsample C 8``: ``random_walk.upsample_scores`` (propagate_all's
  chunks).

Per case and call: the CUDA-event time, wrapper included (mean over
``--reps`` calls after one, back to back); the host time of one call
between two synchronizes (median over ``--reps``: what chip_smoke's
``layers`` steps time); the host time per call back to back, without a
synchronize (mean over ``--reps``: the wrapper's own cost while the card
keeps up); and, under torch.profiler, the card's own time of each device
row (kernels, copies, memsets) by name with their counts, and the device
operations per call. On the card also the host microseconds of pieces
every wrapper pays: a ``torch.cuda.current_stream`` object, a
``torch.cuda.device`` context, and the ctypes call of
``irn_upsample_scores`` alone (prepared arguments). Every output is held
to the plain twin on the same card (equal; NaN nowhere). ``--root``
imports ``irn_tpu_torch`` from another checkout (a parent's ``git
archive``), so one call profiles both trees in turns; run the file by its
path for that. Prints the card's name and power limit (nvidia-smi) and
one JSON line; ``--out`` writes the JSON there too.

``--device cpu`` runs the plain twins on the host clock (no device rows:
not a device time); ``--small`` cuts the bucket to 24 x 32 and C 128 to
16, for a test.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BUCKET = (96, 128)
ROWS = (8, 128)


def inputs(small: bool):
    """(edge [ch, cw], rw8 [8, ch, cw], rw128 [C, ch, cw], h4, w4, h0, w0),
    numpy f32: a sigmoid edge map; scores uniform in [0, 1) inside the
    (h4, w4) cells, zero outside."""
    import numpy as np

    ch, cw = (24, 32) if small else BUCKET
    c_big = 16 if small else ROWS[1]
    g = np.random.default_rng(0)
    edge = (1 / (1 + np.exp(-g.standard_normal((ch, cw))))).astype(
        np.float32)
    h4, w4 = ch - 3, cw - 5
    rws = []
    for c in (ROWS[0], c_big):
        x = np.zeros((c, ch, cw), np.float32)
        x[:, :h4, :w4] = g.random((c, h4, w4))
        rws.append(x)
    return edge, rws[0], rws[1], h4, w4, 4 * h4 - 2, 4 * w4 - 3


def device_rows(fn, reps: int):
    """Per call of fn (after a warm-up call): the card's own microseconds
    and count of each device row (kernels, copies, memsets) by name."""
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


def host_us(dev, fn, reps: int) -> float:
    """Mean host microseconds per call of fn, back to back without a
    synchronize (after one call)."""
    from irn_tpu_torch.tools import sync

    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    sync(dev)
    return seconds / reps * 1e6


def host_pieces(dev, reps: int) -> dict:
    """Host microseconds per call of what every wrapper pays (the card
    only): a current-stream object, a device context, a bare ctypes
    launch."""
    import ctypes

    import torch

    from irn_tpu_torch.ops import _build

    x = torch.zeros((8, 96, 128), device=dev)
    up = torch.empty((8, 384, 512), device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)

    def context():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(dev),
        "torch.cuda.device context": context,
        "ctypes call of irn_upsample_scores": lambda: lib.irn_upsample_scores(
            x.data_ptr(), up.data_ptr(), 8, 96, 128, 93, 123, 370, 489,
            stream, ctypes.byref(launched)),
    }
    return {k: host_us(dev, f, 20 * reps) for k, f in pieces.items()}


def calls(dev, small: bool):
    """name -> (call, twin, shape): the wrapper on ``dev`` and the plain
    twin on the same tensors (on the card the twins run as eager CUDA
    torch, on the CPU as themselves)."""
    import torch

    from irn_tpu_torch.ops import random_walk as rw

    edge_np, rw8_np, rw128_np, h4, w4, h0, w0 = inputs(small)
    edge = torch.from_numpy(edge_np).to(dev)
    rw8 = torch.from_numpy(rw8_np).to(dev)
    rw128 = torch.from_numpy(rw128_np).to(dev)
    geom = rw.build_geometry(*edge.shape, radius=5)
    bg = 0.35
    has_dtype = "labels_dtype" in inspect.signature(rw.decode).parameters

    def instance():
        if has_dtype:
            out = rw.decode(rw128, h4, w4, h0, w0, bg, best=True,
                            labels_dtype=torch.int32)
            return out.labels, out.best
        out = rw.decode(rw128, h4, w4, h0, w0, bg, best=True)
        return out.labels.to(torch.int32), out.best

    def instance_twin():
        out = rw.decode_plain(rw128, h4, w4, h0, w0, bg, best=True)
        return out.labels.to(torch.int32), out.best

    def decoded(out):
        return tuple(t for t in out if t is not None)

    shape = f"bucket {tuple(edge.shape)}, extents ({h4}, {w4}) cells, " \
            f"({h0}, {w0}) pixels"
    return {
        "diag_operator": (
            lambda: rw.build_diag_operator(geom, edge),
            lambda: rw.build_diag_operator_plain(geom, edge),
            f"edge {tuple(edge.shape)} radius 5 beta 10 -> w "
            f"[{geom.path_set.n_pairs}, {geom.n_pad}], inv"),
        "decode C 8": (
            lambda: decoded(rw.decode(rw8, h4, w4, h0, w0, bg)),
            lambda: decoded(rw.decode_plain(rw8, h4, w4, h0, w0, bg)),
            f"rw {tuple(rw8.shape)}, {shape}: int64 labels, max"),
        "decode C 8 scores best": (
            lambda: decoded(rw.decode(rw8, h4, w4, h0, w0, bg, scores=True,
                                      best=True)),
            lambda: decoded(rw.decode_plain(rw8, h4, w4, h0, w0, bg,
                                            scores=True, best=True)),
            f"rw {tuple(rw8.shape)}: labels, scores, max, best"),
        f"decode C {rw128.shape[0]} best int32": (
            instance, instance_twin,
            f"rw {tuple(rw128.shape)}: int32 labels and best (the instance "
            f"walk; labels_dtype in this tree: {has_dtype})"),
        "upsample C 8": (
            lambda: (rw.upsample_scores(rw8, h4, w4, h0, w0),),
            lambda: (rw.upsample_scores_plain(rw8, h4, w4, h0, w0),),
            f"rw {tuple(rw8.shape)} -> scores"),
    }


def run_case(dev, call, twin, shape: str, reps: int) -> dict:
    import torch

    from irn_tpu_torch.tools import device_ms

    got = [t.cpu() for t in call()]
    want = [t.cpu() for t in twin()]
    res = dict(shape=shape,
               equal=len(got) == len(want) and all(
                   a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want)),
               ms=device_ms(dev, call, reps), sync_ms=sync_ms(dev, call, reps),
               host_us=host_us(dev, call, reps))
    if dev.type == "cuda":
        rows = device_rows(call, reps)
        res.update(rows=rows,
                   device_us=sum(r["us"] for r in rows.values()),
                   device_ops=sum(r["count"] for r in rows.values()),
                   copies=sum(r["count"] for k, r in rows.items()
                              if "emcpy" in k or "emset" in k))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="checkout whose irn_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a 24 x 32 bucket and C 16 for C 128 (a test's size)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    from irn_tpu_torch.tools import device_label, resolve_device

    dev = resolve_device(args.device)
    card = device_label(dev)
    print(card, flush=True)
    res = dict(card=card, root=os.path.abspath(args.root), reps=args.reps,
               cases={})
    for name, (call, twin, shape) in calls(dev, args.small).items():
        r = run_case(dev, call, twin, shape, args.reps)
        res["cases"][name] = r
        print(f"{name}: {r['shape']}: {r['ms']:.4f} ms per call (events"
              f"{'' if dev.type == 'cuda' else ', host clock'}), "
              f"{r['sync_ms']:.4f} synchronized, {r['host_us']:.2f} us of "
              f"host time back to back; device "
              f"{r.get('device_us', float('nan')):.2f} us in "
              f"{r.get('device_ops', 0):g} operations ("
              f"{r.get('copies', 0):g} copies or memsets); equal "
              f"{r['equal']}", flush=True)
    if dev.type == "cuda":
        res["host_pieces_us"] = host_pieces(dev, args.reps)
        print(f"host us per call: {res['host_pieces_us']}", flush=True)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
