"""Where K10's and K15's time goes on the card, by variant:

  python irn_tpu_torch/tools/probe_walk_variants.py [--reps 20] [--out FILE]

Builds ``csrc/diag_operator.cu`` (K10) and ``csrc/decode.cu`` (K15) as
they are and as variants (string edits of the sources, each into its own
library by nvcc with ``_build.NVCC_FLAGS``), each with ``%globaltimer``
stamps per CTA at its phase boundaries, and runs each through the port's
wrappers (``random_walk.build_diag_operator`` / ``decode`` with the
variant's library in place of the built one) at the walk's 96 x 128
bucket: K10 on a sigmoid edge map at radius 5, beta 10; K15 on [8, 96,
128] scores (int64 labels, make_sem_seg's call) and [128, 96, 128] (best,
int32 labels, the instance walk's).

Variants (:func:`variants`): K10 as built, with beta at run time (the
beta-10 instance off), 4 x 32 tiles, two pair groups and one; K15 as
built, with 256-thread CTAs where the values stay in registers, and with
every C recomputed (no register instance).

Per variant and case: equal to the plain twin (bit for bit), the card's
own microseconds per call (torch.profiler's device rows), and per phase
the first, mean and last CTA's stamp in microseconds after the first
CTA's start (K10: staged edge, phase 1, sums; K15: phase 1, barrier,
phase 2). Prints the card's name and power limit and one JSON line;
``--out`` writes the JSON there too. Run the file by its path. The card
only: there is nothing to build on a host without nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(ROOT, "irn_tpu_torch", "csrc")
STAMPS = 8

STAMP_DEF = r'''
__device__ unsigned long long g_stamp[8][4096];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamp[k][blockIdx.x + gridDim.x * blockIdx.y] = t;
  }
}
'''
STAMP_API = r'''
IRN_API int irn_get_stamps(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}
IRN_API int irn_clear_stamps() {
  static unsigned long long zeros[8][4096];
  return (int)cudaMemcpyToSymbol(g_stamp, zeros, sizeof(g_stamp));
}
'''


def _edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"probe_walk_variants: {old!r} found "
                         f"{text.count(old)} times in the source")
    return text.replace(old, new)


def _stamped(kernel: str, text: str) -> str:
    """The source with the stamp array, its reader and the phase stamps."""
    text = _edit(text, "namespace {\n", "namespace {\n" + STAMP_DEF)
    if kernel == "diag_operator":
        marks = (("  // the padded edge: rows from Y0 - rf",
                  "  stamp(0);\n  // the padded edge: rows from Y0 - rf"),
                 ("  __syncthreads();\n\n  const int grp",
                  "  __syncthreads();\n  stamp(1);\n\n  const int grp"),
                 ("  __syncthreads();\n\n  if (t < kTileH * kTileW) {",
                  "  __syncthreads();\n  stamp(2);\n\n"
                  "  if (t < kTileH * kTileW) {"),
                 ("      inv[flat] = __fdiv_rn(1.f, __fadd_rn(1.f, total));"
                  "\n    }\n  }\n}",
                  "      inv[flat] = __fdiv_rn(1.f, __fadd_rn(1.f, total));"
                  "\n    }\n  }\n  __syncthreads();\n  stamp(3);\n}"))
    else:
        marks = (("  unsigned key = 0;\n  float v[",
                  "  stamp(0);\n  unsigned key = 0;\n  float v["),
                 ("  key = __reduce_max_sync(0xffffffffu, key);\n",
                  "  stamp(1);\n  key = __reduce_max_sync(0xffffffffu, key);"
                  "\n"),
                 ("  irn::hopper::grid_barrier(a.sync, 1);\n",
                  "  irn::hopper::grid_barrier(a.sync, 1);\n  stamp(2);\n"),
                 ("  // the last CTA out zeroes",
                  "  __syncthreads();\n  stamp(3);\n"
                  "  // the last CTA out zeroes"))
    for old, new in marks:
        text = _edit(text, old, new)
    return text + STAMP_API


def variants() -> dict:
    """name -> (kernel, source text, random_walk overrides): the stamped
    sources as built and with each variant's edits."""
    src = {k: open(os.path.join(CSRC, f"{k}.cu")).read()
           for k in ("diag_operator", "decode")}
    k10 = _stamped("diag_operator", src["diag_operator"])
    k15 = _stamped("decode", src["decode"])
    return {
        "K10 as built": ("diag_operator", k10, {}),
        "K10 beta at run time": ("diag_operator", _edit(
            k10, "beta == 10 ? diag_operator_staged<10>",
            "false ? diag_operator_staged<10>"), {}),
        "K10 4x32 tiles": ("diag_operator", _edit(_edit(
            k10, "constexpr int kTileH = 8;", "constexpr int kTileH = 4;"),
            "constexpr int kTileW = 16;", "constexpr int kTileW = 32;"),
            {"K10_TILE": (4, 32)}),
        "K10 two groups": ("diag_operator", k10, {"K10_THREADS": 640}),
        "K10 one group": ("diag_operator", k10, {"K10_THREADS": 320}),
        "K15 as built": ("decode", k15, {}),
        "K15 256-thread CTAs": ("decode", _edit(
            k15, "return kC > 0 ? 512 : 256;", "return 256;"), {}),
        "K15 recomputed": ("decode", _edit(_edit(_edit(
            k15,
            "  int e = try_launch<8, 1>(a, stream, launched, &done);\n",
            "  int e = 0;\n"),
            "  if (!e && !done) e = try_launch<8, 2>(a, stream, launched, "
            "&done);\n", ""),
            "  if (!e && !done) e = try_launch<16, 2>(a, stream, launched, "
            "&done);\n", ""), {}),
    }


def build(name: str, text: str, out_dir: str):
    """The variant's library (nvcc, the build's flags), declared."""
    from irn_tpu_torch.ops import _build

    stem = os.path.join(out_dir, name.replace(" ", "_"))
    with open(stem + ".cu", "w") as f:
        f.write(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared", "-o",
           stem + ".so", stem + ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}\n"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(stem + ".so")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    if hasattr(lib, "irn_decode"):
        lib.irn_decode.argtypes = [p, p, p, p, i, p, p, i, i, i, i, i, i, i,
                                   ctypes.c_float, p, n]
        lib.irn_decode.restype = i
    if hasattr(lib, "irn_diag_operator"):
        lib.irn_diag_operator.argtypes = [p, p, p, p, i, p, p, i, i, i, i,
                                          i, i, i, i, p, n]
        lib.irn_diag_operator.restype = i
    lib.irn_get_stamps.argtypes = [p]
    lib.irn_clear_stamps.argtypes = []
    return lib


def phases(lib) -> dict:
    """Per stamp: the first, mean and last CTA's time in us after the
    first CTA's start, over the CTAs of the last launch."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    buf = np.zeros((STAMPS, 4096), np.uint64)
    lib.irn_get_stamps(buf.ctypes.data)
    a = buf[:4].astype(np.int64)
    a = a[:, a[0] > 0]
    t0 = a[0].min()
    return dict(ctas=int(a.shape[1]), **{
        f"stamp {k}": [round(float(x - t0) / 1e3, 2)
                       for x in (a[k].min(), a[k].mean(), a[k].max())]
        for k in range(4)})


def cases(dev):
    """name -> (kernel, call, twin) at the 96 x 128 bucket."""
    import torch

    from irn_tpu_torch.ops import random_walk as rw

    g = torch.Generator().manual_seed(0)
    geom = rw.build_geometry(96, 128, radius=5)
    edge = torch.sigmoid(torch.randn((96, 128), generator=g)).to(dev)
    ext = (93, 123, 370, 489)
    x = {}
    for c in (8, 128):
        t = torch.zeros((c, 96, 128))
        t[:, :93, :123] = torch.rand((c, 93, 123), generator=g)
        x[c] = t.to(dev)

    def k15(c, **kw):
        return lambda: tuple(o for o in rw.decode(x[c], *ext, 0.35, **kw)
                             if o is not None)

    def k15_plain(c, dtype=torch.int64, **kw):
        out = rw.decode_plain(x[c], *ext, 0.35, **kw)
        return lambda: tuple(o for o in out._replace(
            labels=out.labels.to(dtype)) if o is not None)

    return {
        "K10 radius 5": ("diag_operator",
                         lambda: rw.build_diag_operator(geom, edge),
                         lambda: rw.build_diag_operator_plain(geom, edge)),
        "K15 C 8": ("decode", k15(8), k15_plain(8)),
        "K15 C 128 best int32": (
            "decode", k15(128, best=True, labels_dtype=torch.int32),
            k15_plain(128, torch.int32, best=True)),
    }


def device_us(fn, reps: int) -> float:
    """The card's own microseconds per call (the profiler's device rows)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--build_dir", default=os.path.join(
        ROOT, "irn_tpu_torch", "_kernels", "variants"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.ops import random_walk as rw
    from irn_tpu_torch.tools import device_label, resolve_device

    dev = resolve_device("cuda")
    card = device_label(dev)
    print(card, flush=True)
    os.makedirs(args.build_dir, exist_ok=True)
    built = _build.load()
    saved = {k: getattr(rw, k) for k in ("K10_TILE", "K10_THREADS")}
    runs = cases(dev)
    res = dict(card=card, reps=args.reps, variants={})
    for name, (kernel, text, overrides) in variants().items():
        lib = build(name, text, args.build_dir)
        try:
            _build._lib = lib
            _build._scratch.clear()
            for k, v in {**saved, **overrides}.items():
                setattr(rw, k, v)
            rw.path_table(rw.build_geometry(96, 128, radius=5).path_set
                          ).packed.pop("k10", None)
            rw.k10_args.cache_clear()
            out = {}
            for case, (k, call, twin) in runs.items():
                if k != kernel:
                    continue
                got, want = call(), twin()
                equal = all(torch.equal(a, b) for a, b in zip(got, want))
                us = device_us(call, args.reps)
                torch.cuda.synchronize()
                lib.irn_clear_stamps()
                call()
                out[case] = dict(equal=equal, device_us=us, **phases(lib))
                print(f"{name}, {case}: equal {equal}, {us:.2f} us on the "
                      f"card; phases {out[case]}", flush=True)
            res["variants"][name] = out
        finally:
            _build._lib = built
            _build._scratch.clear()
            for k, v in saved.items():
                setattr(rw, k, v)
            rw.path_table(rw.build_geometry(96, 128, radius=5).path_set
                          ).packed.pop("k10", None)
            rw.k10_args.cache_clear()
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
