"""Time make_ins_seg's advection (K11) call by call, and where its time
goes:

  python irn_tpu_torch/tools/probe_advect.py [--root DIR] [--reps 20]
      [--device cuda] [--small] [--variants] [--sass_out FILE] [--out FILE]

Cases, made from seed 0 with numpy, at the 128 x 128 grid cap with
chip_smoke's extent (94, 125), 300 steps:

- ``basin``: chip_smoke's basin field, dp pulling toward the nearest of
  three centres with gain 0.3, plus noise 0.1 (a particle's distance
  shrinks by 0.7 a step);
- ``full gain``: dp = centre - position plus noise 0.05, the form a trained
  displacement head predicts (a particle lands in about one step);
- ``random``: N(0, 3) over the whole grid;
- ``irn forward``: the dp of the port's IRN forward (seeded random
  weights, seed 0) on the first image of chip_smoke's synthetic tree, at
  that image's own extent.

Per case and call: the card's own time of each device row by name with
their counts (torch.profiler), the CUDA-event time back to back, wrapper
included (mean over ``--reps`` after one), the host time of a
synchronized call (median: what chip_smoke's ``layers`` steps time), and
the host time per call back to back (the wrapper's cost). Each output is
held to the plain twin (``equal``). ``--root`` imports ``irn_tpu_torch``
from another checkout (a parent's ``git archive``), so one call times both
trees in turns; run the file by its path for that.

``--variants`` (the card only) builds this checkout's ``csrc/advect.cu``
as it is and as variants (:func:`variants`: string edits of the source:
no early stop, the taps through L1, 256 or 512 staging threads, chunks of
4 and 16, 256 particles per CTA, and the pooled check of a non-finite dp
left out: no wait for the helper warp, no check of the staged rows;
right on finite fields only), each twice by nvcc with
``_build.NVCC_FLAGS`` into ``_kernels/variants/``: as edited, timed by the
profiler's device rows, and with clock64 stamps added (:func:`stamped`),
which give per CTA the staging cycles, thread 0's cycles per step and the
CTA's cycles, and with each lane's step count, which gives per warp the
steps its slowest lane ran.
``--sass_out`` writes the built kernel's SASS there and the opcode counts
of its step loop into the JSON.

Prints the card's name and power limit (nvidia-smi) and one JSON line;
``--out`` writes the JSON there too. ``--device cpu`` runs the plain twins
on the host clock (no device rows: not a device time); ``--small`` cuts
the grid to 16 x 16, for a test.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(ROOT, "irn_tpu_torch", "csrc")
CAP = 128
EXTENT = (94, 125)
ITERATIONS = 300
SMALL = 8  # --small divides the cap and the extent by this
def _centres(h4: int, w4: int):
    import numpy as np

    return np.array([[0.3, 0.25], [0.35, 0.75], [0.75, 0.5]]) * np.array(
        [h4, w4])


def pull_field(cap: int, ext, gain: float, noise: float, seed: int = 0):
    """dp [2, cap, cap] f32 toward the nearest of three centres times
    ``gain``, plus N(0, noise), zero beyond the extent."""
    import numpy as np

    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[:cap, :cap].astype(np.float32)
    c = _centres(*ext)
    d2 = (yy[None] - c[:, 0, None, None]) ** 2 + \
        (xx[None] - c[:, 1, None, None]) ** 2
    near = c[d2.argmin(0)]
    dp = np.stack([(near[..., 0] - yy) * gain,
                   (near[..., 1] - xx) * gain]).astype(np.float32)
    dp += (g.standard_normal(dp.shape) * noise).astype(np.float32)
    dp[:, ext[0]:] = 0
    dp[:, :, ext[1]:] = 0
    return dp


def random_field(h: int, w: int, seed: int = 0):
    """dp [2, h, w] f32 drawn from N(0, 3) over the whole grid."""
    import numpy as np

    g = np.random.default_rng(seed)
    return (g.standard_normal((2, h, w)) * 3.0).astype(np.float32)


def cycle_field(h: int, w: int, ext, period: int):
    """dp [2, h, w] f32 whose particles run along their row in cycles of
    ``period`` columns (dx = +1 up to the cycle's last column, which jumps
    back by period - 1; dy = 0): at integer positions each sample is one
    tap, exactly, so the orbit from the start repeats with that period.
    Columns of an unfinished cycle at the extent's edge stay put."""
    import numpy as np

    dp = np.zeros((2, h, w), np.float32)
    cols = np.arange(ext[1])
    full = cols < ext[1] // period * period
    dx = np.where(cols % period == period - 1, -(period - 1), 1.0)
    dp[1, : ext[0], : ext[1]] = np.where(full, dx, 0.0)[None]
    return dp


def nan_field(cap: int, ext, seed: int = 0, value: float = float("nan")):
    """The basin field with ``value`` (NaN or an infinity) planted: on a few
    pixels inside the extent and beyond the taps' reach (rows past h4,
    columns past w4). Either makes every sample of its plane NaN (JAX's
    form multiplies it by weight 0), so the end points are JAX's for a
    non-finite dp (``centroids.advect_step``)."""
    dp = pull_field(cap, ext, 0.3, 0.1, seed)
    h4, w4 = ext
    dp[0, h4 // 2, w4 // 3] = value
    dp[1, h4 // 3, w4 // 2] = value
    if h4 + 1 < cap:
        dp[:, h4 + 1:, :] = value
    if w4 + 1 < cap:
        dp[:, :, w4 + 1:] = value
    return dp


def irn_field(dev, small: bool):
    """(dp [2, cap, cap], (h4, w4)): the port's IRN forward with seeded
    random weights on the first image of chip_smoke's synthetic tree (360
    px, jitter 140, seed 0; with ``small`` 40 px, jitter 20, a 16 cap)."""
    import torch

    from irn_tpu_torch.data import image_io, synthetic
    from irn_tpu_torch.models.irn import IRNet, init_irnet
    from irn_tpu_torch.pipeline.config import Config
    from irn_tpu_torch.pipeline.stages_irn import EdgeDisplacementRunner

    size, jitter, cap = (40, 20, CAP // SMALL) if small else (360, 140, CAP)
    with tempfile.TemporaryDirectory() as root:
        synthetic.generate(root, n_images=1, size=size,
                           max_side_jitter=jitter, seed=0)
        img = image_io.imread(os.path.join(root, "JPEGImages",
                                           "2007_000000.jpg"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_irnet(IRNet(), torch.Generator().manual_seed(0))
    runner = EdgeDisplacementRunner(Config(rw_grid_cap=cap), model, dev)
    (_, dp, hw4), = runner.batch([img], [img.shape[:2]])
    return dp.contiguous(), hw4


def cases(dev, small: bool) -> dict:
    """name -> (dp [2, cap, cap] f32 on ``dev``, (h4, w4))."""
    import torch

    cap = CAP // SMALL if small else CAP
    ext = (EXTENT[0] // SMALL, EXTENT[1] // SMALL) if small else EXTENT
    out = {
        "basin": (pull_field(cap, ext, 0.3, 0.1), ext),
        "full gain": (pull_field(cap, ext, 1.0, 0.05), ext),
        "random": (random_field(cap, cap), ext),
    }
    out = {k: (torch.from_numpy(v).to(dev), e) for k, (v, e) in out.items()}
    out["irn forward"] = irn_field(dev, small)
    return out


def device_rows(fn, reps: int) -> dict:
    """Over ``reps`` calls of fn (after a warm-up call), each device row by
    name: the card's own microseconds per call and the count per call, and
    the microseconds per launch over the launches the profiler saw (it
    drops a call's events now and then, never adds one)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows[e.key[:90]][0] += e.self_device_time_total
            rows[e.key[:90]][1] += e.count
    return {k: dict(us=v[0] / reps, count=v[1] / reps,
                    us_per_launch=v[0] / max(v[1], 1))
            for k, v in rows.items()}


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


def _equal(got, want) -> bool:
    import torch

    return all(a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
               for a, b in zip(got, want))


def run_case(dev, dp, hw4, reps: int, want) -> dict:
    from irn_tpu_torch.ops import centroids
    from irn_tpu_torch.tools import device_ms

    def call():
        return centroids.advect(dp, *hw4)

    res = dict(shape=f"dp {list(dp.shape)} extent {list(hw4)}, "
                     f"{ITERATIONS} steps",
               equal=_equal(call(), want), ms=device_ms(dev, call, reps),
               sync_ms=sync_ms(dev, call, reps),
               host_us=host_us(dev, call, reps))
    if dev.type == "cuda":
        rows = device_rows(call, reps)
        # one launch per call: the time of the launches the profiler saw
        res.update(rows=rows,
                   device_us=sum(r["us_per_launch"] for r in rows.values()),
                   device_ops=sum(r["count"] for r in rows.values()))
    return res


# -- variants (the card only) ----------------------------------------------


STAMP_DEF = r"""
constexpr int kStamps = 9;
constexpr int kProbeCtas = 4096;
__device__ long long g_stamp[kStamps][kProbeCtas];
__device__ long long g_warp_end[kProbeCtas * kThreads / 32];
__device__ int g_steps[kProbeCtas * kThreads];
// clock64 of thread 0 of the CTA into stamp k
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0 && blockIdx.x < kProbeCtas)
    g_stamp[k][blockIdx.x] = clock64();
}

"""
STAMP_API = r"""
// The last launch's stamps [kStamps][kProbeCtas] (the CTA's start, after
// the staging, after thread 0's steps 50, 100, ..., 300 (0 where it
// stopped before), thread 0's end), warp ends and steps per lane.
IRN_API int irn_advect_probe_read(long long* stamps, long long* warp_end,
                                  int* steps) {
  cudaError_t e = cudaMemcpyFromSymbol(stamps, g_stamp, sizeof(g_stamp));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(warp_end, g_warp_end, sizeof(g_warp_end));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(steps, g_steps, sizeof(g_steps));
  return (int)e;
}
IRN_API int irn_advect_probe_clear() {
  static long long zs[kStamps][kProbeCtas];
  static long long zw[kProbeCtas * kThreads / 32];
  static int zi[kProbeCtas * kThreads];
  cudaError_t e = cudaMemcpyToSymbol(g_stamp, zs, sizeof(zs));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_warp_end, zw, sizeof(zw));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_steps, zi, sizeof(zi));
  return (int)e;
}
IRN_API int irn_advect_probe_shape(int* out) {
  out[0] = kStamps;
  out[1] = kProbeCtas;
  out[2] = kThreads;
  out[3] = kChunk;
  return 0;
}
"""


def _edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"probe_advect: {old!r} found {text.count(old)} "
                         f"times in the source")
    return text.replace(old, new)


def stamped(text: str) -> str:
    """The source with the stamps, the step counts and their readers."""
    marks = (
        ("template <bool kStaged>\n__global__",
         STAMP_DEF + "template <bool kStaged>\n__global__"),
        ("  extern __shared__ float2 staged[];\n",
         "  extern __shared__ float2 staged[];\n  stamp(0);\n"),
        ("  if (kStaged) bad = stage_rows(staged, fdy, fdx, H, W, h4, "
         "s_poison);\n",
         "  if (kStaged) bad = stage_rows(staged, fdy, fdx, H, W, h4, "
         "s_poison);\n  stamp(1);\n"),
        ("    int left = p < HW ? iterations : 0;\n",
         "    int left = p < HW ? iterations : 0;\n    int ran = 0;\n"),
        ("      left -= kChunk;\n",
         "      left -= kChunk;\n      ran += kChunk;\n"
         "      if (ran >= 50 && ran % 50 < kChunk && ran <= 300)\n"
         "        stamp(1 + ran / 50);\n"),
        ("    for (; left > 0; --left) step(taps, y, x, ymax, xmax);\n",
         "    for (; left > 0; --left) {\n"
         "      step(taps, y, x, ymax, xmax);\n"
         "      ++ran;\n"
         "      if (ran % 50 == 0 && ran <= 300) stamp(1 + ran / 50);\n"
         "    }\n"
         "    stamp(8);\n"
         "    __syncwarp(__activemask());\n"
         "    if (p < kProbeCtas * kThreads) {\n"
         "      g_steps[p] = ran;\n"
         "      if (threadIdx.x % 32 == 0) g_warp_end[p / 32] = clock64();\n"
         "    }\n"))
    for old, new in marks:
        text = _edit(text, old, new)
    return text + STAMP_API


def variants() -> dict:
    """name -> the variant's source: ``csrc/advect.cu`` as built and
    with each variant's edits."""
    with open(os.path.join(CSRC, "advect.cu")) as f:
        src = f.read()
    no_stop = ("if (__float_as_uint(y) == by && __float_as_uint(x) == bx) {",
               "if (false) {")
    l1 = ("  return W % 4 == 0 && bytes <= kSmemMax ? (int)bytes : 0;",
          "  return 0;")

    # the pooled check of a non-finite dp left out (clean fields only): the
    # steppers neither meet the helper nor read what it found, or the
    # staged rows go unchecked
    no_wait = (("      irn::hopper::named_sync(kBarrier, kThreads + 32);\n"
                "      poisoned = (s_poison[0] | s_poison[5]) != 0;",
                "      poisoned = false;"),
               ("  irn::hopper::named_arrive(kBarrier, kThreads + 32);", ""))
    no_check = (("  if (!__syncthreads_or(isnan(z))) return false;",
                 "  __syncthreads();\n  return false;"),)

    def const(name, value):
        m = re.search(rf"constexpr int {name} = \d+;", src)
        return (m.group(0) if m else f"constexpr int {name} = ?;",
                f"constexpr int {name} = {value};")

    edits = {
        "as built": (),
        "no stop": (no_stop,),
        "taps through L1": (l1,),
        "taps through L1, no stop": (l1, no_stop),
        "staged by 256 threads": (const("kStageThreads", 256),),
        "staged by 512 threads": (const("kStageThreads", 512),),
        "chunk 4": (const("kChunk", 4),),
        "chunk 16": (const("kChunk", 16),),
        "256 particles per CTA": (const("kThreads", 256),),
        "no pooled wait": no_wait,
        "no staged check": no_check,
    }
    out = {}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            text = _edit(text, old, new)
        out[name] = text
    return out


def _build_variant(name: str, text: str, probe: bool, out_dir: str):
    """nvcc of a variant's source (with the stamps when ``probe``) into its
    own library; returns (path, Popen)."""
    from irn_tpu_torch.ops import _build

    stem = os.path.join(out_dir, "advect_" + re.sub(
        r"[^a-z0-9]+", "_", name.lower()) + ("_probe" if probe else ""))
    with open(stem + ".cu", "w") as f:
        f.write(stamped(text) if probe else text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared", "-o",
           stem + ".so", stem + ".cu"]
    return stem + ".so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)


def _load_variant(path: str, probe: bool):
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.irn_advect.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float,
                               p, ctypes.POINTER(i)]
    lib.irn_advect.restype = i
    lib.irn_advect_staged_bytes.argtypes = [i, i]
    lib.irn_advect_staged_bytes.restype = i
    lib.irn_advect_scratch_words.argtypes = []
    lib.irn_advect_scratch_words.restype = i
    if probe:
        lib.irn_advect_probe_read.argtypes = [p, p, p]
        lib.irn_advect_probe_clear.argtypes = []
        lib.irn_advect_probe_shape.argtypes = [p]
    return lib


def _stamps(lib, n_px: int, iterations: int) -> dict:
    """The last launch's clock64 stamps and step counts, summarized."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    shape = np.zeros(4, np.int32)
    lib.irn_advect_probe_shape(shape.ctypes.data)
    n_stamps, ctas, threads, chunk = (int(v) for v in shape)
    stamps = np.zeros((n_stamps, ctas), np.int64)
    warp_end = np.zeros(ctas * threads // 32, np.int64)
    steps = np.zeros(ctas * threads, np.int32)
    e = lib.irn_advect_probe_read(stamps.ctypes.data, warp_end.ctypes.data,
                                  steps.ctypes.data)
    if e:
        raise RuntimeError(f"probe read failed: cudaError {e}")
    used = -(-n_px // threads)
    st = stamps[:, :used]
    steps = steps[:n_px]
    warps = -(-n_px // 32)
    warp_max = np.array([steps[32 * k: 32 * k + 32].max()
                         for k in range(warps)])
    cta_end = warp_end[:warps].reshape(-1)
    cta_end = np.array([cta_end[k * threads // 32:(k + 1) * threads // 32]
                        .max() for k in range(used)])
    full = st[7] > 0  # thread 0 reached step 300
    per_step = ((st[7, full] - st[1, full]) / 300.0) if full.any() else \
        np.zeros(0)
    return dict(
        chunk=chunk, threads=threads, ctas=used,
        staging_cycles=[float(np.mean(st[1] - st[0])),
                        float(np.max(st[1] - st[0]))],
        cycles_per_step_thread0=([float(per_step.mean()),
                                  float(per_step.min()),
                                  float(per_step.max())]
                                 if per_step.size else None),
        cta_cycles=[float(np.mean(cta_end - st[0])),
                    float(np.max(cta_end - st[0]))],
        warp_max_steps=dict(
            mean=float(warp_max.mean()), min=int(warp_max.min()),
            max=int(warp_max.max()),
            share_full=float((warp_max >= iterations).mean())),
        lane_steps_mean=float(steps.mean()),
        lanes_stopped_early=float((steps < iterations).mean()))


def _sass_summary(path: str, sass_out) -> dict:
    """Opcode counts of each instance's chunk of steps (the innermost loop
    with the most shared or global loads) from the library's SASS; the
    listing to ``sass_out``."""
    from irn_tpu_torch.ops import _build

    sass = _build.cuobjdump_sass(path)
    if sass_out:
        with open(sass_out, "w") as f:
            f.write(sass)
    out = {}
    for fn, lines in _build.sass_functions(sass).items():
        if "advect_kernel" not in fn:
            continue
        ins = []
        for line in lines:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2)))
        spans = []
        for addr, text in ins:
            m = re.search(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                spans.append((int(m.group(1), 16), addr))
        # the loops that hold no other, the one with the most shared or
        # global loads first: the chunk of steps (4 taps a step)
        spans = [(lo, hi) for lo, hi in spans
                 if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                            for a, b in spans)]
        loops = sorted(([t for a, t in ins if lo <= a <= hi]
                        for lo, hi in spans),
                       key=lambda b: sum(t.split()[0].startswith(
                           ("LDS", "LDG")) for t in b if t), reverse=True)
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
            for t in (loops[0] if loops else []))
        out[fn] = dict(loop_sizes=sorted((len(lp) for lp in loops),
                                         reverse=True),
                       largest_loop_ops=dict(sorted(ops.items())))
    return out


def run_variants(dev, runs: dict, reps: int, out_dir: str,
                 sass_out=None) -> dict:
    """Each variant built plain and with the probe, run on every case."""
    import torch

    from irn_tpu_torch.ops import _build, centroids

    os.makedirs(out_dir, exist_ok=True)
    sources = variants()
    jobs = {(name, probe): _build_variant(name, text, probe, out_dir)
            for name, text in sources.items() for probe in (False, True)}
    for (name, probe), (path, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{text}")
    built = _build.load()
    res = dict(sass=_sass_summary(jobs[("as built", False)][0], sass_out),
               variants={})
    try:
        for name in sources:
            out = {}
            for case, (dp, hw4, want) in runs.items():
                def call():
                    return centroids.advect(dp, *hw4)
                _build._lib = _load_variant(jobs[(name, False)][0], False)
                equal = _equal(call(), want)
                rows = device_rows(call, reps)
                probe = _load_variant(jobs[(name, True)][0], True)
                _build._lib = probe
                probe.irn_advect_probe_clear()
                probe_equal = _equal(call(), want)
                stamps = _stamps(probe, dp.shape[1] * dp.shape[2],
                                 ITERATIONS)
                out[case] = dict(
                    equal=equal and probe_equal,
                    device_us=sum(r["us_per_launch"] for r in rows.values()),
                    rows=rows, **stamps)
                print(f"variant {name}, {case}: equal {out[case]['equal']}, "
                      f"{out[case]['device_us']:.2f} us on the card; "
                      f"stamps {stamps}", flush=True)
            res["variants"][name] = out
    finally:
        _build._lib = built
    torch.cuda.synchronize()
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose irn_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help=f"the grid cut by {SMALL} (a test's size)")
    ap.add_argument("--variants", action="store_true",
                    help="build and time this checkout's variants (card)")
    ap.add_argument("--sass_out", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    from irn_tpu_torch.ops import centroids
    from irn_tpu_torch.tools import device_label, resolve_device

    dev = resolve_device(args.device)
    if args.variants and dev.type != "cuda":
        raise ValueError("--variants builds CUDA code: the card only")
    card = device_label(dev)
    print(card, flush=True)
    res = dict(card=card, root=os.path.abspath(args.root), reps=args.reps,
               cases={})
    runs = {}
    for name, (dp, hw4) in cases(dev, args.small).items():
        want = centroids.advect_plain(dp, *hw4)
        runs[name] = (dp, hw4, want)
        r = run_case(dev, dp, hw4, args.reps, want)
        res["cases"][name] = r
        print(f"{name}: {r['shape']}: {r['ms']:.4f} ms per call (events"
              f"{'' if dev.type == 'cuda' else ', host clock'}), "
              f"{r['sync_ms']:.4f} synchronized, {r['host_us']:.2f} us of "
              f"host time back to back; device "
              f"{r.get('device_us', float('nan')):.2f} us in "
              f"{r.get('device_ops', 0):g} operations "
              f"{sorted(r.get('rows', {}))}; equal {r['equal']}", flush=True)
    if args.variants:
        res.update(run_variants(
            dev, runs, args.reps,
            os.path.join(ROOT, "irn_tpu_torch", "_kernels", "variants"),
            args.sass_out))
        res["clocks"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
