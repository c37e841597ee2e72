"""Time K14's designs on one card: the port's two-launch kernel
(``csrc/crf_landmark.cu`` through ``crf_device.landmark_rows``) and its
first design (``tools/crf_landmark_ieee.cu``, built here on its own), and
count each design's SASS instructions per entry:

  python -m irn_tpu_torch.tools.probe_crf_landmark [--reps 10]
      [--sass_out FILE]

Input: a scene of colour regions with noise at the 512 x 512 bucket
(extent 500 x 500), made from seed 0 on the card. The first design's int8
store is first held to the port's within one step of 127 (they round
differently), a disagreement failing the run. Times are mean device
milliseconds per call (CUDA events, after one warm-up call), the designs
in turns (port, first design, first design, port). Prints one JSON line:
the card's name and power limit (nvidia-smi), per store the port's and
the first design's ms (two each), the sums alone, and the SASS
instructions per entry of each design's int8 row loop (``--sass_out``
writes both loops' listings). Needs a CUDA card. ``chip_smoke.py`` calls
:func:`sass_per_entry` for K14's own loop; the first design is timed here
alone.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "crf_landmark_ieee.cu")
BUCKET = (512, 512)
EXTENT = (500, 500)
STORES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
# rows per slice when the first design is held to the port
HOLD_ROWS = 4096
# each design's int8 row-loop kernel in the SASS: the port's rows pass
# (rows_kernel<1>), the first design's landmark_kernel<1>
NEW_KERNEL = "rows_kernelILi1E"
IEEE_KERNEL = "landmark_kernelILi1E"


def build(build_mod) -> Tuple[str, Dict[str, str]]:
    """nvcc the first design into its own shared library with the port's
    flags (``ops/_build.py``), next to the port's kernels; returns (path,
    ptxas's register and spill lines)."""
    os.makedirs(build_mod.BUILD_DIR, exist_ok=True)
    out = os.path.join(build_mod.BUILD_DIR, "probe_crf_landmark_ieee.so")
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


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.irn_crf_landmark_ieee.argtypes = [
        p, p, p, i, i, i, i, i, i, i, i, i, i, i, f, f, p,
        ctypes.POINTER(ctypes.c_int)]
    lib.irn_crf_landmark_ieee.restype = ctypes.c_int
    return lib


def ieee_rows(lib: ctypes.CDLL, planes: torch.Tensor, eh: int, ew: int,
              store: torch.dtype, stride: int = 4, sxy: float = 50.0,
              srgb: float = 5.0, rows: Optional[Tuple[int, int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first design's (store [r1 - r0, S'], sums [r1 - r0]) of the
    rows [r0, r1) (default all), one launch on the current stream."""
    from irn_tpu_torch.ops import crf_device as cd

    _, h, w = planes.shape
    r0, r1 = rows if rows is not None else (0, h * w)
    lh, lw = cd.landmark_grid(h, w, stride)
    s_cols = cd.landmark_columns(lh * lw, store)
    out = torch.empty((r1 - r0, s_cols), dtype=store, device=planes.device)
    sums = torch.empty(r1 - r0, dtype=torch.float32, device=planes.device)
    launched = ctypes.c_int(0)
    status = lib.irn_crf_landmark_ieee(
        planes.data_ptr(), out.data_ptr(), sums.data_ptr(), h, w, eh, ew,
        stride, lw, lh * lw, s_cols, store.itemsize, r0, r1, sxy, srgb,
        torch.cuda.current_stream(planes.device).cuda_stream,
        ctypes.byref(launched))
    if status != 0:
        raise RuntimeError(f"crf_landmark_ieee: cudaError {status}")
    return out, sums


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\bBRA\b[^;]*?\b0x([0-9a-f]+)")


def sass_loop(lines: List[str]) -> Tuple[int, int, List[str]]:
    """(instructions, MUFU.EX2 count, listing) of the innermost loop that
    holds an exp in one function's ``cuobjdump -sass`` lines: the span
    from a backward branch's target to the branch, without NOPs and without
    the blocks that store single bytes (the unaligned and ragged-tile
    path). A block starts at a branch target or after a branch."""
    insns = [(int(m.group(1), 16), m.group(2).strip())
             for m in map(_INSN.search, lines) if m]
    index = {a: i for i, (a, _) in enumerate(insns)}
    starts, spans = set(), []
    for i, (addr, text) in enumerate(insns):
        m = _TARGET.search(text)
        if not m:
            continue
        target = int(m.group(1), 16)
        starts.update((target, insns[min(i + 1, len(insns) - 1)][0]))
        lo = index.get(target)
        if lo is not None and lo <= i and any(
                "MUFU.EX2" in t for _, t in insns[lo:i + 1]):
            spans.append((i - lo, lo, i))
    if not spans:
        raise RuntimeError("no loop with MUFU.EX2 in the SASS")
    _, lo, hi = min(spans)
    blocks = []
    for addr, text in insns[lo:hi + 1]:
        if addr in starts or not blocks:
            blocks.append([])
        blocks[-1].append((addr, text))
    listing = [f"{a:05x} {t}" for b in blocks
               if not any(re.search(r"\bSTG?\.\S*U8\b", t) for _, t in b)
               for a, t in b if not t.startswith("NOP")]
    ex2 = sum("MUFU.EX2" in line for line in listing)
    return len(listing), ex2, listing


def sass_per_entry(sass: str, kernel: str) -> Tuple[float, List[str]]:
    """SASS instructions per entry of ``kernel``'s (a substring of its
    mangled name) row loop in the SASS listing ``sass``: the loop's
    instructions over its exps (one per entry); and the loop's listing."""
    from irn_tpu_torch.ops import _build

    fns = [v for k, v in _build.sass_functions(sass).items() if kernel in k]
    if len(fns) != 1:
        raise RuntimeError(f"{kernel}: {len(fns)} functions in the SASS")
    n, ex2, listing = sass_loop(fns[0])
    if ex2 == 0:
        raise RuntimeError(f"{kernel}: no exp in the kept row loop")
    return n / ex2, listing


def scene(dev, bucket=BUCKET, seed: int = 0) -> torch.Tensor:
    """[3, h, w] uint8 colour regions with noise, made on ``dev``."""
    h, w = bucket
    gen = torch.Generator(device=dev).manual_seed(seed)
    img = torch.full((3, h, w), 60.0, device=dev)
    img[:, :, : w // 2] = torch.tensor([190.0, 70.0, 60.0],
                                       device=dev)[:, None, None]
    img[:, h // 2:, w // 2:] = torch.tensor([70.0, 170.0, 90.0],
                                            device=dev)[:, None, None]
    img += 8 * torch.randn((3, h, w), generator=gen, device=dev)
    return img.clamp(0, 255).to(torch.uint8)


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def hold_ieee(lib, planes, extent) -> float:
    """The first design's int8 store within one step of the port's (they
    round differently) and its row sums its stored integers' sums times
    f32(1/127): a run that launched it for real. Both are built and
    compared ``HOLD_ROWS`` rows at a time, so the memory held stays near
    one slice's. Returns the share of entries that differ."""
    from irn_tpu_torch.ops import crf_device as cd

    n = planes.shape[1] * planes.shape[2]
    step, differ, entries = 0, 0, 0
    for r0 in range(0, n, HOLD_ROWS):
        rows = (r0, min(r0 + HOLD_ROWS, n))
        new_k, _ = cd.landmark_rows(planes, *extent, store=torch.int8,
                                    rows=rows)
        old_k, old_d = ieee_rows(lib, planes, *extent, torch.int8, rows=rows)
        diff = (new_k.short() - old_k.short()).abs()
        step = max(step, int(diff.max()))
        differ += int((diff > 0).sum())
        entries += diff.numel()
        own = old_k.sum(1, dtype=torch.int64).float() * (1.0 / 127.0)
        if step > 1 or not torch.allclose(old_d, own, rtol=1e-6, atol=0):
            raise AssertionError(f"crf_landmark_ieee: int8 off by {step} or "
                                 f"its sums are not its store's (rows {rows})")
    return differ / entries


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sass_out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_crf_landmark needs a CUDA card")
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.ops import crf_device as cd

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    path, ptxas = build(_build)
    lib = load(path)
    planes = scene(dev)
    res = dict(card=card, ieee_ptxas=ptxas, bucket=BUCKET, extent=EXTENT,
               ieee_int8_differ=hold_ieee(lib, planes, EXTENT), stores={})
    for name, store in STORES.items():
        fns = (lambda: cd.landmark_rows(planes, *EXTENT, store=store),
               lambda: ieee_rows(lib, planes, *EXTENT, store))
        t = [cuda_ms(fns[i], args.reps) for i in (0, 1, 1, 0)]
        res["stores"][name] = dict(port_ms=[t[0], t[3]], ieee_ms=[t[1], t[2]])
        torch.cuda.empty_cache()
    res["sums_only_ms"] = cuda_ms(lambda: cd.landmark_rows(
        planes, *EXTENT, sums_only=True), args.reps)
    listings = []
    for name, sass, kernel in (
            ("port", _build.cuobjdump_sass(_build.build()), NEW_KERNEL),
            ("ieee", _build.cuobjdump_sass(path), IEEE_KERNEL)):
        per, listing = sass_per_entry(sass, kernel)
        res.setdefault("sass_per_entry", {})[name] = per
        listings += [f"# {kernel}: {per:.3f} per entry", *listing]
    if args.sass_out:
        with open(args.sass_out, "w") as f:
            f.write("\n".join(listings) + "\n")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
