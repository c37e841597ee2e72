"""Profile the device CRF's mean-field iterations on one card:

  python irn_tpu_torch/tools/probe_crf_iteration.py [--root DIR] [--reps 5]
      [--out FILE]

Input: one image at the 512 x 512 bucket (extent 500 x 497; colour regions
with noise and a label pair over three labels with 6% noise, made from
seed 0 with numpy), its ``LandmarkKernel`` built for the int8 and the
dense (bf16) store in turn. Per store it measures:

- ten iterations, ``mean_field_pair(..., t=10)``: mean device ms per call
  (CUDA events after one warm-up call, ``--reps`` calls);
- one iteration under torch.profiler, as the difference of a t = 2 and a
  t = 1 call (the unary, the first softmax and the argmax cancel): device
  microseconds and kernel count of the product (``product_int8`` /
  ``product_f32``), of the Gaussian's Toeplitz GEMMs (``_sep_gauss``,
  where the tree has it), of the other kernels torch launched and of
  K17's hand kernels (``hand``, where the tree has them), with the rest's
  and the hand kernels by name.

``--root`` imports ``irn_tpu_torch`` from another checkout (a parent's
``git archive``), so one script profiles both trees; run the file by its
path for that. Prints the card's name and power limit (nvidia-smi) and one
JSON line; ``--out`` writes the JSON there too. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BUCKET = (512, 512)
EXTENT = (500, 497)
N_LABELS = 3
TAGS = {"_sep_gauss": "toeplitz", "product_int8": "product",
        "product_f32": "product"}
# K17's kernels, by their demangled names
HAND_KERNELS = ("::blur_kernel", "::start_kernel", "::quantize_kernel",
                "::combine_kernel")


def scene(seed: int = 0):
    """(image [H, W, 3] uint8, labels [2, H, W] uint8) at the bucket: colour
    regions with noise inside the extent, labels per region with 6%
    noise."""
    import numpy as np

    g = np.random.default_rng(seed)
    h, w = BUCKET
    eh, ew = EXTENT
    img = np.zeros((h, w, 3))
    img[:eh, :ew] = (60, 60, 60)
    img[:eh, : ew // 2] = (190, 70, 60)
    img[eh // 2:eh, ew // 2:ew] = (70, 170, 90)
    img[:eh, :ew] += g.normal(0, 10, (eh, ew, 3))
    lab = np.zeros((2, h, w), np.uint8)
    lab[0, :eh, : ew // 2 - 3] = 1
    lab[0, eh // 2 + 3:eh, ew // 2:ew] = 2
    lab[1] = np.where(lab[0] == 2, 2, 0)
    noise = g.random((2, h, w)) < 0.06
    lab[noise] = g.integers(0, N_LABELS, int(noise.sum()))
    lab[:, eh:] = 0
    lab[:, :, ew:] = 0
    return np.clip(img, 0, 255).astype(np.uint8), lab


def _tagged(fn, tag):
    import torch

    def run(*a, **kw):
        with torch.profiler.record_function(f"probe:{tag}"):
            return fn(*a, **kw)
    return run


def _tag_of(e) -> str:
    while e is not None:
        if e.name.startswith("probe:"):
            return e.name[len("probe:"):]
        e = e.cpu_parent
    return "rest"


def profile(fn):
    """Device microseconds and kernel counts per tag of one call of fn
    (after a warm-up call), the rest's kernels by name, and the hand
    kernels (launched through ctypes, under no torch op: read from the
    device rows by name)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    us, count = collections.Counter(), collections.Counter()
    names = collections.Counter()
    for e in prof.events():
        tag = _tag_of(e)
        for k in e.kernels:
            us[tag] += k.duration
            count[tag] += 1
            if tag == "rest":
                names[k.name[:80]] += k.duration
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.key for k in HAND_KERNELS)):
            us["hand"] += e.self_device_time_total
            count["hand"] += e.count
            names[e.key[:80]] += e.self_device_time_total
    return us, count, names


def cuda_ms(fn, reps: int) -> float:
    import torch

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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="checkout whose irn_tpu_torch is profiled")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_crf_iteration needs a CUDA card")
    from irn_tpu_torch.ops import crf_device as cd

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    img, lab = scene()
    labels = torch.from_numpy(lab).to(dev)
    image = torch.from_numpy(img).to(dev)
    for name, tag in TAGS.items():
        if hasattr(cd, name):
            setattr(cd, name, _tagged(getattr(cd, name), tag))
    res = dict(card=card, root=os.path.abspath(args.root), bucket=BUCKET,
               extent=EXTENT, n_labels=N_LABELS, stores={})
    for store in ("int8", "dense"):
        with torch.no_grad():
            kern = cd.LandmarkKernel(image, *EXTENT, kernel_store=store)

            def iterate(t):
                return lambda: cd.mean_field_pair(kern, labels, N_LABELS, 0.7,
                                                  t=t)

            ten_ms = cuda_ms(iterate(10), args.reps)
            one = profile(iterate(1))
            two = profile(iterate(2))
        per = {tag: dict(us=two[0][tag] - one[0][tag],
                         kernels=two[1][tag] - one[1][tag])
               for tag in ("product", "toeplitz", "rest", "hand")}
        rest = {k: v - one[2].get(k, 0) for k, v in two[2].most_common(12)}
        res["stores"][store] = dict(ten_iterations_ms=ten_ms,
                                    one_iteration=per, rest_by_kernel=rest)
        print(f"{store}: ten iterations {ten_ms:.4f} ms; one iteration "
              f"{json.dumps(per)}", flush=True)
        del kern
        torch.cuda.empty_cache()
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
