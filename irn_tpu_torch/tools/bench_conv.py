"""3x3 conv probe: the hand-written implicit-GEMM kernel (K9, ``conv3x3``)
against its plain twin and cuDNN's own bf16 conv; the counterpart of
``tools/bench_conv_pallas.py``'s ``main``.

Shapes are the JAX probe's: the heaviest make_cam pass (scale 2.0, layer
c3) and the other production 3x3s. Per shape the tool prints the GFLOP,
K9's ms and TFLOP/s, the twin's ms (f32 ``F.conv2d`` on the bf16 values,
TF32 off, rounded once to bf16: the JAX function's math), cuDNN's bf16
``F.conv2d`` on channels_last views (no copy of the NHWC input) ms, and
K9's error against the twin: max abs relative to max|twin| and the share
of bit-equal elements. Inputs are bf16 normals from a seeded
``torch.Generator``; each time is the mean over ``--reps`` calls after one
warm-up (CUDA events on the card).

Usage:
  python -m irn_tpu_torch.tools.bench_conv [--reps 8] [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Iterable, List, Tuple

import torch
import torch.nn.functional as F

from irn_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
from irn_tpu_torch.tools import device_label, device_ms, resolve_device

# (label, B, H, W, C, F), tools/bench_conv_pallas.py:124-129
SHAPES: Tuple[Tuple[str, int, int, int, int, int], ...] = (
    ("make_cam s2.0 c3 3x3x128", 64, 125, 94, 128, 128),
    ("make_cam s2.0 c4 3x3x256", 64, 63, 47, 256, 256),
    ("make_cam s2.0 c5 3x3x512", 64, 63, 47, 512, 512),
    ("train/edge 512^2 c4 3x3x256", 16, 32, 32, 256, 256),
)


def make_inputs(b, h, w, c, f, dev, seed: int = 0):
    """x [B, H, W, C] ~ N(0, 1) and k [3, 3, C, F] ~ N(0, 0.05^2), bf16."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen).to(torch.bfloat16)
    k = (torch.randn((3, 3, c, f), generator=gen) * 0.05).to(torch.bfloat16)
    return x.to(dev), k.to(dev)


def cudnn_weight(k: torch.Tensor) -> torch.Tensor:
    """k [3, 3, C, F] (HWIO) as the [F, C, 3, 3] channels_last weight of
    :func:`cudnn_conv`, made once outside the timed calls."""
    return k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def cudnn_conv(x: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
    """cuDNN's bf16 conv on the NHWC input as a channels_last NCHW view
    (``w_oihw`` from :func:`cudnn_weight`); returns NHWC (a view of the
    channels_last output)."""
    return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1).permute(
        0, 2, 3, 1)


def run_shape(label: str, b: int, h: int, w: int, c: int, f: int,
              dev: torch.device, reps: int, card: str) -> dict:
    x, k = make_inputs(b, h, w, c, f, dev)
    gflop = 2.0 * b * h * w * c * f * 9 / 1e9
    got = conv3x3(x, k)
    want = conv3x3_plain(x, k)
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-30)
    equal = float((got == want).float().mean())
    w_cl = cudnn_weight(k)
    row = dict(
        label=label, shape=(b, h, w, c, f), gflop=gflop, max_abs_err=err,
        rel_err=rel, bit_equal=equal,
        ms=device_ms(dev, lambda: conv3x3(x, k), reps),
        plain_ms=device_ms(dev, lambda: conv3x3_plain(x, k), reps),
        cudnn_ms=device_ms(dev, lambda: cudnn_conv(x, w_cl), reps),
    )
    row["tflops"] = gflop / row["ms"]
    print(f"{label}: {gflop:7.1f} GFLOP  K9 {row['ms']:8.3f} ms "
          f"{row['tflops']:6.1f} TFLOP/s  twin {row['plain_ms']:8.3f} ms  "
          f"cuDNN bf16 {row['cudnn_ms']:8.3f} ms "
          f"{gflop / row['cudnn_ms']:6.1f} TFLOP/s  rel {rel:.1e}  "
          f"bit-equal {equal:.4f} ({card})", flush=True)
    return row


def sweep(dev: torch.device, reps: int = 8,
          shapes: Iterable[Tuple[str, int, int, int, int, int]] = SHAPES
          ) -> List[dict]:
    card = device_label(dev)
    return [run_shape(*s, dev=dev, reps=reps, card=card) for s in shapes]


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False  # the twin is an f32 conv
    return sweep(dev, args.reps)


if __name__ == "__main__":
    main()
