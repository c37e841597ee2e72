#!/usr/bin/env python3
"""Smoke run of irn_tpu_torch on one NVIDIA card: python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``irn_tpu_torch/csrc`` (printing
each source's registers and spills and, from ``cuobjdump -sass``, its HGMMA
count: K2, K5, K6 and K9 must run on ``wgmma`` without a spill, K13's
``path_max.cu``, K14's ``crf_landmark.cu``, K16's ``irn_loss.cu`` and K17's
``crf_mean_field.cu`` without a spill), checks each
kernel against its plain PyTorch twin at the main path's shapes and times
it beside the twin, one library call where there is one and its bound,
then drives make_sem_seg end to end through the port's CLI
(``irn_tpu_torch.pipeline.run.main``) on a synthetic VOC-sized tree with a
seeded random IRNet, in five configurations, each with the launch counts
set to 0 just before it and read just after:

- ``default``: the K0 stencil walk, one K0 launch per walk;
- ``banded`` = ``--rw_square_times 1``: K2 squaring (two launches), K1
  pack, K3 chain (one cooperative launch per walk);
- ``pure`` = ``--rw_square_times 8`` on 4 images: the reference's pure
  squaring on the dense route, K6 then 7 x K5 (two launches each);
- ``e3`` = ``--exp_times 3 --rw_square_times 3``: three K2 squarings, then
  one K4 application;
- ``e3_diag`` = ``--exp_times 3``: the K0 stencil, e3's comparison.

Then the library entry points ``random_walk.propagate_banded(...,
bj=1024)`` on one image (the K7 masked-band chain, one launch) and
``random_walk.propagate_banded_batch(..., square_times=1)`` on four images
of one bucket (the K8 batched chain, one launch, each image bit-equal to
``propagate_banded``); the two tools' entry points, ``tools.bench_conv``
over its four shapes (``probe conv``: K9 against its twin and cuDNN's bf16
conv) and ``tools.bench_banded``'s batched sweep at B 1, 2, 4 (K8); the
pure route of one image through the plain twins on the card, one image's
default walk through the twins on the host, and a per-layer breakdown.

The default walk is three hand-kernel launches per image and pass: K10
builds the operator (``csrc/diag_operator.cu``, one launch), K0 runs the
chain, K15 decodes (``csrc/decode.cu``: the x4 upsample and global max,
then the normalize and argmax, two launches); the default runs count them
per walk, and the kernels phase holds K10 (the three buckets, a sigmoid
map, its 8-level ties and all ones, beta 1 and 10) and K15 (C 8 and 128,
odd extents, zeros, planted ties) to their twins bit for bit. The host
twin walk of one image equals the card's, label for label.

The phase ``stage: make_cam -> cam_to_ir_label`` runs the front of the
pipeline through the CLI on the same tree with a seeded random CAMNet
(saved through ``cam_to_jax``): make_cam (four scales, cam_infer_batch 32)
and eval_cam, cam_to_ir_label with the device CRF (``auto``: int8; then
``tpu --crf_kernel_store dense``) and with the native lattice (built from
``native/`` at first use), TF32 switched on before and required off inside
the stages; then make_sem_seg's default walk on make_cam's own CAMs (one K0
launch per image). It holds one image's make_cam on the card to the port
on the host (max-abs < 1e-3), the device CRF on the card to the host port
on one image's crop (int8 >= 99.9% equal labels, dense bf16 >= 99.5%) and
to the native lattice (>= 90% per image), and prints each stage's smoke
rate, a per-step breakdown (with the kernel build's peak memory above the
stored kernel) and the CRF products' times beside their bound. The device
CRF builds its landmark kernel in two K14 launches per image, its table
pass and its rows (``csrc/crf_landmark.cu``), and runs its ten
iterations through K17 (``csrc/crf_mean_field.cu``): 2 + 2 t = 22
launches per image and pass (the Gaussian's row norms, the start, a
quantize and a combine around each library product). Over the two int8
passes that is 32 K14 and 352 K17 launches, in the dense run 16 and 176,
none under the native lattice, and no other hand kernel in these stages
(the rest of their work is cuDNN's and cuBLAS's). The kernels phase holds
K14 to its twin bit for bit, store and row sums, at the 512x512 bucket
and an odd 92x84 one (S 483) with each store, on a scene, an all-black
and a uniform image, a row range and the sums alone, its table pass to
the table's twin, and times each store with the SASS instructions per
entry of its int8 row loop (beside its first design:
``tools/probe_crf_landmark.py``). It holds every K17 launch (blur,
start, quantize with each operand, combine into q and into the labels)
to its twin bit for bit at the same two buckets on one image's int8 and
bf16 kernels, ten iterations' labels to the twins' loop, and times
quantize, combine, the product and whole iterations (int8 and dense).

The phase ``stage: train_irn`` trains IRNet through the CLI at its
defaults (crop 512, batch 32, path radius 10, lr 0.1) with a seeded random
backbone on the cam phase's ir labels (the 8 images 8 times: 2 steps per
epoch): 2 epochs, then the same run at 3 epochs resumed from its
``.train`` file (2 more steps), TF32 switched on before and required off
inside; per step one K13a, two K16 forward, one K16 backward and one
K13b launch (6, 12, 6 and 6); every loss
finite, the backbone bit-equal to its initial values, every head tensor
moved, dp_mean a finite pair; make_sem_seg and make_ins_seg on the trained
checkpoint. It holds one step at batch 4 on the card to the port on the
host (losses within 1e-3, head updates within 1e-2 in norm) and prints
the step time (median after the first, batch 32), img/s, a per-step
breakdown (heads forward, loss forward K13a + K16, backward, K13a, K13b
and both K16 launches alone), the device's busy share over a step and the
peak memory. The kernels phase holds K13a and K13b to their twins bit for
bit at the default shapes (a sigmoid map and the same map quantized to 8
levels) and an odd small shape, and K16's forward and backward to their
twins run on the card (the f64 stats, the loss values, d_maxed and d_dp)
at the default shapes on synthetic reduced labels, labels with 255, no
foreground, NaN in dp, radii 5 and 4 and an odd map, timed beside the
eager composition's forward + backward.

The phase ``stage: train_cam`` trains the CAM classifier through the CLI
at its defaults (crop 512, batch 16, lr 0.1, ``cam_stop_grad`` c3, the
frozen batch norms calibrated from one batch, no pretrained backbone) on
the tree's 8 images 4 times (2 steps per epoch; the val list is the 8
images, one tail batch): 2 epochs with ``--profile_dir``, then the same run
at 3 epochs resumed from its ``.train`` file (2 more steps), TF32 switched
on before and required off inside; no hand kernel launched; every loss and
validate loss finite; the stem and layers 1-2 bit-equal to their initial
values while every statistic was calibrated; every layer3, layer4 and head
tensor moved; one trace under ``<profile_dir>/train_cam``; make_cam and
eval_cam on the trained checkpoint, one image's make_cam on the host
(max-abs < 1e-3) and the trained head's maps before the ReLU, card vs
host. It holds one step at batch 4 on the card to the port on the host
and to the same step in f64 on the card (loss within 1e-3; the update in
norm within 2e-3 of the host's and no farther from f64 than 1.25x the
host's) and prints the step time at batch 16, img/s, a per-step breakdown
(loader, upload, stem..c3 forward without autograd, c4..head forward +
loss, backward, optimizer), the device's busy share and the peak memory.

The phase ``stage: make_ins_seg -> eval_ins_seg -> make_cocoann`` runs the
instance stages through the CLI on make_sem_seg's tree, GT cams and
checkpoint: two passes at the defaults (K11 one launch per image; K12a and
K12b three launches per call, two calls each per image), eval_ins_seg and
the rle COCO json, then every flow (host clustering, host split, both, a
cluster cap of 1, a seed cap of 8) on 4 images with the displacement head
x2, each writing the default run's dicts; the card's dicts of two images
against the port on the host (same instances and classes, masks >= 99.9%
equal, scores within 2e-3), a per-step breakdown and the device's busy
share. The kernels phase holds K11 (300 steps at the 128x128 cap) and K12
(the basin plane, a 384x512 label map) to their twins exactly and K0 at
128 seed rows bit-equal.

Every check that fails raises, so the exit code is non-zero; without CUDA,
or without the repository beside it, the script fails before printing any
result.

The last three lines of standard output are the card's name and power
limit (nvidia-smi), one JSON object with the per-kernel results (its
``launches`` count kernel launches in the run of the kernel's path, see
``HOME_RUN``; ``bound_ms`` is the larger of the operations over the peak
for their type and the bytes over HBM's rate, from the run's shapes;
``library_ms`` is one PyTorch call computing the same function, or null;
K2, K5 and K6 add ``bound_f32_ms``, the bound of the same work in f32
outside the tensor cores; the three chains over the nonzero entries (K3,
K7, K8) count those entries in ``bound_ms`` and every band row in
``bound_dense_ms``, beside their occupied-row, ELL-entry and held shares,
``ms_per_application`` and the shares of their CTAs' clocks by phase
(``phase_shares``), with K3 one image at a time beside K8 (``k3_ms``) and
K1 + K3 beside K7 (``k13_ms``); ``shared`` is true when nvidia-smi showed
another process on the card, so the times are not clean), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# main-path geometry: the (96, 128) grid bucket of a VOC-sized image
BUCKET = (96, 128)
BS = 512
BJ = 1024  # K7's output tile in the library call
N_IMAGES = 8
N_PURE = 4  # images of the pure-squaring run (about 1-2.3 s each)
B_BATCH = 4  # images of the batched chain (K8); the tree's first 4 share
             # the 128x128 bucket
SEED = 0

REPLACES = {
    "diag_chain": "irn_tpu/ops/random_walk.py:208",
    "pack_banded": "irn_tpu/ops/matpow_pallas.py:742",
    "square_banded": "irn_tpu/ops/matpow_pallas.py:218",
    "packed_chain": "irn_tpu/ops/matpow_pallas.py:536",
    "apply_banded": "irn_tpu/ops/matpow_pallas.py:295",
    "square_dense": "irn_tpu/ops/matpow_pallas.py:126",
    "square_fused_first": "irn_tpu/ops/matpow_pallas.py:810",
    "banded_chain": "irn_tpu/ops/matpow_pallas.py:457",
    "packed_chain_batched": "irn_tpu/ops/matpow_pallas.py:678",
    "conv3x3": "tools/bench_conv_pallas.py:82",
    # XLA programs of the instance stage, not Pallas kernels
    "advect": "irn_tpu/ops/centroids.py:140",
    "ccl_label": "irn_tpu/ops/ccl_tpu.py:55",
    "ccl_tables": "irn_tpu/ops/ccl_tpu.py:122",
    # train_irn's path max and its custom VJP (XLA programs)
    "path_max_fwd": "irn_tpu/ops/affinity.py:41",
    "path_max_bwd": "irn_tpu/ops/affinity.py:87",
    # the default walk's operator build (band_values :144 and affinity.py
    # path_affinity :130 under it) and its decode (upsample_scores :851
    # with it), XLA programs
    "diag_operator": "irn_tpu/ops/random_walk.py:187",
    "decode": "irn_tpu/ops/random_walk.py:873",
    # the device CRF's landmark-kernel build (crf_pair_program's build_chunk,
    # mapped over 4096-row chunks), an XLA program
    "crf_landmark": "irn_tpu/ops/crf_tpu.py:196",
    # the device CRF's mean-field iterations (the unrolled loop :259-295,
    # the first softmax :258, the argmax :299), an XLA program
    "crf_mean_field": "irn_tpu/ops/crf_tpu.py:259",
    # train_irn's loss side after the path max (affinity_labels_2d :171,
    # pair_displacement :241, affinity_displacement_loss_maps :274 after
    # path_affinity, irn_total_loss :297) and its autodiff, XLA programs
    "irn_loss_fwd": "irn_tpu/ops/affinity.py:274",
    "irn_loss_bwd": "irn_tpu/ops/affinity.py:297",
}
SOURCES = {
    "diag_chain": "irn_tpu_torch/csrc/diag_chain.cu",
    "pack_banded": "irn_tpu_torch/csrc/pack_banded.cu",
    "square_banded": "irn_tpu_torch/csrc/square_banded.cu",
    "packed_chain": "irn_tpu_torch/csrc/packed_chain.cu",
    "apply_banded": "irn_tpu_torch/csrc/apply_banded.cu",
    "square_dense": "irn_tpu_torch/csrc/square_dense.cu",
    "square_fused_first": "irn_tpu_torch/csrc/square_fused_first.cu",
    "banded_chain": "irn_tpu_torch/csrc/banded_chain.cu",
    "packed_chain_batched": "irn_tpu_torch/csrc/packed_chain_batched.cu",
    "conv3x3": "irn_tpu_torch/csrc/conv3x3.cu",
    "advect": "irn_tpu_torch/csrc/advect.cu",
    "ccl_label": "irn_tpu_torch/csrc/ccl.cu",
    "ccl_tables": "irn_tpu_torch/csrc/ccl.cu",
    "path_max_fwd": "irn_tpu_torch/csrc/path_max.cu",
    "path_max_bwd": "irn_tpu_torch/csrc/path_max.cu",
    "diag_operator": "irn_tpu_torch/csrc/diag_operator.cu",
    "decode": "irn_tpu_torch/csrc/decode.cu",
    "crf_landmark": "irn_tpu_torch/csrc/crf_landmark.cu",
    "crf_mean_field": "irn_tpu_torch/csrc/crf_mean_field.cu",
    "irn_loss_fwd": "irn_tpu_torch/csrc/irn_loss.cu",
    "irn_loss_bwd": "irn_tpu_torch/csrc/irn_loss.cu",
}
# the run whose launch counts the kernels line reports for each kernel
HOME_RUN = {
    "diag_chain": "default", "pack_banded": "banded",
    "square_banded": "banded", "packed_chain": "banded",
    "apply_banded": "e3", "square_dense": "pure",
    "square_fused_first": "pure", "banded_chain": "library bj",
    "packed_chain_batched": "library batch", "conv3x3": "probe conv",
    "advect": "ins default", "ccl_label": "ins default",
    "ccl_tables": "ins default", "path_max_fwd": "train irn",
    "path_max_bwd": "train irn", "diag_operator": "default",
    "decode": "default", "crf_landmark": "cam stages",
    "crf_mean_field": "cam stages", "irn_loss_fwd": "train irn",
    "irn_loss_bwd": "train irn",
}


# the card's published peaks (H100 SXM, dense, at the 700 W limit): f32
# outside the tensor cores, bf16 on them, HBM
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_BYTES_S = 3.35e12
# exponentials per second on the SFUs: 16 per SM and clock, 132 SMs at the
# 1.98 GHz boost clock
SFU_EXP_S = 132 * 16 * 1.98e9

# kernels that must run on wgmma: the build phase fails if their SASS holds
# no HGMMA instruction or ptxas reports a spill in their source
WGMMA_KERNELS = ("conv3x3", "square_banded", "square_dense",
                 "square_fused_first")
# other sources whose build fails on a register spill
SPILL_CHECKED = ("path_max", "crf_landmark", "crf_mean_field", "irn_loss")
# K0 launch plans timed beside the chosen one: (seed rows, CTAs) per
# cluster, w in shared memory or from L2
DIAG_PLANS = ((1, 16, True), (2, 16, True), (4, 16, True), (1, 16, False),
              (2, 16, False), (1, 8, False))


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi(*query: str) -> str:
    out = subprocess.run(["nvidia-smi", *query], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call (CUDA events after warm-up)."""
    for _ in range(warmup):
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


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds per call that the card itself spends on ``fn``'s
    kernels, copies and memsets (torch.profiler's device time over ``reps``
    calls after a warm-up), apart from the host's time to launch them, which
    ``cuda_ms`` includes when a call's device work is shorter."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def bound(ops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of ``ops`` over
    ``peak`` and ``nbytes`` (each input read once, each output written
    once) over HBM's rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _band_rows(n: int, bs: int, kh: int) -> int:
    """Rows of T inside the matrix over all packed tiles: tile j spans
    rows [(j - kh) bs, (j + kh + 1) bs)."""
    return sum(min(n, (j + kh + 1) * bs) - max(0, (j - kh) * bs)
               for j in range(n // bs))


def _band_nnz(n: int, h: int) -> int:
    """Entries with |r - c| <= h of an n x n matrix."""
    return sum(min(n - 1, c + h) - max(0, c - h) + 1 for c in range(n))


def _square_banded_work(n: int, h: int, bs: int) -> tuple:
    """(ops, bytes) of K2: the in-band output blocks, each contracting the
    blocks inside both operands' bands; the input's in-band blocks read
    once, the output's written once."""
    nb, kb, jb = n // bs, -(-h // bs), -(-2 * h // bs)
    ops = 0
    out_blocks = 0
    for i in range(nb):
        for j in range(max(0, i - jb), min(nb, i + jb + 1)):
            out_blocks += 1
            klo, khi = max(max(i, j) - kb, 0), min(min(i, j) + kb, nb - 1)
            ops += 2 * bs ** 3 * max(0, khi - klo + 1)
    in_blocks = sum(min(nb, i + kb + 1) - max(0, i - kb) for i in range(nb))
    return ops, (in_blocks + out_blocks) * bs * bs * 4


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


PHASES = ("prologue", "grid barriers", "x waits", "products", "sums")


def phase_shares(timing: torch.Tensor) -> dict:
    """Where the chain's CTAs' clocks went (thread 0 of each CTA, summed
    over the CTAs), as shares of the five phases of ``timing`` [CTAs, 5]."""
    cycles = timing.double().sum(0)
    return {name: float(v / cycles.sum()) for name, v in zip(PHASES, cycles)}


def _phases_text(shares: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in shares.items())


def chain_stats(stats: torch.Tensor, occupied: list, entries: list, plan,
                span: int, what: str) -> dict:
    """A chain's per-item stats [items, 3] (or [B, items, 3]) held to the
    plain occupied rows, ELL entries and held share (per image), and its
    shares: occupied 32-column row segments and ELL entries per tile row,
    and the entries held in shared memory."""
    from irn_tpu_torch.ops import matpow_kernels as mk

    stats = stats.cpu().reshape(-1, stats.shape[-2], 3)
    items = stats.shape[1]
    check(stats[..., 0].flatten().tolist() == occupied
          and stats[..., 1].flatten().tolist() == entries,
          f"{what} occupancy or ELL lengths differ from the plain ones")
    held = [h for b in range(stats.shape[0]) for h in mk.packed_chain_held_plain(
        entries[b * items : (b + 1) * items], plan)]
    check(stats[..., 2].flatten().tolist() == held,
          f"{what} held entries differ from the plain share")
    rows = stats.shape[0] * items * span
    return dict(occupied_share=sum(occupied) / rows,
                entry_share=sum(entries) / rows,
                held_share=sum(held) / max(sum(entries), 1))


def hgmma_counts(sass: str) -> dict:
    """HGMMA (wgmma) instructions in the built library's SASS listing per
    kernel source. Every kernel sits in its source's anonymous namespace,
    whose mangled name carries the file name (``_10_conv3x3_cu_`` for
    conv3x3.cu), so each ``Function :`` block is attributed by that; a
    kernel that shares its source (K12a and K12b in ccl.cu) reports the
    source's count."""
    stems = {os.path.basename(src)[:-3] for src in SOURCES.values()}
    tags = {k: f"_{len(k) + 3}_{k}_cu_" for k in stems}
    per_source = {k: 0 for k in stems}
    owner = None
    for line in sass.splitlines():
        s_ = line.strip()
        if s_.startswith("Function :"):
            owner = next((k for k, tag in tags.items() if tag in s_), None)
        elif "HGMMA" in s_ and owner:
            per_source[owner] += 1
    return {k: per_source[os.path.basename(src)[:-3]]
            for k, src in SOURCES.items()}


def sass_loops(sass: str, kernel: str) -> list:
    """The SASS instruction counts of the loops (a branch back to a lower
    address, the branch included) of the one function whose mangled name
    holds ``kernel``, largest first."""
    from irn_tpu_torch.ops import _build

    fns = [v for k, v in _build.sass_functions(sass).items() if kernel in k]
    check(len(fns) == 1, f"{kernel}: {len(fns)} functions in the SASS")
    ins = []
    for line in fns[0]:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, text in ins:
        m = re.search(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            loops.append(sum(1 for a, _ in ins
                             if int(m.group(1), 16) <= a <= addr))
    return sorted(loops, reverse=True)


def build_report(here: str) -> tuple:
    """Build the kernels; print each source's ptxas register and spill
    lines and each kernel's HGMMA count; fail if a wgmma kernel shows no
    HGMMA, or a wgmma kernel's or a SPILL_CHECKED source spills. Returns
    (the HGMMA counts, the library's SASS listing)."""
    from irn_tpu_torch.ops import _build

    _build.load()
    info = _build.BUILD_INFO
    print(f"built {os.path.relpath(info['path'], here)} in "
          f"{info['seconds']:.2f} s (cached: {info['cached']})", flush=True)
    for src, log in sorted(info.get("logs", {}).items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "wgmma" in line:
                print(f"  {src}: {line.strip()}", flush=True)
        if src in WGMMA_KERNELS + SPILL_CHECKED:
            spills = [ln.strip() for ln in log.splitlines()
                      if any(int(v) for v in re.findall(
                          r"(\d+) bytes spill (?:stores|loads)", ln))]
            check(not spills, f"{src}: register spills {spills}")
    sass = _build.cuobjdump_sass(info["path"])
    counts = hgmma_counts(sass)
    print(f"HGMMA instructions per kernel source: {counts}", flush=True)
    for k in WGMMA_KERNELS:
        check(counts[k] > 0, f"{k}: no HGMMA instruction in its SASS")
    return counts, sass


def check_kernels(dev, card: str, sass: str) -> dict:
    """K0-K3 vs their plain twins at the main path's shapes (K0 also under
    each plan of DIAG_PLANS)."""
    from irn_tpu_torch.ops import matpow_kernels as mk
    from irn_tpu_torch.ops import random_walk as rw

    gen = torch.Generator().manual_seed(SEED)
    geom = rw.build_geometry(*BUCKET, radius=5)
    n = geom.n_pad
    h = rw.band_halfwidth(geom)
    check(n == 14336 and h == 556, f"geometry n={n} h={h}")
    edge = torch.rand(BUCKET, generator=gen).to(dev) * 0.9
    x = torch.rand((8, n), generator=gen).to(dev)
    res = {}

    # K0: 256 applications of T in diagonal form, C = 8 seed rows, in one
    # launch; bit-equal to its twin under every plan
    w, inv = rw.build_diag_operator(geom, edge)
    doffs = rw.diag_offsets(geom)
    got = rw.apply_diag_chain(x, w, inv, doffs, 256)
    want = rw.apply_diag_chain_plain(x, w, inv, doffs, 256)
    check(torch.equal(got, want), "diag_chain not bit-equal to its twin")
    plan = rw.card_diag_chain_plan(dev, 8, n, tuple(doffs))
    plans = []

    def held(p_):
        return rw.diag_chain_max_clusters(dev, 8, n, doffs, p_)

    for rows, cluster, w_shared in DIAG_PLANS:
        p_ = rw.diag_chain_plan(8, n, doffs, held, rows, cluster, w_shared)
        check(torch.equal(rw.launch_diag_chain(x, w, inv, doffs, 256, p_),
                          want), f"diag_chain plan {p_} not bit-equal")
        t_ = cuda_ms(
            lambda: rw.launch_diag_chain(x, w, inv, doffs, 256, p_), 10)
        plans.append(f"rows {p_[0]} x {p_[1]} CTAs, w in "
                     f"{'shared memory' if p_[4] else 'L2'}, {held(p_)} "
                     f"clusters at once: {t_:.4f} ms")
    ms = cuda_ms(lambda: rw.apply_diag_chain(x, w, inv, doffs, 256), 10)
    # the chosen plan with no diagonals: what the 256 applications' cluster
    # barriers, halo exchanges and output cost alone
    sync_ms = cuda_ms(lambda: rw.launch_diag_chain(
        x, w[:0], inv, (), 256, plan), 10)
    res["diag_chain"] = dict(
        max_abs_err=0.0,
        ms=ms,
        ms_per_application=ms / 256,
        plain_ms=cuda_ms(
            lambda: rw.apply_diag_chain_plain(x, w, inv, doffs, 256), 2),
        shape=(f"x [8, {n}], w [{len(doffs)}, {n}], 256 applications, one "
               f"launch; bit-equal; plan (rows, CTAs, slice, halo, w in "
               f"shared memory) {plan}; the plan with no diagonals (barriers "
               f"and halo exchange alone) {sync_ms:.4f} ms; "
               f"per plan: {', '.join(plans)}"),
        library_ms=None,
        **bound(256 * 8 * n * (4 * len(doffs) + 1),
                4 * (8 * n + len(doffs) * n + n) + 4 * 8 * n, PEAK_F32),
    )

    # K2: one banded squaring of T (h = 556), NaN in every input block
    # beyond kb (never read): the split pass alone bit-equal to its twin,
    # the split product against the twin in band
    t = rw.normalize_transition(rw.dense_affinity(geom, edge))
    t_nan = _poison_blocks(t, h)
    check(torch.equal(mk.split_banded(t_nan, h, BS),
                      mk.split_banded_plain(t, h, BS)),
          "square_banded split pass not bit-equal to its twin")
    got = mk.square_banded(t_nan, h, BS)
    want = mk.square_banded_plain(t, h, BS)
    r = torch.arange(n, device=dev)
    inband = (r[:, None] - r[None, :]).abs() <= 2 * h
    err, rel = rel_err(got[inband], want[inband])
    check(bool(torch.isfinite(got[inband]).all()) and rel <= 1e-5,
          f"square_banded rel err {rel}")
    ops, nbytes = _square_banded_work(n, h, BS)
    res["square_banded"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: mk.square_banded(t_nan, h, BS), 5),
        plain_ms=cuda_ms(lambda: mk.square_banded_plain(t, h, BS), 3),
        shape=(f"T [{n}, {n}], h {h}, bs {BS}, NaN beyond the input band; "
               f"split pass bit-equal; library: dense torch.matmul"),
        library_ms=cuda_ms(lambda: torch.matmul(t, t), 1),
        # six bf16 passes on the tensor cores; the f32 SIMT line beside it
        bound_f32_ms=bound(ops, nbytes, PEAK_F32)["bound_ms"],
        **bound(6 * ops, nbytes, PEAK_BF16),
    )
    del inband, want, t_nan

    # K1: pack T^2 (h = 1112), bit-equal
    t2, h2 = got, 2 * h
    got = mk.pack_banded(t2, h2, BS)
    want = mk.pack_banded_plain(t2, h2, BS)
    check(torch.equal(got, want), "pack_banded not bit-equal")
    res["pack_banded"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: mk.pack_banded(t2, h2, BS), 10),
        plain_ms=cuda_ms(lambda: mk.pack_banded_plain(t2, h2, BS), 5),
        shape=f"T^2 [{n}, {n}] -> tiles {tuple(got.shape)}",
        library_ms=None,
        **bound(0, 4 * (_band_rows(n, BS, (got.shape[1] // BS - 1) // 2) * BS
                        + got.numel()), PEAK_F32),
    )

    # K3: 128 applications over the packed tiles, C = 8, in one cooperative
    # launch; its per-item occupied and held row segments against the plain
    # occupancy and share
    tp = got
    del want, t
    kh = (tp.shape[1] // BS - 1) // 2
    plan = mk.card_packed_chain_plan(dev, n, BS, kh)
    got, stats, timing = mk.launch_packed_chain(x, tp, 128, BS, plan)
    phases = phase_shares(timing)
    want = mk.packed_chain_plain(x, tp, 128, BS)
    err, rel = rel_err(got, want)
    check(rel <= 1e-4, f"packed_chain rel err {rel}")
    check(torch.equal(got, mk.packed_chain(x, tp, 128, BS)),
          "packed_chain not deterministic")
    occupied = mk.packed_occupancy_plain(tp).sum(-1).flatten().tolist()
    ell = mk.packed_ell_plain(tp).flatten(0, 1)  # [items, slots, 4]
    entries = ell.sum((-2, -1)).tolist()
    # the chain's critical path: each slot step waits for its CTA's longest
    # quarter-slot; the most entries a CTA's steps sum to, per application
    ell_cta = torch.nn.functional.pad(
        ell, (0, 0, 0, 0, 0, plan[0] * plan[1] - ell.shape[0])).reshape(
        plan[0], plan[1], ell.shape[1], 4)
    critical = int(ell_cta.amax((1, 3)).sum(1).max())
    mean_warp = float(ell.sum()) / (ell.shape[0] * 4)
    shares = chain_stats(stats, occupied, entries, plan, tp.shape[1],
                         "packed_chain")
    nnz = int((tp != 0).sum())
    padding = sum(entries) * mk.PACKED_STRIP / max(nnz, 1)
    # where the time goes: one application (the prologue's scan and copy
    # plus one application), and all-zero tiles (nothing occupied: the grid
    # barriers, x staging and slot sums alone)
    zeros = torch.zeros_like(tp)
    one_ms = cuda_ms(lambda: mk.packed_chain(x, tp, 1, BS), 5)
    zero_ms = cuda_ms(lambda: mk.packed_chain(x, zeros, 128, BS), 5)
    zero_one_ms = cuda_ms(lambda: mk.packed_chain(x, zeros, 1, BS), 5)
    del zeros
    ms = cuda_ms(lambda: mk.packed_chain(x, tp, 128, BS), 5)
    res["packed_chain"] = dict(
        max_abs_err=err,
        ms=ms,
        ms_per_application=ms / 128,
        plain_ms=cuda_ms(lambda: mk.packed_chain_plain(x, tp, 128, BS), 3),
        shape=(f"x [8, {n}], tiles {tuple(tp.shape)}, 128 applications, "
               f"one launch; plan (CTAs, items per CTA, threads, x blocks, "
               f"entry slots, shared bytes) {plan}; 32-column row "
               f"segments occupied {shares['occupied_share']:.4f}, ELL "
               f"entries per tile row {shares['entry_share']:.4f} "
               f"({padding:.3f} x the nonzeros), of those held in shared "
               f"memory {shares['held_share']:.4f}; entries "
               f"per application on the slowest CTA's path {critical}, per "
               f"warp on average {mean_warp:.1f}; nonzero "
               f"tile entries "
               f"{nnz} ({nnz / tp.numel():.4f}); bound over the nonzero "
               f"entries, dense bound beside it; one application "
               f"{one_ms:.4f} ms; all-zero tiles {zero_ms:.4f} ms (one "
               f"application {zero_one_ms:.4f} ms); shares of the CTAs' "
               f"clock: {_phases_text(phases)}"),
        library_ms=None,
        phase_shares=phases,
        **shares,
        # the work the data needs: the nonzero entries, read once; the
        # dense bound (every in-matrix tile row, tiles read once per chain,
        # as if they stayed on chip) beside it
        bound_dense_ms=bound(
            128 * 2 * 8 * _band_rows(n, BS, kh) * BS,
            4 * (tp.numel() + 2 * x.numel()), PEAK_F32)["bound_ms"],
        **bound(128 * 2 * 8 * nnz, 4 * (nnz + 2 * x.numel()), PEAK_F32),
    )
    del got, want, tp, t2
    check_dense_kernels(dev, geom, edge, x, res)
    check_batched_chain(dev, geom, gen, res)
    check_conv(dev, res)
    check_instance_kernels(dev, geom, edge, gen, res)
    check_path_max_kernels(dev, gen, res)
    check_irn_loss(dev, gen, res, sass)
    check_walk_kernels(dev, gen, res)
    check_crf_landmark(dev, gen, res, sass)
    check_crf_mean_field(dev, gen, res, sass)
    for name, r_ in res.items():
        lib = (f"{r_['library_ms']:.4f} ms" if r_["library_ms"] is not None
               else "none")
        per_app = (f" ({r_['ms_per_application'] * 1e3:.3f} us per "
                   f"application)" if "ms_per_application" in r_ else "")
        print(f"kernel {name}: max_abs_err {r_['max_abs_err']:.3e} "
              f"kernel {r_['ms']:.4f} ms{per_app}, plain twin "
              f"{r_['plain_ms']:.4f} ms, "
              f"library {lib}, bound {r_['bound_ms']:.4f} ms "
              f"({r_['bound_by']}) ({r_['shape']}; {card})", flush=True)
    return res


# the instance stage's main-path shapes: a 375x500 VOC image's stride-4
# extent in the 128x128 grid cap, its walk at the (96, 128) bucket
INS_CAP = 128
INS_EXTENT = (94, 125)
INS_LABELS = (4 * BUCKET[0], 4 * BUCKET[1])
# f32 operations per pixel and step of K11: per channel two products and
# two fused multiply-adds (the rows), two products and a sum (the column);
# four differences, two sums and four clamps of the position
ADVECT_OPS = 2 * (2 + 2 * 2 + 3) + 4 + 2 + 4


def basin_field(gen, cap: int, hw4: tuple) -> torch.Tensor:
    """dp [2, cap, cap] pulling toward three centres with noise (a trained
    field's shape: basins that contract the trajectories), zero beyond the
    extent."""
    h4, w4 = hw4
    yy, xx = torch.meshgrid(torch.arange(cap, dtype=torch.float32),
                            torch.arange(cap, dtype=torch.float32),
                            indexing="ij")
    centres = torch.tensor([[0.3, 0.25], [0.35, 0.75], [0.75, 0.5]]) * \
        torch.tensor([h4, w4])
    d2 = (yy[None] - centres[:, 0, None, None]) ** 2 + \
        (xx[None] - centres[:, 1, None, None]) ** 2
    near = centres[d2.argmin(0)]
    dp = torch.stack([(near[..., 0] - yy) * 0.3, (near[..., 1] - xx) * 0.3])
    dp += torch.randn(dp.shape, generator=gen) * 0.1
    dp[:, h4:] = 0
    dp[:, :, w4:] = 0
    return dp


def check_instance_kernels(dev, geom, edge, gen, res: dict) -> None:
    """K11 and K12 vs their twins at the instance stage's shapes, and K0 at
    the instance walk's 128 seed rows."""
    from irn_tpu_torch.ops import ccl
    from irn_tpu_torch.ops import centroids
    from irn_tpu_torch.ops import random_walk as rw

    # K0 at C 128 (ins_seed_cap): several waves of clusters, bit-equal
    w, inv = rw.build_diag_operator(geom, edge)
    doffs = rw.diag_offsets(geom)
    x128 = torch.rand((128, geom.n_pad), generator=gen).to(dev)
    got = rw.apply_diag_chain(x128, w, inv, doffs, 256)
    check(torch.equal(got, rw.apply_diag_chain_plain(x128, w, inv, doffs,
                                                     256)),
          "diag_chain at C 128 not bit-equal to its twin")
    c128 = cuda_ms(lambda: rw.apply_diag_chain(x128, w, inv, doffs, 256), 3)
    res["diag_chain"]["c128_ms"] = c128
    res["diag_chain"]["shape"] += (
        f"; at C 128 (ins_seed_cap, plan "
        f"{rw.card_diag_chain_plan(dev, 128, geom.n_pad, tuple(doffs))}): "
        f"bit-equal, {c128:.4f} ms")
    del x128, got

    # K11: 300 steps over the 128x128 cap at a VOC image's extent
    hw4 = INS_EXTENT
    n = INS_CAP * INS_CAP
    dp = basin_field(gen, INS_CAP, hw4).to(dev)
    cent, basin = centroids.advect(dp, *hw4)
    want_cent, want_basin = centroids.advect_plain(dp, *hw4)
    check(torch.equal(cent, want_cent) and torch.equal(basin, want_basin),
          "advect not bit-equal to its twin")
    rdp = (torch.randn((2, INS_CAP, INS_CAP), generator=gen) * 3).to(dev)
    check(all(torch.equal(a, b) for a, b in zip(
        centroids.advect(rdp, *hw4), centroids.advect_plain(rdp, *hw4))),
        "advect not bit-equal to its twin on a random field")
    res["advect"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: centroids.advect(dp, *hw4), 20),
        plain_ms=cuda_ms(lambda: centroids.advect_plain(dp, *hw4), 2),
        shape=(f"dp [2, {INS_CAP}, {INS_CAP}] f32, extent {hw4}, 300 steps, "
               f"one launch; end points and basin bit-equal (a basin field "
               f"and a random one)"),
        library_ms=None,
        **bound(300 * n * ADVECT_OPS, 4 * 2 * n + 4 * 2 * n + n, PEAK_F32),
    )

    # K12a + K12b on the basin plane: the clusters (k_cap 8)
    lab = ccl.min_label_plane(basin, *hw4)
    check(torch.equal(lab.cpu(), ccl.min_label_plane(basin.cpu(), *hw4)),
          "ccl_label (basin) differs from its twin")
    masks, n_found = ccl.cluster_masks(lab, cent, *hw4, 8)
    want_masks, want_n = ccl.cluster_masks_plain(lab, cent, *hw4, 8)
    check(torch.equal(masks, want_masks) and int(n_found) == int(want_n),
          "cluster_masks differ from their twin")
    cluster_ms = cuda_ms(lambda: ccl.cluster_masks(lab, cent, *hw4, 8), 20)
    basin_ms = cuda_ms(lambda: ccl.min_label_plane(basin, *hw4), 20)

    # K12a + K12b on a decoded label map of the (96, 128) bucket
    hl, wl = INS_LABELS
    blocks = torch.randint(0, 9, (hl // 64, wl // 64), generator=gen)
    labels = torch.kron(blocks, torch.ones((64, 64), dtype=torch.int64))
    labels = labels.to(torch.int32).to(dev)
    best = torch.rand((hl, wl), generator=gen).to(dev)
    minidx = ccl.min_label_plane_multi(labels)
    check(torch.equal(minidx, ccl.min_label_plane_multi_plain(labels)),
          "ccl_label (label map) differs from its twin")
    got = ccl.rank_tables(labels, minidx, best, 128)
    want = ccl.rank_tables_plain(labels, minidx, best, 128)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "component tables differ from their twin")
    n_comp = int(got[4])
    nl = hl * wl
    res["ccl_label"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: ccl.min_label_plane_multi(labels), 20),
        plain_ms=cuda_ms(lambda: ccl.min_label_plane_multi_plain(labels), 3),
        shape=(f"label map [{hl}, {wl}] int32, {n_comp} components, three "
               f"launches (init, merge, compress); equal to the twin; the "
               f"basin plane [{INS_CAP}, {INS_CAP}] at extent {hw4} "
               f"{basin_ms:.4f} ms, equal"),
        library_ms=None,
        **bound(0, 4 * nl + 4 * nl, PEAK_F32),
    )
    res["ccl_tables"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: ccl.rank_tables(labels, minidx, best, 128), 20),
        plain_ms=cuda_ms(lambda: ccl.rank_tables_plain(labels, minidx, best,
                                                       128), 3),
        shape=(f"component tables of the [{hl}, {wl}] map, comp_cap 128, "
               f"{n_comp} components, three launches; all five outputs "
               f"equal to the twin; cluster masks at the basin plane "
               f"(k_cap 8, {int(n_found)} found) {cluster_ms:.4f} ms, equal"),
        library_ms=None,
        # read labels, minidx and best, write the id map and the tables;
        # ranking compares each candidate key with every other
        **bound(n_comp * n_comp, 12 * nl + 4 * nl + 12 * 128, PEAK_F32),
    )


# train_irn's main-path shapes: batch 32 of 512 px crops (a 128x128 grid),
# path radius 10 (152 pairs, 2,134 cells)
TRAIN_BATCH = 32
TRAIN_GRID = 128
TRAIN_RADIUS = 10


def _special_g(shape, gen) -> torch.Tensor:
    """A cotangent of normals with a fifth signed zeros, +-inf on a tenth
    and one NaN."""
    g = torch.randn(shape, generator=gen)
    u = torch.rand(shape, generator=gen)
    g[u < 0.1] = 0.0
    g[(u >= 0.1) & (u < 0.2)] = -0.0
    g[(u >= 0.2) & (u < 0.25)] = float("inf")
    g[(u >= 0.25) & (u < 0.3)] = -float("inf")
    g.view(-1)[g.numel() // 3] = float("nan")
    return g


def _winner_targets(winner: torch.Tensor, table, hw) -> torch.Tensor:
    """The flat d_edge index each (pair, pixel) cotangent routes to: its
    winning cell's edge pixel."""
    h, w = hw
    b, n, ch, cw = winner.shape
    dev = winner.device
    cells = torch.zeros((n, max(len(c) for c in table.cells), 2),
                        dtype=torch.long)
    for p, path in enumerate(table.cells):
        cells[p, : len(path)] = torch.tensor(path)
    cells = cells.to(dev)
    pidx = torch.arange(n, device=dev)[None, :, None, None]
    wl = winner.long()
    y = torch.arange(ch, device=dev)[:, None] + cells[..., 0][pidx, wl]
    x = torch.arange(cw, device=dev) + table.rf + cells[..., 1][pidx, wl]
    bi = torch.arange(b, device=dev)[:, None, None, None]
    return ((bi * h + y) * w + x).reshape(-1)


def check_path_max_kernels(dev, gen, res: dict) -> None:
    """K13a and K13b vs their twins, bit for bit (values, winners, edge
    gradient): at the default shapes on a sigmoid edge map, on the same map
    quantized to 8 levels (ties) and with NaN and -inf planted; at radii 5
    and 4 at the default batch and grid; at B 1; on an odd small shape
    (radii 10 and 5) and a window narrower than one tile; and K13b on a cotangent with signed
    zeros, +-inf and a NaN (compared with equal NaNs). K13b's library
    yardstick: ``index_add_`` of the cotangents into their winners' pixels
    (atomics in no fixed order: not bit-equal)."""
    from irn_tpu_torch.ops import affinity
    from irn_tpu_torch.ops import paths

    def tab(radius):
        return affinity.path_table(paths.build_path_set(radius))

    table = tab(TRAIN_RADIUS)
    shape = (TRAIN_BATCH, TRAIN_GRID, TRAIN_GRID)
    edge = torch.sigmoid(torch.randn(shape, generator=gen)).to(dev)
    planted = edge.clone()
    planted.view(-1)[::37] = float("nan")
    planted.view(-1)[5::41] = -float("inf")

    def sig(s_):
        return torch.sigmoid(torch.randn(s_, generator=gen)).to(dev)

    cases = (("default", table, edge),
             ("ties", table, torch.round(edge * 7) / 7),
             ("NaN and -inf in the map", table, planted),
             ("radius 5", tab(5), sig(shape)),
             ("radius 4", tab(4), sig(shape)),
             ("B 1", table, sig((1, TRAIN_GRID, TRAIN_GRID))),
             ("odd", table, sig((3, 37, 29))),
             ("odd, radius 5", tab(5), sig((3, 37, 29))),
             ("window narrower than a tile", table, sig((2, 40, 40))))
    for tag, tb, e in cases:
        hw = tuple(e.shape[1:])
        maxed, winner = affinity.path_max_fwd(e, tb)
        want_m, want_w = affinity.path_max_plain(e, tb)
        check(torch.equal(maxed.view(torch.int32), want_m.view(torch.int32))
              and torch.equal(winner, want_w),
              f"path_max_fwd ({tag}) not bit-equal to its twin")
        g = torch.randn(tuple(maxed.shape), generator=gen).to(dev)
        check(torch.equal(affinity.path_max_bwd(g, winner, tb, hw),
                          affinity.path_max_bwd_plain(g, want_w, tb, hw)),
              f"path_max_bwd ({tag}) not bit-equal to its twin")
        g = _special_g(tuple(maxed.shape), gen).to(dev)
        torch.testing.assert_close(
            affinity.path_max_bwd(g, winner, tb, hw),
            affinity.path_max_bwd_plain(g, want_w, tb, hw), rtol=0, atol=0,
            equal_nan=True,
            msg=lambda m: f"path_max_bwd ({tag}, signed zeros, inf, NaN): "
                          f"{m}")
        del maxed, winner, want_m, want_w, g
    maxed, winner = affinity.path_max_fwd(edge, table)
    g = torch.randn(tuple(maxed.shape), generator=gen).to(dev)
    hw = tuple(edge.shape[1:])
    target = _winner_targets(winner, table, hw)
    gflat = g.reshape(-1)
    d_lib = torch.zeros(edge.numel(), device=dev)

    def library():
        d_lib.zero_().index_add_(0, target, gflat)

    library_ms = cuda_ms(library, 20)
    library()
    lib_err = float((d_lib.view(shape) - affinity.path_max_bwd(
        g, winner, table, hw)).abs().max())
    n_edge, n_out = edge.numel(), maxed.numel()
    cells = sum(len(c) for c in table.cells)
    desc = (f"edge [{TRAIN_BATCH}, {TRAIN_GRID}, {TRAIN_GRID}] f32, radius "
            f"{TRAIN_RADIUS} ({table.n_pairs} pairs, {cells} cells), one "
            f"launch; bit-equal to the twin on a sigmoid map, the map "
            f"quantized to 8 levels (ties), NaN and -inf planted, radii 5 "
            f"and 4, B 1, an odd [3, 37, 29] map (radii 10 and 5) and a "
            f"[2, 40, 40] map (window narrower than a tile)")
    res["path_max_fwd"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: affinity.path_max_fwd(edge, table), 20),
        plain_ms=cuda_ms(lambda: affinity.path_max_plain(edge, table), 2),
        shape=desc + f"; writes maxed f32 + winner int8 [{TRAIN_BATCH}, "
                     f"{table.n_pairs}, {maxed.shape[2]}, {maxed.shape[3]}]; "
                     f"{table.tables(dev).levels} stack levels of suffix "
                     f"pairs",
        library_ms=None,
        # one compare per path cell per output pixel
        **bound(cells * TRAIN_BATCH * maxed.shape[2] * maxed.shape[3],
                4 * n_edge + 5 * n_out, PEAK_F32),
    )
    res["path_max_bwd"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: affinity.path_max_bwd(g, winner, table, hw), 20),
        plain_ms=cuda_ms(lambda: affinity.path_max_bwd_plain(
            g, winner, table, hw), 2),
        shape=desc + f"; also equal (NaN as NaN) with signed zeros, +-inf "
                     f"and a NaN in g; reads g f32 + winner int8, writes "
                     f"d_edge; no atomics; "
                     f"library: index_add_ of g into its winners' pixels "
                     f"(atomics, no fixed order; max abs diff {lib_err:.3e})",
        library_ms=library_ms,
        # one add per cotangent (each lands in one pixel) and one per
        # (unique cell, pixel) group
        **bound(n_out + len(table.by_cell) * n_edge, 5 * n_out + 4 * n_edge,
                PEAK_F32),
    )
    del maxed, winner, g, edge, target, gflat, d_lib


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, NaN at the same places (its payload may differ)."""
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.masked_fill(nan, 0).view(view),
                       b.masked_fill(nan, 0).view(view))


def _eager_loss(maxed, dp, labels, table):
    """The eager composition from the path max's output: the label masks,
    the loss maps and ``irn_total_loss`` (the port's train step before
    K16)."""
    from irn_tpu_torch.ops import affinity

    with torch.no_grad():
        masks = affinity.affinity_labels_2d(labels, table.path_set)
    return affinity.irn_total_loss(affinity.loss_maps(maxed, dp, table),
                                   *masks)[0]


# K16's operations per (pair, window pixel), counted from irn_loss.cu: the
# forward's subtractions, adds, products and two logs; the backward's
# source and destination roles with two divisions
IRN_LOSS_FWD_OPS = 23
IRN_LOSS_BWD_OPS = 38


def check_irn_loss(dev, gen, res: dict, sass: str) -> None:
    """K16 forward and backward vs their twins run on the card, bit for bit
    (the f64 stats and the five loss values; d_maxed and d_dp, NaN where
    the twin has NaN): at the default shapes (B 32, 128x128, radius 10) on
    maxed from K13a over a sigmoid map and the probe's synthetic reduced
    labels (class ellipses, 255 bands), on labels of {0, 1, 2, 255}, with
    no foreground, with NaN in dp, at radii 5 and 4, and on an odd [3, 37,
    29] map. Times each with CUDA events and the profiler's device time
    beside its twin and the eager composition's forward + backward
    (``eager_ms``)."""
    from irn_tpu_torch.ops import affinity
    from irn_tpu_torch.ops import paths
    from irn_tpu_torch.tools.probe_train_step import reduced_labels

    def tab(radius):
        return affinity.path_table(paths.build_path_set(radius))

    def inputs(radius, shape, kind):
        table = tab(radius)
        b, h, w = shape
        edge = torch.sigmoid(torch.randn(shape, generator=gen))
        if radius > 14:
            # K13a's tables hold the path sets up to radius 14: its twin
            maxed = affinity.path_max_plain(edge, table)[0].to(dev)
        else:
            maxed, _ = affinity.path_max_fwd(edge.to(dev), table)
        dp = torch.randn((b, 2, h, w), generator=gen)
        if kind == "NaN in dp":
            dp.view(-1)[::101] = float("nan")
        if kind == "synthetic labels":
            lab = torch.from_numpy(reduced_labels(b, h, seed=SEED))
        else:
            vals = torch.tensor([0, 255] if kind == "no foreground"
                                else [0, 1, 2, 255], dtype=torch.int32)
            p = torch.tensor([0.8, 0.2] if kind == "no foreground"
                             else [0.4, 0.25, 0.25, 0.1])
            lab = vals[torch.multinomial(p, b * h * w, True, generator=gen)
                       ].reshape(shape)
        return table, maxed, dp.to(dev), lab.to(dev)

    g = torch.tensor([1.0, 0.25, -0.5, 0.125, 2.0], device=dev)
    full = (TRAIN_BATCH, TRAIN_GRID, TRAIN_GRID)
    cases = (("synthetic labels", TRAIN_RADIUS, full),
             ("labels with 255", TRAIN_RADIUS, full),
             ("no foreground", TRAIN_RADIUS, full),
             ("NaN in dp", TRAIN_RADIUS, full),
             ("labels with 255", 5, full), ("labels with 255", 4, full),
             ("labels with 255", TRAIN_RADIUS, (3, 37, 29)),
             ("labels with 255", TRAIN_RADIUS, (2, 36, 29)),
             ("labels with 255", 4, (2, 20, 150)),
             ("labels with 255", 5, (2, 40, 300)),
             ("labels with 255", 14, (2, 40, 60)),
             ("labels with 255", 20, (1, 540, 39)))
    for kind, radius, shape in cases:
        tag = f"{kind}, radius {radius}, {list(shape)}"
        table, maxed, dp, lab = inputs(radius, shape, kind)
        loss, stats = affinity.irn_loss_fwd(maxed, dp, lab, table)
        w_loss, w_stats = affinity.irn_loss_fwd_plain(maxed, dp, lab, table)
        check(_same_bits(stats, w_stats) and _same_bits(loss, w_loss),
              f"irn_loss_fwd ({tag}) not bit-equal to its twin: "
              f"{loss.tolist()} {w_loss.tolist()} / {stats.tolist()} "
              f"{w_stats.tolist()}")
        d_m, d_d = affinity.irn_loss_bwd(g, stats, maxed, dp, lab, table)
        w_m, w_d = affinity.irn_loss_bwd_plain(g, stats, maxed, dp, lab,
                                               table)
        check(_same_bits(d_m, w_m) and _same_bits(d_d, w_d),
              f"irn_loss_bwd ({tag}) not bit-equal to its twin")
        check(kind != "NaN in dp" or bool(torch.isnan(loss[[0, 3, 4]]).all()),
              f"irn_loss_fwd ({tag}): NaN did not reach the dp terms")
        del maxed, dp, lab, d_m, d_d, w_m, w_d
    table, maxed, dp, lab = inputs(TRAIN_RADIUS, full, "synthetic labels")
    loss, stats = affinity.irn_loss_fwd(maxed, dp, lab, table)
    m_leaf = maxed.clone().requires_grad_(True)
    dp_leaf = dp.clone().requires_grad_(True)

    def eager():
        torch.autograd.grad(_eager_loss(m_leaf, dp_leaf, lab, table),
                            (m_leaf, dp_leaf))

    eager_ms = cuda_ms(eager, 3)
    e_loss = float(_eager_loss(maxed, dp, lab, table))
    n_el = maxed.numel()
    io = 4 * (n_el + dp.numel() + lab.numel())
    counts = [int(v) for v in stats[5:].tolist()]
    desc = (f"maxed [{TRAIN_BATCH}, {table.n_pairs}, {maxed.shape[2]}, "
            f"{maxed.shape[3]}] f32 (K13a over a sigmoid map), dp [{TRAIN_BATCH}"
            f", 2, {TRAIN_GRID}, {TRAIN_GRID}], the synthetic reduced labels "
            f"(counts bg / fg / neg {counts}); bit-equal to the twin on the "
            f"card there, on labels of {{0, 1, 2, 255}}, with no foreground, "
            f"with NaN in dp, at radii 5, 4 and 14 and on [3, 37, 29], [2, "
            f"36, 29], [2, 20, 150] and [2, 40, 300] maps, a one-column "
            f"window at radius 20 (rows through L1); "
            f"loss {loss.tolist()} (eager composition's total {e_loss}); "
            f"eager: the composition's forward + backward from maxed and dp")
    # SASS per element: the forward's pair loop (4 pairs x 2 pixels per
    # trip) over 8, the backward's (2 pairs x 1 pixel, its source and
    # destination roles) over 2
    fwd_loops = sass_loops(sass, "irn_loss_sums_kernelILb1ELb1E")
    bwd_loops = sass_loops(sass, "irn_loss_bwd_kernel")
    print(f"K16 SASS loops: forward {fwd_loops}, backward {bwd_loops}",
          flush=True)
    res["irn_loss_fwd"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: affinity.irn_loss_fwd(maxed, dp, lab, table), 20),
        device_ms=device_ms(
            lambda: affinity.irn_loss_fwd(maxed, dp, lab, table), 20),
        plain_ms=cuda_ms(lambda: affinity.irn_loss_fwd_plain(
            maxed, dp, lab, table), 2),
        eager_ms=eager_ms,
        shape=desc + "; two launches (the block sums, their f64 total and "
                     f"the terms); {fwd_loops[0] / 8:.2f} SASS instructions "
                     f"per element",
        library_ms=None,
        sass_per_element=fwd_loops[0] / 8,
        **bound(IRN_LOSS_FWD_OPS * n_el, io, PEAK_F32),
    )
    res["irn_loss_bwd"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: affinity.irn_loss_bwd(g, stats, maxed, dp, lab,
                                                 table), 20),
        device_ms=device_ms(lambda: affinity.irn_loss_bwd(
            g, stats, maxed, dp, lab, table), 20),
        plain_ms=cuda_ms(lambda: affinity.irn_loss_bwd_plain(
            g, stats, maxed, dp, lab, table), 2),
        eager_ms=eager_ms,
        shape=desc + "; one launch, writes d_maxed and d_dp, no atomics; "
                     f"{bwd_loops[0] / 2:.2f} SASS instructions per element "
                     f"(its source and destination roles)",
        library_ms=None,
        sass_per_element=bwd_loops[0] / 2,
        **bound(IRN_LOSS_BWD_OPS * n_el, io + 4 * (n_el + dp.numel()),
                PEAK_F32),
    )
    del maxed, dp, lab, m_leaf, dp_leaf


# K10 at the three buckets of the default 128 x 128 grid cap (radius 5)
WALK_BUCKETS = ((96, 128), (128, 96), (128, 128))
WALK_ROWS = (8, 128)  # K15: make_sem_seg's seed rows, ins_seed_cap


def _pow_mults(beta: int) -> int:
    """Multiplies of pow_int's binary exponentiation."""
    return bin(beta).count("1") - 1 + beta.bit_length() - 1


def _walk_edge(gen, kind: str, cap: tuple) -> torch.Tensor:
    """A capped edge map: a sigmoid of normals, the same quantized to 8
    levels (ties along every path), or all ones (w 0, inv 1)."""
    if kind == "ones":
        return torch.ones(cap)
    e = torch.sigmoid(torch.randn(cap, generator=gen))
    return torch.round(e * 7) / 7 if kind == "ties" else e


def _decode_scores(gen, kind: str, c: int) -> tuple:
    """(rw [C, 96, 128], h4, w4, h0, w0, bg_thres) at the main path's
    bucket with odd extents: random rows, all zeros, or planted ties: rows
    0 and 1 equal on the left half (the first wins), row 2 at exactly
    bg_thres once normalized (the background wins on the right half), row
    3 on a block (the max)."""
    ch, cw = BUCKET
    h4, w4 = ch - 3, cw - 5
    rw_ = torch.zeros((c, ch, cw))
    bg = 0.35
    if kind == "random":
        rw_[:, :h4, :w4] = torch.rand((c, h4, w4), generator=gen)
    elif kind == "ties":
        rw_[0, :h4, : w4 // 2] = 1 + torch.rand((h4, w4 // 2),
                                                generator=gen)
        rw_[1] = rw_[0]
        rw_[2, :h4, :w4] = 0.25
        rw_[3, ch // 8 : ch // 2, 5 * cw // 8 : 7 * cw // 8] = 4.0
        bg = 0.0625  # row 2 normalized: 0.25 / 4.0 exactly
    return rw_, h4, w4, 4 * h4 - 2, 4 * w4 - 3, bg


def check_walk_kernels(dev, gen, res: dict) -> None:
    """K10 and K15 vs their twins on the card, bit for bit: K10 at the
    three buckets on a sigmoid map, its 8-level ties and all ones, at beta
    1 and 10; K15 at C 8 and 128 on odd extents, zero scores and planted
    ties (every output: labels, max, normalized scores, best)."""
    from irn_tpu_torch.ops import random_walk as rw

    for cap in WALK_BUCKETS:
        geom = rw.build_geometry(*cap, radius=5)
        for kind in ("sigmoid", "ties", "ones"):
            edge = _walk_edge(gen, kind, cap).to(dev)
            for beta in (1, 10):
                got = rw.build_diag_operator(geom, edge, beta)
                want = rw.build_diag_operator_plain(geom, edge, beta)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"diag_operator {cap} {kind} beta {beta} not "
                      f"bit-equal to its twin")
    geom = rw.build_geometry(*BUCKET, radius=5)
    edge = _walk_edge(gen, "sigmoid", BUCKET).to(dev)
    n, n_pairs = geom.n_pad, geom.path_set.n_pairs
    cells = int(geom.path_set.lengths.sum())
    window = (geom.padded[0] - geom.path_set.radius_floor) * (
        geom.padded[1] - 2 * geom.path_set.radius_floor)
    dev_ms = device_ms(lambda: rw.build_diag_operator(geom, edge), 20)
    res["diag_operator"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: rw.build_diag_operator(geom, edge), 20),
        device_ms=dev_ms,
        plain_ms=cuda_ms(lambda: rw.build_diag_operator_plain(geom, edge),
                         3),
        shape=(f"edge {BUCKET} f32 -> w [{n_pairs}, {n}], inv [{n}], radius "
               f"5 ({cells} path cells), beta 10, one launch; the card's own "
               f"time per call (profiler: the kernel and the two table "
               f"copies) {dev_ms:.4f} ms; bit-equal to "
               f"the twin at the buckets {WALK_BUCKETS} on a sigmoid map, its "
               f"8-level ties and all ones, beta 1 and 10"),
        library_ms=None,
        # the path max's compares, 1 - m and the powers once per (pair,
        # window cell); two adds per (pair, column), an add and a division
        # per column
        **bound(cells * window + n_pairs * window * (1 + _pow_mults(10))
                + 2 * n_pairs * n + 2 * n,
                4 * (edge.numel() + n_pairs * n + n), PEAK_F32),
    )

    for c in WALK_ROWS:
        for kind in ("random", "zeros", "ties"):
            x, h4, w4, h0, w0, bg = _decode_scores(gen, kind, c)
            x = x.to(dev)
            got = rw.decode(x, h4, w4, h0, w0, bg, scores=True, best=True)
            want = rw.decode_plain(x, h4, w4, h0, w0, bg, scores=True,
                                   best=True)
            lean = rw.decode(x, h4, w4, h0, w0, bg, best=True)
            up = rw.upsample_scores(x, h4, w4, h0, w0)
            check(all(torch.equal(a, b) for a, b in zip(got, want))
                  and torch.equal(lean.labels, want.labels)
                  and torch.equal(lean.best, want.best)
                  and torch.equal(up, rw.upsample_scores_plain(
                      x, h4, w4, h0, w0)),
                  f"decode C {c} {kind} not bit-equal to its twin")
            if kind == "ties":
                seen = torch.unique(want.labels[:h0, :w0]).tolist()
                check(seen == [0, 1, 4], f"decode C {c}: planted ties "
                      f"decoded to {seen}")
    x, h4, w4, h0, w0, bg = _decode_scores(gen, "random", 8)
    x = x.to(dev)
    hw = 16 * x.shape[1] * x.shape[2]
    x128 = _decode_scores(gen, "random", 128)[0].to(dev)
    full_ms = cuda_ms(lambda: rw.decode(x, h4, w4, h0, w0, bg, scores=True,
                                        best=True), 20)
    c128_ms = cuda_ms(lambda: rw.decode(x128, h4, w4, h0, w0, bg,
                                        best=True), 20)
    up_ms = cuda_ms(lambda: rw.upsample_scores(x, h4, w4, h0, w0), 20)
    dev_ms = device_ms(lambda: rw.decode(x, h4, w4, h0, w0, bg), 20)
    res["decode"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: rw.decode(x, h4, w4, h0, w0, bg), 20),
        device_ms=dev_ms,
        plain_ms=cuda_ms(lambda: rw.decode_plain(x, h4, w4, h0, w0, bg), 5),
        shape=(f"rw [8, {BUCKET[0]}, {BUCKET[1]}] f32 -> labels "
               f"[{4 * BUCKET[0]}, {4 * BUCKET[1]}] int64 (make_sem_seg's "
               f"call), two launches; the card's own time per call "
               f"(profiler: both passes and the key's memset) {dev_ms:.4f} "
               f"ms; bit-equal to the twin at C 8 and 128 on "
               f"odd extents, zeros and planted ties; with the scores and "
               f"best {full_ms:.4f} ms; C 128 with best (the instance walk) "
               f"{c128_ms:.4f} ms; the upsample alone (one launch) "
               f"{up_ms:.4f} ms"),
        library_ms=None,
        # per value the masked taps (4), the bilinear (9), the quotient and
        # the pixel mask (2), the normalization and the compare (2); per
        # pixel the mask's bilinear (9)
        **bound(hw * (17 * 8 + 9), 4 * x.numel() + 8 * hw, PEAK_F32),
    )
    del x, x128


# K14 at the smoke tree's largest cam_to_ir_label bucket (its 128x128-grid
# images pad to 512x512 at pad_multiple 64), and an odd bucket whose S (23 x
# 21 = 483 landmarks) leaves int8 and bf16 rows off 16-byte alignment and the
# last tile ragged
CRF_BUCKET, CRF_EXTENT = (512, 512), (500, 497)
CRF_ODD, CRF_ODD_EXTENT = (92, 84), (89, 81)
CRF_STORES = {"int8": torch.int8, "bf16": torch.bfloat16,
              "f32": torch.float32}


def _crf_planes(gen, kind: str, bucket: tuple) -> torch.Tensor:
    """[3, h, w] uint8 image planes: color regions with noise (k over all
    of [0, 1]), all black, or uniform (d2 <= 0 at every landmark's own
    pixel)."""
    h, w = bucket
    if kind == "black":
        return torch.zeros((3, h, w), dtype=torch.uint8)
    if kind == "uniform":
        return torch.full((3, h, w), 128, dtype=torch.uint8)
    img = torch.full((3, h, w), 60.0)
    img[:, :, : w // 2] = torch.tensor([190.0, 70.0, 60.0])[:, None, None]
    img[:, h // 2:, w // 2:] = torch.tensor([70.0, 170.0, 90.0])[:, None, None]
    img += 8 * torch.randn((3, h, w), generator=gen)
    return img.clamp(0, 255).to(torch.uint8)


def check_crf_landmark(dev, gen, res: dict, sass: str) -> None:
    """K14 vs its twin on the card: at the largest bucket and the odd one,
    on a scene, an all-black and a uniform image, with each store (int8,
    bf16, f32), the store and the row sums bit-equal (the dense sums too:
    the twin adds in the kernel's lane order), the table pass alone equal
    to its twin; on the odd bucket also a row range and the sums alone.
    Timed at the largest bucket with each store and the sums alone, with
    the SASS instructions per entry of its int8 row loop (K14 beside its
    first design: ``tools/probe_crf_landmark.py``)."""
    from irn_tpu_torch.ops import crf_device as cd
    from irn_tpu_torch.tools import probe_crf_landmark as probe

    cases = [("scene", CRF_BUCKET, CRF_EXTENT), ("scene", CRF_ODD,
                                                 CRF_ODD_EXTENT),
             ("black", CRF_BUCKET, CRF_EXTENT), ("uniform", CRF_BUCKET,
                                                 CRF_BUCKET),
             ("black", CRF_ODD, CRF_ODD_EXTENT)]
    for kind, bucket, extent in cases:
        planes = _crf_planes(gen, kind, bucket).to(dev)
        n = bucket[0] * bucket[1]
        check(torch.equal(cd.landmark_table(planes, *extent),
                          cd.landmark_table_plain(planes, *extent)),
              f"crf_landmark table {kind} {bucket} {extent} not equal to "
              f"its twin")
        modes = [{}]
        if bucket == CRF_ODD:
            modes += [dict(rows=(37, n - 5)), dict(sums_only=True)]
        for name, store in CRF_STORES.items():
            for mode in modes:
                got = cd.landmark_rows(planes, *extent, store=store, **mode)
                want = cd.landmark_rows_plain(planes, *extent, store=store,
                                              **mode)
                check(torch.equal(got[1], want[1])
                      and (got[0] is None if mode.get("sums_only")
                           else torch.equal(got[0], want[0])),
                      f"crf_landmark {kind} {bucket} {extent} {name} {mode} "
                      f"not bit-equal to its twin")
                del got, want
            torch.cuda.empty_cache()
    planes = _crf_planes(gen, "scene", CRF_BUCKET).to(dev)
    n = CRF_BUCKET[0] * CRF_BUCKET[1]
    s_land = len(range(2, CRF_BUCKET[0], 4)) * len(range(2, CRF_BUCKET[1], 4))
    store_ms = {}
    for name, store in CRF_STORES.items():
        store_ms[name] = cuda_ms(
            lambda: cd.landmark_rows(planes, *CRF_EXTENT, store=store), 10)
        torch.cuda.empty_cache()
    sums_ms = cuda_ms(lambda: cd.landmark_rows(planes, *CRF_EXTENT,
                                               sums_only=True), 10)
    plain_ms = cuda_ms(lambda: cd.landmark_rows_plain(planes, *CRF_EXTENT), 1)
    per_entry, _ = probe.sass_per_entry(sass, probe.NEW_KERNEL)
    exps = n * s_land
    res["crf_landmark"] = dict(
        max_abs_err=0.0,
        ms=store_ms["int8"],
        plain_ms=plain_ms,
        exps=exps,
        exp_sfu_ms=exps / SFU_EXP_S * 1e3,
        store_ms=store_ms,
        sums_only_ms=sums_ms,
        sass_per_entry=per_entry,
        shape=(f"image [3, {CRF_BUCKET[0]}, {CRF_BUCKET[1]}] uint8, extent "
               f"{CRF_EXTENT} -> int8 store [{n}, {s_land}] "
               f"({n * s_land / 1e9:.2f} GB) + f32 row sums, two launches "
               f"(table, rows); bf16 "
               f"store {store_ms['bf16']:.4f} ms, "
               f"f32 store {store_ms['f32']:.4f} ms, the sums alone "
               f"{sums_ms:.4f} ms; SASS per int8 entry {per_entry:.3f}; "
               f"{exps:.3e} exps ({exps / SFU_EXP_S * 1e3:.4f} ms on the "
               f"SFUs); store and sums bit-equal to the twin, the table "
               f"equal (every store; {CRF_BUCKET} and {CRF_ODD} extent "
               f"{CRF_ODD_EXTENT}; a scene, all black, uniform; a row range, "
               f"the sums alone)"),
        library_ms=None,
        # per entry the five-term dot (9), 2x, the two sums, the clamp, the
        # -0.5, v and the 127 scale (16, the exp counted as one); the image
        # read once, the store and the sums written once
        **bound(16 * exps, 3 * n + n * s_land + 4 * n, PEAK_F32),
    )
    del planes
    torch.cuda.empty_cache()


# K17 at the device CRF's shapes: the fg / bg pair over 21 channels, 3
# labels present (a VOC image with two classes and the background)
CRF_CAP, CRF_LABELS, CRF_GT = 21, 3, 0.7


def _crf_labels(gen, bucket: tuple, extent: tuple) -> torch.Tensor:
    """[2, h, w] uint8 label maps < CRF_LABELS: two regions and 6% noise
    inside the extent, 0 outside."""
    h, w = bucket
    eh, ew = extent
    lab = torch.zeros((2, h, w), dtype=torch.uint8)
    lab[0, :eh, : ew // 2 - 3] = 1
    lab[0, eh // 2 + 3:eh, ew // 2:ew] = 2
    lab[1] = torch.where(lab[0] == 2, 2, 0)
    noise = torch.rand((2, h, w), generator=gen) < 0.06
    lab[noise] = torch.randint(0, CRF_LABELS, (int(noise.sum()),),
                               generator=gen, dtype=torch.uint8)
    lab[:, eh:] = 0
    lab[:, :, ew:] = 0
    return lab


def _combine_edges(dev, gen) -> int:
    """K17's combine at 2, 5, 21 and 32 channels per map with the taps of
    sxy 1, 2 and 3, on a bucket no multiple of the 32 x 32 tile and on one
    narrower and shorter than a tile, from an int32 product with qscale
    and an f32 product, into q_{i+1} and into the labels: each bit-equal
    to the twin; a width that is no multiple of 4 and an unaligned q are
    refused before a launch. Returns the cases held."""
    from irn_tpu_torch.ops import crf_device as cd

    n_cases = 0
    for bucket, extent in (((92, 84), (89, 81)), ((20, 24), (17, 22))):
        h, w = bucket
        valid = torch.zeros((h, w))
        valid[:extent[0], :extent[1]] = 1
        nr_g = ((torch.rand((h, w), generator=gen) + 0.05) * valid).to(dev)
        nr_b = ((torch.rand((h, w), generator=gen) + 0.05) * valid).to(dev)
        for cap in (2, 5, 21, 32):
            n_labels = min(cap, 4)
            logits = torch.randn((2, cap, h, w), generator=gen) * 2
            logits[:, n_labels:] = -1e30
            q = torch.softmax(logits, 1).to(dev)
            labels = torch.randint(0, n_labels, (2, h, w), generator=gen,
                                   dtype=torch.uint8).to(dev)
            lg, lo = cd.unary_logs(CRF_GT, n_labels)
            m = 2 * cd.map_columns(cap)
            prods = ((torch.randint(0, 2 ** 20, (h * w, m), generator=gen,
                                    dtype=torch.int32).to(dev),
                      torch.rand(m, generator=gen).to(dev)),
                     ((torch.rand((h * w, m), generator=gen) * 200).to(dev),
                      None))
            for sxy in (1.0, 2.0, 3.0):
                taps = cd.gaussian_taps(sxy)
                for prod, qscale in prods:
                    for out in (torch.empty_like(q),
                                torch.empty_like(labels)):
                        got = cd.combine(q, labels, nr_g, nr_b, taps, prod,
                                         qscale, n_labels, lg, lo,
                                         out.clone())
                        want = cd.combine_plain(q, labels, nr_g, nr_b, taps,
                                                prod, qscale, n_labels, lg,
                                                lo, out.clone())
                        check(torch.equal(got, want),
                              f"crf_mean_field combine {bucket} cap {cap} "
                              f"sxy {sxy} {prod.dtype} into {out.dtype}: not "
                              f"bit-equal to the twin")
                        n_cases += 1
    q = torch.zeros((2, 3, 24, 30), device=dev)
    shifted = torch.zeros(2 * 3 * 24 * 28 + 1, device=dev)[1:].view(
        2, 3, 24, 28)
    for bad in (q, shifted):
        try:
            cd.check_q_map(bad)
            check(False, f"crf_mean_field: q {tuple(bad.shape)} at "
                         f"{bad.data_ptr() % 16} past 16 bytes was not "
                         f"refused")
        except ValueError:
            pass
    return n_cases


def check_crf_mean_field(dev, gen, res: dict, sass: str) -> None:
    """K17 vs its twins on the card at the largest bucket and the odd one,
    on one image's kernels (K14's int8 and bf16 stores): the blur (the
    validity mask and 42 planes), the start (softmax and argmax), the
    quantize (int8, bf16 and f32 operands, qscale, zero columns past the
    labels), the combine (int32 and f32 products; q_{i+1} and the labels)
    bit-equal, and ten iterations through ``mean_field_pair`` equal to the
    same loop through the twins; then the combine's edge cases
    (:func:`_combine_edges`). At the largest bucket quantize, combine,
    the product and one whole iteration are timed by CUDA events, int8 and
    dense, beside the twins and the bytes an iteration must move; the
    combine's SASS loops are counted."""
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.ops import crf_device as cd

    lg, lo = cd.unary_logs(CRF_GT, CRF_LABELS)
    timing = {}
    for bucket, extent in ((CRF_BUCKET, CRF_EXTENT),
                           (CRF_ODD, CRF_ODD_EXTENT)):
        img = _crf_planes(gen, "scene", bucket).to(dev).permute(1, 2, 0)
        labels = _crf_labels(gen, bucket, extent).to(dev)
        for store, kw in (("int8", dict(kernel_store="int8")),
                          ("dense", dict())):
            kern = cd.LandmarkKernel(img, *extent, **kw)
            tag = f"crf_mean_field {bucket} {store}"
            for x in (kern.valid[None],
                      torch.rand((2 * CRF_CAP, *bucket), generator=gen).to(
                          dev) * kern.valid):
                check(torch.equal(cd.blur(x, kern.taps),
                                  cd.blur_plain(x, kern.taps)),
                      f"{tag}: blur of {x.shape[0]} planes not bit-equal")
            for argmax in (False, True):
                check(torch.equal(
                    cd.start(labels, CRF_CAP, CRF_LABELS, lg, lo,
                             argmax=argmax),
                    cd.start_plain(labels, CRF_CAP, CRF_LABELS, lg, lo,
                                   argmax=argmax)),
                      f"{tag}: start (argmax {argmax}) not bit-equal")
            q = cd.start(labels, CRF_CAP, CRF_LABELS, lg, lo)
            for op_store in ((torch.int8,) if store == "int8"
                             else (torch.bfloat16, torch.float32)):
                bufs = [cd.operand_buffers(kern.n_land, CRF_CAP, op_store,
                                           dev) for _ in range(2)]
                cd.quantize(q, kern.nr_b, *bufs[0])
                cd.quantize_plain(q, kern.nr_b, *bufs[1])
                check(torch.equal(bufs[0][0], bufs[1][0])
                      and torch.equal(bufs[0][1], bufs[1][1]),
                      f"{tag}: quantize {op_store} not bit-equal")
            opnd, qscale = kern.operand(CRF_CAP)
            cd.quantize(q, kern.nr_b, opnd, qscale)
            prod = kern.product(opnd)
            qs = qscale if kern.int8 else None
            for out in (torch.empty_like(q), torch.empty_like(labels)):
                got = cd.combine(q, labels, kern.nr_g, kern.nr_b, kern.taps,
                                 prod, qs, CRF_LABELS, lg, lo,
                                 out.clone())
                want = cd.combine_plain(q, labels, kern.nr_g, kern.nr_b,
                                        kern.taps, prod, qs, CRF_LABELS, lg,
                                        lo, out.clone())
                check(torch.equal(got, want),
                      f"{tag}: combine into {out.dtype} not bit-equal "
                      f"(max abs {(got.float() - want.float()).abs().max()})")
            # ten iterations: kernels against the twins' loop on the card
            _build.reset_launches()
            got = cd.mean_field_pair(kern, labels, CRF_LABELS, CRF_GT)
            torch.cuda.synchronize()
            check(_build.LAUNCHES["crf_mean_field"] == 21,
                  f"{tag}: {_build.LAUNCHES['crf_mean_field']} launches for "
                  f"ten iterations, expected 21")
            q_ = cd.start_plain(labels, CRF_CAP, CRF_LABELS, lg, lo)
            want = torch.empty_like(labels)
            for i in range(10):
                cd.quantize_plain(q_, kern.nr_b, opnd, qscale)
                q_ = cd.combine_plain(
                    q_, labels, kern.nr_g, kern.nr_b, kern.taps,
                    kern.product(opnd), qs, CRF_LABELS, lg, lo,
                    want if i == 9 else torch.empty_like(q_))
            check(torch.equal(got, want),
                  f"{tag}: ten iterations' labels differ from the twins' "
                  f"({float((got != want).float().mean()):.2e})")
            if bucket == CRF_BUCKET:
                q_next = torch.empty_like(q)

                def quant():
                    cd.quantize(q, kern.nr_b, opnd, qscale)

                def comb():
                    cd.combine(q, labels, kern.nr_g, kern.nr_b, kern.taps,
                               prod, qs, CRF_LABELS, lg, lo, q_next)

                def both():
                    quant()
                    comb()

                def iteration():
                    cd.quantize(q, kern.nr_b, opnd, qscale)
                    cd.combine(q, labels, kern.nr_g, kern.nr_b, kern.taps,
                               kern.product(opnd), qs, CRF_LABELS, lg, lo,
                               q_next)

                def plain():
                    cd.quantize_plain(q, kern.nr_b, opnd, qscale)
                    cd.combine_plain(q, labels, kern.nr_g, kern.nr_b,
                                     kern.taps, prod, qs, CRF_LABELS, lg, lo,
                                     q_next)

                timing[store] = dict(
                    quantize_ms=cuda_ms(quant, 20),
                    combine_ms=cuda_ms(comb, 20),
                    ms=cuda_ms(both, 20),
                    # the card's own time, apart from the wrappers' host
                    # time that cuda_ms includes when a launch is shorter
                    quantize_device_ms=device_ms(quant, 10),
                    combine_device_ms=device_ms(comb, 10),
                    device_ms=device_ms(both, 10),
                    product_ms=cuda_ms(lambda: kern.product(opnd), 10),
                    iteration_ms=cuda_ms(iteration, 10),
                    ten_iterations_ms=cuda_ms(lambda: cd.mean_field_pair(
                        kern, labels, CRF_LABELS, CRF_GT), 5),
                    plain_ms=cuda_ms(plain, 2))
                n = bucket[0] * bucket[1]
                qbytes = 2 * CRF_CAP * n * 4
                timing[store]["bytes"] = (
                    2 * qbytes + prod.numel() * prod.element_size()
                    + labels.numel() + 2 * 4 * n
                    + opnd.numel() * opnd.element_size())
            del kern, q, opnd, prod, got, want
            torch.cuda.empty_cache()
    n_edges = _combine_edges(dev, gen)
    loops = sass_loops(sass, "combine_kernelILb1E")
    print(f"K17 combine: {n_edges} edge cases bit-equal; SASS loops "
          f"{loops}", flush=True)
    t8, td = timing["int8"], timing["dense"]
    n = CRF_BUCKET[0] * CRF_BUCKET[1]
    print(f"K17 at {CRF_BUCKET}: int8 {json.dumps(t8)}; dense "
          f"{json.dumps(td)}", flush=True)
    res["crf_mean_field"] = dict(
        max_abs_err=0.0,
        ms=t8["ms"],
        device_ms=t8["device_ms"],
        plain_ms=t8["plain_ms"],
        quantize_ms=t8["quantize_ms"],
        combine_ms=t8["combine_ms"],
        product_ms=t8["product_ms"],
        iteration_ms=t8["iteration_ms"],
        ten_iterations_ms=t8["ten_iterations_ms"],
        dense_ms=td["ms"],
        dense_product_ms=td["product_ms"],
        dense_iteration_ms=td["iteration_ms"],
        dense_ten_iterations_ms=td["ten_iterations_ms"],
        sass_loops=loops[:4],
        shape=(f"q [2, {CRF_CAP}, {CRF_BUCKET[0]}, {CRF_BUCKET[1]}] f32, "
               f"{CRF_LABELS} labels, one image's K14 int8 kernel; ms = one "
               f"iteration's quantize + combine (two launches; quantize "
               f"{t8['quantize_ms']:.4f}, combine {t8['combine_ms']:.4f}; "
               f"the card's own time {t8['device_ms']:.4f}: quantize "
               f"{t8['quantize_device_ms']:.4f}, combine "
               f"{t8['combine_device_ms']:.4f}); "
               f"torch._int_mm {t8['product_ms']:.4f}; one iteration "
               f"{t8['iteration_ms']:.4f}, ten (mean_field_pair, with the "
               f"start) {t8['ten_iterations_ms']:.4f}; dense (bf16 operand, "
               f"f32 product): quantize + combine {td['ms']:.4f}, product "
               f"{td['product_ms']:.4f}, iteration "
               f"{td['iteration_ms']:.4f}, ten "
               f"{td['ten_iterations_ms']:.4f}; {t8['bytes'] / 1e6:.1f} MB "
               f"per iteration; bit-equal to the twins (blur, start, "
               f"quantize int8 / bf16 / f32, combine int32 / f32 into q and "
               f"labels; {CRF_BUCKET} and {CRF_ODD}; {n_edges} combine edge "
               f"cases: caps 2, 5, 21, 32, sxy 1, 2, 3, buckets 92x84 and "
               f"20x24); combine SASS loops {loops[:4]}; ten iterations' "
               f"labels equal to the twins' loop"),
        library_ms=None,
        # per pixel and channel: two 25-tap passes (mul + add), RN(nr_g q),
        # the two messages' scalings and sums, the softmax's subtract, exp,
        # sum and division; q read and written, the product's output, the
        # labels and row norms read once, the operand written once
        **bound(2 * CRF_CAP * n * (4 * cd.BLUR_TAPS + 10), t8["bytes"],
                PEAK_F32),
    )


def _poison_blocks(t: torch.Tensor, h: int) -> torch.Tensor:
    """T with every BS x BS block beyond kb = ceil(h/BS) set to NaN: where
    K2's output is unspecified, so a kernel that reads it fails."""
    kb = -(-h // BS)
    bi = torch.arange(t.shape[0], device=t.device) // BS
    return torch.where((bi[:, None] - bi[None, :]).abs() > kb,
                       torch.full((), float("nan"), device=t.device), t)


def check_dense_kernels(dev, geom, edge, x, res: dict) -> None:
    """K5, K6, K4 and K7 vs their plain twins at the main path's shapes."""
    from irn_tpu_torch.ops import matpow_kernels as mk
    from irn_tpu_torch.ops import random_walk as rw

    n = geom.n_pad
    h = rw.band_halfwidth(geom)
    a = rw.dense_affinity(geom, edge)
    t = rw.normalize_transition(a)

    # K5: one dense squaring of T: the split pass alone bit-equal to its
    # twin, then the split product against its twin, the library call
    # (cuBLAS f32)
    check(torch.equal(mk.split_identity(t), mk.split_identity_plain(t)),
          "square_dense split pass not bit-equal to its twin")
    got = mk.square_dense(t)
    want = mk.square_dense_plain(t)
    err, rel = rel_err(got, want)
    check(bool(torch.isfinite(got).all()) and rel <= 1e-5,
          f"square_dense rel err {rel}")
    res["square_dense"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: mk.square_dense(t), 3),
        plain_ms=cuda_ms(lambda: mk.square_dense_plain(t), 3),
        shape=f"T [{n}, {n}]; split pass bit-equal",
        # six bf16 passes on the tensor cores; the f32 SIMT line beside it
        bound_f32_ms=bound(2 * n ** 3, 0, PEAK_F32)["bound_ms"],
        **bound(6 * 2 * n ** 3, 2 * 4 * n * n, PEAK_BF16),
    )
    res["square_dense"]["library_ms"] = res["square_dense"]["plain_ms"]
    del got, want

    # K6: A -> T^2, beta 10: the split pass alone bit-equal to its twin, then
    # the split product against normalize_transition + cuBLAS f32 (its twin,
    # the library line)
    inv = 1.0 / torch.sum(mk.pow_int(a, 10), dim=0)
    check(torch.equal(mk.split_operands(a, inv, 10),
                      mk.split_operands_plain(a, inv, 10)),
          "square_fused_first split pass not bit-equal to its twin")
    got = mk.square_fused_first(a, 10)
    want = mk.square_fused_first_plain(a, 10)
    err, rel = rel_err(got, want)
    check(bool(torch.isfinite(got).all()) and rel <= 1e-5,
          f"square_fused_first rel err {rel}")
    res["square_fused_first"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: mk.square_fused_first(a, 10), 3),
        plain_ms=cuda_ms(lambda: mk.square_fused_first_plain(a, 10), 3),
        shape=(f"A [{n}, {n}], beta 10; split pass bit-equal; K5 "
               f"{res['square_dense']['ms']:.3f} ms at the same n"),
        # six bf16 passes on the tensor cores; the f32 SIMT design's bound
        # beside it
        bound_f32_ms=bound(2 * n ** 3, 0, PEAK_F32)["bound_ms"],
        **bound(6 * 2 * n ** 3, 2 * 4 * n * n, PEAK_BF16),
    )
    res["square_fused_first"]["library_ms"] = res["square_fused_first"][
        "plain_ms"]
    del got, want, a, inv

    # K4: one application of T^8 (three K2 squarings, h 4448), NaN in every
    # block beyond kb
    t8, h8 = t, h
    for _ in range(3):
        t8, h8 = mk.square_banded(t8, h8, BS), 2 * h8
    check(h8 == 4448, f"e3 band {h8}")
    k4_library = cuda_ms(lambda: torch.matmul(x, t8), 10)
    t8 = _poison_blocks(t8, h8)
    got = mk.apply_banded(x, t8, h8, BS)
    want = mk.apply_banded_plain(x, t8, h8, BS)
    err, rel = rel_err(got, want)
    check(bool(torch.isfinite(got).all()) and rel <= 1e-5,
          f"apply_banded rel err {rel}")
    res["apply_banded"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: mk.apply_banded(x, t8, h8, BS), 10),
        plain_ms=cuda_ms(lambda: mk.apply_banded_plain(x, t8, h8, BS), 5),
        shape=(f"x [8, {n}], T^8 [{n}, {n}], h {h8}, bs {BS}; library: "
               f"torch.matmul over the whole T^8 before the NaN fill"),
        library_ms=k4_library,
        **bound(2 * 8 * _band_rows(n, BS, -(-h8 // BS)) * BS,
                4 * (_band_rows(n, BS, -(-h8 // BS)) * BS + 2 * x.numel()),
                PEAK_F32),
    )
    del t8, got, want

    # K7: 128 applications of T^2 (h 1112) masked to its band, NaN beyond
    # the written block band and between h and the tile edge; against its
    # twin, and bit-equal to K1 + K3 on the same T^2 without that NaN
    t2, h2 = mk.square_banded(t, h, BS), 2 * h
    del t
    t2 = _poison_blocks(t2, h2)
    r = torch.arange(n, device=dev)
    band = (r[:, None] - r[None, :]).abs() <= h2
    # the same T^2 with NaN between h and the tile edge too, where K2 wrote
    # zeros (K1 + K3 would read it; K7's select drops it)
    kb = -(-h2 // BS)
    bi = r // BS
    near = ~band & ((bi[:, None] - bi[None, :]).abs() <= kb)
    t2_nan = torch.where(near, torch.full((), float("nan"), device=dev), t2)
    del near, bi
    plan = mk.card_packed_chain_plan(dev, n, BS, kb)
    got, stats, timing = mk.launch_banded_chain(x, t2_nan, h2, 128, BS, plan)
    phases = phase_shares(timing)
    want = mk.banded_chain_plain(x, t2_nan, h2, 128)
    err, rel = rel_err(got, want)
    check(bool(torch.isfinite(got).all()) and rel <= 1e-4,
          f"banded_chain rel err {rel}")
    tp = mk.pack_banded(t2, h2, BS)
    k13 = mk.packed_chain(x, tp, 128, BS)
    check(torch.equal(got, k13), "banded_chain not bit-equal to K1 + K3")
    check(torch.equal(got, mk.banded_chain(x, t2_nan, h2, 128, BS, BJ)),
          "banded_chain not deterministic")
    masked = torch.where(band, t2, torch.zeros((), device=dev))
    del band
    ell = mk.banded_ell_plain(t2_nan, h2, BS)
    check(torch.equal(ell, mk.packed_ell_plain(tp)),
          "banded_chain ELL lengths differ from K1 + K3's")
    shares = chain_stats(
        stats, mk.packed_occupancy_plain(tp).sum(-1).flatten().tolist(),
        ell.sum((-2, -1)).flatten().tolist(), plan, tp.shape[1],
        "banded_chain")
    nnz = int((masked != 0).sum())
    del masked, ell
    ms = cuda_ms(lambda: mk.banded_chain(x, t2_nan, h2, 128, BS, BJ), 5)
    k13_ms = cuda_ms(lambda: mk.packed_chain(
        x, mk.pack_banded(t2, h2, BS), 128, BS), 5)
    res["banded_chain"] = dict(
        max_abs_err=err,
        ms=ms,
        ms_per_application=ms / 128,
        plain_ms=cuda_ms(
            lambda: mk.banded_chain_plain(x, t2_nan, h2, 128), 3),
        shape=(f"x [8, {n}], T^2 [{n}, {n}], h {h2}, bs {BS}, bj {BJ}, "
               f"128 applications, one launch, NaN beyond the block band "
               f"and between h and the tile edge; bit-equal to K1 + K3 on "
               f"T^2 without that NaN, K1 + K3 {k13_ms:.4f} ms "
               f"({ms / k13_ms:.3f}x); plan {plan}; segments occupied "
               f"{shares['occupied_share']:.4f}, ELL entries per tile row "
               f"{shares['entry_share']:.4f}, held "
               f"{shares['held_share']:.4f}; nonzero band entries {nnz}; "
               f"shares of the CTAs' clock: {_phases_text(phases)}"),
        library_ms=None,
        k13_ms=k13_ms,
        phase_shares=phases,
        **shares,
        # the nonzero entries of T^2 masked to its band, read once; the
        # dense band (every |r - c| <= h) beside it
        bound_dense_ms=bound(128 * 2 * 8 * _band_nnz(n, h2),
                             4 * (_band_nnz(n, h2) + 2 * x.numel()),
                             PEAK_F32)["bound_ms"],
        **bound(128 * 2 * 8 * nnz, 4 * (nnz + 2 * x.numel()), PEAK_F32),
    )


def check_batched_chain(dev, geom, gen, res: dict) -> None:
    """K8 at the main path's shapes: B_BATCH images, each with its own T^2
    (h 1112) from a seeded edge map, 128 applications, C 8; against its twin,
    and against K3 on each image (bit-equal)."""
    from irn_tpu_torch.ops import matpow_kernels as mk
    from irn_tpu_torch.ops import random_walk as rw

    n = geom.n_pad
    h = rw.band_halfwidth(geom)
    tps = []
    for _ in range(B_BATCH):  # one dense T at a time; only its tiles stay
        edge = torch.rand(BUCKET, generator=gen).to(dev) * 0.9
        t2 = mk.square_banded(
            rw.normalize_transition(rw.dense_affinity(geom, edge)), h, BS)
        tps.append(mk.pack_banded(t2, 2 * h, BS))
        del t2
    tps = torch.stack(tps)
    xs = torch.rand((B_BATCH, 8, n), generator=gen).to(dev)
    kh = (tps.shape[2] // BS - 1) // 2
    plan = mk.card_packed_chain_plan(dev, n, BS, kh, B_BATCH)
    check(mk.packed_chain_images(plan, n, BS) == B_BATCH,
          f"packed_chain_batched plan {plan} needs more than one launch")
    got, stats, timing = mk.launch_packed_chain_batched(xs, tps, 128, BS,
                                                        plan)
    phases = phase_shares(timing)
    want = mk.packed_chain_batched_plain(xs, tps, 128, BS)
    err, rel = rel_err(got, want)
    check(bool(torch.isfinite(got).all()) and rel <= 1e-4,
          f"packed_chain_batched rel err {rel}")
    for b in range(B_BATCH):
        check(torch.equal(got[b], mk.packed_chain(xs[b], tps[b], 128, BS)),
              f"packed_chain_batched image {b} not bit-equal to K3")
    check(torch.equal(got, mk.packed_chain_batched(xs, tps, 128, BS)),
          "packed_chain_batched not deterministic")
    entries = [mk.packed_ell_plain(tp).sum((-2, -1)).flatten().tolist()
               for tp in tps]
    shares = chain_stats(
        stats, [v for tp in tps for v in
                mk.packed_occupancy_plain(tp).sum(-1).flatten().tolist()],
        [v for e in entries for v in e], plan, tps.shape[2],
        "packed_chain_batched")
    held = stats[..., 2].sum(-1).double().cpu() / torch.tensor(
        [max(sum(e), 1) for e in entries], dtype=torch.float64)
    nnz = int((tps != 0).sum())
    ms = cuda_ms(lambda: mk.packed_chain_batched(xs, tps, 128, BS), 5)
    k3_ms = cuda_ms(lambda: [mk.packed_chain(xs[b], tps[b], 128, BS)
                             for b in range(B_BATCH)], 5)
    res["packed_chain_batched"] = dict(
        max_abs_err=err,
        ms=ms,
        ms_per_application=ms / 128,
        plain_ms=cuda_ms(
            lambda: mk.packed_chain_batched_plain(xs, tps, 128, BS), 3),
        shape=(f"xs [{B_BATCH}, 8, {n}], tiles {tuple(tps.shape)}, 128 "
               f"applications, one launch; each image bit-equal to K3; K3 "
               f"on the {B_BATCH} images one by one {k3_ms:.4f} ms "
               f"({ms / k3_ms:.3f}x); plan {plan}; segments occupied "
               f"{shares['occupied_share']:.4f}, ELL entries per tile row "
               f"{shares['entry_share']:.4f}, held "
               f"{shares['held_share']:.4f} (per image "
               f"{', '.join(f'{v:.4f}' for v in held.tolist())}); nonzero "
               f"tile entries {nnz}; shares of the CTAs' clock: "
               f"{_phases_text(phases)}"),
        library_ms=None,
        k3_ms=k3_ms,
        held_share_per_image=held.tolist(),
        phase_shares=phases,
        **shares,
        # the B images' nonzero tile entries, read once; every in-matrix
        # tile row beside it
        bound_dense_ms=bound(
            B_BATCH * 128 * 2 * 8 * BS * _band_rows(n, BS, kh),
            4 * (tps.numel() + 2 * xs.numel()), PEAK_F32)["bound_ms"],
        **bound(128 * 2 * 8 * nnz, 4 * (nnz + 2 * xs.numel()), PEAK_F32),
    )


def _bf16_check(got, want, what: str) -> tuple:
    """(max abs err, share of bit-equal elements); fails past 2^-7 of
    max|want| or under 99% bit-equal."""
    err, rel = rel_err(got.float(), want.float())
    equal = float((got == want).float().mean())
    check(bool(torch.isfinite(got.float()).all()) and rel <= 2.0 ** -7
          and equal >= 0.99, f"{what}: rel err {rel}, bit-equal {equal}")
    return err, equal


def check_conv(dev, res: dict) -> None:
    """K9 against its twin (f32 conv on the bf16 values, one round) at the
    probe's largest-traffic shape and at one odd small shape, with cuDNN's
    own bf16 conv timed beside it."""
    from irn_tpu_torch.ops import conv3x3 as cv
    from irn_tpu_torch.tools import bench_conv

    odd = (2, 13, 11, 32, 48)
    x, k = bench_conv.make_inputs(*odd, dev, seed=SEED)
    _, equal_odd = _bf16_check(cv.conv3x3(x, k), cv.conv3x3_plain(x, k),
                               f"conv3x3 at {odd}")
    label, *shape = bench_conv.SHAPES[0]
    x, k = bench_conv.make_inputs(*shape, dev, seed=SEED)
    err, equal = _bf16_check(cv.conv3x3(x, k), cv.conv3x3_plain(x, k),
                             f"conv3x3 at {shape}")
    w_cl = bench_conv.cudnn_weight(k)
    cudnn = cuda_ms(lambda: bench_conv.cudnn_conv(x, w_cl), 10)
    b, h, w, c, f = shape
    res["conv3x3"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: cv.conv3x3(x, k), 10),
        plain_ms=cuda_ms(lambda: cv.conv3x3_plain(x, k), 5),
        shape=(f"{label} x {shape[:4]} -> {shape[4]}, bf16; bit-equal "
               f"{equal:.5f} ({equal_odd:.5f} at the odd shape {odd}); "
               f"library: cuDNN bf16"),
        library_ms=cudnn,
        **bound(2 * b * h * w * 9 * c * f,
                2 * (x.numel() + k.numel() + b * h * w * f), PEAK_BF16),
    )


def cli(argv, log: list = None) -> dict:
    """The port's CLI (``irn_tpu_torch.pipeline.run.main``) with its
    config and progress prints captured, and shown only if it raises (or
    appended to ``log``)."""
    from irn_tpu_torch.pipeline import run as port_run

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return port_run.main(argv)
    except BaseException:
        print(buf.getvalue()[-8000:], flush=True)
        raise
    finally:
        if log is not None:
            log.append(buf.getvalue())


def agreement(dir_a: str, dir_b: str, names) -> list:
    """Per-image share of equal label pixels between two PNG dirs."""
    from irn_tpu_torch.data.image_io import imread

    out = []
    for n_ in names:
        a = imread(os.path.join(dir_a, n_ + ".png"))
        b = imread(os.path.join(dir_b, n_ + ".png"))
        check(a.shape == b.shape, f"{n_}: shapes {a.shape} {b.shape}")
        out.append(float(np.mean(a == b)))
    return out


def run_stage(dev, work: str) -> dict:
    """make_sem_seg through the port's CLI in each walk configuration, the
    launch counts of each run read on their own."""
    from irn_tpu_torch.data import synthetic
    from irn_tpu_torch.models.irn import IRNet, init_irnet
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.pipeline import run as port_run
    from irn_tpu_torch.utils.checkpoint import save_checkpoint
    from irn_tpu_torch.utils.weights import irn_to_jax

    root = os.path.join(work, "voc")
    synthetic.generate(root, n_images=N_IMAGES, size=360,
                       max_side_jitter=140, seed=SEED)
    names = [f"2007_{i:06d}" for i in range(N_IMAGES)]
    ids = os.path.join(root, "all.txt")
    with open(ids, "w") as f:
        f.write("\n".join(names) + "\n")
    synthetic.write_gt_cams(root, names, os.path.join(work, "cam"))
    model = init_irnet(IRNet(), torch.Generator().manual_seed(SEED))
    weights = os.path.join(work, "irn.ckpt")
    save_checkpoint(weights, irn_to_jax(model.state_dict()))

    four = os.path.join(root, "pure.txt")
    with open(four, "w") as f:
        f.write("\n".join(names[:N_PURE]) + "\n")

    def argv(out, extra=(), ids=ids, evaluate=True):
        return [
            "--voc12_root", root, "--infer_list", ids, "--train_list", ids,
            "--cam_out_dir", os.path.join(work, "cam"),
            "--irn_weights_name", weights,
            "--session_dir", os.path.join(work, "sess"),
            "--log_name", os.path.join(work, "log"),
            "--sem_seg_out_dir", out, "--make_sem_seg_pass",
            *(("--eval_sem_seg_pass",) if evaluate else ()),
            "--device", str(dev), *extra,
        ]

    runs = {}
    launches = {}
    for tag, extra in (("default", ()), ("banded", ("--rw_square_times", "1"))):
        out = os.path.join(work, f"sem_{tag}")
        _build.reset_launches()
        first = cli(argv(out, extra))
        # a second pass over the same images (warm caches): a smoke-run
        # rate over N_IMAGES images, not a settled throughput
        again = cli(argv(out, (*extra, "--overwrite")))
        launches[tag] = dict(_build.LAUNCHES)
        summ = again["make_sem_seg_labels"]
        for n_ in names:
            check(os.path.exists(os.path.join(out, n_ + ".png")),
                  f"{tag}: no PNG for {n_}")
        runs[tag] = dict(
            out=out,
            img_s=summ["n_images"] / summ["seconds"],
            first_img_s=(first["make_sem_seg_labels"]["n_images"]
                         / first["make_sem_seg_labels"]["seconds"]),
            modes=summ["modes"],
            edge_mean=summ["edge_mean"],
            edge_saturated=summ["edge_saturated"],
            miou=float(again["eval_sem_seg"]["miou"]),
        )
    for tag, r_ in runs.items():
        print(f"stage {tag}: {r_['img_s']:.3f} img/s second pass "
              f"({r_['first_img_s']:.3f} img/s first pass; smoke rates over "
              f"{N_IMAGES} images 360-500 px), walk modes {r_['modes']}, edge mean "
              f"{r_['edge_mean']:.4f}, edge saturated "
              f"{r_['edge_saturated']:.4f}, mIoU {r_['miou']:.4f}",
              flush=True)
    check(all(m == "diag" for m in runs["default"]["modes"].values()),
          f"default walk modes {runs['default']['modes']}")
    check(all(m == "banded" for m in runs["banded"]["modes"].values()),
          f"banded walk modes {runs['banded']['modes']}")
    # K3 is one launch per walk, K2 two per squaring (split pass, product):
    # two passes over the tree
    lb = launches["banded"]
    check(lb["packed_chain"] == 2 * N_IMAGES
          and lb["square_banded"] == 2 * 2 * N_IMAGES,
          f"banded launches {lb}")
    agree = agreement(runs["default"]["out"], runs["banded"]["out"], names)
    print(f"stage label agreement default vs banded: min {min(agree):.6f} "
          f"mean {np.mean(agree):.6f}", flush=True)
    check(min(agree) >= 0.99, f"default vs banded agreement {agree}")

    # the pure-squaring routes, one pass each
    for tag, extra, ids_, mode in (
        ("pure", ("--rw_square_times", "8"), four, "dense"),
        ("e3", ("--exp_times", "3", "--rw_square_times", "3"), ids, "banded"),
        ("e3_diag", ("--exp_times", "3"), ids, "diag"),
    ):
        out = os.path.join(work, f"sem_{tag}")
        _build.reset_launches()
        summ = cli(argv(out, extra, ids_, evaluate=False))[
            "make_sem_seg_labels"]
        launches[tag] = dict(_build.LAUNCHES)
        runs[tag] = dict(out=out, img_s=summ["n_images"] / summ["seconds"],
                         modes=summ["modes"], n_images=summ["n_images"])
        print(f"stage {tag} ({' '.join(extra)}): {runs[tag]['img_s']:.3f} "
              f"img/s over {summ['n_images']} images, one pass, walk modes "
              f"{summ['modes']}", flush=True)
        check(summ["modes"] and all(m == mode for m in summ["modes"].values()),
              f"{tag} walk modes {summ['modes']}")
    lp, le = launches["pure"], launches["e3"]
    # K6 and K5 are two launches per call (split pass, product)
    check(lp["square_fused_first"] == 2 * N_PURE
          and lp["square_dense"] == 2 * 7 * N_PURE,
          f"pure launches {lp}")
    # the default walk is K10 -> K0 -> K15 (one K10 launch, one K0 launch,
    # two K15 launches per walk): two passes over the tree, then one
    for tag, walks in (("default", 2 * N_IMAGES), ("e3_diag", N_IMAGES)):
        l_ = launches[tag]
        check(l_["diag_operator"] == walks and l_["diag_chain"] == walks
              and l_["decode"] == 2 * walks,
              f"{tag} launches K10 {l_['diag_operator']}, K0 "
              f"{l_['diag_chain']}, K15 {l_['decode']} for {walks} walks")
    check(launches["banded"]["decode"] == 2 * 2 * N_IMAGES
          and launches["banded"]["diag_operator"] == 0,
          f"banded launches {launches['banded']}")
    check(le["apply_banded"] == N_IMAGES
          and le["square_banded"] == 2 * 3 * N_IMAGES,
          f"e3 launches {le}")
    agree = agreement(runs["default"]["out"], runs["pure"]["out"],
                      names[:N_PURE])
    print(f"stage label agreement pure vs default: min {min(agree):.6f} "
          f"mean {np.mean(agree):.6f}", flush=True)
    check(min(agree) >= 0.99, f"pure vs default agreement {agree}")
    agree = agreement(runs["e3"]["out"], runs["e3_diag"]["out"], names)
    print(f"stage label agreement e3 vs e3_diag: min {min(agree):.6f} "
          f"mean {np.mean(agree):.6f}", flush=True)
    check(min(agree) >= 0.99, f"e3 vs e3_diag agreement {agree}")
    cfg, _ = port_run.parse(argv(runs["default"]["out"]))
    return dict(runs=runs, launches=launches, cfg=cfg, work=work,
                names=names)


def _walk_inputs(cfg, dev, index: int):
    """One image of the tree through the stage's own runner: (name, size,
    geom, cam [rows, ch, cw], edge [ch, cw], (h4, w4), keys) at the image's
    bucket, as RandomWalkRunner builds them."""
    from irn_tpu_torch.data import voc12
    from irn_tpu_torch.ops import random_walk as rw
    from irn_tpu_torch.pipeline import stages_irn

    runner = stages_irn._load_irn(cfg, dev)
    walker = stages_irn.RandomWalkRunner(cfg, 20, dev)
    sample = voc12.ImageDataset(cfg.infer_list, cfg.voc12_root,
                             img_normal=False)[index]
    img = sample["img"]
    size = img.shape[:2]
    (edge, _, (h4, w4)), = runner.batch([img], [size])
    cams, keys = stages_irn._load_sem_cam(cfg, sample["name"])
    ch, cw = walker._bucket(h4), walker._bucket(w4)
    cam = np.zeros((walker._row_bucket(len(cams)), ch, cw), np.float32)
    cam[: len(cams), :h4, :w4] = cams
    geom = rw.build_geometry(ch, cw, radius=cfg.rw_radius)
    return (sample["name"], size, geom, torch.from_numpy(cam).to(dev),
            edge[:ch, :cw], (h4, w4), keys)


def _labels_agree(cfg, rw_capped, hw4, size, keys, png: str) -> float:
    from irn_tpu_torch.data.image_io import imread
    from irn_tpu_torch.ops import random_walk as rw

    labels = rw.decode(rw_capped, hw4[0], hw4[1], size[0], size[1],
                       cfg.sem_seg_bg_thres).labels
    pred = keys[labels.cpu().numpy()[: size[0], : size[1]]]
    return float(np.mean(pred == imread(png)))


def library_bj_check(dev, stage: dict) -> None:
    """random_walk.propagate_banded(..., bj=1024) on one image (the K7
    rectangular-tile chain) vs the --rw_square_times 1 stage PNG."""
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.ops import random_walk as rw

    cfg = stage["cfg"]
    name, size, geom, cam, edge, hw4, keys = _walk_inputs(cfg, dev, 0)
    _build.reset_launches()
    out = rw.propagate_banded(geom, cam, edge, cfg.beta, exp_times=8,
                              square_times=1, bj=BJ)
    torch.cuda.synchronize()
    stage["launches"]["library bj"] = dict(_build.LAUNCHES)
    agree = _labels_agree(cfg, out, hw4, size, keys, os.path.join(
        stage["runs"]["banded"]["out"], name + ".png"))
    print(f"library propagate_banded(bj={BJ}) on {name} (grid "
          f"{geom.cap}): launches {stage['launches']['library bj']}, label "
          f"agreement with the --rw_square_times 1 stage {agree:.6f}",
          flush=True)
    check(_build.LAUNCHES["banded_chain"] == 1,
          f"library bj launches {_build.LAUNCHES}")
    check(agree >= 0.99, f"library bj agreement {agree}")


def library_batch_check(dev, stage: dict) -> None:
    """random_walk.propagate_banded_batch(..., square_times=1) on the tree's
    first B_BATCH images, which share the 128x128 bucket (n_pad 18432): one
    K8 chain for all, each image bit-equal to propagate_banded of that image
    and agreeing with the --rw_square_times 1 stage PNG."""
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.ops import random_walk as rw

    cfg = stage["cfg"]
    ins = [_walk_inputs(cfg, dev, i) for i in range(B_BATCH)]
    geom = ins[0][2]
    check(all(g.cap == geom.cap for _, _, g, *_ in ins)
          and geom.n_pad == 18432, f"batch buckets {[g.cap for _, _, g, *_ in ins]}")
    rows = max(cam.shape[0] for _, _, _, cam, *_ in ins)
    cams = torch.stack([torch.nn.functional.pad(
        cam, (0, 0, 0, 0, 0, rows - cam.shape[0])) for _, _, _, cam, *_ in ins])
    edges = torch.stack([edge for _, _, _, _, edge, *_ in ins])
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = rw.propagate_banded_batch(geom, cams, edges, cfg.beta, exp_times=8,
                                    square_times=1)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    stage["launches"]["library batch"] = dict(_build.LAUNCHES)
    check(_build.LAUNCHES["packed_chain_batched"] == 1
          and _build.LAUNCHES["packed_chain"] == 0,
          f"library batch launches {_build.LAUNCHES}")
    t0 = time.perf_counter()
    refs = [rw.propagate_banded(geom, cam, edge, cfg.beta, exp_times=8,
                                square_times=1)
            for _, _, _, cam, edge, *_ in ins]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    for b, (name, size, _, cam, _, hw4, keys) in enumerate(ins):
        check(torch.equal(out[b, : cam.shape[0]], refs[b]),
              f"propagate_banded_batch {name} not bit-equal to propagate_banded")
        agree = _labels_agree(cfg, out[b, : cam.shape[0]], hw4, size, keys,
                              os.path.join(
            stage["runs"]["banded"]["out"], name + ".png"))
        print(f"library propagate_banded_batch image {name}: bit-equal to "
              f"propagate_banded; label agreement with the --rw_square_times "
              f"1 stage {agree:.6f}", flush=True)
        check(agree >= 0.99, f"library batch agreement {name} {agree}")
    print(f"library propagate_banded_batch(square_times=1) on {B_BATCH} "
          f"images (grid {geom.cap}, n_pad {geom.n_pad}): "
          f"{batch_s * 1e3 / B_BATCH:.3f} ms/img batched, "
          f"{single_s * 1e3 / B_BATCH:.3f} ms/img one by one (host clock, "
          f"one call each; launches "
          f"{stage['launches']['library batch']})", flush=True)


def probe_conv(dev, stage: dict) -> None:
    """The conv probe's entry point, irn_tpu_torch.tools.bench_conv, over
    its four shapes with a small rep count; every shape within 2^-7 of
    max|twin| and >= 99% bit-equal."""
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.tools import bench_conv

    _build.reset_launches()
    rows = bench_conv.main(["--reps", "3"])
    torch.cuda.synchronize()
    stage["launches"]["probe conv"] = dict(_build.LAUNCHES)
    for r_ in rows:
        check(r_["rel_err"] <= 2.0 ** -7 and r_["bit_equal"] >= 0.99,
              f"bench_conv {r_['label']}: rel {r_['rel_err']}, bit-equal "
              f"{r_['bit_equal']}")


def probe_banded(dev, stage: dict) -> None:
    """The banded sweep's entry point, irn_tpu_torch.tools.bench_banded,
    batched sweep only, B in {1, 2, 4} at e = 1, one timed run."""
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.tools import bench_banded

    _build.reset_launches()
    bench_banded.main(["--batch_only", "--batch_sizes", "1", "2", "4",
                       "--square_times", "1", "--reps", "1"])
    torch.cuda.synchronize()
    stage["launches"]["probe banded"] = dict(_build.LAUNCHES)
    check(_build.LAUNCHES["packed_chain_batched"] > 0,
          f"bench_banded launches {_build.LAUNCHES}")


def pure_twin_check(dev, stage: dict) -> None:
    """One pure-route image through the plain twins, called by name on
    CUDA tensors (normalize + cuBLAS squarings), vs the hand-kernel
    route's PNG. On the host these eight squarings would take minutes."""
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.ops import matpow_kernels as mk
    from irn_tpu_torch.ops import random_walk as rw

    cfg = stage["cfg"]
    name, size, geom, cam, edge, hw4, keys = _walk_inputs(cfg, dev, 0)
    _build.reset_launches()
    t0 = time.perf_counter()
    t = mk.square_fused_first_plain(rw.dense_affinity(geom, edge), cfg.beta)
    for _ in range(7):
        t = mk.square_dense_plain(t)
    out = rw.propagate_with_transition(geom, cam, edge, t, 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(not any(_build.LAUNCHES.values()), f"twins launched {_build.LAUNCHES}")
    agree = _labels_agree(cfg, out, hw4, size, keys, os.path.join(
        stage["runs"]["pure"]["out"], name + ".png"))
    print(f"pure route of {name} (grid {geom.cap}, n_pad {geom.n_pad}) "
          f"through the plain twins on the card ({seconds:.3f} s): label "
          f"agreement with the hand kernels {agree:.6f}", flush=True)
    check(agree >= 0.999, f"pure twin vs kernel agreement {agree}")


def cpu_walk_check(dev, stage: dict) -> float:
    """One image's walk through the plain twins on CPU tensors vs the same
    walk on the card (K10 -> K0 -> K15) from the same edge map: equal
    labels; and vs the default run's PNG."""
    from irn_tpu_torch.data import voc12
    from irn_tpu_torch.data.image_io import imread
    from irn_tpu_torch.pipeline import stages_irn

    cfg = stage["cfg"]
    runner = stages_irn._load_irn(cfg, dev)
    sample = voc12.ImageDataset(cfg.infer_list, cfg.voc12_root,
                             img_normal=False)[0]
    img = sample["img"]
    size = img.shape[:2]
    (edge, _, (h4, w4)), = runner.batch([img], [size])
    cams, keys = stages_irn._load_sem_cam(cfg, sample["name"])
    walker = stages_irn.RandomWalkRunner(cfg, 20, torch.device("cpu"))
    t0 = time.perf_counter()
    labels = walker(cams, edge.cpu(), h4, w4, size, cfg.sem_seg_bg_thres)
    seconds = time.perf_counter() - t0
    on_card = stages_irn.RandomWalkRunner(cfg, 20, dev)(
        cams, edge, h4, w4, size, cfg.sem_seg_bg_thres).cpu()
    same = float((on_card == labels).float().mean())
    print(f"default walk of {sample['name']} on the card (K10 -> K0 -> K15) "
          f"vs the host twins from the same edge map: {same:.6f} of the "
          f"labels equal", flush=True)
    check(torch.equal(on_card, labels), f"card vs host twin walk {same}")
    pred = keys[labels.numpy()[: size[0], : size[1]]]
    card = imread(os.path.join(cfg.sem_seg_out_dir,
                                       sample["name"] + ".png"))
    agree = float(np.mean(pred == card))
    print(f"CPU plain-twin walk of {sample['name']} ({size[0]}x{size[1]} px, "
          f"modes {walker.modes}, {seconds:.2f} s on the host): label "
          f"agreement with the card {agree:.6f}", flush=True)
    check(agree >= 0.999, f"CPU vs card agreement {agree}")
    return agree


def layer_breakdown(dev, stage: dict, card: str) -> None:
    """Where an image's time goes: each step of the stage, run alone over
    the tree's images and ended by a synchronize (host clock), for both
    walks; then one default-configuration stage pass under torch.profiler
    for the device's busy share."""
    from collections import defaultdict

    from irn_tpu_torch.data import image_io, voc12
    from irn_tpu_torch.ops import matpow_kernels as mk
    from irn_tpu_torch.ops import random_walk as rw
    from irn_tpu_torch.pipeline import stages_irn

    cfg = stage["cfg"]
    runner = stages_irn._load_irn(cfg, dev)
    walker = stages_irn.RandomWalkRunner(cfg, 20, dev)
    ds = voc12.ImageDataset(cfg.infer_list, cfg.voc12_root,
                             img_normal=False)
    ms = defaultdict(float)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3 / len(ds)
        return out

    out_png = os.path.join(stage["work"], "layer.png")
    for rep in range(2):  # the first pass warms up; the second is kept
        ms.clear()
        for i in range(len(ds)):
            sample = timed("read image + cams", lambda: ds[i])
            img = sample["img"]
            size = img.shape[:2]
            (edge, _, (h4, w4)), = timed(
                "forward", lambda: runner.batch([img], [size]))
            cams, keys = timed("read image + cams",
                               lambda: stages_irn._load_sem_cam(
                                   cfg, sample["name"]))
            ch, cw = walker._bucket(h4), walker._bucket(w4)
            geom = rw.build_geometry(ch, cw, radius=cfg.rw_radius)
            edge_b = edge[:ch, :cw]

            def upload():
                cam = np.zeros((walker._row_bucket(len(cams)), ch, cw),
                               np.float32)
                cam[: len(cams), :h4, :w4] = cams
                return torch.from_numpy(cam).to(dev)

            cam_t = timed("seed upload", upload)
            w, inv = timed("default: operator build (band values, diag T)",
                           lambda: rw.build_diag_operator(geom, edge_b))
            timed("default: operator build, plain twin (eager torch)",
                  lambda: rw.build_diag_operator_plain(geom, edge_b))
            x = rw._flat_seeds(geom, cam_t, edge_b)
            y = timed("default: K0 chain (256 applications)",
                      lambda: rw.apply_diag_chain(
                          x, w, inv, rw.diag_offsets(geom), 256))
            h = rw.band_halfwidth(geom)
            t = timed("banded: dense T (affinity, A^beta, colnorm)",
                      lambda: rw.normalize_transition(
                          rw.dense_affinity(geom, edge_b)))
            t = timed("banded: K2 squaring", lambda: mk.square_banded(t, h))
            tp = timed("banded: K1 pack", lambda: mk.pack_banded(t, 2 * h))
            xb = torch.nn.functional.pad(x, (0, 0, 0, (-len(x)) % 8))
            timed("banded: K3 chain (128 applications)",
                  lambda: mk.packed_chain(xb, tp, 128))
            del t, tp
            y = rw._unflatten_rw(geom, y)
            labels = timed("decode (x4 upsample, argmax)",
                           lambda: rw.decode(y, h4, w4, size[0], size[1],
                                             cfg.sem_seg_bg_thres).labels)
            timed("decode, plain twin (eager torch)",
                  lambda: rw.decode_plain(y, h4, w4, size[0], size[1],
                                          cfg.sem_seg_bg_thres))
            timed("fetch labels + PNG write", lambda: image_io.imwrite(
                out_png, keys[labels.cpu().numpy()[: size[0], : size[1]]]
                .astype(np.uint8)))
    for name, v in ms.items():
        print(f"layer {name}: {v:.3f} ms/img ({card})", flush=True)

    prof_cfg = dataclasses.replace(
        cfg, sem_seg_out_dir=os.path.join(stage["work"], "sem_prof"))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        summ = stages_irn.make_sem_seg_labels(prof_cfg, dev)
    device_us = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    )
    wall_ms = summ["seconds"] * 1e3
    if device_us > 0:
        print(f"profiled default pass: {summ['n_images']} images in "
              f"{wall_ms:.1f} ms, device busy {device_us / 1e3:.1f} ms "
              f"({100 * device_us / 1e3 / wall_ms:.1f}% of the loop; "
              f"profiler on) ({card})", flush=True)
    else:
        print("profiled default pass: the profiler saw no device time; "
              "device busy share not measured", flush=True)


def dense_layers(dev, stage: dict, card: str) -> None:
    """The pure and e3 routes' steps, each ended by a synchronize (host
    clock), over the first two images after one warm-up call."""
    from collections import defaultdict

    from irn_tpu_torch.ops import matpow
    from irn_tpu_torch.ops import matpow_kernels as mk
    from irn_tpu_torch.ops import random_walk as rw

    cfg = stage["cfg"]
    inputs = [_walk_inputs(cfg, dev, i) for i in range(2)]
    ms = defaultdict(float)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3 / len(inputs)
        return out

    for batch in ([inputs[0]], inputs):
        ms.clear()  # the first call warms up; the two images are kept
        for _, _, geom, cam, edge, _, _ in batch:
            a = timed("dense A build (affinity)",
                      lambda: rw.dense_affinity(geom, edge))
            t = timed("pure: K6 fused first squaring",
                      lambda: mk.square_fused_first(a, cfg.beta))
            t = timed("pure: 7 x K5 squarings",
                      lambda: matpow.matrix_power_squarings(t, 7))
            timed("pure: x @ T application (torch.matmul)",
                  lambda: rw.propagate_with_transition(geom, cam, edge, t, 1))
            del t
            h = rw.band_halfwidth(geom)
            t = timed("e3: T (A^beta, colnorm)",
                      lambda: rw.normalize_transition(a, cfg.beta))
            del a

            def squarings():
                t_, h_ = t, h
                for _ in range(3):
                    t_, h_ = mk.square_banded(t_, h_, BS), 2 * h_
                return t_, h_

            t8, h8 = timed("e3: 3 x K2 squarings", squarings)
            timed("e3: K4 application", lambda: rw.apply_transition_banded(
                geom, cam, edge, t8, h8, 1, BS))
            del t, t8
    grids = ", ".join(f"{g.cap[0]}x{g.cap[1]}" for _, _, g, *_ in inputs)
    for name, v in ms.items():
        print(f"layer {name}: {v:.3f} ms/img (grids {grids}; {card})",
              flush=True)


def _cam_net_checkpoint(work: str) -> str:
    """A seeded random CAMNet written through cam_to_jax: the JAX-layout
    checkpoint make_cam reads."""
    from irn_tpu_torch.models.cam import CAMNet
    from irn_tpu_torch.models.irn import init_irnet
    from irn_tpu_torch.utils.checkpoint import save_checkpoint
    from irn_tpu_torch.utils.weights import cam_to_jax

    # init_irnet draws every conv of a module (here the backbone and head)
    model = init_irnet(CAMNet(), torch.Generator().manual_seed(SEED + 1))
    path = os.path.join(work, "cam.ckpt")
    save_checkpoint(path, cam_to_jax(model.state_dict()))
    return path


def run_cam_stages(dev, stage: dict, card: str) -> dict:
    """make_cam, eval_cam and cam_to_ir_label through the port's CLI on the
    tree, with a seeded random CAMNet: the device CRF (auto: int8; then
    the dense store) and the native lattice, then make_sem_seg's default
    walk on make_cam's own CAMs. TF32 is switched on before the runs: the
    stages must switch it off."""
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.ops import crf_device
    from irn_tpu_torch.ops import native
    from irn_tpu_torch.pipeline import stages_cam
    from irn_tpu_torch.pipeline.config import Config

    work, names = stage["work"], stage["names"]
    root = os.path.join(work, "voc")
    ids = os.path.join(root, "all.txt")
    cams = os.path.join(work, "cam_made")
    weights = _cam_net_checkpoint(work)

    def argv(*extra, ir="ir_auto"):
        return ["--voc12_root", root, "--infer_list", ids, "--train_list", ids,
                "--cam_weights_name", weights, "--cam_out_dir", cams,
                "--ir_label_out_dir", os.path.join(work, ir),
                "--session_dir", os.path.join(work, "sess"),
                "--log_name", os.path.join(work, "log_cam"),
                "--device", str(dev), *extra]

    tf32 = []
    forward, build = stages_cam.CAMScalePass.forward, crf_device.LandmarkKernel

    def forward_seen(self, *a):
        tf32.append(("make_cam", torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return forward(self, *a)

    class KernelSeen(build):
        def __init__(self, *a, **kw):
            tf32.append(("crf", torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            super().__init__(*a, **kw)

    runs = {}
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    stages_cam.CAMScalePass.forward = forward_seen
    crf_device.LandmarkKernel = KernelSeen
    try:
        _build.reset_launches()
        first = cli(argv("--make_cam_pass", "--eval_cam_pass",
                         "--cam_to_ir_label_pass"))
        # a second pass over the same images (warm caches): smoke rates
        again = cli(argv("--make_cam_pass", "--cam_to_ir_label_pass",
                         "--overwrite"))
        stage["launches"]["cam stages"] = dict(_build.LAUNCHES)
        _build.reset_launches()
        runs["native"] = cli(argv("--cam_to_ir_label_pass", "--crf_backend",
                                  "native", ir="ir_native"))["cam_to_ir_label"]
        stage["launches"]["cam native"] = dict(_build.LAUNCHES)
        _build.reset_launches()
        runs["dense"] = cli(argv("--cam_to_ir_label_pass", "--crf_backend",
                                 "tpu", "--crf_kernel_store", "dense",
                                 ir="ir_dense"))["cam_to_ir_label"]
        stage["launches"]["cam dense"] = dict(_build.LAUNCHES)
    finally:
        stages_cam.CAMScalePass.forward = forward
        crf_device.LandmarkKernel = build
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    check(tf32 and not any(a or b for _, a, b in tf32),
          f"TF32 on inside a stage: {sorted(set(tf32))}")
    # per image and device-CRF pass (two int8 passes, one dense): K14's two
    # launches (its table pass and its rows), K17's 2 + 2 t (the blur of
    # the validity mask, the start, a quantize and a combine per
    # iteration); no other hand kernel, none under the native lattice
    per_pass = {"crf_landmark": 2,
                "crf_mean_field": 2 + 2 * Config.crf_iters}
    for run, passes in (("cam stages", 2), ("cam native", 0),
                        ("cam dense", 1)):
        counts = stage["launches"][run]
        want = {k: passes * per_pass.get(k, 0) * len(names)
                for k in counts}
        check(counts == want, f"{run}: launches {counts}, expected {want}")
    for n_ in names:
        d = np.load(os.path.join(cams, n_ + ".npy"), allow_pickle=True).item()
        h, w = _image_size(root, n_)
        check(sorted(d) == ["cam", "high_res", "keys"]
              and d["keys"].dtype == np.int64
              and d["cam"].dtype == d["high_res"].dtype == np.float32
              and d["cam"].shape == (len(d["keys"]), (h - 1) // 4 + 1,
                                     (w - 1) // 4 + 1)
              and d["high_res"].shape == (len(d["keys"]), h, w)
              and bool(np.isfinite(d["cam"]).all())
              and bool(np.isfinite(d["high_res"]).all())
              and float(d["high_res"].max(initial=0)) <= 1.0,
              f"make_cam {n_}: keys {d['keys']}, cam {d['cam'].shape}, "
              f"high_res {d['high_res'].shape} of a {h}x{w} image")
    mc, ir = again["make_cam"], again["cam_to_ir_label"]
    check(mc["n_images"] == ir["n_images"] == len(names)
          and ir["backend"] == "tpu" and ir["kernel_store"] == "int8"
          and runs["native"]["backend"] == "native"
          and runs["dense"]["kernel_store"] == "dense",
          f"cam stage summaries {mc} {ir} {runs}")
    runs["int8"] = ir
    print(f"stage make_cam: {mc['n_images'] / mc['seconds']:.3f} img/s second "
          f"pass ({first['make_cam']['n_images'] / first['make_cam']['seconds']:.3f} "
          f"img/s first pass; smoke rates over {len(names)} images 360-500 px, "
          f"4 scales, cam_infer_batch 32; {card})", flush=True)
    print(f"stage eval_cam: mIoU {first['eval_cam']['miou']:.4f} (random "
          f"weights)", flush=True)
    for tag in ("int8", "dense", "native"):
        r_ = runs[tag]
        print(f"stage cam_to_ir_label {tag} ({r_['backend']}): "
              f"{r_['n_images'] / r_['seconds']:.3f} img/s over "
              f"{r_['n_images']} images{', second pass' if tag == 'int8' else ''}"
              f" ({card})", flush=True)
    print(f"stage cam_to_ir_label int8 first pass: "
          f"{first['cam_to_ir_label']['n_images'] / first['cam_to_ir_label']['seconds']:.3f}"
          f" img/s; native library {native.BUILD_INFO}", flush=True)
    for tag in ("int8", "dense"):
        agree = agreement(os.path.join(work, f"ir_{'auto' if tag == 'int8' else tag}"),
                          os.path.join(work, "ir_native"), names)
        print(f"stage ir_label agreement device CRF {tag} vs native: min "
              f"{min(agree):.6f} mean {np.mean(agree):.6f}", flush=True)
        check(min(agree) >= 0.90, f"device CRF {tag} vs native {agree}")
    agree = agreement(os.path.join(work, "ir_auto"),
                      os.path.join(work, "ir_dense"), names)
    print(f"stage ir_label agreement int8 vs dense: min {min(agree):.6f} "
          f"mean {np.mean(agree):.6f}", flush=True)

    # make_sem_seg's default walk on make_cam's own CAMs: K10, K0, K15
    _build.reset_launches()
    out = os.path.join(work, "sem_on_made_cams")
    summ = cli(["--voc12_root", root, "--infer_list", ids, "--train_list", ids,
                "--cam_out_dir", cams, "--irn_weights_name",
                stage["cfg"].irn_weights_name,
                "--session_dir", os.path.join(work, "sess"),
                "--log_name", os.path.join(work, "log_sem_cam"),
                "--sem_seg_out_dir", out, "--make_sem_seg_pass",
                "--device", str(dev)])["make_sem_seg_labels"]
    stage["launches"]["default on made cams"] = dict(_build.LAUNCHES)
    check(summ["n_images"] == len(names)
          and _build.LAUNCHES["diag_operator"] == len(names)
          and _build.LAUNCHES["diag_chain"] == len(names)
          and _build.LAUNCHES["decode"] == 2 * len(names)
          and all(os.path.exists(os.path.join(out, n_ + ".png"))
                  for n_ in names),
          f"make_sem_seg on make_cam's CAMs: {summ}, {_build.LAUNCHES}")
    print(f"stage make_sem_seg (default) on make_cam's CAMs: "
          f"{summ['n_images'] / summ['seconds']:.3f} img/s, one pass, "
          f"launches {stage['launches']['default on made cams']}", flush=True)
    return dict(root=root, ids=ids, cams=cams, weights=weights, work=work,
                names=names)


def _image_size(root: str, name: str) -> tuple:
    from PIL import Image

    with Image.open(os.path.join(root, "JPEGImages", name + ".jpg")) as im:
        return im.size[1], im.size[0]


def make_cam_host_check(cam: dict, tag: str = "cam_host") -> tuple:
    """One image's make_cam on the host against the card's npy in
    ``cam['cams']`` (same keys, max-abs < 1e-3); returns (the image's name,
    the card's npy dict, the host's Config)."""
    from irn_tpu_torch.pipeline import stages_cam
    from irn_tpu_torch.pipeline.config import Config

    name = cam["names"][0]
    one = os.path.join(cam["work"], "one.txt")
    with open(one, "w") as f:
        f.write(name + "\n")
    host_dir = os.path.join(cam["work"], tag)
    cfg = Config(voc12_root=cam["root"], train_list=one, infer_list=one,
                 cam_weights_name=cam["weights"],
                 cam_out_dir=host_dir).resolve()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stages_cam.make_cam(cfg, "cpu")
    seconds = time.perf_counter() - t0
    got = np.load(os.path.join(cam["cams"], name + ".npy"),
                  allow_pickle=True).item()
    want = np.load(os.path.join(host_dir, name + ".npy"),
                   allow_pickle=True).item()
    check(np.array_equal(got["keys"], want["keys"]),
          f"make_cam keys card {got['keys']} host {want['keys']}")
    errs = {k: float(np.abs(got[k] - want[k]).max(initial=0))
            for k in ("cam", "high_res")}
    print(f"make_cam of {name} on the host ({seconds:.2f} s) vs the card "
          f"({cam['weights']}): max-abs {errs}", flush=True)
    check(max(errs.values()) < 1e-3, f"make_cam card vs host {errs}")
    return name, got, cfg


def cam_host_checks(dev, cam: dict, crop=(192, 256)) -> None:
    """One image's make_cam on the host against the card's npy (max-abs
    < 1e-3), and the device CRF on the card against the host port on one
    image's top-left ``crop`` (int8: >= 99.9% equal, its products exact
    integers on both; dense bf16: >= 99.5%)."""
    from irn_tpu_torch.ops.crf_device import LandmarkCRF
    from irn_tpu_torch.pipeline import stages_cam

    name, got, cfg = make_cam_host_check(cam)

    from irn_tpu_torch.data.image_io import imread

    img = imread(os.path.join(cam["root"], "JPEGImages", name + ".jpg"))
    h, w = crop
    img = np.ascontiguousarray(img[:h, :w])
    fg, bg = stages_cam.confident_maps(got["high_res"][:, :h, :w],
                                       cfg.conf_fg_thres, cfg.conf_bg_thres)
    n_labels = len(got["keys"]) + 1
    for store, gate in (("int8", 0.999), ("dense", 0.995)):
        kw = dict(t=cfg.crf_iters, pad_multiple=cfg.pad_multiple,
                  kernel_store=store)
        card_ = LandmarkCRF(device=dev, **kw).pair(img, fg, bg, n_labels)
        t0 = time.perf_counter()
        host = LandmarkCRF(device="cpu", **kw).pair(img, fg, bg, n_labels)
        seconds = time.perf_counter() - t0
        agree = [float(np.mean(a == b)) for a, b in zip(card_, host)]
        print(f"device CRF {store} on {name}[:{h}, :{w}]: card vs host "
              f"({seconds:.2f} s) label agreement fg {agree[0]:.6f} bg "
              f"{agree[1]:.6f}", flush=True)
        check(min(agree) >= gate, f"device CRF {store} card vs host {agree}")


def cam_layers(dev, cam: dict, card: str) -> None:
    """Where an image's time goes in make_cam and cam_to_ir_label: each
    step run alone over the tree's images and ended by a synchronize (host
    clock), the first pass a warm-up; then the CRF's two library products
    at the largest bucket of the tree, timed by CUDA events beside their
    bound."""
    from collections import defaultdict

    from irn_tpu_torch.data import image_io, voc12
    from irn_tpu_torch.ops.crf_device import (LandmarkCRF, product_f32,
                                              product_int8)
    from irn_tpu_torch.pipeline import stages_cam
    from irn_tpu_torch.pipeline.config import Config

    cfg = Config(voc12_root=cam["root"], train_list=cam["ids"],
                 infer_list=cam["ids"], cam_weights_name=cam["weights"],
                 cam_out_dir=cam["cams"]).resolve()
    ds = voc12.ClassificationDataset(cfg.infer_list, cfg.voc12_root,
                                     stages_cam._label_dict(cfg),
                                     img_normal=False)
    sp = stages_cam.CAMScalePass(stages_cam.load_cam_net(cfg, dev), dev,
                                 cfg.rw_grid_cap, 4 * cfg.rw_grid_cap)
    crfs = {s: LandmarkCRF(t=cfg.crf_iters, pad_multiple=cfg.pad_multiple,
                           kernel_store=s, device=dev)
            for s in ("int8", "dense")}
    ms = defaultdict(float)
    n = len(ds)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3 / n
        return out

    npy = os.path.join(cam["work"], "layer.npy")
    png = os.path.join(cam["work"], "layer_ir.png")
    kernel_bytes, build_peak = {}, {}
    with torch.no_grad():
        for rep in range(2):
            ms.clear()
            for i in range(n):
                sample = timed("make_cam: read image", lambda: ds[i])
                imgs = sample["img"][None]
                size = imgs.shape[1:3]
                s4 = stages_cam.T.get_strided_size(size, 4)
                su = stages_cam.T.get_strided_up_size(size, 16)
                s_acc = torch.zeros((1, 20, sp.s4_cap, sp.s4_cap), device=dev)
                h_acc = torch.zeros((1, 20, sp.su_cap, sp.su_cap), device=dev)
                for scale in cfg.cam_scales:
                    padded, sh, sw = timed(
                        "make_cam: PIL rescale + pad (host)",
                        lambda: stages_cam.scale_inputs(imgs, scale,
                                                        cfg.pad_multiple))
                    x = timed("make_cam: upload",
                              lambda: torch.from_numpy(padded).to(dev))
                    vh, vw = -(-sh // 16), -(-sw // 16)
                    stack = timed("make_cam: normalize + flip stack",
                                  lambda: sp.prep(x, sh, sw))
                    maps = timed(f"make_cam: forward at scale {scale}",
                                 lambda: sp.forward(stack, sh, sw))
                    s, hr = timed("make_cam: flip fusion + resizes",
                                  lambda: sp.resize(sp.fuse(maps, vw), vh, vw,
                                                    s4, su, size))
                    s_acc += s
                    h_acc += hr
                valid = np.nonzero(np.asarray(sample["label"]))[0]
                timed("make_cam: finalize + npy write", lambda: stages_cam.save_cam(
                    npy, valid, *stages_cam.finalize(s_acc[0], h_acc[0], valid),
                    s4, size))

                d = timed("cam_to_ir_label: read npy + confident maps (host)",
                          lambda: np.load(os.path.join(
                              cam["cams"], sample["name"] + ".npy"),
                              allow_pickle=True).item())
                fg, bg = timed("cam_to_ir_label: read npy + confident maps (host)",
                               lambda: stages_cam.confident_maps(
                                   d["high_res"], cfg.conf_fg_thres,
                                   cfg.conf_bg_thres))
                keys = np.pad(d["keys"] + 1, (1, 0))
                for store, crf in crfs.items():
                    h, w = size
                    packed = timed(f"cam_to_ir_label {store}: upload",
                                   lambda: crf.upload(sample["img"], fg, bg))
                    torch.cuda.reset_peak_memory_stats(dev)
                    base = torch.cuda.memory_allocated(dev)
                    kern = timed(f"cam_to_ir_label {store}: kernel build",
                                 lambda: crf.build(packed, h, w))
                    kernel_bytes[store] = max(kernel_bytes.get(store, 0),
                                              kern.nbytes())
                    # what the build held beyond what it keeps
                    build_peak[store] = max(build_peak.get(store, 0),
                                            torch.cuda.max_memory_allocated(dev)
                                            - base - kern.nbytes())
                    out = timed(f"cam_to_ir_label {store}: {cfg.crf_iters} "
                                f"iterations", lambda: crf.iterate(
                                    kern, packed, len(keys), cfg.crf_gt_prob))
                    del kern
                    timed(f"cam_to_ir_label {store}: fetch + PNG write",
                          lambda: image_io.imwrite(png, stages_cam.combine_conf(
                              keys[out[0, :h, :w].cpu().numpy()],
                              keys[out[1, :h, :w].cpu().numpy()])))
    for name, v in ms.items():
        print(f"layer {name}: {v:.3f} ms/img ({card})", flush=True)
    print(f"device CRF landmark kernel at the tree's largest bucket: "
          f"{kernel_bytes} bytes; the build's peak memory above it "
          f"{build_peak} bytes", flush=True)

    # the iterations' products at the largest bucket of the tree
    bucket = max((LandmarkCRF(pad_multiple=cfg.pad_multiple)._bucket(
        *_image_size(cam["root"], n_)) for n_ in cam["names"]),
        key=lambda b: b[0] * b[1])
    n_px = bucket[0] * bucket[1]
    s_land = len(range(2, bucket[0], 4)) * len(range(2, bucket[1], 4))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k8 = torch.randint(0, 128, (n_px, s_land), generator=gen, device=dev,
                       dtype=torch.int8)
    q8 = torch.randint(0, 128, (s_land, 42), generator=gen, device=dev,
                       dtype=torch.int8)
    t_int8 = cuda_ms(lambda: product_int8(k8, q8), 10)
    q8_rows = torch.nn.functional.pad(q8, (0, 6))  # row-major right operand
    check(torch.equal(torch._int_mm(k8, q8_rows)[:, :42],
                      product_int8(k8, q8)), "int8 product layouts differ")
    t_int8_rows = cuda_ms(lambda: torch._int_mm(k8, q8_rows), 10)
    b_int8 = bound(2 * n_px * s_land * 48, n_px * s_land + s_land * 48
                   + 4 * n_px * 48, PEAK_INT8)
    del k8
    kb = torch.rand((n_px, s_land), generator=gen, device=dev).bfloat16()
    q = torch.rand((s_land, 42), generator=gen, device=dev)
    t_bf16 = cuda_ms(lambda: product_f32(kb, q), 10)
    b_bf16 = bound(2 * n_px * s_land * 42, 2 * n_px * s_land + 4 * s_land * 42
                   + 4 * n_px * 42, PEAK_BF16)
    del kb
    print(f"CRF product at the {bucket[0]}x{bucket[1]} bucket (N {n_px}, S "
          f"{s_land}): torch._int_mm int8 [N, S] @ [S, 48] {t_int8:.4f} ms "
          f"(right operand column-major; row-major {t_int8_rows:.4f} ms), "
          f"bound {b_int8['bound_ms']:.4f} ms ({b_int8['bound_by']}); "
          f"torch.mm bf16 [N, S] @ [S, 42] -> f32 {t_bf16:.4f} ms, bound "
          f"{b_bf16['bound_ms']:.4f} ms ({b_bf16['bound_by']}) ({card})",
          flush=True)


TRAIN_REPEAT = 8  # the train list: the tree's 8 images, 8 times each
HOST_BATCH = 4  # the card-vs-host train step


def _head_names(sd) -> list:
    return [k for k in sd if not k.startswith(("resnet50.", "mean_shift."))]


def run_train_stage(dev, stage: dict, card: str) -> dict:
    """train_irn through the port's CLI at its defaults (crop 512, batch 32,
    radius 10, lr 0.1) on the ir labels of the cam phase, with a seeded
    random backbone: 2 epochs of 2 steps, then the same run at 3 epochs,
    resumed from ``.train`` (2 more steps); then make_sem_seg and
    make_ins_seg on the trained checkpoint. TF32 is switched on before the
    runs: the stage must switch it off."""
    from irn_tpu_torch.models.irn import IRNet
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.pipeline import common
    from irn_tpu_torch.pipeline import run as port_run
    from irn_tpu_torch.train import irn_train
    from irn_tpu_torch.utils.checkpoint import load_checkpoint
    from irn_tpu_torch.utils.weights import irn_from_jax

    work, names = stage["work"], stage["names"]
    root = os.path.join(work, "voc")
    ids = os.path.join(root, "all.txt")
    train_ids = os.path.join(root, "train64.txt")
    with open(train_ids, "w") as f:
        f.write("\n".join(names * TRAIN_REPEAT) + "\n")
    weights = os.path.join(work, "irn_trained.ckpt")

    def argv(*extra):
        return ["--voc12_root", root, "--train_list", train_ids,
                "--infer_list", ids,
                "--ir_label_out_dir", os.path.join(work, "ir_auto"),
                "--cam_out_dir", os.path.join(work, "cam"),
                "--irn_weights_name", weights,
                "--session_dir", os.path.join(work, "sess"),
                "--log_name", os.path.join(work, "log_train"),
                "--device", str(dev), *extra]

    tf32 = []
    make_step = irn_train.make_train_step

    def make_step_seen(*a, **kw):
        step = make_step(*a, **kw)

        def seen(*x):
            tf32.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return step(*x)
        return seen

    logs = []
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    irn_train.make_train_step = make_step_seen
    try:
        _build.reset_launches()
        first = cli(argv("--train_irn_pass", "--irn_num_epoches", "2"),
                    logs)["train_irn"]
        resumed = cli(argv("--train_irn_pass", "--irn_num_epoches", "3"),
                      logs)["train_irn"]
        stage["launches"]["train irn"] = dict(_build.LAUNCHES)
    finally:
        irn_train.make_train_step = make_step
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    for text in logs:
        for line in text.splitlines():
            if line.startswith(("WARNING", "Epoch", "step:", "resumed",
                                "saved", "Analyzing")):
                print(f"  train_irn: {line}", flush=True)
    check(len(tf32) == 6 and not any(a or b for a, b in tf32),
          f"TF32 inside train_irn's steps: {tf32}")
    check(any("WARNING: no pretrained_backbone" in t for t in logs),
          "train_irn printed no random-backbone warning")
    lt = stage["launches"]["train irn"]
    check((first["n_steps"], resumed["n_steps"], resumed["start_epoch"])
          == (4, 2, 2), f"train runs {first['n_steps']} + "
          f"{resumed['n_steps']} steps from epoch {resumed['start_epoch']}")
    # per step one K13a, two K16 forward (its sums, their total), one K16
    # backward and one K13b, nothing else
    check(lt["path_max_fwd"] == 6 and lt["path_max_bwd"] == 6
          and lt["irn_loss_fwd"] == 12 and lt["irn_loss_bwd"] == 6
          and sum(lt.values()) == 30, f"train launches {lt}")
    losses = first["losses"] + resumed["losses"]
    check(len(losses) == 6 and all(np.isfinite(v) for row in losses
                                   for v in row.values()),
          f"train losses {losses}")
    print(f"train losses per step (pos_aff, neg_aff, dp_fg, dp_bg, total): "
          + "; ".join(", ".join(f"{row[k]:.4f}" for k in (
              "loss_pos_aff", "loss_neg_aff", "loss_dp_fg", "loss_dp_bg",
              "loss")) for row in losses), flush=True)

    # the backbone is the seeded initial one bit for bit; every head
    # tensor moved; dp_mean is a finite pair
    cfg, _ = port_run.parse(argv())
    with contextlib.redirect_stdout(io.StringIO()):
        init = common.init_model_variables(IRNet(), cfg).state_dict()
    saved = load_checkpoint(weights)
    final = irn_from_jax(saved)
    check(all(torch.equal(final[k], v) for k, v in init.items()
              if k.startswith("resnet50.")),
          "the trained backbone differs from its initial values")
    still = [k for k in _head_names(init) if torch.equal(final[k], init[k])]
    check(not still, f"head tensors unchanged by training: {still}")
    dp_mean = np.asarray(saved["stats"]["dp_mean"])
    check(dp_mean.shape == (2,) and bool(np.isfinite(dp_mean).all()),
          f"dp_mean {dp_mean}")
    rate = [r["n_steps"] * cfg.irn_batch_size / r["seconds"]
            for r in (first, resumed)]
    print(f"stage train_irn: {rate[0]:.2f} img/s over the first run's "
          f"{first['n_steps']} steps, {rate[1]:.2f} img/s over the resumed "
          f"run's {resumed['n_steps']} (epoch loops incl. loader and .train "
          f"saves; smoke rates, batch {cfg.irn_batch_size}, crop "
          f"{cfg.irn_crop_size}); dp_mean {dp_mean.tolist()}; launches {lt} "
          f"({card})", flush=True)

    # both make stages on the trained checkpoint
    sem = cli(argv("--make_sem_seg_pass", "--sem_seg_out_dir",
                   os.path.join(work, "sem_trained")))["make_sem_seg_labels"]
    ins_out = os.path.join(work, "ins_trained")
    ins = cli(argv("--make_ins_seg_pass", "--ins_seg_out_dir",
                   ins_out))["make_ins_seg_labels"]
    check(sem["n_images"] == ins["n_images"] == len(names)
          and all(os.path.exists(os.path.join(work, "sem_trained", n_ + ".png"))
                  and os.path.exists(os.path.join(ins_out, n_ + ".npy"))
                  for n_ in names),
          f"make stages on the trained checkpoint: {sem} {ins}")
    print(f"stage make_sem_seg / make_ins_seg on the trained checkpoint: "
          f"{sem['n_images'] / sem['seconds']:.3f} / "
          f"{ins['n_images'] / ins['seconds']:.3f} img/s, one pass each "
          f"({card})", flush=True)
    return dict(cfg=cfg, root=root, train_ids=train_ids, work=work,
                rate=rate, first=first, resumed=resumed)


def _train_loader(cfg, batch: int):
    """The stage's loader of the train list at ``batch``."""
    from irn_tpu_torch.data import loader as loader_mod
    from irn_tpu_torch.data import voc12

    ds = voc12.AffinityDataset(
        cfg.train_list, label_dir=cfg.ir_label_out_dir,
        crop_size=cfg.irn_crop_size, voc12_root=cfg.voc12_root,
        rescale=(0.5, 1.5), hor_flip=True, crop_method="random")
    return loader_mod.BatchLoader(ds, batch, shuffle=True, drop_last=True,
                                  num_workers=cfg.num_workers)


def _train_model(cfg, dev, max_step: int):
    """The stage's seeded initial model on ``dev``, its optimizer and the
    path table."""
    from irn_tpu_torch.models.irn import IRNet
    from irn_tpu_torch.pipeline import common
    from irn_tpu_torch.train import irn_train, optim

    with contextlib.redirect_stdout(io.StringIO()):
        model = common.init_model_variables(IRNet(), cfg).to(dev)
    opt = optim.poly_sgd(model.named_parameters(), cfg.irn_learning_rate,
                         max_step=max_step, power=0.9,
                         momentum=cfg.irn_weight_decay,
                         weight_decay=cfg.irn_weight_decay,
                         mult_fn=optim.irn_lr_mult)
    table = irn_train.build_train_geometry(cfg.irn_crop_size,
                                           cfg.path_radius)
    return model, opt, table


def _batch_to(batch, dev):
    img = torch.from_numpy(batch["img"]).to(dev).permute(0, 3, 1, 2)
    return (img.contiguous(),
            torch.from_numpy(batch["reduced_label"]).to(dev))


def train_host_check(dev, train: dict) -> None:
    """One train step at batch 4, crop 512, from the same initial weights
    and batch: the card with its kernels against the port on the host with
    the twins. The losses within 1e-3 relative, each head tensor's update
    within 1e-2 relative in norm (f32 on cuDNN against oneDNN; a K13a
    winner may flip where two edges nearly tie)."""
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.train import irn_train

    cfg = train["cfg"]
    dl = _train_loader(cfg, HOST_BATCH)
    batch = next(iter(dl))
    runs = []
    for d in (dev, torch.device("cpu")):
        model, opt, table = _train_model(cfg, d,
                                         len(dl) * cfg.irn_num_epoches)
        before = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
        n0 = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        metrics = irn_train.make_train_step(model, opt, table)(
            *_batch_to(batch, d))
        metrics = {k: float(v) for k, v in metrics.items()}
        runs.append((metrics, before, {
            k: v.detach().cpu() for k, v in model.state_dict().items()},
            time.perf_counter() - t0,
            {k: _build.LAUNCHES[k] - n0[k] for k in n0}))
        del model, opt
    (m_c, b_c, a_c, t_c, l_c), (m_h, b_h, a_h, t_h, l_h) = runs
    check(l_c["path_max_fwd"] == 1 and l_c["path_max_bwd"] == 1
          and l_c["irn_loss_fwd"] == 2 and l_c["irn_loss_bwd"] == 1
          and sum(l_c.values()) == 5 and not any(l_h.values()),
          f"host check launches: card {l_c}, host {l_h}")
    loss_err = max(abs(m_c[k] - m_h[k]) / max(abs(m_h[k]), 1e-30)
                   for k in m_h)
    upd_err = {}
    for k in _head_names(b_h):
        dh, dc = a_h[k] - b_h[k], a_c[k] - b_c[k]
        upd_err[k] = float((dc - dh).norm() / max(float(dh.norm()), 1e-30))
    worst = max(upd_err, key=upd_err.get)
    print(f"train step card vs host (batch {HOST_BATCH}, crop "
          f"{cfg.irn_crop_size}): losses card {m_c}, host {m_h}, worst "
          f"relative loss difference {loss_err:.3e}; head updates: worst "
          f"{worst} {upd_err[worst]:.3e}, median "
          f"{float(np.median(list(upd_err.values()))):.3e} (relative, in "
          f"norm); step {t_c * 1e3:.1f} ms card (first call), "
          f"{t_h * 1e3:.1f} ms host", flush=True)
    check(loss_err <= 1e-3, f"card vs host losses {m_c} {m_h}")
    check(upd_err[worst] <= 1e-2, f"card vs host head updates {upd_err}")
    check(all(torch.equal(a_c[k], b_c[k]) for k in b_c
              if k.startswith("resnet50.")), "the card step moved the backbone")


TRAIN_TIMED_STEPS = 5


def train_layers(dev, train: dict, card: str) -> None:
    """Step ms (median over the steps after the first, each ended by a
    synchronize) and img/s at batch 32; a per-step breakdown, each part
    run alone and ended by a synchronize; the device's busy share over one
    step under torch.profiler; the peak memory allocated."""
    from collections import defaultdict

    from irn_tpu_torch.ops import affinity
    from irn_tpu_torch.train import irn_train

    cfg = train["cfg"]
    dl = _train_loader(cfg, cfg.irn_batch_size)
    model, opt, table = _train_model(cfg, dev, len(dl) * cfg.irn_num_epoches)
    step_fn = irn_train.make_train_step(model, opt, table)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    while len(steps) < TRAIN_TIMED_STEPS:
        dl.set_epoch(len(steps))
        for batch in dl:
            x, red = _batch_to(batch, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(x, red)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            if len(steps) == TRAIN_TIMED_STEPS:
                break
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = float(np.median(steps[1:]))
    print(f"train step at batch {cfg.irn_batch_size}, crop "
          f"{cfg.irn_crop_size}, radius {cfg.path_radius}: "
          f"{step_ms:.2f} ms median over {len(steps) - 1} steps after the "
          f"first ({', '.join(f'{t:.2f}' for t in steps)}), "
          f"{cfg.irn_batch_size / step_ms * 1e3:.1f} img/s; peak memory "
          f"allocated {peak / 2**30:.2f} GiB ({card})", flush=True)

    ms = defaultdict(float)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3
        return out

    reps = 3
    it = iter(dl)
    for rep in range(reps + 1):
        if rep == 1:
            ms.clear()  # the first pass warms up
        batch = timed("loader wait (host)", lambda: next(it, None))
        if batch is None:
            dl.set_epoch(rep)
            it = iter(dl)
            batch = timed("loader wait (host)", lambda: next(it))
        x, red = timed("upload", lambda: _batch_to(batch, dev))
        feats = timed("backbone forward (no autograd)",
                      lambda: model.features(x))

        edge_logit, dp = timed("heads forward", lambda: model.heads(feats))

        def loss_fwd():
            maxed = affinity.path_max(
                torch.sigmoid(edge_logit[:, 0]).contiguous(), table)
            return affinity.irn_loss(maxed, dp, red, table)[0]

        loss = timed("loss forward (K13a + K16)", loss_fwd)
        edge = torch.sigmoid(edge_logit[:, 0]).detach().contiguous()
        maxed, winner = timed("K13a alone", lambda: affinity.path_max_fwd(
            edge, table))
        dp_d = dp.detach()
        _, stats = timed("K16 forward alone", lambda: affinity.irn_loss_fwd(
            maxed, dp_d, red, table))
        opt.zero_grad()
        timed("backward (incl. K16, K13b)", loss.backward)
        g5 = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0], device=dev)
        g, _ = timed("K16 backward alone", lambda: affinity.irn_loss_bwd(
            g5, stats, maxed, dp_d, red, table))
        timed("K13b alone", lambda: affinity.path_max_bwd(
            g, winner, table, tuple(edge.shape[1:])))
        timed("optimizer", opt.step)
        del maxed, winner, g, loss, edge_logit, dp, dp_d, feats, stats
    for name, v in ms.items():
        print(f"layer train {name}: {v / reps:.3f} ms/step ({card})",
              flush=True)

    x, red = _batch_to(batch, dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step_fn(x, red)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    )
    if device_us > 0:
        print(f"profiled train step: {wall_ms:.1f} ms, device busy "
              f"{device_us / 1e3:.1f} ms ({100 * device_us / 1e3 / wall_ms:.1f}"
              f"% of the step; profiler on) ({card})", flush=True)
    else:
        print("profiled train step: the profiler saw no device time; device "
              "busy share not measured", flush=True)


CAM_TRAIN_REPEAT = 4  # the train list: the tree's 8 images, 4 times each
CAM_FROZEN = ("resnet50.conv1.", "resnet50.bn1.", "resnet50.layer1.",
              "resnet50.layer2.")


def _cam_stats_names(sd) -> list:
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


def run_train_cam_stage(dev, stage: dict, card: str) -> dict:
    """train_cam through the port's CLI at its defaults (crop 512, batch 16,
    lr 0.1, cam_stop_grad c3, calibration on, no pretrained backbone) on
    the tree's 8 images 4 times (2 steps per epoch; the val list is the 8
    images, one tail batch): 2 epochs with ``--profile_dir``, then the same
    run at 3 epochs resumed from ``.train`` (2 more steps); then make_cam
    and eval_cam on the trained checkpoint. TF32 is switched on before the
    runs: the stage must switch it off."""
    from irn_tpu_torch.models.cam import CAMNet
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.pipeline import common
    from irn_tpu_torch.pipeline import run as port_run
    from irn_tpu_torch.train import cam_train
    from irn_tpu_torch.utils.checkpoint import load_checkpoint
    from irn_tpu_torch.utils.weights import cam_from_jax

    work, names = stage["work"], stage["names"]
    root = os.path.join(work, "voc")
    ids = os.path.join(root, "all.txt")
    train_ids = os.path.join(root, "train_cam32.txt")
    with open(train_ids, "w") as f:
        f.write("\n".join(names * CAM_TRAIN_REPEAT) + "\n")
    weights = os.path.join(work, "cam_trained.ckpt")
    prof_dir = os.path.join(work, "prof")
    cams = os.path.join(work, "cam_trained")

    def argv(*extra):
        return ["--voc12_root", root, "--train_list", train_ids,
                "--val_list", ids, "--infer_list", ids,
                "--cam_weights_name", weights, "--cam_out_dir", cams,
                "--session_dir", os.path.join(work, "sess"),
                "--log_name", os.path.join(work, "log_train_cam"),
                "--device", str(dev), *extra]

    tf32 = []
    make_step = cam_train.make_train_step

    def make_step_seen(*a, **kw):
        step = make_step(*a, **kw)

        def seen(*x):
            tf32.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return step(*x)
        return seen

    logs = []
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    cam_train.make_train_step = make_step_seen
    try:
        _build.reset_launches()
        first = cli(argv("--train_cam_pass", "--cam_num_epoches", "2",
                         "--profile_dir", prof_dir), logs)["train_cam"]
        after_first = load_checkpoint(weights + ".train")
        resumed = cli(argv("--train_cam_pass", "--cam_num_epoches", "3"),
                      logs)["train_cam"]
        stage["launches"]["train cam"] = dict(_build.LAUNCHES)
    finally:
        cam_train.make_train_step = make_step
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    for text in logs:
        for line in text.splitlines():
            if line.startswith(("WARNING", "calibrated", "Epoch", "step:",
                                "validate", "resumed", "saved")):
                print(f"  train_cam: {line}", flush=True)
    cfg, _ = port_run.parse(argv())
    check(len(tf32) == 6 and not any(a or b for a, b in tf32),
          f"TF32 inside train_cam's steps: {tf32}")
    check(any("calibrated frozen-BN statistics" in t for t in logs),
          "train_cam did not calibrate its batch norms")
    lt = stage["launches"]["train cam"]
    check(not any(lt.values()), f"train_cam launched hand kernels: {lt}")
    saved_train = load_checkpoint(weights + ".train")
    check((first["n_steps"], resumed["n_steps"], resumed["start_epoch"],
           int(after_first["step"]), int(saved_train["step"]),
           int(saved_train["epoch"])) == (4, 2, 2, 4, 6, 3),
          f"train_cam runs {first['n_steps']} + {resumed['n_steps']} steps "
          f"from epoch {resumed['start_epoch']}, .train steps "
          f"{int(after_first['step'])} then {int(saved_train['step'])}")
    losses = first["losses"] + resumed["losses"]
    val = first["val_losses"] + resumed["val_losses"]
    check(len(losses) == 6 and len(val) == 3
          and all(np.isfinite(losses + val)),
          f"train_cam losses {losses}, validate {val}")
    print("train_cam losses per step: "
          + ", ".join(f"{v:.4f}" for v in losses) + "; validate per epoch: "
          + ", ".join(f"{v:.4f}" for v in val), flush=True)
    traces = os.listdir(os.path.join(prof_dir, "train_cam"))
    check(len(traces) == 1 and traces[0].endswith(".pt.trace.json"),
          f"--profile_dir traces {traces}")
    trace_mb = os.path.getsize(
        os.path.join(prof_dir, "train_cam", traces[0])) / 2**20

    # frozen parameters bit-equal to the seeded init while the calibration
    # wrote every statistic; every trained tensor moved
    with contextlib.redirect_stdout(io.StringIO()):
        init = common.init_model_variables(CAMNet(), cfg).state_dict()
    final = cam_from_jax(load_checkpoint(weights))
    params = [k for k in init if k not in _cam_stats_names(init)]
    frozen = [k for k in params if k.startswith(CAM_FROZEN)]
    trained = [k for k in params if k not in frozen]
    check(len(frozen) == 72 and len(trained) == 88,
          f"{len(frozen)} frozen, {len(trained)} trained tensors")
    check(all(torch.equal(final[k], init[k]) for k in frozen),
          "train_cam moved a frozen parameter")
    still = [k for k in _cam_stats_names(init) + trained
             if torch.equal(final[k], init[k])]
    check(not still, f"tensors left at their initial values: {still}")
    rate = [r["n_steps"] * cfg.cam_batch_size / r["seconds"]
            for r in (first, resumed)]
    print(f"stage train_cam: {rate[0]:.2f} img/s over the first run's "
          f"{first['n_steps']} steps, {rate[1]:.2f} img/s over the resumed "
          f"run's {resumed['n_steps']} (epoch loops incl. loader, validation "
          f"and .train saves; smoke rates, batch {cfg.cam_batch_size}, crop "
          f"{cfg.cam_crop_size}; the first run profiles steps [2, 4): trace "
          f"{trace_mb:.1f} MiB); launches {lt} ({card})", flush=True)

    # make_cam and eval_cam on the trained checkpoint, then one image on
    # the host
    out = cli(argv("--make_cam_pass", "--eval_cam_pass"))
    mc = out["make_cam"]
    check(mc["n_images"] == len(names)
          and all(os.path.exists(os.path.join(cams, n_ + ".npy"))
                  for n_ in names), f"make_cam on the trained checkpoint {mc}")
    print(f"stage make_cam / eval_cam on the trained checkpoint: "
          f"{mc['n_images'] / mc['seconds']:.3f} img/s, mIoU "
          f"{out['eval_cam']['miou']:.4f} ({card})", flush=True)
    tc = dict(cfg=cfg, root=root, work=work, names=names, weights=weights,
              cams=cams, rate=rate, first=first, resumed=resumed)
    name, got, _ = make_cam_host_check(tc, "cam_trained_host")

    # make_cam's maps are the head's after a ReLU, zero where it is negative
    # everywhere: the trained head's maps before it, card against host, at
    # 1e-3 of their largest magnitude
    from irn_tpu_torch.data import transforms
    from irn_tpu_torch.data.image_io import imread
    from irn_tpu_torch.pipeline import stages_cam

    img = imread(os.path.join(root, "JPEGImages", name + ".jpg"))
    x = torch.from_numpy(transforms.normalize(img)).permute(2, 0, 1)[None]
    maps = []
    for d in (dev, torch.device("cpu")):
        net = stages_cam.load_cam_net(cfg, d)
        with torch.no_grad():
            maps.append(net.classifier(net.resnet50(x.to(d))["c5"]).cpu())
    err = float((maps[0] - maps[1]).abs().max() / maps[1].abs().max())
    present = maps[1][0, torch.from_numpy(got["keys"])]
    print(f"trained head's maps of {name} before the ReLU, card vs host: "
          f"{err:.3e} of the largest |value|; {100 * float((present > 0).float().mean()):.1f}% "
          f"positive in the present classes {got['keys'].tolist()}, "
          f"make_cam high_res max {float(got['high_res'].max(initial=0)):.4f}",
          flush=True)
    check(err <= 1e-3, f"trained head's maps card vs host {err}")
    return tc


def _cam_train_loader(cfg, batch: int):
    """The stage's train loader at ``batch``."""
    from irn_tpu_torch.data import loader as loader_mod
    from irn_tpu_torch.data import voc12
    from irn_tpu_torch.pipeline import stages_cam

    ds = voc12.ClassificationDataset(
        cfg.train_list, cfg.voc12_root, stages_cam._label_dict(cfg),
        resize_long=(320, 640), img_normal=True, hor_flip=True,
        crop_size=cfg.cam_crop_size, crop_method="random")
    return loader_mod.BatchLoader(ds, batch, shuffle=True, drop_last=True,
                                  num_workers=cfg.num_workers)


def _cam_batch_to(batch, dev, dtype=torch.float32):
    img = torch.from_numpy(batch["img"]).to(dev).permute(0, 3, 1, 2)
    return (img.contiguous().to(dtype),
            torch.from_numpy(batch["label"]).to(dev).to(dtype))


def _cam_train_model(cfg, state: dict, dev, max_step: int, dtype):
    """A CAMNet holding ``state`` on ``dev`` at ``dtype`` and the stage's
    optimizer."""
    from irn_tpu_torch.models.cam import CAMNet
    from irn_tpu_torch.train import optim

    model = CAMNet(stop_grad_at=cfg.cam_stop_grad or None)
    model.load_state_dict(state)
    model = model.to(device=dev, dtype=dtype)
    opt = optim.poly_sgd(model.named_parameters(), cfg.cam_learning_rate,
                         max_step=max_step, power=0.9,
                         momentum=cfg.cam_weight_decay,
                         weight_decay=cfg.cam_weight_decay,
                         mult_fn=optim.cam_lr_mult)
    return model, opt


def _calibrated_state(cfg, batch, dev) -> dict:
    """The stage's seeded initial CAMNet calibrated on ``batch`` on
    ``dev``, as a host state dict: one start for the steps that follow."""
    from irn_tpu_torch.models.cam import CAMNet
    from irn_tpu_torch.pipeline import common

    with contextlib.redirect_stdout(io.StringIO()):
        model = common.init_model_variables(CAMNet(), cfg).to(dev)
    model.calibrate_stats(_cam_batch_to(batch, dev)[0])
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def train_cam_host_check(dev, tc: dict) -> None:
    """One train step at batch 4, crop 512, from the same calibrated
    weights and batch: the card (f32, TF32 off) against the port on the
    host (f32), and both against the same step in f64 on the card. The
    loss within 1e-3 relative; the trained tensors' update in norm: the
    card's distance from the f64 step within 1.25x the host's (each f32
    step is as far from f64 as the two are from each other, CPU tests in
    tests/test_torch_cam_train_steps.py), and the card's from the host's
    within 2e-3 (measured: 7.3e-4, H100 80GB HBM3 at 700 W)."""
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.train import cam_train

    cfg = tc["cfg"]
    dl = _cam_train_loader(cfg, HOST_BATCH)
    batch = next(iter(dl))
    state = _calibrated_state(cfg, batch, dev)
    max_step = len(dl) * cfg.cam_num_epoches
    runs = {}
    for tag, d, dtype in (("card", dev, torch.float32),
                          ("host", torch.device("cpu"), torch.float32),
                          ("card f64", dev, torch.float64)):
        model, opt = _cam_train_model(cfg, state, d, max_step, dtype)
        n0 = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        loss = float(cam_train.make_train_step(model, opt)(
            *_cam_batch_to(batch, d, dtype)))
        seconds = time.perf_counter() - t0
        after = {k: v.detach().cpu().double() for k, v in
                 model.state_dict().items()}
        runs[tag] = (loss, after, seconds,
                     {k: _build.LAUNCHES[k] - n0[k] for k in n0})
        del model, opt
    trained = [k for k in state if k not in _cam_stats_names(state)
               and not k.startswith(CAM_FROZEN)]

    def dist(a: str, b: str) -> float:
        num = den = 0.0
        for k in trained:
            wa, wb = runs[a][1][k], runs[b][1][k]
            num += float(((wa - wb) ** 2).sum())
            den += float(((wb - state[k].double()) ** 2).sum())
        return (num / den) ** 0.5

    check(not any(v for r in runs.values() for v in r[3].values()),
          f"host check launches {[r[3] for r in runs.values()]}")
    loss_err = abs(runs["card"][0] - runs["host"][0]) / abs(runs["host"][0])
    d_ch, d_c64, d_h64 = (dist("card", "host"), dist("card", "card f64"),
                          dist("host", "card f64"))
    print(f"train_cam step card vs host (batch {HOST_BATCH}, crop "
          f"{cfg.cam_crop_size}, from one calibrated state): loss card "
          f"{runs['card'][0]:.6f}, host {runs['host'][0]:.6f}, card f64 "
          f"{runs['card f64'][0]:.6f}, relative difference {loss_err:.3e}; "
          f"trained tensors' update in norm: card vs host {d_ch:.3e}, card "
          f"vs f64 {d_c64:.3e}, host vs f64 {d_h64:.3e}; step "
          f"{runs['card'][2] * 1e3:.1f} ms card (first call), "
          f"{runs['host'][2] * 1e3:.1f} ms host", flush=True)
    check(loss_err <= 1e-3, f"card vs host loss {loss_err}")
    check(d_c64 <= 1.25 * d_h64, f"card step {d_c64} from f64, host {d_h64}")
    check(d_ch <= 2e-3, f"card vs host update {d_ch}")
    check(all(torch.equal(runs["card"][1][k], state[k].double())
              for k in state if k.startswith(CAM_FROZEN)),
          "the card step moved a frozen parameter")


def train_cam_layers(dev, tc: dict, card: str) -> None:
    """5 synchronized steps at batch 16 (median after the first) and
    img/s; a per-step breakdown, each part run alone and ended by a
    synchronize: loader wait, upload, stem..c3 forward without autograd,
    c4..head forward + loss, backward, optimizer; the device's busy share
    over one profiled step; the peak memory allocated."""
    from collections import defaultdict

    import torch.nn.functional as F

    from irn_tpu_torch.models.cam import multilabel_soft_margin_loss
    from irn_tpu_torch.train import cam_train

    cfg = tc["cfg"]
    dl = _cam_train_loader(cfg, cfg.cam_batch_size)
    max_step = len(dl) * cfg.cam_num_epoches
    state = _calibrated_state(cfg, next(iter(dl)), dev)
    model, opt = _cam_train_model(cfg, state, dev, max_step, torch.float32)
    step_fn = cam_train.make_train_step(model, opt)
    r = model.resnet50

    def front(x):
        with torch.no_grad():
            x = F.max_pool2d(F.relu(r.bn1(r.conv1(x))), 3, stride=2,
                             padding=1)
            return r.layer2(r.layer1(x))

    def back(c3, labels):
        c5 = r.layer4(r.layer3(c3))
        logits = model.classifier(c5.mean(dim=(2, 3), keepdim=True))
        return multilabel_soft_margin_loss(logits.flatten(1), labels)

    # the split forward of the breakdown is the model's forward
    x, y = _cam_batch_to(next(iter(dl)), dev)
    with torch.no_grad():
        split = float(back(front(x), y))
        whole = float(multilabel_soft_margin_loss(model(x, train=False), y))
    check(abs(split - whole) <= 1e-6 * abs(whole),
          f"the timed split forward's loss {split}, the model's {whole}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    while len(steps) < TRAIN_TIMED_STEPS:
        dl.set_epoch(len(steps))
        for batch in dl:
            x, y = _cam_batch_to(batch, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(x, y)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            if len(steps) == TRAIN_TIMED_STEPS:
                break
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = float(np.median(steps[1:]))
    print(f"train_cam step at batch {cfg.cam_batch_size}, crop "
          f"{cfg.cam_crop_size}: {step_ms:.2f} ms median over "
          f"{len(steps) - 1} steps after the first "
          f"({', '.join(f'{t:.2f}' for t in steps)}), "
          f"{cfg.cam_batch_size / step_ms * 1e3:.1f} img/s; peak memory "
          f"allocated {peak / 2**30:.2f} GiB ({card})", flush=True)


    ms = defaultdict(float)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3
        return out

    reps = 3
    it = iter(dl)
    for rep in range(reps + 1):
        if rep == 1:
            ms.clear()  # the first pass warms up
        batch = timed("loader wait (host)", lambda: next(it, None))
        if batch is None:
            dl.set_epoch(rep)
            it = iter(dl)
            batch = timed("loader wait (host)", lambda: next(it))
        x, y = timed("upload", lambda: _cam_batch_to(batch, dev))
        c3 = timed("stem..c3 forward (no autograd)", lambda: front(x))
        loss = timed("c4..head forward + loss", lambda: back(c3, y))
        opt.zero_grad()
        timed("backward", loss.backward)
        timed("optimizer", opt.step)
        del loss, c3
    for name, v in ms.items():
        print(f"layer train_cam {name}: {v / reps:.3f} ms/step ({card})",
              flush=True)

    x, y = _cam_batch_to(batch, dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step_fn(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    )
    if device_us > 0:
        print(f"profiled train_cam step: {wall_ms:.1f} ms, device busy "
              f"{device_us / 1e3:.1f} ms ({100 * device_us / 1e3 / wall_ms:.1f}"
              f"% of the step; profiler on) ({card})", flush=True)
    else:
        print("profiled train_cam step: the profiler saw no device time; "
              "device busy share not measured", flush=True)


N_INS_FLOWS = 4  # images of each flow run of the instance stage
INS_FLOWS = {
    "host_cluster": ("--no-ins_device_ccl",),
    "host_split": ("--ins_comp_cap", "0"),
    "host": ("--no-ins_device_ccl", "--ins_comp_cap", "0"),
    "overflow_redo": ("--ins_cluster_cap", "1"),
    "chunked": ("--ins_seed_cap", "8"),
}


def _read_ins(out: str, names) -> dict:
    return {n_: np.load(os.path.join(out, n_ + ".npy"),
                        allow_pickle=True).item() for n_ in names}


def _ins_dicts_equal(a: dict, b: dict) -> bool:
    return (sorted(a) == sorted(b) and a["size"] == b["size"]
            and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                    for k in ("score", "mask", "class")))


def _scaled_head_checkpoint(src: str, dst: str, scale: float) -> str:
    """``src`` with the displacement head's last conv scaled: the random
    field then has several basins per image instead of one."""
    from irn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    variables = load_checkpoint(src)
    head = variables["params"]["fc_dp7b"]
    head["kernel"] = np.asarray(head["kernel"]) * np.float32(scale)
    save_checkpoint(dst, variables)
    return dst


def run_ins_stages(dev, stage: dict, card: str) -> dict:
    """make_ins_seg, eval_ins_seg and make_cocoann through the port's CLI
    on the make_sem_seg phase's tree, GT cams and checkpoint: two passes at
    the defaults (rle COCO: the card host has no cv2), then each flow on
    the first N_INS_FLOWS images with the displacement head x2 (|dp| about
    2.5 cells on average: some images hold two basins, where the seeded
    head alone gives one and a ten-fold head none), every dict equal to
    that default run's."""
    from irn_tpu_torch.ops import _build

    work, names = stage["work"], stage["names"]
    root = os.path.join(work, "voc")
    ids = os.path.join(root, "all.txt")
    four = os.path.join(root, "ins_four.txt")
    with open(four, "w") as f:
        f.write("\n".join(names[:N_INS_FLOWS]) + "\n")
    weights = stage["cfg"].irn_weights_name
    weights2 = _scaled_head_checkpoint(
        weights, os.path.join(work, "irn_x2.ckpt"), 2.0)

    def argv(out, *extra, ids=ids, weights=weights):
        return ["--voc12_root", root, "--infer_list", ids,
                "--train_list", ids, "--cam_out_dir",
                os.path.join(work, "cam"), "--irn_weights_name", weights,
                "--session_dir", os.path.join(work, "sess"),
                "--log_name", os.path.join(work, "log_ins"),
                "--ins_seg_out_dir", out,
                "--coco_ann_path", os.path.join(out, "coco.json"),
                "--coco_seg_format", "rle", "--device", str(dev), *extra]

    launches = stage["launches"]
    out = os.path.join(work, "ins_default")
    torch.backends.cudnn.allow_tf32 = True  # the stage must switch it off
    torch.backends.cuda.matmul.allow_tf32 = True
    _build.reset_launches()
    first = cli(argv(out, "--make_ins_seg_pass", "--eval_ins_seg_pass",
                     "--make_cocoann_pass"))
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          "make_ins_seg left TF32 on")
    # a second pass over the same images (warm caches): a smoke rate
    again = cli(argv(out, "--make_ins_seg_pass", "--overwrite"))
    launches["ins default"] = dict(_build.LAUNCHES)
    n = len(names)
    summ, summ1 = again["make_ins_seg_labels"], first["make_ins_seg_labels"]
    ld = launches["ins default"]
    # per image: one K11; K12a on the basin and on the label map, K12b's
    # cluster masks and tables, three launches each; per walk (an image's,
    # and a redo's) one K10, then one K0 and two K15 (upsample, argmax), or
    # past ins_seed_cap one K0 and one K15 upsample per chunk
    check(ld["advect"] == 2 * n and ld["ccl_label"] == 2 * 6 * n
          and ld["ccl_tables"] == 2 * 6 * n, f"ins default launches {ld}")
    walks = 2 * n + summ1["redo"] + summ["redo"]
    chunked = summ1["chunked"] + summ["chunked"]
    check(ld["diag_operator"] == walks
          and (ld["diag_chain"] == walks and ld["decode"] == 2 * walks
               if not chunked else
               ld["diag_chain"] > walks and ld["decode"] >= walks),
          f"ins default walk launches {ld} for {walks} walks, {chunked} "
          f"chunked")
    dicts = _read_ins(out, names)
    for n_ in names:
        d = dicts[n_]
        h, w = _image_size(root, n_)
        k = len(d["score"])
        check(sorted(d) == ["class", "mask", "score", "size"]
              and d["size"] == (h, w) and d["mask"].shape == (k, h, w)
              and d["mask"].dtype == bool and d["score"].dtype == np.float32
              and d["class"].dtype == np.int32 and d["class"].shape == (k,)
              and bool(np.isfinite(d["score"]).all())
              and bool((d["mask"].sum((1, 2)) > 0).all()),
              f"ins_seg {n_}: {[(key, getattr(v, 'shape', v)) for key, v in d.items()]}")
    coco = first["make_cocoann"]
    n_kept = sum(int((d["score"] >= 1e-5).sum()) for d in dicts.values())
    check(len(coco["images"]) == n and len(coco["annotations"]) == n_kept
          and os.path.exists(os.path.join(out, "coco.json")),
          f"coco: {len(coco['images'])} images, {len(coco['annotations'])} "
          f"annotations, {n_kept} kept instances")
    ap = first["eval_ins_seg"]
    print(f"stage make_ins_seg: {n / summ['seconds']:.3f} img/s second pass "
          f"({n / summ1['seconds']:.3f} img/s first pass; smoke rates over "
          f"{n} images 360-500 px), walk modes {summ['modes']}, "
          f"{sum(len(d['score']) for d in dicts.values())} instances, flows "
          f"{ {k: v for k, v in summ.items() if k not in ('seconds', 'modes')} } "
          f"({card})", flush=True)
    print(f"stage eval_ins_seg: mAP {ap['map']:.4f} (random weights); "
          f"make_cocoann: {len(coco['annotations'])} rle annotations",
          flush=True)

    # every flow writes the default flow's dicts (head x2: more basins)
    ref = os.path.join(work, "ins_x2")
    _build.reset_launches()
    ref_summ = cli(argv(ref, "--make_ins_seg_pass", ids=four,
                        weights=weights2))["make_ins_seg_labels"]
    launches["ins x2"] = dict(_build.LAUNCHES)
    want = _read_ins(ref, names[:N_INS_FLOWS])
    flows = {}
    for tag, extra in INS_FLOWS.items():
        fout = os.path.join(work, f"ins_{tag}")
        _build.reset_launches()
        flows[tag] = cli(argv(fout, "--make_ins_seg_pass", *extra, ids=four,
                              weights=weights2))["make_ins_seg_labels"]
        launches[f"ins {tag}"] = dict(_build.LAUNCHES)
        got = _read_ins(fout, names[:N_INS_FLOWS])
        for n_ in names[:N_INS_FLOWS]:
            check(_ins_dicts_equal(got[n_], want[n_]),
                  f"ins flow {tag}: {n_} differs from the default flow")
    lh = launches["ins host"]
    check(lh["advect"] == N_INS_FLOWS and lh["ccl_label"] == 0
          and lh["ccl_tables"] == 0, f"ins host launches {lh}")
    check(flows["chunked"]["chunked"] >= 1,
          f"no chunked walk at --ins_seed_cap 8: {flows['chunked']}")
    print(f"stage make_ins_seg flows on {N_INS_FLOWS} images, head x2 "
          f"({sum(len(d['score']) for d in want.values())} instances; default "
          f"{ {k: v for k, v in ref_summ.items() if k not in ('seconds', 'modes')} }"
          f"): every flow's dicts equal the default's; "
          + "; ".join(
              f"{tag} {N_INS_FLOWS / f_['seconds']:.3f} img/s, redo "
              f"{f_['redo']}, chunked {f_['chunked']}"
              for tag, f_ in flows.items()), flush=True)
    return dict(out=out, root=root, ids=ids, work=work, names=names,
                weights=weights)


def ins_host_check(dev, ins: dict) -> None:
    """The card's default dicts of two images against the port on the CPU
    with the same weights: the same instances and classes, masks >= 99.9%
    equal, scores within 2e-3."""
    from irn_tpu_torch.pipeline import stages_irn
    from irn_tpu_torch.pipeline.config import Config

    names = ins["names"][:2]
    two = os.path.join(ins["root"], "ins_two.txt")
    with open(two, "w") as f:
        f.write("\n".join(names) + "\n")
    host = os.path.join(ins["work"], "ins_host_cpu")
    cfg = Config(voc12_root=ins["root"], train_list=two, infer_list=two,
                 cam_out_dir=os.path.join(ins["work"], "cam"),
                 irn_weights_name=ins["weights"],
                 ins_seg_out_dir=host).resolve()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stages_irn.make_ins_seg_labels(cfg, "cpu")
    seconds = time.perf_counter() - t0
    card_ = _read_ins(ins["out"], names)
    cpu = _read_ins(host, names)
    agree = []
    for n_ in names:
        a, b = card_[n_], cpu[n_]
        check(a["mask"].shape == b["mask"].shape
              and np.array_equal(a["class"], b["class"]),
              f"{n_}: card {a['mask'].shape} {a['class']} host "
              f"{b['mask'].shape} {b['class']}")
        agree += [float(np.mean(x == y)) for x, y in zip(a["mask"], b["mask"])]
        err = float(np.abs(a["score"] - b["score"]).max(initial=0))
        check(err <= 2e-3, f"{n_}: scores card vs host {err}")
    print(f"make_ins_seg of {len(names)} images on the host ({seconds:.2f} s) "
          f"vs the card: same instances and classes, mask agreement min "
          f"{min(agree, default=1.0):.6f}", flush=True)
    check(min(agree, default=1.0) >= 0.999, f"ins masks card vs host {agree}")


def ins_layers(dev, ins: dict, card: str) -> None:
    """Where an image's time goes in make_ins_seg: each step run alone over
    the tree's images and ended by a synchronize (host clock; the first
    pass warms up), then one default pass under torch.profiler for the
    device's busy share."""
    from collections import defaultdict

    from irn_tpu_torch.data import voc12
    from irn_tpu_torch.ops import ccl
    from irn_tpu_torch.ops import centroids
    from irn_tpu_torch.ops import random_walk as rw
    from irn_tpu_torch.pipeline import stages_irn
    from irn_tpu_torch.pipeline.config import Config

    cfg = Config(voc12_root=ins["root"], train_list=ins["ids"],
                 infer_list=ins["ids"],
                 cam_out_dir=os.path.join(ins["work"], "cam"),
                 irn_weights_name=ins["weights"],
                 ins_seg_out_dir=os.path.join(ins["work"], "ins_prof")
                 ).resolve()
    runner = stages_irn._load_irn(cfg, dev)
    walker = stages_irn.RandomWalkRunner(cfg, cfg.ins_seed_cap, dev)
    ds = voc12.ImageDataset(cfg.infer_list, cfg.voc12_root,
                             img_normal=False)
    ms = defaultdict(float)
    n = len(ds)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3 / n
        return out

    npy = os.path.join(ins["work"], "layer_ins.npy")
    for rep in range(2):
        ms.clear()
        for i in range(n):
            sample = timed("read image + cams (host)", lambda: ds[i])
            img = sample["img"]
            size = img.shape[:2]
            (edge, dp, (h4, w4)), = timed(
                "forward", lambda: runner.batch([img], [size]))
            cams, keys = timed("read image + cams (host)",
                               lambda: stages_irn._load_ins_cam(
                                   cfg, sample["name"]))
            cent, basin = timed("K11 advection + basin",
                                lambda: centroids.advect(dp, h4, w4))
            masks, n_found = timed(
                "K12 clusters (K12a basin labels, K12b masks)",
                lambda: ccl.cluster_from_basin(basin, cent, h4, w4,
                                               cfg.ins_cluster_cap))
            ch, cw = walker._bucket(h4), walker._bucket(w4)
            c_pad = stages_irn.pow2_ge(len(cams))

            def seeds_():
                camp = np.zeros((c_pad, ch, cw), np.float32)
                camp[: len(cams), :h4, :w4] = cams
                return stages_irn.seed_build(torch.from_numpy(camp).to(dev),
                                             masks)

            seeds = timed("seed upload + build", seeds_)
            pad = walker._row_bucket(len(seeds)) - len(seeds)
            cam_t = torch.nn.functional.pad(seeds, (0, 0, 0, 0, 0, pad))
            out = timed("walk (operator build + K0 chain)",
                        lambda: walker._propagate(cam_t, edge, ch, cw))
            labels, _, _, best = timed(
                "decode (x4 upsample, argmax)",
                lambda: rw.decode(out, h4, w4, size[0], size[1],
                                  cfg.ins_seg_bg_thres, best=True))
            tables = timed("K12 component split (K12a, K12b tables)",
                           lambda: ccl.component_tables(
                               labels.to(torch.int32), best,
                               cfg.ins_comp_cap))

            def save():
                cmap, rows, sizes, scores, n_comp = (
                    t.cpu().numpy() for t in tables)
                n_comp = int(n_comp)
                keys_pad = np.zeros(c_pad, keys.dtype)
                keys_pad[: len(keys)] = keys
                stages_irn.save_detected(
                    npy, size, cmap, rows[:n_comp], sizes[:n_comp],
                    np.concatenate([np.zeros(1, np.float32),
                                    scores[:n_comp]]),
                    np.repeat(keys_pad, cfg.ins_cluster_cap))

            timed("fetch + npy write (host)", save)
    for name, v in ms.items():
        print(f"layer ins {name}: {v:.3f} ms/img ({card})", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with contextlib.redirect_stdout(io.StringIO()):
            summ = stages_irn.make_ins_seg_labels(cfg, dev)
    device_us = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    )
    wall_ms = summ["seconds"] * 1e3
    if device_us > 0:
        print(f"profiled make_ins_seg pass: {summ['n_images']} images in "
              f"{wall_ms:.1f} ms, device busy {device_us / 1e3:.1f} ms "
              f"({100 * device_us / 1e3 / wall_ms:.1f}% of the loop; "
              f"profiler on) ({card})", flush=True)
    else:
        print("profiled make_ins_seg pass: the profiler saw no device time; "
              "device busy share not measured", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "irn_tpu_torch")):
        print(f"chip_smoke: irn_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    t_start = time.perf_counter()

    phase("environment")
    others = nvidia_smi("--query-compute-apps=pid,process_name",
                        "--format=csv,noheader")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    card = nvidia_smi("--query-gpu=name,power.limit", "--format=csv,noheader")
    card = card.splitlines()[0]
    shared = bool(others)
    print(f"card: {card}; other processes on the card: "
          f"{others or 'none'}", flush=True)
    if shared:
        print("WARNING: the card is shared; the timings below are not clean "
              "(the kernels line carries \"shared\": true)", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("build")
    from irn_tpu_torch.ops import _build

    hgmma, sass = build_report(here)

    phase("kernels vs plain twins")
    kernels = check_kernels(dev, card, sass)

    phase("stage: make_sem_seg")
    work = tempfile.mkdtemp(prefix="irn_smoke_")
    try:
        stage = run_stage(dev, work)
        phase("library: propagate_banded(bj=1024)")
        library_bj_check(dev, stage)
        phase("library: propagate_banded_batch (K8)")
        library_batch_check(dev, stage)
        phase("probe: conv3x3 (K9)")
        probe_conv(dev, stage)
        phase("probe: bench_banded batched sweep")
        probe_banded(dev, stage)
        phase("stage: pure route through the plain twins on the card")
        pure_twin_check(dev, stage)
        phase("stage: CPU plain-twin walk vs the card")
        cpu_walk_check(dev, stage)
        phase("layers")
        layer_breakdown(dev, stage, card)
        dense_layers(dev, stage, card)
        phase("stage: make_cam -> cam_to_ir_label")
        cam = run_cam_stages(dev, stage, card)
        cam_host_checks(dev, cam)
        cam_layers(dev, cam, card)
        phase("stage: train_irn")
        train = run_train_stage(dev, stage, card)
        train_host_check(dev, train)
        train_layers(dev, train, card)
        phase("stage: train_cam")
        tc = run_train_cam_stage(dev, stage, card)
        train_cam_host_check(dev, tc)
        train_cam_layers(dev, tc, card)
        phase("stage: make_ins_seg -> eval_ins_seg -> make_cocoann")
        ins = run_ins_stages(dev, stage, card)
        ins_host_check(dev, ins)
        ins_layers(dev, ins, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    launches = stage["launches"]
    for run, counts in launches.items():
        print(f"launches in the {run} run: {counts}", flush=True)
    for k, run in HOME_RUN.items():
        check(launches[run][k] > 0,
              f"kernel {k} never launched on its path ({run})")

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "irn_tpu"))
    check(not loaded, f"JAX or the JAX package was imported: {loaded}")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
             launches=launches[HOME_RUN[k]][k],
             max_abs_err=kernels[k]["max_abs_err"], ms=kernels[k]["ms"],
             plain_ms=kernels[k]["plain_ms"], bound_ms=kernels[k]["bound_ms"],
             bound_by=kernels[k]["bound_by"],
             library_ms=kernels[k]["library_ms"], hgmma=hgmma[k],
             **{key: kernels[k][key]
                for key in ("bound_f32_ms", "bound_dense_ms",
                            "ms_per_application", "c128_ms", "device_ms",
                            "occupied_share",
                            "entry_share", "held_share",
                            "held_share_per_image", "phase_shares", "k3_ms",
                            "k13_ms", "exps", "exp_sfu_ms", "store_ms",
                            "sums_only_ms", "sass_per_entry",
                            "sass_per_element", "sass_loops", "quantize_ms",
                            "combine_ms", "product_ms", "iteration_ms",
                            "ten_iterations_ms", "dense_ms",
                            "dense_product_ms", "dense_iteration_ms",
                            "dense_ten_iterations_ms", "eager_ms")
                if key in kernels[k]})
        for k in _build.KERNELS
    ], "shared": shared}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
