"""Profile one train_irn step on one card, part by part:

  python irn_tpu_torch/tools/probe_train_step.py [--root DIR]
      [--batch 32] [--crop 512] [--radius 10] [--reps 3]
      [--model_dtype float32 [bfloat16]] [--out FILE]

Input: a seeded random IRNet (``init_irnet``, seed 0), images of normals
and reduced labels of a few class ellipses on background with 255 bands
along their borders and 255 blocks, made from seed 0 with numpy (a
synthetic stand-in for cam_to_ir_label's output; the step's work does not
depend on the images' content). TF32 off, no bf16-reduced cuBLAS
reduction. ``--model_dtype`` takes one or both backbone dtypes; each is
profiled in turn, from the same seeded weights, in the same process.

Parts, each run alone under torch.profiler after a warm-up, ``--reps``
times: the card's own time per call (the device rows' sum) and its device
launches per call (kernels, copies and memsets):

- ``backbone forward``: ``model.features`` (no autograd);
- ``heads forward``: ``model.heads`` (1x1 convolutions, GroupNorm,
  upsampling, concatenation) and the edge sigmoid;
- ``loss forward``: the eager loss side (labels, maps, masked sums, from
  the path max's output) or, with the kernels, ``irn_loss``'s forward;
- ``K13a``: the path max;
- ``loss backward``: autograd from the total to the path max's output and
  the displacements (K13b not included);
- ``K13b``: the path max's backward;
- ``heads backward``: autograd from the edge map and the displacements to
  the heads' parameters (the sigmoid included);
- ``optimizer``: ``PolySGD.step``.

The backbone forward's device rows are also summed by kind (convolution,
layout transform, elementwise, other; by kernel name).

Then the whole step, ``irn_train.make_train_step`` of the tree: its time
(host clock around a synchronized step, median over ``--reps`` steps
after one), its device time and launches under the profiler, and the peak
memory allocated over one step.

The loss is the tree's ``affinity.irn_loss`` where it has one (K16),
else the eager composition, so the parts and the whole step run the same
loss. ``--root`` imports ``irn_tpu_torch`` from another checkout (a parent's
``git archive``), so one script profiles both trees; run the file by its
path for that (a tree before bf16 runs float32 only). Prints the card's
name and power limit (nvidia-smi) and one JSON line, each dtype's results
under ``runs``; ``--out`` writes the JSON there too. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def reduced_labels(batch: int, grid: int, seed: int = 0):
    """[batch, grid, grid] int32: 1-4 ellipses of classes 1-20 on
    background 0, a 255 band of 2 cells along every class border, and 0-3
    255 blocks of 4-16 cells a side."""
    import numpy as np

    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[:grid, :grid]
    out = np.zeros((batch, grid, grid), np.int32)
    for b in range(batch):
        lab = np.zeros((grid, grid), np.int32)
        for _ in range(g.integers(1, 5)):
            cy, cx = g.uniform(0, grid, 2)
            ry, rx = g.uniform(grid / 12, grid / 3, 2)
            lab[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = \
                g.integers(1, 21)
        edge = np.zeros((grid, grid), bool)
        for ax in (0, 1):
            d = np.diff(lab, axis=ax) != 0
            pad = [(0, 0), (0, 0)]
            pad[ax] = (1, 0)
            edge |= np.pad(d, pad)
            pad[ax] = (0, 1)
            edge |= np.pad(d, pad)
        band = edge.copy()
        for ax in (0, 1):
            band |= np.roll(edge, 1, ax) | np.roll(edge, -1, ax)
        lab[band] = 255
        for _ in range(g.integers(0, 4)):
            y0, x0 = g.integers(0, grid, 2)
            h, w = g.integers(4, 17, 2)
            lab[y0:y0 + h, x0:x0 + w] = 255
        out[b] = lab
    return out


def profile(fn, reps: int, top: dict = None):
    """(device ms, device launches) per call of fn: torch.profiler's device
    rows after a warm-up call (ctypes launches appear there by name, under
    no torch op). ``top``, when given, receives the device rows by kind
    (:func:`kind`): ms and launches per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us += e.self_device_time_total
            n += e.count
            if top is not None:
                row = top.setdefault(kind(e.key), [0.0, 0.0])
                row[0] += e.self_device_time_total / 1e3 / reps
                row[1] += e.count / reps
    return us / 1e3 / reps, n / reps


def kind(name: str) -> str:
    """A device row's kind, from its kernel name: convolution, layout
    transform, elementwise or other."""
    low = name.lower()
    if any(k in low for k in ("fprop", "dgrad", "wgrad", "conv", "gemm")):
        return "convolution"
    if any(k in low for k in ("nchwtonhwc", "nhwctonchw", "transpose")):
        return "layout transform"
    if "elementwise" in low or "vectorized" in low or "unrolled" in low:
        return "elementwise"
    return "other"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="checkout whose irn_tpu_torch is profiled")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--crop", type=int, default=512)
    ap.add_argument("--radius", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--model_dtype", nargs="+", default=["float32"],
                    choices=["float32", "bfloat16"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_train_step needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    res = dict(card=card, root=os.path.abspath(args.root), runs={})
    for name in args.model_dtype:
        res["runs"][name] = probe(args, name, card)
        torch.cuda.empty_cache()
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


def probe(args, dtype_name: str, card: str) -> dict:
    """One train_irn step by part with the backbone in ``dtype_name``."""
    import numpy as np
    import torch

    from irn_tpu_torch.models.irn import IRNet, init_irnet
    from irn_tpu_torch.ops import affinity
    from irn_tpu_torch.train import irn_train, optim

    kernel = hasattr(affinity, "irn_loss")
    dev = torch.device("cuda")
    net = (IRNet() if dtype_name == "float32"
           else IRNet(dtype=getattr(torch, dtype_name)))
    model = init_irnet(net, torch.Generator().manual_seed(0)).to(dev)
    opt = optim.poly_sgd(model.named_parameters(), 0.1, max_step=1000,
                         power=0.9, momentum=1e-4, weight_decay=1e-4,
                         mult_fn=optim.irn_lr_mult)
    table = irn_train.build_train_geometry(args.crop, args.radius)
    grid = args.crop // 4
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal(
        (args.batch, 3, args.crop, args.crop)).astype(np.float32)).to(dev)
    red = torch.from_numpy(reduced_labels(args.batch, grid)).to(dev)
    ignore = float((red == 255).float().mean())

    feats = model.features(x)
    edge_logit, dp = model.heads(feats)
    edge = torch.sigmoid(edge_logit[:, 0]).contiguous()
    maxed, winner = affinity.path_max_fwd(edge.detach(), table)
    m_leaf = maxed.detach().requires_grad_(True)
    dp_leaf = dp.detach().requires_grad_(True)

    def loss_fwd():
        if kernel:
            return affinity.irn_loss(m_leaf, dp_leaf, red, table)[0]
        # the eager maps of affinity_displacement_loss_maps after its path
        # max, written out so that trees before K16 run them too
        with torch.no_grad():
            masks = affinity.affinity_labels_2d(red, table.path_set)
        b, n, ch, cw = m_leaf.shape
        aff = (1.0 - m_leaf).reshape(b, n, ch * cw)
        pair = affinity.pair_displacement(dp_leaf, table.path_set)
        target = torch.from_numpy(
            table.path_set.dst_offsets.T.astype(np.float32)
        ).to(dev)[None, :, :, None]
        maps = affinity.AffinityLossMaps(
            -torch.log(aff + 1e-5), -torch.log(1.0 + 1e-5 - aff),
            torch.abs(pair - target), torch.abs(pair))
        return affinity.irn_total_loss(maps, *masks)[0]

    total = loss_fwd()
    d_maxed, d_dp = torch.autograd.grad(total, (m_leaf, dp_leaf))
    d_edge = affinity.path_max_bwd(d_maxed.contiguous(), winner, table,
                                   tuple(edge.shape[1:]))

    def heads_fwd():
        el, d = model.heads(feats)
        return torch.sigmoid(el[:, 0]).contiguous(), d

    def heads_bwd():
        e, d = heads_fwd_out
        torch.autograd.backward([e, d], [d_edge, d_dp], retain_graph=True)

    heads_fwd_out = heads_fwd()
    parts = {}
    backbone_rows = {}
    profile(lambda: model.features(x), args.reps, backbone_rows)
    for name, fn in (
            ("backbone forward", lambda: model.features(x)),
            ("heads forward", heads_fwd),
            ("loss forward", loss_fwd),
            ("K13a", lambda: affinity.path_max_fwd(edge.detach(), table)),
            ("loss backward", lambda: torch.autograd.grad(
                loss_fwd(), (m_leaf, dp_leaf))),
            ("K13b", lambda: affinity.path_max_bwd(
                d_maxed.contiguous(), winner, table, tuple(edge.shape[1:]))),
            ("heads backward", heads_bwd),
            ("optimizer", opt.step)):
        parts[name] = profile(fn, args.reps)
    # the backward's own share: its profile ran the forward too
    lb = parts["loss backward"]
    lf = parts["loss forward"]
    parts["loss backward"] = (lb[0] - lf[0], lb[1] - lf[1])
    del heads_fwd_out, total, d_maxed, d_dp, d_edge, maxed, winner
    del m_leaf, dp_leaf, feats, edge_logit, dp, edge
    opt.zero_grad()
    torch.cuda.empty_cache()

    step = irn_train.make_train_step(model, opt, table)
    step(x, red)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    wall = []
    for _ in range(args.reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, red)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    step_dev = profile(lambda: step(x, red), args.reps)
    res = dict(
        model_dtype=dtype_name,
        backbone_rows={k: dict(device_ms=v[0], launches=v[1])
                       for k, v in backbone_rows.items()},
        loss="kernel" if kernel else "eager", batch=args.batch,
        crop=args.crop, radius=args.radius, ignore_share=ignore,
        parts={k: dict(device_ms=v[0], launches=v[1])
               for k, v in parts.items()},
        step_ms=float(np.median(wall[1:])), step_ms_all=wall,
        step_device_ms=step_dev[0], step_launches=step_dev[1],
        peak_gib=peak / 2 ** 30, before_step_gib=base / 2 ** 30)
    for k, v in parts.items():
        print(f"{dtype_name} {k}: {v[0]:.3f} ms device, {v[1]:.0f} "
              f"launches ({card})", flush=True)
    for k, v in sorted(backbone_rows.items()):
        print(f"{dtype_name} backbone forward, {k} rows: {v[0]:.3f} ms "
              f"device, {v[1]:.0f} launches ({card})", flush=True)
    print(f"{dtype_name} step: {res['step_ms']:.2f} ms (host clock, "
          f"median), device "
          f"{step_dev[0]:.2f} ms in {step_dev[1]:.0f} launches; peak "
          f"{res['peak_gib']:.2f} GiB ({res['before_step_gib']:.2f} before "
          f"the step); loss {res['loss']} ({card})", flush=True)
    return res


if __name__ == "__main__":
    main()
