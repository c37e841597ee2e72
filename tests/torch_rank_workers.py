"""Functions that the multi-rank tests run on each spawned rank
(``irn_tpu_torch.parallel.mesh.run_ranks`` pickles them by reference, so
they live in a module a fresh process can import: this one imports the
port and torch only)."""

import numpy as np
import torch
import torch.distributed as dist

from irn_tpu_torch.ops import affinity
from irn_tpu_torch.ops import paths
from irn_tpu_torch.parallel import mesh


def _loss_and_grads(maxed, dp, labels, table, group):
    maxed = maxed.clone().requires_grad_(True)
    dp = dp.clone().requires_grad_(True)
    total, terms = affinity.irn_loss(maxed, dp, labels, table, group)
    total.backward()
    return dict(loss=float(total.detach()),
                **{k: float(v.detach()) for k, v in terms.items()},
                d_maxed=maxed.grad.numpy(), d_dp=dp.grad.numpy())


def irn_loss_rank(data: dict, radius: int, device) -> dict:
    """This rank's rows of a global batch through ``affinity.irn_loss``,
    twice: over the group (the global batch's denominators) and alone
    (its own denominators, as DDP's averaging would take them)."""
    table = affinity.path_table(paths.build_path_set(radius))
    mesh.process_barrier("irn_loss")
    lo, hi = mesh.local_batch_slice(data["maxed"].shape[0])
    maxed = torch.from_numpy(data["maxed"][lo:hi])
    dp = torch.from_numpy(data["dp"][lo:hi])
    labels = torch.from_numpy(data["labels"][lo:hi])
    return dict(rank=dist.get_rank(), rows=(lo, hi),
                group=_loss_and_grads(maxed, dp, labels, table,
                                      dist.group.WORLD),
                alone=_loss_and_grads(maxed, dp, labels, table, None))


def irn_loss_ranks(cases: dict, radius: int, device) -> dict:
    """:func:`irn_loss_rank` for every case, after a sum of the ranks over
    the group (``rank_sum``)."""
    t = torch.tensor([float(mesh.rank())], dtype=torch.float64)
    out = {k: irn_loss_rank(data, radius, device)
           for k, data in cases.items()}
    return dict(out, rank_sum=int(mesh.all_reduce_sum(t).item()))


def failing_rank(device) -> None:
    """Rank 1 raises; rank 0 would wait at the barrier."""
    if mesh.rank() == 1:
        raise RuntimeError("rank 1 fails")
    mesh.process_barrier("never")
    return np.zeros(1)


def _step_batches(kind: str, n_steps: int, batch: int, crop: int,
                  dtype) -> list:
    """Seeded (images, targets) of every step: CAM labels [B, 20] or IRN
    reduced labels [B, crop / 4, crop / 4]."""
    g = np.random.default_rng(4)
    out = []
    for _ in range(n_steps):
        img = torch.from_numpy(g.standard_normal(
            (batch, 3, crop, crop))).to(dtype)
        if kind == "cam":
            tgt = torch.from_numpy((g.random((batch, 20)) < 0.2).astype(
                np.float64)).to(dtype)
        else:
            tgt = torch.from_numpy(g.choice(
                np.array([0, 1, 2, 255], np.int32),
                size=(batch, crop // 4, crop // 4),
                p=(0.4, 0.25, 0.25, 0.1)))
        out.append((img, tgt))
    return out


def dp_steps(kind: str, n_steps: int = 2, batch: int = 2,
             dtype=torch.float64) -> dict:
    """``n_steps`` train steps of ``kind`` ("cam" or "irn") in ``dtype`` from
    a seeded init, on this rank's rows of seeded global batches: under DDP
    (``mesh.data_parallel``; IRN sums the gradients and its loss over the
    group, CAM averages) inside a group, else the whole batch. CAM first
    calibrates its statistics on the whole first batch. Returns the losses
    and the trained state dict."""
    from irn_tpu_torch.models.cam import CAMNet
    from irn_tpu_torch.models.irn import IRNet, init_irnet
    from irn_tpu_torch.train import cam_train, irn_train, optim

    crop = 32 if kind == "cam" else 64  # IRN's radius-4 window needs 64
    in_group = mesh.is_distributed()
    steps = _step_batches(kind, n_steps, batch, crop, dtype)
    lo, hi = mesh.local_batch_slice(batch) if in_group else (0, batch)
    torch.manual_seed(0)
    if kind == "cam":
        model = init_irnet(CAMNet(), torch.Generator().manual_seed(1))
        model = model.to(dtype)
        model.calibrate_stats(steps[0][0])
        mult = optim.cam_lr_mult
    else:
        model = init_irnet(IRNet(), torch.Generator().manual_seed(2))
        model = model.to(dtype)
        mult = optim.irn_lr_mult
    opt = optim.poly_sgd(model.named_parameters(), 0.1 if kind == "irn"
                         else 1e-3, max_step=10, momentum=1e-4,
                         weight_decay=1e-4, mult_fn=mult)
    net = model
    if in_group:
        net = mesh.data_parallel(model, optim.trained_params(opt), "cpu",
                                 sum_gradients=kind == "irn")
    if kind == "cam":
        step = cam_train.make_train_step(net, opt)
    else:
        step = irn_train.make_train_step(
            net, opt, irn_train.build_train_geometry(crop, 4),
            dist.group.WORLD if in_group else None)
    losses = []
    for img, tgt in steps:
        out = step(img[lo:hi].contiguous(), tgt[lo:hi].contiguous())
        loss = out if kind == "cam" else out["loss"]
        losses.append(float(mesh.all_reduce_mean(loss.clone())))
    return dict(losses=losses, state={
        k: v.numpy().copy() for k, v in model.state_dict().items()})


def train_stage_jobs(jobs: list, device) -> list:
    """Each job in turn on this rank, in the group: ("dp_steps", kind),
    ("train_irn" | "train_cam", cfg), or ("copy", src, dst) (rank 0 copies
    a file, then every rank meets at a barrier)."""
    import shutil

    from irn_tpu_torch.pipeline import stages_cam, stages_irn

    out = []
    for job in jobs:
        if job[0] == "dp_steps":
            out.append(dp_steps(job[1]))
        elif job[0] == "copy":
            if mesh.is_main():
                shutil.copy(job[1], job[2])
            mesh.process_barrier("copy")
            out.append(None)
        else:
            stage = (stages_irn.train_irn if job[0] == "train_irn"
                     else stages_cam.train_cam)
            out.append(stage(job[1], device))
    return out
