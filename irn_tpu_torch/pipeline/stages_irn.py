"""make_sem_seg and make_ins_seg on PyTorch — the counterparts of those
parts of :mod:`irn_tpu.pipeline.stages_irn` (split flow).

make_sem_seg, per image: the EdgeDisplacement forward over the padded
(image, flip) pair, the random walk at the image's grid bucket through the
hand kernels (:mod:`irn_tpu_torch.ops.random_walk`; by default the operator
build K10 and the chain K0), the x4 decode (K15), and a uint8 PNG in
``sem_seg_out_dir`` — the artifact layout of step/make_sem_seg_labels.py.

make_ins_seg, per image: the same forward, then the advection (K11,
:mod:`irn_tpu_torch.ops.centroids`), the basin clustering (K12,
:mod:`irn_tpu_torch.ops.ccl`, or the host union-find), the (instance x
class) walk, the component split and the npy dict of
step/make_ins_seg_labels.py in ``ins_seg_out_dir``. The JAX stage's
monolith programs and packed fetches exist for its TPU transport and are
not ported: the port passes tensors between the steps.

train_irn: the epoch loop over the ``ir_label`` crops (AffinityDataset,
BatchLoader), one train step per batch through the path max kernels (K13a,
K13b; :mod:`irn_tpu_torch.train.irn_train`), a ``profile_dir`` trace of
steps [2, 5), a ``.train`` checkpoint per epoch to resume from, the
displacement-mean calibration over ``infer_list`` and the final checkpoint
in the JAX layout, which both frameworks' make stages read.

The device is explicit: nothing moves to the CPU because no card was
found.
"""

from __future__ import annotations

import os
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from irn_tpu_torch.data import image_io
from irn_tpu_torch.data import loader as loader_mod
from irn_tpu_torch.data import voc12
from irn_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from irn_tpu_torch.models.irn import IRNet
from irn_tpu_torch.ops import ccl
from irn_tpu_torch.ops import centroids
from irn_tpu_torch.ops import matpow_kernels as mk
from irn_tpu_torch.ops import random_walk as rw_mod
from irn_tpu_torch.parallel import mesh
from irn_tpu_torch.parallel import rw_sharded
from irn_tpu_torch.pipeline import common
from irn_tpu_torch.pipeline.config import Config
from irn_tpu_torch.train import irn_train, optim
from irn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from irn_tpu_torch.utils.logging import DeviceMeter, Timer
from irn_tpu_torch.utils.profiling import StageProfiler
from irn_tpu_torch.utils.weights import irn_from_jax, irn_to_jax


def resolve_device(device) -> torch.device:
    """``device`` as given; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available "
            "(pass --device cpu to run on the CPU)"
        )
    return dev


def check_slice_flags(cfg: Config) -> None:
    """Flags whose code paths are not ported yet raise instead of running
    something else. ``--rw_matmul_dtype bfloat16`` raises here when every
    grid bucket of ``rw_grid_cap`` would take the banded chain of more than
    one application (:func:`bf16_chain_everywhere`), else in the walk of a
    bucket that does (``RandomWalkRunner._route``), with the same
    message."""
    if common.rw_matmul_dtype(cfg) is not None and bf16_chain_everywhere(cfg):
        raise NotImplementedError(mk.CHAIN_BF16_TODO)
    common.model_dtype(cfg)
    if cfg.sem_monolith:
        raise NotImplementedError(
            "sem_monolith: the relay-transport monolith is not ported "
            "(ROADMAP queue 1, 'Not ported')"
        )


def walk_buckets(cap: int) -> List[int]:
    """The grid sides :meth:`RandomWalkRunner._bucket` gives under the cap
    ``cap``: multiples of ``RandomWalkRunner.BUCKET`` below it, and the cap."""
    step = RandomWalkRunner.BUCKET
    return sorted({min(b, cap) for b in range(step, cap + step, step)})


def bf16_chain_everywhere(cfg: Config) -> bool:
    """Whether the flags alone route every walk to an application chain
    without a bf16 mode: one device (``rw_mesh_model`` 1), and every
    bucket of ``rw_grid_cap`` on the banded route at 0 < e < E."""
    if cfg.rw_mesh_model > 1:
        return False
    walker = RandomWalkRunner(cfg, 1, torch.device("cpu"))
    sides = walk_buckets(cfg.rw_grid_cap)
    for ch in sides:
        for cw in sides:
            try:
                walker.resolve_mode(ch, cw)
            except NotImplementedError:
                continue
            return False
    return True


def _images(batch: Dict, dev: torch.device) -> torch.Tensor:
    """A batch's normalized HWC images as [B, 3, H, W] f32 on ``dev``."""
    img = torch.from_numpy(batch["img"]).to(dev)
    return img.permute(0, 3, 1, 2).contiguous()


def train_ranks(batch_size: int, cfg: Config, device,
                ranks: Optional[mesh.RankSpec]) -> Optional[mesh.RankSpec]:
    """The ranks a train stage starts itself: ``ranks`` when given; else,
    outside a process group, ``--mesh_data``'s rank count on ``device``
    (:func:`mesh.ranks_for_batch`; 0 = every visible card) when it is more
    than one; else None (this process trains, alone or as one rank of its
    group)."""
    if ranks is not None or mesh.is_distributed():
        return ranks
    dev = resolve_device(device)
    n = mesh.ranks_for_batch(batch_size, cfg.mesh_data, dev)
    if n < cfg.mesh_data:
        print(f"mesh_data {cfg.mesh_data}: the batch of {batch_size} splits "
              f"over {n} ranks (the largest count that divides it)")
    return mesh.RankSpec(mesh.rank_devices(dev, n)) if n > 1 else None


def run_train(fn, cfg: Config, device, ranks: Optional[mesh.RankSpec],
              batch_size: int) -> Dict:
    """``fn(cfg, device)`` in this process, or on the ranks of
    :func:`train_ranks` (their rank 0's summary, with every rank's
    ``written`` files as ``written_by_rank``)."""
    spec = train_ranks(batch_size, cfg, device, ranks)
    if spec is None:
        return fn(cfg, resolve_device(device))
    results = mesh.run_ranks(fn, (cfg,), spec)
    return dict(results[0], written_by_rank=[r["written"] for r in results])


def train_irn(cfg: Config, device="cuda",
              ranks: Optional[mesh.RankSpec] = None) -> Dict:
    """Train IRNet's heads over a frozen backbone (step/train_irn.py): poly
    SGD, the four affinity / displacement losses through K13a and K13b, a
    ``.train`` checkpoint per epoch (resumed from when ``cfg.resume``),
    then the displacement-mean calibration and ``cfg.irn_weights_name``.

    Data-parallel over ranks (DDP, one process each) when ``ranks`` is
    given, when ``--mesh_data`` asks for more than one rank (0: every
    visible card; the stage spawns them) or in a process group (each
    process one rank): each rank loads its rows of every global batch, the
    loss and gradients are the global batch's (``irn_train``), and rank 0
    alone writes the checkpoints and calibrates while the others wait.

    Returns a summary (rank 0's): the steps this run took, the seconds its
    epoch loop took (every step finished), each step's losses, the epoch
    it started from, max_step, the calibrated dp_mean, the rank count and
    the files this rank wrote."""
    common.model_dtype(cfg)
    return run_train(_train_irn, cfg, device, ranks, cfg.irn_batch_size)


def _train_irn(cfg: Config, dev: torch.device) -> Dict:
    """train_irn in this process: alone, or as one rank of the group."""
    dtype = common.model_dtype(cfg)
    common.pin_numerics()
    world = (mesh.group_ranks(cfg.irn_batch_size, cfg.mesh_data)
             if mesh.is_distributed() else 1)
    main = mesh.is_main()

    ds = voc12.AffinityDataset(
        cfg.train_list, label_dir=cfg.ir_label_out_dir,
        crop_size=cfg.irn_crop_size, voc12_root=cfg.voc12_root,
        rescale=(0.5, 1.5), hor_flip=True, crop_method="random",
    )
    dl = loader_mod.BatchLoader(
        ds, cfg.irn_batch_size, shuffle=True, drop_last=True,
        num_workers=cfg.num_workers,
        local_rows=mesh.local_batch_slice(cfg.irn_batch_size)
        if world > 1 else None)
    max_step = (len(ds) // cfg.irn_batch_size) * cfg.irn_num_epoches

    model = common.init_model_variables(IRNet(dtype=dtype), cfg).to(dev)
    table = irn_train.build_train_geometry(cfg.irn_crop_size,
                                           cfg.path_radius)
    opt = optim.poly_sgd(
        model.named_parameters(), cfg.irn_learning_rate, max_step=max_step,
        power=0.9, momentum=cfg.irn_weight_decay,
        weight_decay=cfg.irn_weight_decay, mult_fn=optim.irn_lr_mult,
    )

    train_ckpt_path = cfg.irn_weights_name + ".train"
    start_epoch = 0
    if cfg.resume and os.path.exists(train_ckpt_path):
        start_epoch = optim.load_train_state(
            model, opt, load_checkpoint(train_ckpt_path), train_ckpt_path,
            irn_from_jax)
        print(f"resumed {train_ckpt_path} at epoch {start_epoch}")

    net, group = model, None
    if mesh.is_distributed():
        net = mesh.data_parallel(model, optim.trained_params(opt), dev,
                                 sum_gradients=True)
        group = dist.group.WORLD
    step_fn = irn_train.make_train_step(net, opt, table, group)
    prof = StageProfiler(cfg.profile_dir if main else None, "train_irn",
                         device=dev)
    meter = DeviceMeter()
    timer = Timer()
    steps_per_epoch = len(dl)
    history: List[Dict[str, torch.Tensor]] = []
    written: List[str] = []
    t0 = time.perf_counter()
    try:
        for ep in range(start_epoch, cfg.irn_num_epoches):
            if main:
                print(f"Epoch {ep + 1}/{cfg.irn_num_epoches}")
            # pin the loader's RNG stream to the true epoch, so a resumed
            # run continues the shuffle and augmentation sequence
            dl.set_epoch(ep)
            for it, batch in enumerate(dl):
                metrics = step_fn(
                    _images(batch, dev),
                    torch.from_numpy(batch["reduced_label"]).to(dev))
                prof.tick()
                meter.add(metrics)
                history.append(metrics)
                gstep = ep * steps_per_epoch + it + 1
                if (gstep - 1) % 50 == 0:
                    # every rank syncs here (a failed rank surfaces); rank
                    # 0 prints
                    losses = (
                        meter.pop("loss_pos_aff"), meter.pop("loss_neg_aff"),
                        meter.pop("loss_dp_fg"), meter.pop("loss_dp_bg"),
                    )
                    if main:
                        timer.update_progress(gstep / max_step)
                        print(
                            f"step:{gstep - 1:5d}/{max_step:5d}",
                            "loss:%.4f %.4f %.4f %.4f" % losses,
                            f"imps:{(it + 1) * cfg.irn_batch_size / timer.get_stage_elapsed():.1f}",
                            f"etc:{timer.str_estimated_complete()}",
                            flush=True,
                        )
            timer.reset_stage()
            if main:
                save_checkpoint(train_ckpt_path, optim.train_state(
                    model, opt, ep + 1, irn_to_jax))
                written.append(train_ckpt_path)
    finally:
        prof.close()
    seconds = time.perf_counter() - t0
    summary = dict(n_steps=len(history), seconds=seconds, world=world,
                   written=written)
    if not main:
        # rank 0 calibrates and saves the trained state, which every rank
        # holds alike
        mesh.process_barrier("train_irn.saved")
        return summary

    # displacement mean calibration (train_irn.py:87-107)
    model = mesh.fetch_replicated(net)
    infer_ds = voc12.ImageDataset(
        cfg.infer_list, cfg.voc12_root, img_normal=True,
        crop_size=cfg.irn_crop_size, crop_method="top_left",
    )
    infer_dl = loader_mod.BatchLoader(infer_ds, cfg.irn_batch_size,
                                      num_workers=cfg.num_workers)
    dp_step = irn_train.make_dp_mean_step(model)
    print("Analyzing displacements mean ... ", end="", flush=True)
    means = [dp_step(_images(b, dev)) for b in infer_dl]
    irn_train.calibrate_mean_shift(model, means)
    print("done.")

    save_checkpoint(cfg.irn_weights_name, irn_to_jax(model.state_dict()))
    written.append(cfg.irn_weights_name)
    print(f"saved {cfg.irn_weights_name}")
    mesh.process_barrier("train_irn.saved")
    keys = list(history[0]) if history else []
    rows = (torch.stack([torch.stack([m[k] for k in keys])
                         for m in history]).tolist() if history else [])
    return dict(summary, losses=[dict(zip(keys, r)) for r in rows],
                start_epoch=start_epoch, max_step=max_step,
                dp_mean=model.mean_shift.running_mean.cpu().tolist())


class EdgeDisplacementRunner:
    """EdgeDisplacement over the padded crop buffer (cap*4 px square).

    ``batch(imgs, sizes)`` -> per image (edge [cap, cap] with 1.0 beyond
    the extent, dp [2, cap, cap] with 0 beyond it, (h4, w4)): the sigmoid
    of the flip-averaged logit and the unflipped, mean-shifted
    displacement (resnet50_irn.py:223-234)."""

    def __init__(self, cfg: Config, model: IRNet, device: torch.device):
        self.device = device
        self.model = model.to(device).eval()
        self.cap = cfg.rw_grid_cap
        self.batch_size = max(1, cfg.edge_infer_batch)
        self.mean = torch.as_tensor(IMAGENET_MEAN, device=device)
        self.std = torch.as_tensor(IMAGENET_STD, device=device)

    def _prep(self, img_u8: torch.Tensor, h_px: int, w_px: int):
        """[cap_px, cap_px, 3] uint8 -> the normalized (image, flip) pair
        [2, 3, cap_px, cap_px]. Padding is zero in normalized space, and
        the flip is rolled so its valid region starts at column 0."""
        cap_px = img_u8.shape[1]
        x = (img_u8.float() / 255.0 - self.mean) / self.std
        rows = torch.arange(cap_px, device=self.device)[:, None] < h_px
        cols = torch.arange(cap_px, device=self.device)[None, :] < w_px
        x = torch.where((rows & cols)[..., None], x, 0.0)
        flip = torch.roll(x.flip(1), -(cap_px - w_px), dims=1)
        return torch.stack([x, flip]).permute(0, 3, 1, 2)

    def _fuse(self, e: torch.Tensor, d: torch.Tensor, h4: int, w4: int):
        """e [2, cap, cap] edge logits, d [2, 2, cap, cap] displacements."""
        cap = self.cap
        flipped = torch.roll(e[1].flip(-1), -(cap - w4), dims=-1)
        edge = torch.sigmoid(e[0] / 2.0 + flipped / 2.0)
        rows = torch.arange(cap, device=self.device)[:, None] < h4
        cols = torch.arange(cap, device=self.device)[None, :] < w4
        valid = rows & cols
        edge = torch.where(valid, edge, 1.0)  # hard boundary beyond extent
        dp = torch.where(valid[None], d[0], 0.0)
        return edge, dp

    @torch.no_grad()
    def batch(self, imgs: List[np.ndarray], sizes: List[Tuple[int, int]]):
        """One forward over up to ``batch_size`` images of any size mix
        (all share the padded buffer)."""
        if not 1 <= len(imgs) <= self.batch_size:
            raise ValueError(f"{len(imgs)} images for batch {self.batch_size}")
        cap_px = self.cap * 4
        buf = np.zeros((len(imgs), cap_px, cap_px, 3), np.uint8)
        for j, im in enumerate(imgs):
            h, w, _ = im.shape
            if h > cap_px or w > cap_px:
                raise ValueError(f"image {h}x{w} exceeds the {cap_px}px cap")
            buf[j, :h, :w] = im
        dev_buf = torch.from_numpy(buf).to(self.device)
        pairs = torch.cat([
            self._prep(dev_buf[j], im.shape[0], im.shape[1])
            for j, im in enumerate(imgs)
        ])
        edge_logit, dp = self.model(pairs, apply_mean_shift=True)
        out = []
        for j, size in enumerate(sizes):
            h4 = (size[0] - 1) // 4 + 1
            w4 = (size[1] - 1) // 4 + 1
            edge, d = self._fuse(edge_logit[2 * j : 2 * j + 2, 0],
                                 dp[2 * j : 2 * j + 2], h4, w4)
            out.append((edge, d, (h4, w4)))
        return out


def walk_mesh(cfg: Config, device,
              devices: Optional[List] = None
              ) -> Optional[rw_sharded.ModelMesh]:
    """The devices of one image's walk under ``--rw_mesh_model k`` > 1
    (None otherwise): ``devices`` when given (k of them; a device may
    repeat), else :func:`common.spread_devices` for k (the CPU k times; on
    CUDA the first k visible cards, or k from a process rank's own, more
    than are visible raise). The JAX package takes its model mesh from the
    global device list instead."""
    k = cfg.rw_mesh_model
    if k <= 1:
        return None
    if devices is not None:
        if len(devices) != k:
            raise ValueError(f"rw_mesh_model {k}: {len(devices)} devices "
                             "given")
        return rw_sharded.ModelMesh(devices)
    return rw_sharded.ModelMesh(common.spread_devices(device, k,
                                                      "rw_mesh_model"))


class RandomWalkRunner:
    """Bucketed walk + decode. Grids round up to ``BUCKET`` cells (capped at
    ``rw_grid_cap``); seed rows pad to a power-of-two bucket from
    ``ROW_BUCKET``, capped at ``n_seed_rows``.

    Under ``--rw_mesh_model k`` > 1 each walk splits over ``mesh`` (default
    :func:`walk_mesh` of ``device``), the JAX runner's long-context mode;
    the runner's device is then the mesh's first, where the seeds, the
    operator build and the decode live and the walk's result is
    gathered."""

    BUCKET = 32
    ROW_BUCKET = 8

    def __init__(self, cfg: Config, n_seed_rows: int, device: torch.device,
                 mesh: Optional[rw_sharded.ModelMesh] = None):
        if cfg.rw_mesh_model > 1 and mesh is None:
            mesh = walk_mesh(cfg, device)
        self.mesh = mesh if cfg.rw_mesh_model > 1 else None
        self.device = self.mesh.first if self.mesh is not None else device
        self.cap = cfg.rw_grid_cap
        self.radius = cfg.rw_radius
        self.beta = cfg.beta
        self.exp_times = cfg.exp_times
        self.n_rows = n_seed_rows
        self.square_times_cfg = cfg.rw_square_times
        self.banded_cfg = cfg.rw_banded
        self.mm_dtype = common.rw_matmul_dtype(cfg)
        self.modes: Dict[Tuple[int, int], str] = {}

    def _square_times(self, geom) -> int:
        """The pinned split, or the cost model's at the operand dtype (JAX
        ``_square_times``, n_chunks 1 so the chunked walk picks the same)."""
        if self.square_times_cfg >= 0:
            return min(self.square_times_cfg, self.exp_times)
        return rw_mod.pick_square_times(geom.n_pad, self.exp_times,
                                        matmul_dtype=self.mm_dtype)

    def _use_banded(self, geom, sq: int) -> bool:
        """The single-device hand-kernel routes (stencil or banded) on every
        device, never under a mesh: on the CPU they run through the
        kernels' plain twins."""
        return (self.banded_cfg and self.mesh is None
                and rw_mod.banded_fits(geom, self.exp_times, sq))

    def _mesh_banded(self, geom, sq: int) -> bool:
        """The row-split banded route: a mesh, the band under its gate."""
        return (self.mesh is not None and self.banded_cfg
                and rw_mod.banded_sharded_fits(geom, self.exp_times, sq,
                                               len(self.mesh)))

    def _mesh_diag(self, geom, sq: int) -> bool:
        """The column-split stencil: a mesh at e = 0 (the stencil applies T
        itself), each block covering the halo."""
        return (sq == 0 and self.mesh is not None and self.banded_cfg
                and rw_mod.diag_sharded_fits(geom, len(self.mesh)))

    def _resolve(self, geom) -> Tuple[int, bool]:
        """(square_times, banded): the banded split (e = 0) when its band
        fits on one device, or its row-split or column-split route fits
        the mesh; else the pinned or cost-model split."""
        if self.square_times_cfg < 0:
            sqb = rw_mod.pick_square_times_banded(self.exp_times)
            if self._use_banded(geom, sqb):
                return sqb, True
            if self._mesh_banded(geom, sqb) or self._mesh_diag(geom, sqb):
                return sqb, False
        sq = self._square_times(geom)
        return sq, self._use_banded(geom, sq)

    def _route(self, geom) -> Tuple[int, str]:
        """(square_times, mode): ``diag`` (K0 stencil) | ``banded`` (K2 +
        K1 + K3, or K2 + K4 at e = E) | ``mesh_diag`` (K0 per device and
        round) | ``mesh_banded`` (the row-split band) | ``dense`` (on one
        device, or its squarings' rows split over the mesh). At bf16 the
        banded route with a chain of more than one application raises
        :class:`NotImplementedError` (no bf16 mode of K1 + K3 yet)."""
        sq, banded = self._resolve(geom)
        if banded:
            if sq > 0:
                rw_mod.check_banded_dtype(geom, self.exp_times, sq,
                                          matmul_dtype=self.mm_dtype)
            return sq, "diag" if sq == 0 else "banded"
        if self._mesh_diag(geom, sq):
            return sq, "mesh_diag"
        if self._mesh_banded(geom, sq):
            return sq, "mesh_banded"
        return sq, "dense"

    def resolve_mode(self, cap_h: int, cap_w: int) -> str:
        """The mode :meth:`_route` gives the (cap_h, cap_w) bucket (JAX
        ``resolve_mode``)."""
        return self._route(rw_mod.build_geometry(cap_h, cap_w,
                                                 radius=self.radius))[1]

    def _bucket(self, x: int) -> int:
        b = ((x + self.BUCKET - 1) // self.BUCKET) * self.BUCKET
        return min(b, self.cap)

    def _row_bucket(self, k: int) -> int:
        b = self.ROW_BUCKET
        while b < min(k, self.n_rows):
            b *= 2
        return min(b, self.n_rows)

    def _propagate(self, cam_t: torch.Tensor, edge: torch.Tensor, ch: int,
                   cw: int) -> torch.Tensor:
        """The walk of seed rows ``cam_t`` [R, ch, cw] on the image's edge
        map at the (ch, cw) bucket, by the resolved route."""
        edge_b = edge[:ch, :cw]
        geom = rw_mod.build_geometry(ch, cw, radius=self.radius)
        sq, mode = self._route(geom)
        self.modes[(ch, cw)] = mode
        if mode in ("diag", "banded"):
            return rw_mod.propagate_banded(geom, cam_t, edge_b, self.beta,
                                           self.exp_times, square_times=sq,
                                           matmul_dtype=self.mm_dtype)
        return rw_mod.propagate(geom, cam_t, edge_b, self.beta,
                                self.exp_times, square_times=sq,
                                mesh=self.mesh, mesh_banded=self.banded_cfg,
                                matmul_dtype=self.mm_dtype)

    def __call__(self, cam_rows: np.ndarray, edge: torch.Tensor, h4: int,
                 w4: int, size: Tuple[int, int], bg_thres: float):
        """cam_rows [K, h4, w4] seeds (K <= n_seed_rows); edge [cap, cap].
        Returns labels [4ch, 4cw] (0 = background, k = seed row k-1) at
        the image's bucket, on the runner's device."""
        ch, cw = self._bucket(h4), self._bucket(w4)
        k = cam_rows.shape[0]
        if k > self.n_rows or h4 > ch or w4 > cw:
            raise ValueError(f"seeds {cam_rows.shape} vs bucket {(ch, cw)}")
        cam = np.zeros((self._row_bucket(k), ch, cw), np.float32)
        cam[:k, :h4, :w4] = cam_rows
        cam_t = torch.from_numpy(cam).to(self.device)
        rw = self._propagate(cam_t, edge, ch, cw)
        return rw_mod.decode(rw, h4, w4, size[0], size[1], bg_thres).labels

    def walk(self, seeds: torch.Tensor, edge: torch.Tensor, h4: int,
             w4: int, size: Tuple[int, int], bg_thres: float):
        """One walk of device seed rows ``seeds`` [K, ch, cw] at the image's
        bucket (K <= n_seed_rows; zero rows pad K to its row bucket).
        Returns (labels [4ch, 4cw] int32, best [4ch, 4cw] f32): best is
        the max over rows of the max-normalized upsampled scores, the
        winning row's score wherever a row wins (JAX stages_irn.py:
        558-564)."""
        ch, cw = self._bucket(h4), self._bucket(w4)
        k = seeds.shape[0]
        if k > self.n_rows or tuple(seeds.shape[1:]) != (ch, cw):
            raise ValueError(f"seeds {tuple(seeds.shape)} vs bucket "
                             f"{(ch, cw)} and {self.n_rows} rows")
        pad = self._row_bucket(k) - k
        cam_t = F.pad(seeds, (0, 0, 0, 0, 0, pad)) if pad else seeds
        rw = self._propagate(cam_t, edge, ch, cw)
        out = rw_mod.decode(rw, h4, w4, size[0], size[1], bg_thres,
                            best=True, labels_dtype=torch.int32)
        return out.labels, out.best

    def propagate_all(self, seeds: torch.Tensor, edge: torch.Tensor,
                      h4: int, w4: int, size: Tuple[int, int],
                      bg_thres: float):
        """:meth:`walk` for any number of seed rows (JAX stages_irn.py:
        633-818). Up to ``n_seed_rows`` rows it is :meth:`walk`; past it
        the operator is built once from the edge map, fixed chunks of
        ``n_seed_rows`` rows each run the chain and the x4 upsample, and
        the chunks combine into a running (max value, argmax row) with a
        strict ``>`` (lower rows win ties). The decode divides by the
        global max: ``norm = best_val / max(gmax, 1e-12)``, labels
        ``best_row + 1`` where ``norm > bg_thres``. Returns (labels int32,
        norm) as :meth:`walk`."""
        k = seeds.shape[0]
        if k <= self.n_rows:
            return self.walk(seeds, edge, h4, w4, size, bg_thres)
        ch, cw = self._bucket(h4), self._bucket(w4)
        if tuple(seeds.shape[1:]) != (ch, cw):
            raise ValueError(f"seeds {tuple(seeds.shape)} vs bucket {(ch, cw)}")
        edge_b = edge[:ch, :cw]
        geom = rw_mod.build_geometry(ch, cw, radius=self.radius)
        sq, mode = self._route(geom)
        self.modes[(ch, cw)] = mode
        n_apply = 1 << (self.exp_times - sq)
        mesh_ = self.mesh
        mm = self.mm_dtype
        if mode == "diag":
            w, inv = rw_mod.build_diag_operator(geom, edge_b, self.beta)
            doffs = rw_mod.diag_offsets(geom)

            def apply(cam):
                x = rw_mod._flat_seeds(geom, cam, edge_b)
                return rw_mod._unflatten_rw(geom, rw_mod.apply_diag_chain(
                    x, w, inv, doffs, n_apply))
        elif mode == "mesh_diag":
            winv = rw_mod.build_diag_operator(geom, edge_b, self.beta)

            def apply(cam):
                return rw_mod.apply_transition_mesh_diag(
                    geom, cam, edge_b, winv, n_apply, mesh_)
        elif mode == "banded":
            t, band = rw_mod.build_transition_banded(
                geom, edge_b, self.beta, sq, matmul_dtype=mm)

            def apply(cam):
                return rw_mod.apply_transition_banded(
                    geom, cam, edge_b, t, band, n_apply, matmul_dtype=mm)
        elif mode == "mesh_banded":
            # T stays row-split over the mesh for every chunk
            blocks = rw_mod.build_transition_mesh_banded(
                geom, edge_b, self.beta, sq, mesh_, mm)

            def apply(cam):
                return rw_mod.apply_transition_mesh_banded(
                    geom, cam, edge_b, blocks, n_apply, mesh_, mm)
        else:
            t = rw_mod.build_transition(geom, edge_b, self.beta, sq, mesh_,
                                        mm)

            def apply(cam):
                return rw_mod.propagate_with_transition(geom, cam, edge_b,
                                                        t, n_apply, mm)

        best_val = torch.zeros((4 * ch, 4 * cw), device=self.device)
        best_row = torch.zeros((4 * ch, 4 * cw), dtype=torch.int64,
                               device=self.device)
        gmax = torch.zeros((), device=self.device)
        for row0 in range(0, k, self.n_rows):
            cam = seeds[row0 : row0 + self.n_rows]
            cam = F.pad(cam, (0, 0, 0, 0, 0, self.n_rows - cam.shape[0]))
            rw_up = rw_mod.upsample_scores(apply(cam), h4, w4, size[0],
                                           size[1])
            v = rw_up.amax(0)
            take = v > best_val
            best_val = torch.where(take, v, best_val)
            best_row = torch.where(take, torch.argmax(rw_up, 0) + row0,
                                   best_row)
            gmax = torch.maximum(gmax, rw_up.max())
        norm = best_val / torch.clamp(gmax, min=1e-12)
        labels = torch.where(norm > bg_thres, best_row + 1, 0)
        return labels.to(torch.int32), norm


def _load_irn(cfg: Config, device: torch.device,
              state: Optional[Dict] = None) -> EdgeDisplacementRunner:
    """The EdgeDisplacement runner on ``device`` over ``cfg``'s checkpoint
    (``state``: its torch state dict, read once for several devices)."""
    model = IRNet(dtype=common.model_dtype(cfg))
    model.load_state_dict(state if state is not None else irn_from_jax(
        load_checkpoint(cfg.irn_weights_name)))
    return EdgeDisplacementRunner(cfg, model, device)


def _pending_blocks(ds, out_dir: str, ext: str, cfg: Config,
                    name: str) -> List[List[int]]:
    """This rank's share of the stage's work: the images whose output does
    not exist yet, in blocks of ``edge_infer_batch`` (one forward each),
    the blocks strided over the ranks (``common.shard_blocks``)."""
    todo = [
        i for i in range(len(ds))
        if cfg.overwrite or not os.path.exists(
            os.path.join(out_dir, ds.img_name_list[i] + ext))
    ]
    bsz = max(1, cfg.edge_infer_batch)
    return common.shard_blocks(
        [todo[c0 : c0 + bsz] for c0 in range(0, len(todo), bsz)], name)


def _walk_spread(cfg: Config, dev: torch.device, devices: Optional[List]
                 ) -> Tuple[Optional[rw_sharded.ModelMesh],
                            common.DeviceSpreader]:
    """A make stage's walk mesh (:func:`walk_mesh`) and its spreader: under
    a mesh one worker, inline on the mesh's first device, where the
    forward and every step but the walk run (one image occupies the whole
    mesh, JAX stages_irn.py:1212-1215; ``--infer_devices`` is ignored);
    else :func:`common.make_spreader` over ``--infer_devices`` or
    ``devices``."""
    wmesh = walk_mesh(cfg, dev, devices)
    if wmesh is not None:
        return wmesh, common.DeviceSpreader([wmesh.first], inline=True)
    return None, common.make_spreader(dev, cfg.infer_devices, devices)


def _load_sem_cam(cfg: Config, name: str):
    cam_dict = np.load(os.path.join(cfg.cam_out_dir, name + ".npy"),
                       allow_pickle=True).item()
    cams = np.asarray(cam_dict["cam"], np.float32)  # [K, h4, w4]
    keys = np.pad(np.asarray(cam_dict["keys"]) + 1, (1, 0), mode="constant")
    return cams, keys


def make_sem_seg_labels(cfg: Config, device="cuda",
                        devices: Optional[List] = None) -> Dict:
    """Random-walk pseudo semantic masks (step/make_sem_seg_labels.py).

    In a process group each rank takes a strided share of the pending
    images; within the process, blocks go round-robin to the workers of
    ``common.DeviceSpreader`` (``--infer_devices`` cards, or ``devices``),
    each with its own runner, walker and CUDA stream. Under
    ``--rw_mesh_model k`` > 1 one worker runs every image and each walk
    splits over k devices (``devices``, which must then be k, or
    :func:`walk_mesh`'s).

    Returns a summary: images written, the seconds the image loop took
    (after the model load; every PNG written), the walk mode per grid
    bucket, the mean and saturated fraction (< 1e-3 or > 1 - 1e-3) of the
    edge map inside each image's extent, and the blocks each worker
    took."""
    check_slice_flags(cfg)
    dev = resolve_device(device)
    common.pin_numerics()

    state = irn_from_jax(load_checkpoint(cfg.irn_weights_name))
    ds = voc12.ImageDataset(cfg.infer_list, cfg.voc12_root, img_normal=False)
    os.makedirs(cfg.sem_seg_out_dir, exist_ok=True)
    n = len(ds)
    blocks = _pending_blocks(ds, cfg.sem_seg_out_dir, ".png", cfg,
                             "make_sem_seg")
    wmesh, spread = _walk_spread(cfg, dev, devices)

    def setup(d):
        return dict(runner=_load_irn(cfg, d, state),
                    walker=RandomWalkRunner(cfg, n_seed_rows=20, device=d,
                                            mesh=wmesh),
                    edge_sum=torch.zeros((), dtype=torch.float64, device=d),
                    edge_sat=torch.zeros((), dtype=torch.float64, device=d),
                    edge_cells=0, n_images=0,
                    pending=deque())  # (i, out_path, size, keys, labels)

    def finish(item):
        i, out_path, size, keys, labels = item
        pred = labels.cpu().numpy()[: size[0], : size[1]]
        image_io.imwrite(out_path, keys[pred].astype(np.uint8))
        if i % max(n // 20, 1) == 0:
            print(f"make_sem_seg {i}/{n}", flush=True)

    def work(ctx, c, block):
        samples = [ds[i] for i in block]
        imgs = [s["img"].astype(np.uint8) for s in samples]
        sizes = [im.shape[:2] for im in imgs]
        for i, sample, size, (edge, _, (h4, w4)) in zip(
            block, samples, sizes, ctx["runner"].batch(imgs, sizes)
        ):
            inside = edge[:h4, :w4].double()
            ctx["edge_sum"] += inside.sum()
            ctx["edge_sat"] += ((inside < 1e-3) | (inside > 1 - 1e-3)).sum()
            ctx["edge_cells"] += h4 * w4
            cams, keys = _load_sem_cam(cfg, sample["name"])
            labels = ctx["walker"](cams, edge, h4, w4, size,
                                   cfg.sem_seg_bg_thres)
            out_path = os.path.join(cfg.sem_seg_out_dir,
                                    sample["name"] + ".png")
            ctx["pending"].append((i, out_path, size, keys, labels))
            ctx["n_images"] += 1
            # the host writes image i-1 while the device walks image i
            while len(ctx["pending"]) > 1:
                finish(ctx["pending"].popleft())

    def done(ctx):
        while ctx["pending"]:
            finish(ctx["pending"].popleft())

    spread.setup(setup)
    t0 = time.perf_counter()
    ctxs = spread.run(blocks, work, done)
    seconds = time.perf_counter() - t0
    cells = max(sum(c["edge_cells"] for c in ctxs), 1)
    modes = {}
    for c in ctxs:
        modes.update(c["walker"].modes)
    return {
        "n_images": sum(c["n_images"] for c in ctxs),
        "seconds": seconds,
        "modes": {f"{h}x{w}": m for (h, w), m in sorted(modes.items())},
        "edge_mean": sum(float(c["edge_sum"].item()) for c in ctxs) / cells,
        "edge_saturated": sum(float(c["edge_sat"].item())
                              for c in ctxs) / cells,
        "assigned": spread.taken(),
    }


def pow2_ge(x: int) -> int:
    """Smallest power of two >= max(x, 1): the seed-row shape bucket of the
    class and instance counts (JAX stages_irn.py:1451)."""
    return 1 << (max(int(x), 1) - 1).bit_length()


def seed_build(cams: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(instance x class) seed rows, class-major: cams [C, ch, cw] f32 times
    masks [K, >= ch, >= cw] uint8 (cropped to the bucket) -> [C*K, ch, cw],
    row c * K + k (JAX ``_seed_build`` / ``_seed_build_cropped``,
    stages_irn.py:1471-1491)."""
    ch, cw = cams.shape[1], cams.shape[2]
    seeds = cams[:, None] * masks[None, :, :ch, :cw].to(cams.dtype)
    return seeds.reshape(-1, ch, cw)


def _load_ins_cam(cfg: Config, name: str):
    """(cams [C, h4, w4] f32, keys [C] 0-based classes) of one image."""
    cam_dict = np.load(os.path.join(cfg.cam_out_dir, name + ".npy"),
                       allow_pickle=True).item()
    return (np.asarray(cam_dict["cam"], np.float32),
            np.asarray(cam_dict["keys"]))


def save_detected(out_path: str, size: Tuple[int, int], comp_map: np.ndarray,
                  comp_rows: np.ndarray, comp_sizes: np.ndarray,
                  scores_all: np.ndarray, instance_class_id: np.ndarray
                  ) -> Dict:
    """The ins_seg npy dict (JAX ``_save_detected``, stages_irn.py:
    1552-1586): one mask per component of ``comp_map`` [>= h, >= w] (ids
    1..K), scored by ``scores_all[k]``, or 0 for a fragment under 1% of
    the image; class ``instance_class_id[row]``."""
    k_comps = comp_rows.shape[0]
    max_fragment = size[0] * size[1] * 0.01
    crop = comp_map[: size[0], : size[1]]
    pred_score, pred_mask, pred_class = [], [], []
    for k in range(1, k_comps + 1):
        pred_score.append(0.0 if comp_sizes[k - 1] < max_fragment
                          else float(scores_all[k]))
        pred_mask.append(crop == k)
        pred_class.append(int(instance_class_id[comp_rows[k - 1]]))
    if pred_mask:
        detected = {
            "score": np.asarray(pred_score, np.float32),
            "mask": np.stack(pred_mask, 0),
            "class": np.asarray(pred_class, np.int32),
        }
    else:
        detected = {
            "score": np.zeros((0,), np.float32),
            "mask": np.zeros((0, int(size[0]), int(size[1])), bool),
            "class": np.zeros((0,), np.int32),
        }
    detected["size"] = (int(size[0]), int(size[1]))
    np.save(out_path, detected)
    return detected


class InstanceTail:
    """make_ins_seg after the forward, for one image: K11 advection and
    basin, the clustering (K12a + K12b on the card, or the host
    union-find), the (instance x class) seeds, the walk (chunked past
    ``ins_seed_cap`` rows), and the component split (K12a + K12b, or the
    host). :meth:`run` queues the device work and returns a record;
    :meth:`finish` fetches it, redoes the image through the host flow when
    a device cap overflowed, and writes the npy."""

    def __init__(self, cfg: Config, walker: RandomWalkRunner):
        self.cfg = cfg
        self.walker = walker
        self.k_cap = cfg.ins_cluster_cap
        self.comp_cap = cfg.ins_comp_cap
        self.counts = {"device_ccl": 0, "host_cluster": 0,
                       "device_split": 0, "host_split": 0, "chunked": 0,
                       "redo": 0}

    def run(self, name: str, size: Tuple[int, int], edge: torch.Tensor,
            dp: torch.Tensor, h4: int, w4: int, host: bool = False,
            advected=None) -> Dict:
        """Queue one image's device work; ``host`` takes the exact host
        flow (host clustering and host split) whatever the config;
        ``advected`` is the image's (cent, basin) when K11 already ran."""
        walker, dev = self.walker, self.walker.device
        cams, keys = _load_ins_cam(self.cfg, name)
        ch, cw = walker._bucket(h4), walker._bucket(w4)
        c_pad = pow2_ge(cams.shape[0])
        camp = np.zeros((c_pad, ch, cw), np.float32)
        camp[: cams.shape[0], :h4, :w4] = cams
        cent, basin = advected or centroids.advect(dp, h4, w4)
        n_found = None
        if self.cfg.ins_device_ccl and not host:
            self.counts["device_ccl"] += 1
            masks, n_found = ccl.cluster_from_basin(basin, cent, h4, w4,
                                                    self.k_cap)
            k = self.k_cap
        else:
            self.counts["host_cluster"] += 1
            inst = centroids.cluster_centroids_from_basin(
                cent[:, :h4, :w4].cpu().numpy(),
                basin[:h4, :w4].cpu().numpy())
            k = pow2_ge(inst.shape[0])
            maskp = np.zeros((k, ch, cw), np.uint8)
            maskp[: inst.shape[0], :h4, :w4] = inst
            masks = torch.from_numpy(maskp).to(dev)
        seeds = seed_build(torch.from_numpy(camp).to(dev), masks)
        if seeds.shape[0] > walker.n_rows:
            self.counts["chunked"] += 1
        labels, best = walker.propagate_all(seeds, edge, h4, w4, size,
                                            self.cfg.ins_seg_bg_thres)
        tables = None
        if self.comp_cap > 0 and not host:
            self.counts["device_split"] += 1
            tables = ccl.component_tables(labels, best, self.comp_cap)
        keys_pad = np.zeros(c_pad, keys.dtype)
        keys_pad[: keys.shape[0]] = keys
        return dict(name=name, size=size, edge=edge, dp=dp, hw4=(h4, w4),
                    advected=(cent, basin), class_ids=np.repeat(keys_pad, k),
                    n_found=n_found, labels=labels, best=best, tables=tables)

    def finish(self, rec: Dict, out_path: str) -> Dict:
        """Fetch one image's record and write its npy dict."""
        size = rec["size"]
        class_ids = rec["class_ids"]
        if rec["n_found"] is not None and int(rec["n_found"]) > self.k_cap:
            return self._redo(rec, out_path)
        if rec["tables"] is not None:
            comp_map, rows, sizes, scores, n_comp = (
                t.cpu().numpy() for t in rec["tables"])
            n_comp = int(n_comp)
            if n_comp > self.comp_cap:
                return self._redo(rec, out_path)
            scores_all = np.concatenate([np.zeros(1, np.float32),
                                         scores[:n_comp]])
            return save_detected(out_path, size, comp_map, rows[:n_comp],
                                 sizes[:n_comp], scores_all, class_ids)
        self.counts["host_split"] += 1
        labels = rec["labels"].cpu().numpy()
        best = rec["best"].cpu().numpy()
        comp_map, comp_rows, comp_sizes = centroids.split_components(
            labels, class_ids.shape[0])
        scores_all = np.zeros(comp_rows.shape[0] + 1, np.float32)
        np.maximum.at(scores_all, comp_map.reshape(-1), best.reshape(-1))
        return save_detected(out_path, size, comp_map, comp_rows, comp_sizes,
                             scores_all, class_ids)

    def _redo(self, rec: Dict, out_path: str) -> Dict:
        """A device cap overflowed: the image again through the exact host
        flow, from its own (deterministic) forward's edge and its K11 end
        points and basin."""
        self.counts["redo"] += 1
        again = self.run(rec["name"], rec["size"], rec["edge"], rec["dp"],
                         *rec["hw4"], host=True, advected=rec["advected"])
        return self.finish(again, out_path)


def make_ins_seg_labels(cfg: Config, device="cuda",
                        devices: Optional[List] = None) -> Dict:
    """Instance pseudo masks (step/make_ins_seg_labels.py): per image the
    forward, then :class:`InstanceTail`, the npy dict of the JAX stage
    (``score`` f32 [K], ``mask`` bool [K, H, W], ``class`` int32 [K],
    ``size``) in ``ins_seg_out_dir``. Spread over ranks and workers as
    :func:`make_sem_seg_labels`.

    Returns a summary: images written, the seconds the image loop took
    (after the model load; every npy written), the walk mode per grid
    bucket, how many images took each flow (device or host clustering,
    device or host split), the chunked walk and the host redo, and the
    blocks each worker took."""
    check_slice_flags(cfg)
    dev = resolve_device(device)
    common.pin_numerics()

    state = irn_from_jax(load_checkpoint(cfg.irn_weights_name))
    ds = voc12.ImageDataset(cfg.infer_list, cfg.voc12_root, img_normal=False)
    os.makedirs(cfg.ins_seg_out_dir, exist_ok=True)
    n = len(ds)
    blocks = _pending_blocks(ds, cfg.ins_seg_out_dir, ".npy", cfg,
                             "make_ins_seg")
    wmesh, spread = _walk_spread(cfg, dev, devices)

    def setup(d):
        walker = RandomWalkRunner(cfg, n_seed_rows=cfg.ins_seed_cap,
                                  device=d, mesh=wmesh)
        return dict(runner=_load_irn(cfg, d, state), walker=walker,
                    tail=InstanceTail(cfg, walker), n_images=0,
                    pending=deque())  # (i, out_path, record)

    def finish(tail, item):
        i, out_path, rec = item
        tail.finish(rec, out_path)
        if i % max(n // 20, 1) == 0:
            print(f"make_ins_seg {i}/{n}", flush=True)

    def work(ctx, c, block):
        samples = [ds[i] for i in block]
        imgs = [s["img"].astype(np.uint8) for s in samples]
        sizes = [im.shape[:2] for im in imgs]
        for i, sample, size, (edge, dp, (h4, w4)) in zip(
            block, samples, sizes, ctx["runner"].batch(imgs, sizes)
        ):
            out_path = os.path.join(cfg.ins_seg_out_dir,
                                    sample["name"] + ".npy")
            rec = ctx["tail"].run(sample["name"], size, edge, dp, h4, w4)
            ctx["pending"].append((i, out_path, rec))
            ctx["n_images"] += 1
            # the host writes image i-1 while the device works on image i
            while len(ctx["pending"]) > 1:
                finish(ctx["tail"], ctx["pending"].popleft())

    def done(ctx):
        while ctx["pending"]:
            finish(ctx["tail"], ctx["pending"].popleft())

    spread.setup(setup)
    t0 = time.perf_counter()
    ctxs = spread.run(blocks, work, done)
    seconds = time.perf_counter() - t0
    modes, counts = {}, Counter()
    for c in ctxs:
        modes.update(c["walker"].modes)
        counts.update(c["tail"].counts)
    return {
        "n_images": sum(c["n_images"] for c in ctxs),
        "seconds": seconds,
        "modes": {f"{h}x{w}": m for (h, w), m in sorted(modes.items())},
        **{k: counts[k] for k in ctxs[0]["tail"].counts},
        "assigned": spread.taken(),
    }
