"""train_cam, make_cam, eval_cam and cam_to_ir_label on PyTorch — the
counterparts of :mod:`irn_tpu.pipeline.stages_cam` (step/train_cam.py,
step/make_cam.py, step/eval_cam.py, step/cam_to_ir_label.py of the
reference).

Same hyper-parameters and the same artifacts: ``cam_weights_name`` in the
JAX layout (plus a ``.train`` file per epoch to resume from), per image
``<cam_out_dir>/<id>.npy`` holding a dict {keys, cam, high_res} and
``<ir_label_out_dir>/<id>.png`` seed maps, so either framework's later
stages read them. The device is explicit: nothing moves to the CPU because
no card was found.

train_cam: the epoch loop over random long-side resized, flipped 512 px
crops (ClassificationDataset, BatchLoader), one train step per batch
(:mod:`irn_tpu_torch.train.cam_train`), the validate loss over
``val_list`` after every epoch. Without a pretrained backbone, one batch
first calibrates every frozen batch norm's statistics.

make_cam groups images by exact original size and runs up to
``cam_infer_batch`` of them per scale as one [2k, 3, ph, pw] stack (the
flip pairs ride the batch), each scale padded to a ``pad_multiple`` bucket
with the backbone masking beyond the true extent. Since every image of a
chunk has the same size, the extents are Python ints here (the JAX stage
passes them as traced scalars to share one program between sizes).
"""

from __future__ import annotations

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from irn_tpu_torch.data import image_io
from irn_tpu_torch.data import loader as loader_mod
from irn_tpu_torch.data import transforms as T
from irn_tpu_torch.data import voc12
from irn_tpu_torch.models.cam import CAMNet
from irn_tpu_torch.ops.resize import resize_bilinear_dynamic
from irn_tpu_torch.parallel import mesh
from irn_tpu_torch.pipeline import common
from irn_tpu_torch.pipeline import stages_eval
from irn_tpu_torch.pipeline.config import Config
from irn_tpu_torch.pipeline.stages_irn import _images, resolve_device, run_train
from irn_tpu_torch.train import cam_train, optim
from irn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from irn_tpu_torch.utils.logging import AverageMeter, DeviceMeter, Timer
from irn_tpu_torch.utils.profiling import StageProfiler
from irn_tpu_torch.utils.weights import cam_from_jax, cam_to_jax

N_CLS = 20


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _chunk_sizes(m: int, cap: int) -> List[int]:
    """Decompose ``m`` into chunk sizes <= cap: full ``cap`` chunks, then a
    power-of-two tail, so the batch shapes a group meets stay O(log cap)."""
    out = []
    while m >= cap:
        out.append(cap)
        m -= cap
    while m:
        k = 1 << (m.bit_length() - 1)
        out.append(k)
        m -= k
    return out


def _label_dict(cfg: Config) -> Dict[str, np.ndarray]:
    if os.path.exists(cfg.cls_labels_path):
        return voc12.load_label_dict(cfg.cls_labels_path)
    names = set(voc12.load_img_name_list(cfg.train_list))
    names |= set(voc12.load_img_name_list(cfg.val_list))
    names |= set(voc12.load_img_name_list(cfg.infer_list))
    print("building cls labels from VOC XML annotations ...")
    return voc12.make_label_dict(sorted(names), cfg.voc12_root)


def train_cam(cfg: Config, device="cuda",
              ranks: Optional[mesh.RankSpec] = None) -> Dict:
    """Train the CAM classifier (step/train_cam.py): poly SGD with a 10x
    head, the stem and layers 1-2 frozen under ``cam_stop_grad`` "c3", the
    frozen batch norms calibrated from one batch when there is no
    pretrained backbone, the validate loss and a ``.train`` checkpoint
    (resumed from when ``cfg.resume``) after every epoch, then
    ``cfg.cam_weights_name`` in the JAX layout.

    Data-parallel over ranks as ``stages_irn.train_irn`` (DDP averaging
    the gradients of each rank's mean loss over its equal share of the
    global batch, which is the global mean's gradient): every rank
    calibrates from the same full first batch; rank 0 alone validates and
    writes the checkpoints.

    Returns a summary (rank 0's): the steps this run took, the seconds its
    epoch loop took (every step and validation finished), each step's
    loss (the global batch's), each epoch's validate loss, the epoch it
    started from, max_step, the rank count and the files this rank
    wrote."""
    common.model_dtype(cfg)
    return run_train(_train_cam, cfg, device, ranks, cfg.cam_batch_size)


def _train_cam(cfg: Config, dev: torch.device) -> Dict:
    """train_cam in this process: alone, or as one rank of the group."""
    dtype = common.model_dtype(cfg)
    common.pin_numerics()
    world = (mesh.group_ranks(cfg.cam_batch_size, cfg.mesh_data)
             if mesh.is_distributed() else 1)
    main = mesh.is_main()

    labels = _label_dict(cfg)
    train_ds = voc12.ClassificationDataset(
        cfg.train_list, cfg.voc12_root, labels, resize_long=(320, 640),
        img_normal=True, hor_flip=True, crop_size=cfg.cam_crop_size,
        crop_method="random")
    val_ds = voc12.ClassificationDataset(
        cfg.val_list, cfg.voc12_root, labels, img_normal=True,
        crop_size=cfg.cam_crop_size)
    train_dl = loader_mod.BatchLoader(
        train_ds, cfg.cam_batch_size, shuffle=True, drop_last=True,
        num_workers=cfg.num_workers,
        local_rows=mesh.local_batch_slice(cfg.cam_batch_size)
        if world > 1 else None)
    # drop_last=False: the reference's validate loader keeps the tail batch
    # (step/train_cam.py:24-27)
    val_dl = loader_mod.BatchLoader(
        val_ds, cfg.cam_batch_size, shuffle=False, drop_last=False,
        num_workers=cfg.num_workers)
    max_step = (len(train_ds) // cfg.cam_batch_size) * cfg.cam_num_epoches

    model = common.init_model_variables(
        CAMNet(stop_grad_at=cfg.cam_stop_grad or None, dtype=dtype),
        cfg).to(dev)
    if cfg.calibrate_bn and not cfg.pretrained_backbone:
        # no ImageNet running statistics exist: calibrate the frozen BN
        # statistics from one real batch so a from-scratch backbone is
        # trainable (this pass advances the loader's epoch; set_epoch below
        # puts every epoch back on its own stream). Every rank calibrates
        # from the same whole first batch, so the statistics agree
        cal_dl = train_dl if world == 1 else loader_mod.BatchLoader(
            train_ds, cfg.cam_batch_size, shuffle=True, drop_last=True,
            num_workers=cfg.num_workers)
        model.calibrate_stats(_images(next(iter(cal_dl)), dev))
        print("calibrated frozen-BN statistics from one batch")

    # the reference's effective hypers: real weight decay + stray momentum
    # of the same value (misc/torchutils.py:10)
    opt = optim.poly_sgd(
        model.named_parameters(), cfg.cam_learning_rate, max_step=max_step,
        power=0.9, momentum=cfg.cam_weight_decay,
        weight_decay=cfg.cam_weight_decay,
        mult_fn=(optim.cam_lr_mult if cfg.cam_stop_grad
                 else optim.cam_lr_mult_full),
    )

    train_ckpt_path = cfg.cam_weights_name + ".train"
    start_epoch = 0
    if cfg.resume and os.path.exists(train_ckpt_path):
        start_epoch = optim.load_train_state(
            model, opt, load_checkpoint(train_ckpt_path), train_ckpt_path,
            cam_from_jax)
        print(f"resumed {train_ckpt_path} at epoch {start_epoch}")

    net = model
    if mesh.is_distributed():
        net = mesh.data_parallel(model, optim.trained_params(opt), dev,
                                 sum_gradients=False)
    step_fn = cam_train.make_train_step(net, opt)
    eval_fn = cam_train.make_eval_step(model)
    prof = StageProfiler(cfg.profile_dir if main else None, "train_cam",
                         device=dev)
    meter = DeviceMeter()
    timer = Timer()
    steps_per_epoch = len(train_dl)
    history: List[torch.Tensor] = []
    val_losses: List[float] = []
    written: List[str] = []
    t0 = time.perf_counter()
    try:
        for ep in range(start_epoch, cfg.cam_num_epoches):
            if main:
                print(f"Epoch {ep + 1}/{cfg.cam_num_epoches}")
            # pin the loader's RNG stream to the true epoch, so a resumed
            # run continues the shuffle and augmentation sequence
            train_dl.set_epoch(ep)
            for it, batch in enumerate(train_dl):
                loss = step_fn(
                    _images(batch, dev),
                    torch.from_numpy(batch["label"]).to(dev))
                # the global batch's loss: the mean of the ranks' equal
                # shares' means
                loss = mesh.all_reduce_mean(loss)
                prof.tick()
                meter.add({"loss1": loss})
                history.append(loss)
                gstep = ep * steps_per_epoch + it + 1
                if (gstep - 1) % 100 == 0:
                    loss1 = meter.pop("loss1")
                    if main:
                        timer.update_progress(gstep / max_step)
                        print(
                            f"step:{gstep - 1:5d}/{max_step:5d}",
                            f"loss:{loss1:.4f}",
                            f"imps:{(it + 1) * cfg.cam_batch_size / timer.get_stage_elapsed():.1f}",
                            f"etc:{timer.str_estimated_complete()}",
                            flush=True,
                        )
            # validation (train_cam.py:14-36), on rank 0 over its own copy
            # of the replicated model
            if main:
                val_meter = AverageMeter()
                for batch in val_dl:
                    val_meter.add({"loss": float(eval_fn(
                        _images(batch, dev),
                        torch.from_numpy(batch["label"]).to(dev)))})
                val_losses.append(val_meter.get("loss"))
                print(f"validate loss: {val_losses[-1]:.4f}")
            timer.reset_stage()
            if main:
                save_checkpoint(train_ckpt_path, optim.train_state(
                    model, opt, ep + 1, cam_to_jax))
                written.append(train_ckpt_path)
    finally:
        prof.close()
    seconds = time.perf_counter() - t0
    summary = dict(n_steps=len(history), seconds=seconds, world=world,
                   written=written)
    if main:
        model = mesh.fetch_replicated(net)
        save_checkpoint(cfg.cam_weights_name, cam_to_jax(model.state_dict()))
        written.append(cfg.cam_weights_name)
        print(f"saved {cfg.cam_weights_name}")
    mesh.process_barrier("train_cam.saved")
    if not main:
        return summary
    return dict(summary,
                losses=torch.stack(history).tolist() if history else [],
                val_losses=val_losses, start_epoch=start_epoch,
                max_step=max_step)


class CAMScalePass:
    """One scale of the multi-scale flipped CAM pass over k images of one
    size, on ``device``: normalize and pad-mask the uint8 upload, stack the
    flip pairs, the CAM forward at the true extent, flip fusion, the two
    dynamic-extent resizes (stride-4 grid in an ``s4_cap`` buffer,
    strided-up grid in an ``su_cap`` buffer, cropped to the original size)
    and the cross-scale sums. Each step is its own method so a caller can
    time it."""

    def __init__(self, model: CAMNet, device: torch.device, s4_cap: int,
                 su_cap: int):
        self.model = model
        self.device = device
        self.s4_cap = s4_cap
        self.su_cap = su_cap
        self.mean = torch.as_tensor(T.IMAGENET_MEAN, device=device)
        self.std = torch.as_tensor(T.IMAGENET_STD, device=device)

    def prep(self, img_u8: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
        """[k, ph, pw, 3] uint8 -> the normalized (images, flips) stack
        [2k, 3, ph, pw], zero beyond (sh, sw); each flip is rolled so its
        valid region starts at column 0."""
        ph, pw = img_u8.shape[1:3]
        x = (img_u8.float() / 255.0 - self.mean) / self.std
        rows = torch.arange(ph, device=self.device)[:, None] < sh
        cols = torch.arange(pw, device=self.device)[None, :] < sw
        x = torch.where((rows & cols)[None, ..., None], x, 0.0)
        flip = torch.roll(x.flip(2), -(pw - sw), dims=2)
        return torch.cat([x, flip]).permute(0, 3, 1, 2)

    def forward(self, stack: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
        """The CAM maps [2k, 20, ph/16, pw/16] of the stack."""
        return self.model.cam(stack, extent=(sh, sw))

    @staticmethod
    def fuse(maps: torch.Tensor, vw: int) -> torch.Tensor:
        """maps [2k, ...] -> [k, ...]: each image plus its flip's maps
        flipped back; valid in [0, vh) x [0, vw)."""
        k = maps.shape[0] // 2
        w16 = maps.shape[-1]
        return maps[:k] + torch.roll(maps[k:].flip(-1), -(w16 - vw), dims=-1)

    def resize(self, fused: torch.Tensor, vh: int, vw: int,
               s4: Tuple[int, int], su: Tuple[int, int],
               size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(stride-4 maps [k, 20, s4_cap, s4_cap], strided-up maps
        [k, 20, su_cap, su_cap]); the strided-up maps are cropped to the
        original size before the sums, as the reference crops high_res
        before normalizing (make_cam.py:43)."""
        s = resize_bilinear_dynamic(fused, (vh, vw), s4,
                                    (self.s4_cap, self.s4_cap))
        hr = resize_bilinear_dynamic(fused, (vh, vw), su,
                                     (self.su_cap, self.su_cap))
        hr[..., size[0]:, :] = 0.0
        hr[..., :, size[1]:] = 0.0
        return s, hr

    @torch.no_grad()
    def __call__(self, img_u8: torch.Tensor, sh: int, sw: int,
                 s4: Tuple[int, int], su: Tuple[int, int],
                 size: Tuple[int, int], s_acc: torch.Tensor,
                 h_acc: torch.Tensor) -> None:
        """Add this scale's maps into s_acc and h_acc."""
        vh, vw = -(-sh // 16), -(-sw // 16)
        maps = self.forward(self.prep(img_u8, sh, sw), sh, sw)
        s, hr = self.resize(self.fuse(maps, vw), vh, vw, s4, su, size)
        s_acc += s
        h_acc += hr


def scale_inputs(imgs: np.ndarray, scale: float,
                 pad_multiple: int) -> Tuple[np.ndarray, int, int]:
    """The k images [k, h, w, 3] uint8 at ``scale`` (PIL bicubic), padded
    to the ``pad_multiple`` bucket: (padded, sh, sw)."""
    s_imgs = imgs if scale == 1 else np.stack(
        [T.pil_rescale(im, scale, 3) for im in imgs])
    sh, sw = s_imgs.shape[1:3]
    ph, pw = round_up(sh, pad_multiple), round_up(sw, pad_multiple)
    return np.pad(s_imgs, ((0, 0), (0, ph - sh), (0, pw - sw), (0, 0))), sh, sw


def finalize(s_acc: torch.Tensor, h_acc: torch.Tensor,
             valid_cat: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image's summed maps [20, ., .] -> the present classes' maps,
    each max-normalized (+1e-5, make_cam.py:48-52)."""
    vc = torch.from_numpy(valid_cat).to(s_acc.device)
    s = s_acc[vc]
    s = s / (s.amax(dim=(1, 2), keepdim=True) + 1e-5)
    h = h_acc[vc]
    h = h / (h.amax(dim=(1, 2), keepdim=True) + 1e-5)
    return s, h


def save_cam(out_path: str, valid_cat: np.ndarray, s: torch.Tensor,
             h: torch.Tensor, s4: Tuple[int, int],
             size: Tuple[int, int]) -> None:
    """The npy dict of make_cam: keys, the stride-4 maps at (s4h, s4w) and
    the high-res maps at the original size."""
    np.save(out_path, {
        "keys": valid_cat,
        "cam": s[:, : s4[0], : s4[1]].cpu().numpy(),
        "high_res": h[:, : size[0], : size[1]].cpu().numpy(),
    })


def load_cam_net(cfg: Config, device: torch.device,
                 state: Optional[Dict] = None) -> CAMNet:
    """CAMNet on ``device`` from ``cfg``'s checkpoint (``state``: its torch
    state dict, read once for several devices)."""
    model = CAMNet(dtype=common.model_dtype(cfg))
    model.load_state_dict(state if state is not None else cam_from_jax(
        load_checkpoint(cfg.cam_weights_name)))
    return model.to(device).eval()


def group_by_size(cfg: Config, ds: voc12.ImageDataset):
    """{(h, w): [(index, out_path)]} of the images still to do (header-only
    PIL reads), in list order."""
    from PIL import Image

    groups: Dict[Tuple[int, int], list] = {}
    for i, name in enumerate(ds.img_name_list):
        out_path = os.path.join(cfg.cam_out_dir, name + ".npy")
        if not cfg.overwrite and os.path.exists(out_path):
            continue
        with Image.open(voc12.get_img_path(name, cfg.voc12_root)) as im:
            w, h = im.size
        groups.setdefault((h, w), []).append((i, out_path))
    return groups


def cam_chunks(cfg: Config, ds) -> List[Tuple]:
    """make_cam's work: per size group (list order), its chunks of up to
    ``cam_infer_batch`` images, each (size, s4, su, [(index, out_path)])."""
    batch_cap = max(1, cfg.cam_infer_batch)
    chunks = []
    for size, items in group_by_size(cfg, ds).items():
        s4 = T.get_strided_size(size, 4)
        su = T.get_strided_up_size(size, 16)
        if s4[0] > cfg.rw_grid_cap or s4[1] > cfg.rw_grid_cap:
            raise ValueError(
                f"{len(items)} image(s) of size {size} exceed the "
                f"rw_grid_cap={cfg.rw_grid_cap} stride-4 grid "
                f"({cfg.rw_grid_cap * 4}px); raise --rw_grid_cap")
        pos = 0
        for k in _chunk_sizes(len(items), batch_cap):
            chunks.append((size, s4, su, items[pos:pos + k]))
            pos += k
    return chunks


def make_cam(cfg: Config, device="cuda",
             devices: Optional[List] = None) -> Dict:
    """Multi-scale flipped CAM inference (step/make_cam.py). In a process
    group each rank takes a strided share of the chunks (each chunk the
    one-process run's batch); within the process, chunks go round-robin to
    the workers of ``common.DeviceSpreader`` (``--infer_devices`` cards, or
    ``devices``). Returns a summary: images written, the seconds the image
    loop took (after the model load; every npy written) and the chunks
    each worker took."""
    common.model_dtype(cfg)
    dev = resolve_device(device)
    common.pin_numerics()
    ds = voc12.ClassificationDataset(cfg.infer_list, cfg.voc12_root,
                                     _label_dict(cfg), img_normal=False)
    state = cam_from_jax(load_checkpoint(cfg.cam_weights_name))
    os.makedirs(cfg.cam_out_dir, exist_ok=True)
    n = len(ds)
    spread = common.make_spreader(dev, cfg.infer_devices, devices)

    def setup(d):
        return dict(scale_pass=CAMScalePass(load_cam_net(cfg, d, state), d,
                                            cfg.rw_grid_cap,
                                            4 * cfg.rw_grid_cap),
                    n_done=0)

    def work(ctx, c, chunk):
        size, s4, su, items = chunk
        scale_pass = ctx["scale_pass"]
        d = scale_pass.device
        k = len(items)
        samples = [ds[i] for i, _ in items]
        imgs = np.stack([s_["img"] for s_ in samples]).astype(np.uint8)
        s_acc = torch.zeros((k, N_CLS, scale_pass.s4_cap,
                             scale_pass.s4_cap), device=d)
        h_acc = torch.zeros((k, N_CLS, scale_pass.su_cap,
                             scale_pass.su_cap), device=d)
        for scale in cfg.cam_scales:
            padded, sh, sw = scale_inputs(imgs, scale, cfg.pad_multiple)
            scale_pass(torch.from_numpy(padded).to(d), sh, sw, s4, su,
                       size, s_acc, h_acc)
        for j, ((i, out_path), sample) in enumerate(zip(items, samples)):
            valid_cat = np.nonzero(np.asarray(sample["label"]))[0]
            s, h = finalize(s_acc[j], h_acc[j], valid_cat)
            save_cam(out_path, valid_cat, s, h, s4, size)
            ctx["n_done"] += 1
            if i % max(n // 20, 1) == 0:
                print(f"make_cam {i}/{n}", flush=True)

    spread.setup(setup)
    t0 = time.perf_counter()
    chunks = common.shard_blocks(cam_chunks(cfg, ds), "make_cam")
    ctxs = spread.run(chunks, work)
    return {"n_images": sum(c["n_done"] for c in ctxs),
            "seconds": time.perf_counter() - t0,
            "assigned": spread.taken()}


def eval_cam(cfg: Config, device=None, sweep: bool = False) -> Dict:
    """CAM seed quality at ``cam_eval_thres`` (step/eval_cam.py), a host
    computation (``device`` is accepted for the uniform stage signature and
    unused). With ``sweep=True`` also the mIoU over a background-threshold
    grid."""
    names = voc12.load_img_name_list(cfg.infer_list)
    thresholds = [cfg.cam_eval_thres]
    grid = [round(0.05 * k, 2) for k in range(1, 10)] if sweep else []
    thresholds += [t for t in grid if t not in thresholds]
    confs = {t: np.zeros((21, 21), np.int64) for t in thresholds}
    for name in names:
        d = np.load(os.path.join(cfg.cam_out_dir, name + ".npy"),
                    allow_pickle=True).item()
        gt = image_io.imread(os.path.join(cfg.voc12_root, "SegmentationClass",
                                          name + ".png"))
        keys = np.asarray(d["keys"])
        for t in thresholds:
            pred = stages_eval.decode_cam_to_labels(d["high_res"], keys, t)
            stages_eval.accumulate_confusion(confs[t], pred, gt)

    scores = stages_eval.scores_from_confusion(confs[cfg.cam_eval_thres])
    print({"iou": scores["iou"], "miou": scores["miou"]})
    if sweep:
        sweep_scores = {
            t: stages_eval.scores_from_confusion(confs[t])["miou"]
            for t in grid
        }
        best = max(sweep_scores, key=sweep_scores.get)
        print("threshold sweep:", sweep_scores)
        print(f"best cam_eval_thres: {best} (miou {sweep_scores[best]:.4f})")
        scores["sweep"] = sweep_scores
    return scores


def resolve_crf_backend(cfg: Config, device: torch.device) -> str:
    """'native' (the host lattice) or 'tpu' (the device landmark CRF; the
    flag keeps the JAX package's name): 'auto' is the device CRF on CUDA
    and the lattice on the CPU."""
    if cfg.crf_backend == "auto":
        return "tpu" if torch.device(device).type == "cuda" else "native"
    if cfg.crf_backend not in ("native", "tpu"):
        raise ValueError(f"crf_backend {cfg.crf_backend!r}: auto | native "
                         "| tpu")
    return cfg.crf_backend


def confident_maps(cams: np.ndarray, fg_thres: float,
                   bg_thres: float) -> Tuple[np.ndarray, np.ndarray]:
    """The fg / bg confident label maps of the high-res CAMs [K, H, W]:
    argmax with a background plane at each threshold
    (cam_to_ir_label.py:26-34)."""
    def decode(thres):
        return np.argmax(np.pad(cams, ((1, 0), (0, 0), (0, 0)),
                                constant_values=thres), axis=0).astype(np.int32)

    return decode(fg_thres), decode(bg_thres)


def combine_conf(fg_conf: np.ndarray, bg_conf: np.ndarray) -> np.ndarray:
    """255 = ignore where fg is background, 0 = joint background
    (cam_to_ir_label.py:36-39)."""
    conf_map = fg_conf.copy()
    conf_map[fg_conf == 0] = 255
    conf_map[bg_conf + fg_conf == 0] = 0
    return conf_map.astype(np.uint8)


def cam_to_ir_label(cfg: Config, device="cuda") -> Dict:
    """CAM -> confident inter-pixel relation seeds through a dense CRF
    (step/cam_to_ir_label.py). ``native``: the host lattice, whose calls
    release the GIL, over a thread pool (the OpenMP threads of each call
    split the cores with the pool). ``tpu``: the landmark CRF on
    ``device``, the pool's threads then overlapping the host's decode,
    argmax and PNG write with the device. Returns a summary: images written,
    the loop's seconds, the backend and the device CRF's kernel store."""
    from irn_tpu_torch.ops import crf
    from irn_tpu_torch.ops import native as native_mod
    from irn_tpu_torch.ops.crf_device import LandmarkCRF

    dev = resolve_device(device)
    common.pin_numerics()
    backend = resolve_crf_backend(cfg, dev)
    ds = voc12.ImageDataset(cfg.infer_list, cfg.voc12_root, img_normal=False)
    os.makedirs(cfg.ir_label_out_dir, exist_ok=True)
    n = len(ds)
    n_pool = max(1, cfg.num_workers)
    threads = torch.get_num_threads()
    if backend == "tpu":
        refine = LandmarkCRF(
            stride=cfg.crf_landmark_stride, t=cfg.crf_iters,
            pad_multiple=cfg.pad_multiple,
            kernel_store=cfg.crf_kernel_store, device=dev,
        ).pair
    else:
        refine = functools.partial(crf.crf_inference_label_pair,
                                   t=cfg.crf_iters)
        # the lattice's OpenMP threads are the process's own count, which
        # torch's intra-op threads share (one libgomp): the caller's count
        # comes back when the stage ends
        native_mod.set_num_threads(max(1, (os.cpu_count() or 1) // n_pool))

    def work(i: int) -> int:
        # the skip comes before the decode: resuming a partial run pays no
        # JPEG decode per finished image
        name = ds.img_name_list[i]
        out_path = os.path.join(cfg.ir_label_out_dir, name + ".png")
        if not cfg.overwrite and os.path.exists(out_path):
            return 0
        img = ds[i]["img"].astype(np.uint8)
        cam_dict = np.load(os.path.join(cfg.cam_out_dir, name + ".npy"),
                           allow_pickle=True).item()
        keys = np.pad(np.asarray(cam_dict["keys"]) + 1, (1, 0),
                      mode="constant")
        fg_map, bg_map = confident_maps(cam_dict["high_res"],
                                        cfg.conf_fg_thres, cfg.conf_bg_thres)
        fg_pred, bg_pred = refine(img, fg_map, bg_map,
                                  n_labels=keys.shape[0],
                                  gt_prob=cfg.crf_gt_prob)
        image_io.imwrite(out_path, combine_conf(keys[fg_pred], keys[bg_pred]))
        if i % max(n // 20, 1) == 0:
            print(f"cam_to_ir_label {i}/{n}", flush=True)
        return 1

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=n_pool) as pool:
            done = sum(pool.map(work, common.host_shard_range(n)))
    finally:
        torch.set_num_threads(threads)
    return {"n_images": done, "seconds": time.perf_counter() - t0,
            "backend": backend,
            "kernel_store": cfg.crf_kernel_store if backend == "tpu" else None}
