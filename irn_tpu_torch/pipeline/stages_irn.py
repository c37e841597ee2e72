"""make_sem_seg on PyTorch — the counterpart of the make_sem_seg part of
:mod:`irn_tpu.pipeline.stages_irn` (split flow).

Per image: the EdgeDisplacement forward over the padded (image, flip) pair,
the random walk at the image's grid bucket through the hand kernels
(:mod:`irn_tpu_torch.ops.random_walk`), the x4 decode, and a uint8 PNG in
``sem_seg_out_dir`` — the artifact layout of step/make_sem_seg_labels.py.
The device is explicit: nothing moves to the CPU because no card was
found.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from irn_tpu_torch.data import image_io
from irn_tpu_torch.data import voc12
from irn_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from irn_tpu_torch.models.irn import IRNet
from irn_tpu_torch.ops import random_walk as rw_mod
from irn_tpu_torch.pipeline.config import Config
from irn_tpu_torch.utils.checkpoint import load_checkpoint
from irn_tpu_torch.utils.weights import irn_from_jax


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
    something else."""
    if cfg.rw_mesh_model > 1:
        raise NotImplementedError(
            "rw_mesh_model > 1: multi-GPU random walk is ROADMAP queue 1 "
            "item 10 (Multi-GPU)"
        )
    if cfg.rw_matmul_dtype != "float32":
        raise NotImplementedError(
            f"rw_matmul_dtype={cfg.rw_matmul_dtype!r}: bf16 operand modes "
            "for K2/K3 are later work (ROADMAP queue 2)"
        )
    if cfg.model_dtype != "float32":
        raise NotImplementedError(
            f"model_dtype={cfg.model_dtype!r}: only float32 is ported"
        )
    if cfg.sem_monolith:
        raise NotImplementedError(
            "sem_monolith: the relay-transport monolith is not ported "
            "(ROADMAP queue 1, 'Not ported')"
        )


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


def _mode(sq: int, banded: bool) -> str:
    if banded:
        return "diag" if sq == 0 else "banded"
    return "dense"


class RandomWalkRunner:
    """Bucketed walk + decode. Grids round up to ``BUCKET`` cells (capped at
    ``rw_grid_cap``); seed rows pad to a power-of-two bucket from
    ``ROW_BUCKET``, capped at ``n_seed_rows``."""

    BUCKET = 32
    ROW_BUCKET = 8

    def __init__(self, cfg: Config, n_seed_rows: int, device: torch.device):
        self.device = device
        self.cap = cfg.rw_grid_cap
        self.radius = cfg.rw_radius
        self.beta = cfg.beta
        self.exp_times = cfg.exp_times
        self.n_rows = n_seed_rows
        self.square_times_cfg = cfg.rw_square_times
        self.banded_cfg = cfg.rw_banded
        self.modes: Dict[Tuple[int, int], str] = {}

    def _square_times(self, geom) -> int:
        if self.square_times_cfg >= 0:
            return min(self.square_times_cfg, self.exp_times)
        return rw_mod.pick_square_times(geom.n_pad, self.exp_times)

    def _use_banded(self, geom, sq: int) -> bool:
        """The hand-kernel routes (stencil or banded) on every device: on
        the CPU they run through the kernels' plain twins."""
        return self.banded_cfg and rw_mod.banded_fits(geom, self.exp_times, sq)

    def _resolve(self, geom) -> Tuple[int, bool]:
        """(square_times, banded): the banded split (e = 0) when its band
        fits, else the pinned or cost-model split."""
        if self.square_times_cfg < 0:
            sqb = rw_mod.pick_square_times_banded(self.exp_times)
            if self._use_banded(geom, sqb):
                return sqb, True
        sq = self._square_times(geom)
        return sq, self._use_banded(geom, sq)

    def resolve_mode(self, cap_h: int, cap_w: int) -> str:
        """``diag`` (K0 stencil) | ``banded`` (K2 + K1 + K3) | ``dense``."""
        geom = rw_mod.build_geometry(cap_h, cap_w, radius=self.radius)
        return _mode(*self._resolve(geom))

    def _bucket(self, x: int) -> int:
        b = ((x + self.BUCKET - 1) // self.BUCKET) * self.BUCKET
        return min(b, self.cap)

    def _row_bucket(self, k: int) -> int:
        b = self.ROW_BUCKET
        while b < min(k, self.n_rows):
            b *= 2
        return min(b, self.n_rows)

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
        edge_b = edge[:ch, :cw]
        geom = rw_mod.build_geometry(ch, cw, radius=self.radius)
        sq, banded = self._resolve(geom)
        self.modes[(ch, cw)] = _mode(sq, banded)
        if banded:
            rw = rw_mod.propagate_banded(geom, cam_t, edge_b, self.beta,
                                         self.exp_times, square_times=sq)
        else:
            rw = rw_mod.propagate(geom, cam_t, edge_b, self.beta,
                                  self.exp_times, square_times=sq)
        labels, _, _ = rw_mod.upsample_and_decode(
            rw, h4, w4, size[0], size[1], bg_thres
        )
        return labels


def _load_irn(cfg: Config, device: torch.device) -> EdgeDisplacementRunner:
    model = IRNet()
    model.load_state_dict(irn_from_jax(load_checkpoint(cfg.irn_weights_name)))
    return EdgeDisplacementRunner(cfg, model, device)


def _load_sem_cam(cfg: Config, name: str):
    cam_dict = np.load(os.path.join(cfg.cam_out_dir, name + ".npy"),
                       allow_pickle=True).item()
    cams = np.asarray(cam_dict["cam"], np.float32)  # [K, h4, w4]
    keys = np.pad(np.asarray(cam_dict["keys"]) + 1, (1, 0), mode="constant")
    return cams, keys


def make_sem_seg_labels(cfg: Config, device="cuda") -> Dict:
    """Random-walk pseudo semantic masks (step/make_sem_seg_labels.py).

    Returns a summary: images written, the seconds the image loop took
    (after the model load; every PNG written), the walk mode per grid
    bucket, and the mean and saturated fraction (< 1e-3 or > 1 - 1e-3) of
    the edge map inside each image's extent."""
    check_slice_flags(cfg)
    dev = resolve_device(device)
    # the reference's numerics are f32: a TF32 conv or matmul is not
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    runner = _load_irn(cfg, dev)
    walker = RandomWalkRunner(cfg, n_seed_rows=20, device=dev)
    ds = voc12.ImageDataset(cfg.infer_list, cfg.voc12_root)
    os.makedirs(cfg.sem_seg_out_dir, exist_ok=True)
    n = len(ds)
    todo = [
        i for i in range(n)
        if cfg.overwrite or not os.path.exists(
            os.path.join(cfg.sem_seg_out_dir, ds.img_name_list[i] + ".png"))
    ]
    edge_sum = torch.zeros((), dtype=torch.float64, device=dev)
    edge_sat = torch.zeros((), dtype=torch.float64, device=dev)
    edge_cells = 0
    pending = deque()  # (i, out_path, size, keys, labels on device)

    def finish(item):
        i, out_path, size, keys, labels = item
        pred = labels.cpu().numpy()[: size[0], : size[1]]
        image_io.imwrite(out_path, keys[pred].astype(np.uint8))
        if i % max(n // 20, 1) == 0:
            print(f"make_sem_seg {i}/{n}", flush=True)

    bsz = runner.batch_size
    t0 = time.perf_counter()
    for c0 in range(0, len(todo), bsz):
        block = todo[c0 : c0 + bsz]
        samples = [ds[i] for i in block]
        imgs = [s["img"].astype(np.uint8) for s in samples]
        sizes = [im.shape[:2] for im in imgs]
        for i, sample, size, (edge, _, (h4, w4)) in zip(
            block, samples, sizes, runner.batch(imgs, sizes)
        ):
            inside = edge[:h4, :w4].double()
            edge_sum += inside.sum()
            edge_sat += ((inside < 1e-3) | (inside > 1 - 1e-3)).sum()
            edge_cells += h4 * w4
            cams, keys = _load_sem_cam(cfg, sample["name"])
            labels = walker(cams, edge, h4, w4, size, cfg.sem_seg_bg_thres)
            out_path = os.path.join(cfg.sem_seg_out_dir,
                                    sample["name"] + ".png")
            pending.append((i, out_path, size, keys, labels))
            # the host writes image i-1 while the device walks image i
            while len(pending) > 1:
                finish(pending.popleft())
    while pending:
        finish(pending.popleft())
    seconds = time.perf_counter() - t0
    cells = max(edge_cells, 1)
    return {
        "n_images": len(todo),
        "seconds": seconds,
        "modes": {f"{h}x{w}": m for (h, w), m in sorted(walker.modes.items())},
        "edge_mean": float(edge_sum.item()) / cells,
        "edge_saturated": float(edge_sat.item()) / cells,
    }
