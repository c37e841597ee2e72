"""Typed pipeline configuration: the port's own copy of
``irn_tpu.pipeline.config.Config``, with the same fields, defaults and
:meth:`Config.resolve`, so that the port imports nothing of the JAX package
and the two CLIs take the same flags. The JAX module's comments on each
field (their history and measurements on the TPU) stay there; here each
field says what it sets.

Left out: the JAX class's two JAX-only helpers, ``resolved_crf_backend``
and ``rw_matmul_jnp_dtype``. The cam_to_ir_label stage resolves
``crf_backend`` by the device it runs on
(:func:`irn_tpu_torch.pipeline.stages_cam.resolve_crf_backend`): ``'auto'``
is the device landmark CRF on CUDA and the native lattice on the CPU;
``'tpu'`` keeps the JAX package's name for the device CRF.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass
class Config:
    # environment
    voc12_root: str = ""
    num_workers: int = 4

    # dataset
    train_list: str = "voc12/train_aug.txt"
    val_list: str = "voc12/val.txt"
    infer_list: str = "voc12/train.txt"
    cls_labels_path: str = ""  # default: <voc12_root>/cls_labels.npy
    eval_set: str = "train"

    # CAM
    cam_crop_size: int = 512
    cam_batch_size: int = 16
    cam_num_epoches: int = 5
    cam_learning_rate: float = 0.1
    cam_weight_decay: float = 1e-4
    cam_eval_thres: float = 0.15
    cam_scales: Tuple[float, ...] = (1.0, 0.5, 1.5, 2.0)

    # IR seeds
    conf_fg_thres: float = 0.30
    conf_bg_thres: float = 0.05
    crf_iters: int = 10
    crf_gt_prob: float = 0.7
    crf_backend: str = "auto"             # 'auto' | 'native' (host lattice)
                                          # | 'tpu' (device landmark CRF)
    crf_landmark_stride: int = 4          # device CRF: landmark stride
    crf_kernel_store: str = "int8"        # device CRF: 'int8' | 'dense'

    # IRNet
    irn_crop_size: int = 512
    irn_batch_size: int = 32
    irn_num_epoches: int = 3
    irn_learning_rate: float = 0.1
    irn_weight_decay: float = 1e-4
    path_radius: int = 10

    # random walk
    beta: int = 10
    exp_times: int = 8
    sem_seg_bg_thres: float = 0.25
    ins_seg_bg_thres: float = 0.25
    rw_radius: int = 5

    # output paths
    log_name: str = "sample_train_eval"
    session_dir: str = "sess"
    cam_weights_name: str = "sess/res50_cam.ckpt"
    irn_weights_name: str = "sess/res50_irn.ckpt"
    cam_out_dir: str = "result/cam"
    ir_label_out_dir: str = "result/ir_label"
    sem_seg_out_dir: str = "result/sem_seg"
    ins_seg_out_dir: str = "result/ins_seg"
    coco_ann_path: str = "result/voc2012_train_custom.json"
    coco_seg_format: str = "polygon"      # 'polygon' | 'rle'

    # device knobs (names kept from the JAX package)
    pretrained_backbone: str = ""
    cam_stop_grad: str = "c3"             # "" trains the full backbone
    calibrate_bn: bool = True             # calibrate BN stats when training
                                          # without pretrained weights
    model_dtype: str = "float32"          # backbone compute dtype
    rw_matmul_dtype: str = "float32"      # 'float32' | 'bfloat16'
    rw_banded: bool = True                # banded transition kernels
    rw_square_times: int = -1             # squarings before the thin seed
                                          # applications; -1 = cost model,
                                          # exp_times = pure squaring
    rw_grid_cap: int = 128                # stride-4 cells (=512px images)
    ins_seed_cap: int = 128               # seed rows per walk chunk
    sem_monolith: bool = False            # one fused program per image
    ins_device_ccl: bool = True           # instance clustering on the device
    ins_cluster_cap: int = 8              # device mask rows per class
    ins_comp_cap: int = 128               # device component split capacity
    pad_multiple: int = 64                # inference shape bucketing
    cam_infer_batch: int = 32             # make_cam images per scale pass
    edge_infer_batch: int = 1             # images per EdgeDisplacement pass
    compile_cache_dir: str = ""
    overwrite: bool = False               # rerun stages over existing outputs
    mesh_data: int = 0                    # 0 = all devices
    infer_devices: int = 0                # devices for the per-image stages
    rw_mesh_model: int = 1                # devices sharing one walk's T
    profile_dir: str = ""
    resume: bool = True                   # resume training from epoch ckpts

    # multi-process group
    dist_initialize: bool = False
    dist_coordinator: str = ""            # "host:port" of process 0
    dist_num_processes: int = 0           # total processes (0 = auto)
    dist_process_id: int = -1             # this process (-1 = auto)

    # stage switches
    train_cam_pass: bool = False
    make_cam_pass: bool = False
    eval_cam_pass: bool = False
    cam_to_ir_label_pass: bool = False
    train_irn_pass: bool = False
    make_sem_seg_pass: bool = False
    eval_sem_seg_pass: bool = False
    make_ins_seg_pass: bool = False
    eval_ins_seg_pass: bool = False
    make_cocoann_pass: bool = False

    def resolve(self) -> "Config":
        def in_repo(rel: str) -> str:
            """Fall back to the repo checkout for the shipped voc12/ split
            lists when ``rel`` does not exist relative to the working
            directory."""
            if rel and not os.path.exists(rel) and not os.path.isabs(rel):
                cand = os.path.join(
                    os.path.dirname(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__)))), rel)
                if os.path.exists(cand):
                    return cand
            return rel

        self.train_list = in_repo(self.train_list)
        self.val_list = in_repo(self.val_list)
        self.infer_list = in_repo(self.infer_list)
        if not self.cls_labels_path:
            at_root = os.path.join(self.voc12_root, "cls_labels.npy")
            self.cls_labels_path = (
                at_root if os.path.exists(at_root)
                else in_repo(os.path.join("voc12", "cls_labels.npy"))
            )
        return self
