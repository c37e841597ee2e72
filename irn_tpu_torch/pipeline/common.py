"""Model initialisation shared by the port's stages — the counterpart of
``irn_tpu.pipeline.common``'s ``load_backbone_variables`` and
``init_model_variables`` — and the numerics every model stage pins."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from irn_tpu_torch.models.irn import init_irnet
from irn_tpu_torch.pipeline.config import Config
from irn_tpu_torch.utils import checkpoint as ckpt
from irn_tpu_torch.utils import weights as W

INIT_SEED = 0

# --model_dtype values the port runs, as torch dtypes
MODEL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg: Config) -> torch.dtype:
    """The backbone's compute dtype of ``cfg.model_dtype`` (the JAX stages'
    ``jnp.dtype(cfg.model_dtype)``); any other value than the two ported
    raises (ROADMAP queue 1: ``float16`` is refused)."""
    if cfg.model_dtype not in MODEL_DTYPES:
        raise NotImplementedError(
            f"model_dtype={cfg.model_dtype!r}: the port runs "
            f"{' and '.join(map(repr, MODEL_DTYPES))}")
    return MODEL_DTYPES[cfg.model_dtype]


def pin_numerics() -> None:
    """The reference's convolutions and products accumulate in f32: no TF32
    convolution or matmul, and no cuBLAS reduction in bf16 (a bf16
    backbone's convolutions are cuDNN's bf16 kernels, which accumulate in
    f32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def load_backbone_variables(cfg: Config) -> Optional[Dict]:
    """Pretrained ResNet-50 variables (``{'params', 'stats'}``, the JAX
    layout) from cfg.pretrained_backbone: a torch ``.pth`` state dict is
    converted, anything else read as a numpy pickle. None when unset."""
    path = cfg.pretrained_backbone
    if not path:
        return None
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return W.convert_resnet50(sd)
    return ckpt.load_checkpoint(path)


def init_model_variables(model: torch.nn.Module, cfg: Config,
                         generator: Optional[torch.Generator] = None,
                         backbone_key: str = "resnet50") -> torch.nn.Module:
    """Seeded random init (``generator``, default seed 0), then the
    pretrained backbone grafted in; warns when none is configured."""
    init_irnet(model, generator or torch.Generator().manual_seed(INIT_SEED))
    pretrained = load_backbone_variables(cfg)
    if pretrained is not None:
        sd = W.resnet50_from_jax(pretrained["params"], pretrained["stats"],
                                 prefix=backbone_key + ".")
        result = model.load_state_dict(sd, strict=False)
        missing = [k for k in result.missing_keys
                   if k.startswith(backbone_key + ".")]
        if missing or result.unexpected_keys:
            raise ValueError(f"{cfg.pretrained_backbone}: backbone keys "
                             f"missing {missing[:4]}, unexpected "
                             f"{result.unexpected_keys[:4]}")
    else:
        print(
            "WARNING: no pretrained_backbone configured - the backbone is "
            "randomly initialized; pseudo-label quality will not match the "
            "reference (which always starts from ImageNet weights, "
            "net/resnet50.py:115)."
        )
    return model
