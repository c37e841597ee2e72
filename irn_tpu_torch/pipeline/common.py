"""Model initialisation shared by the port's train stages — the
counterpart of ``irn_tpu.pipeline.common``'s ``load_backbone_variables``
and ``init_model_variables``."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from irn_tpu_torch.models.irn import init_irnet
from irn_tpu_torch.pipeline.config import Config
from irn_tpu_torch.utils import checkpoint as ckpt
from irn_tpu_torch.utils import weights as W

INIT_SEED = 0


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
