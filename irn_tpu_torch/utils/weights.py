"""Weights between the two frameworks' layouts, in both directions.

:func:`irn_from_jax` and :func:`cam_from_jax` map JAX variable pytrees
(IRNet, CAMNet) to torch state dicts: the inverse of
``irn_tpu.utils.weights``; :func:`cam_to_jax` maps a CAMNet state dict
back. :func:`convert_irn_net` is the port's
own copy of that module's numpy-only converter (a torch state dict -> the
JAX variables: OIHW conv kernels become HWIO, BN running statistics the
``stats`` collection, affine weight/bias ``scale``/``bias``), which
:func:`irn_to_jax` uses to write a checkpoint the JAX package reads.

HWIO conv kernels become OIHW; ``stats`` mean/var become the frozen-BN
buffers; ``scale``/``bias`` become ``weight``/``bias``; ConvGN blocks
become Sequential(conv, GN) indices; ``fc_dp7a``/``fc_dp7b`` become
``fc_dp7.0/.1/.3``; ``dp_mean`` becomes ``mean_shift.running_mean``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

BLOCKS = (3, 4, 6, 3)
_IRN_GN = (
    "fc_edge1", "fc_edge2", "fc_edge3", "fc_edge4", "fc_edge5",
    "fc_dp1", "fc_dp2", "fc_dp3", "fc_dp4", "fc_dp5", "fc_dp6",
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _kernel(k) -> torch.Tensor:
    return _t(np.asarray(k).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _bn(sd: Dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[prefix + ".weight"] = _t(params["scale"])
    sd[prefix + ".bias"] = _t(params["bias"])
    sd[prefix + ".running_mean"] = _t(stats["mean"])
    sd[prefix + ".running_var"] = _t(stats["var"])


def resnet50_from_jax(params: Mapping, stats: Mapping,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """ResNet50 ``params``/``stats`` subtrees -> torch ResNet50 keys."""
    sd: Dict[str, torch.Tensor] = {}
    sd[prefix + "conv1.weight"] = _kernel(params["conv1"]["kernel"])
    _bn(sd, prefix + "bn1", params["bn1"], stats["bn1"])
    for li in range(4):
        for bi in range(BLOCKS[li]):
            src = f"layer{li + 1}_{bi}"
            dst = f"{prefix}layer{li + 1}.{bi}"
            bp, bs = params[src], stats[src]
            for ci in (1, 2, 3):
                sd[f"{dst}.conv{ci}.weight"] = _kernel(bp[f"conv{ci}"]["kernel"])
                _bn(sd, f"{dst}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            if "down_conv" in bp:
                sd[f"{dst}.downsample.0.weight"] = _kernel(
                    bp["down_conv"]["kernel"])
                _bn(sd, f"{dst}.downsample.1", bp["down_bn"], bs["down_bn"])
    return sd


def _convgn(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".0.weight"] = _kernel(p["conv"]["kernel"])
    sd[prefix + ".1.weight"] = _t(p["gn"]["scale"])
    sd[prefix + ".1.bias"] = _t(p["gn"]["bias"])


def irn_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """IRNet variables ``{'params', 'stats'}`` (a JAX checkpoint) -> the
    state dict of :class:`irn_tpu_torch.models.irn.IRNet`."""
    params, stats = variables["params"], variables["stats"]
    sd = resnet50_from_jax(params["resnet50"], stats["resnet50"],
                           prefix="resnet50.")
    for name in _IRN_GN:
        _convgn(sd, name, params[name])
    sd["fc_edge6.weight"] = _kernel(params["fc_edge6"]["kernel"])
    sd["fc_edge6.bias"] = _t(params["fc_edge6"]["bias"])
    _convgn(sd, "fc_dp7", params["fc_dp7a"])
    sd["fc_dp7.3.weight"] = _kernel(params["fc_dp7b"]["kernel"])
    sd["mean_shift.running_mean"] = _t(stats["dp_mean"])
    return sd


# -- torch state dict -> JAX variables (irn_tpu.utils.weights) -------------

def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _conv_kernel(t) -> np.ndarray:
    return _np(t).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _bn_to_jax(sd: Mapping, prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": _np(sd[prefix + ".weight"]),
              "bias": _np(sd[prefix + ".bias"])}
    stats = {"mean": _np(sd[prefix + ".running_mean"]),
             "var": _np(sd[prefix + ".running_var"])}
    return params, stats


def convert_resnet50(sd: Mapping, prefix: str = "") -> Dict:
    """torch ResNet-50 state dict -> ``{'params': ..., 'stats': ...}`` in
    the layout of ``irn_tpu.models.resnet.ResNet50``. ``fc.*`` entries, if
    present, are ignored."""
    p: Dict = {}
    s: Dict = {}
    p["conv1"] = {"kernel": _conv_kernel(sd[prefix + "conv1.weight"])}
    p["bn1"], s["bn1"] = _bn_to_jax(sd, prefix + "bn1")
    for li in range(4):
        for bi in range(BLOCKS[li]):
            tsrc = f"{prefix}layer{li + 1}.{bi}"
            name = f"layer{li + 1}_{bi}"
            bp: Dict = {}
            bs: Dict = {}
            for ci in (1, 2, 3):
                bp[f"conv{ci}"] = {
                    "kernel": _conv_kernel(sd[f"{tsrc}.conv{ci}.weight"])
                }
                bp[f"bn{ci}"], bs[f"bn{ci}"] = _bn_to_jax(sd, f"{tsrc}.bn{ci}")
            if f"{tsrc}.downsample.0.weight" in sd:
                bp["down_conv"] = {
                    "kernel": _conv_kernel(sd[f"{tsrc}.downsample.0.weight"])
                }
                bp["down_bn"], bs["down_bn"] = _bn_to_jax(
                    sd, f"{tsrc}.downsample.1")
            p[name] = bp
            s[name] = bs
    return {"params": p, "stats": s}


def _convgn_to_jax(sd: Mapping, prefix: str) -> Dict:
    """torch Sequential(conv, GroupNorm, ...) -> ConvGN params."""
    return {
        "conv": {"kernel": _conv_kernel(sd[prefix + ".0.weight"])},
        "gn": {"scale": _np(sd[prefix + ".1.weight"]),
               "bias": _np(sd[prefix + ".1.bias"])},
    }


def convert_irn_net(sd: Mapping) -> Dict:
    """IRN state dict (the reference's net/resnet50_irn.py names) -> IRNet
    variables. Extra buffers of the training wrapper are ignored; a missing
    ``mean_shift.running_mean`` becomes zeros."""
    backbone = convert_resnet50(sd, prefix="resnet50.")
    params: Dict = {"resnet50": backbone["params"]}
    for name in _IRN_GN:
        params[name] = _convgn_to_jax(sd, name)
    params["fc_edge6"] = {
        "kernel": _conv_kernel(sd["fc_edge6.weight"]),
        "bias": _np(sd["fc_edge6.bias"]),
    }
    # fc_dp7 = Sequential(conv, GN, ReLU, conv2ch, mean_shift)
    params["fc_dp7a"] = _convgn_to_jax(sd, "fc_dp7")
    params["fc_dp7b"] = {"kernel": _conv_kernel(sd["fc_dp7.3.weight"])}
    stats = {
        "resnet50": backbone["stats"],
        "dp_mean": _np(sd["mean_shift.running_mean"])
        if "mean_shift.running_mean" in sd
        else np.zeros((2,), np.float32),
    }
    return {"params": params, "stats": stats}


def irn_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's IRNet state dict -> JAX variables (a JAX checkpoint)."""
    return convert_irn_net(
        {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    )


# -- CAMNet ----------------------------------------------------------------

def cam_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """CAMNet variables ``{'params', 'stats'}`` (a JAX checkpoint of
    ``irn_tpu.models.cam.CAMNet``) -> the state dict of
    :class:`irn_tpu_torch.models.cam.CAMNet`."""
    params, stats = variables["params"], variables["stats"]
    sd = resnet50_from_jax(params["resnet50"], stats["resnet50"],
                           prefix="resnet50.")
    sd["classifier.weight"] = _kernel(params["classifier"]["kernel"])
    return sd


def cam_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's CAMNet state dict -> JAX variables (the inverse of
    :func:`cam_from_jax`), a checkpoint the JAX package reads."""
    backbone = convert_resnet50(state_dict, prefix="resnet50.")
    return {
        "params": {
            "resnet50": backbone["params"],
            "classifier": {
                "kernel": _conv_kernel(state_dict["classifier.weight"])},
        },
        "stats": {"resnet50": backbone["stats"]},
    }
