"""Poly-decay SGD with per-group LR multipliers — the counterpart of
``irn_tpu.train.optim``'s ``poly_schedule``, ``poly_sgd``, ``irn_lr_mult``,
``cam_lr_mult`` and ``cam_lr_mult_full``, on ``torch.optim.SGD`` param
groups.

The reference's effective hyper-parameters (misc/torchutils.py:9-31,
step/train_irn.py:33-36, step/train_cam.py:57-59, pinned by the JAX
package's
tests/test_train_step_parity.py): weight decay 1e-4 and a stray momentum
1e-4, LR ``base_lr * (1 - step/max_step)^0.9`` times each group's
multiplier. torch SGD composes them in the JAX chain's order: decay ->
momentum trace -> group multiplier and schedule (one learning rate per
group, set before each step). A multiplier of 0 (the frozen backbone)
keeps a parameter out of the optimizer, which leaves it bit-equal, as the
JAX update of 0 does.

:func:`train_state` and :func:`load_train_state` are the train stages'
``.train`` checkpoint: a model and its :class:`PolySGD` in the JAX layout,
through the model's pair of weight converters.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

ToJax = Callable[[Mapping[str, torch.Tensor]], Dict]
FromJax = Callable[[Mapping], Dict[str, torch.Tensor]]


def poly_schedule(base_lr: float, max_step: int, power: float = 0.9
                  ) -> Callable[[int], float]:
    """LR = base * (1 - step/max_step)^power, frozen at its last value from
    max_step - 1 on (torchutils.py:21-27)."""

    def schedule(step: int) -> float:
        frac = min(step, max_step - 1) / max_step
        return base_lr * (1.0 - frac) ** power

    return schedule


# the first name component of the CAM net's frozen parameters (the JAX
# package tests Flax names, ``layer1_0``; the port's split at dots gives
# ``("resnet50", "layer1", "0", ...)``)
CAM_FROZEN_PREFIXES = ("conv1", "bn1", "layer1", "layer2")


def cam_lr_mult(path: tuple) -> float:
    """CAM net groups: stem + layer1 + layer2 frozen (detach at
    resnet50_cam.py:28 + the train() freeze at :39-43), layer3/4 1x, head
    10x. ``path`` is a parameter's name split at its dots."""
    if path and path[0] == "classifier":
        return 10.0
    if len(path) >= 2 and path[0] == "resnet50":
        return 0.0 if path[1] in CAM_FROZEN_PREFIXES else 1.0
    return 1.0


def cam_lr_mult_full(path: tuple) -> float:
    """CAM groups with no backbone freeze (from-scratch training, where no
    ImageNet stem exists): backbone 1x, head 10x."""
    return 10.0 if path and path[0] == "classifier" else 1.0


def irn_lr_mult(path: tuple) -> float:
    """IRN groups: backbone frozen (resnet50_irn.py:111-115), edge branch
    1x, displacement branch 10x (train_irn.py:33-36). ``path`` is a
    parameter's name split at its dots."""
    if path and path[0] == "resnet50":
        return 0.0
    if path and path[0].startswith("fc_dp"):
        return 10.0
    return 1.0


class PolySGD:
    """torch SGD over one param group per LR multiplier, its learning rates
    set from the poly schedule before each step. ``step_count`` is the
    number of steps taken (the schedule's step, optax's count)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 base_lr: float, max_step: int, power: float = 0.9,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 mult_fn: Optional[Callable[[tuple], float]] = None):
        groups = {}
        for name, p in named_params:
            mult = mult_fn(tuple(name.split("."))) if mult_fn else 1.0
            if mult:
                groups.setdefault(mult, []).append(p)
        self.schedule = poly_schedule(base_lr, max_step, power)
        self.sgd = torch.optim.SGD(
            [{"params": ps, "mult": m} for m, ps in groups.items()],
            lr=base_lr, momentum=momentum, weight_decay=weight_decay,
        )
        self.step_count = 0

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.schedule(self.step_count)
        for group in self.sgd.param_groups:
            group["lr"] = lr * group["mult"]
        self.sgd.step()
        self.step_count += 1

    def momentum_buffer(self, p: torch.Tensor) -> Optional[torch.Tensor]:
        return self.sgd.state.get(p, {}).get("momentum_buffer")

    def set_momentum_buffer(self, p: torch.Tensor, buf: torch.Tensor) -> None:
        self.sgd.state[p]["momentum_buffer"] = buf


def trained_params(optimizer: PolySGD) -> List[torch.nn.Parameter]:
    """The parameters the optimizer updates (every group's)."""
    return [p for g in optimizer.sgd.param_groups for p in g["params"]]


def poly_sgd(named_params, base_lr: float, max_step: int, power: float = 0.9,
             momentum: float = 0.0, weight_decay: float = 0.0,
             mult_fn: Optional[Callable[[tuple], float]] = None) -> PolySGD:
    """SGD + poly LR decay + per-name LR multipliers (0 freezes; 10 is the
    reference's new-head group) over ``model.named_parameters()``."""
    return PolySGD(named_params, base_lr, max_step, power, momentum,
                   weight_decay, mult_fn)


def _any(tree) -> bool:
    if isinstance(tree, dict):
        return any(_any(v) for v in tree.values())
    return bool(np.any(tree))


def train_state(model: torch.nn.Module, optimizer: PolySGD, epoch: int,
                to_jax: ToJax) -> Dict:
    """The ``.train`` checkpoint: params and stats in the JAX layout
    (``to_jax`` of the state dict), the SGD momentum buffers under the JAX
    param paths of their parameters (numpy; zeros where no step has made
    one yet) for every top-level subtree that holds a trained parameter,
    ``step`` and ``epoch``."""
    sd = model.state_dict()
    variables = to_jax(sd)
    trained = {p for g in optimizer.sgd.param_groups for p in g["params"]}
    bufs = {k: torch.zeros_like(v) for k, v in sd.items()}
    marks = dict(bufs)  # 1 on the trained parameters: which subtrees to keep
    for name, p in model.named_parameters():
        if p in trained:
            marks[name] = torch.ones_like(p)
            buf = optimizer.momentum_buffer(p)
            if buf is not None:
                bufs[name] = buf
    keep = {k for k, sub in to_jax(marks)["params"].items() if _any(sub)}
    momentum = {k: v for k, v in to_jax(bufs)["params"].items() if k in keep}
    return {"params": variables["params"], "stats": variables["stats"],
            "momentum": momentum, "step": optimizer.step_count,
            "epoch": epoch}


def load_train_state(model: torch.nn.Module, optimizer: PolySGD,
                     saved: Dict, path: str, from_jax: FromJax) -> int:
    """Restore :func:`train_state`'s checkpoint into ``model`` and
    ``optimizer``; returns the epoch to start from."""
    if not {"params", "stats", "momentum", "step", "epoch"} <= set(saved):
        raise ValueError(f"{path}: not a train checkpoint of irn_tpu_torch "
                         f"(keys {sorted(saved)})")
    device = next(model.parameters()).device
    model.load_state_dict(from_jax(saved))
    params = dict(saved["params"], **saved["momentum"])
    bufs = from_jax({"params": params, "stats": saved["stats"]})
    trained = {p for g in optimizer.sgd.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        if p in trained:
            optimizer.set_momentum_buffer(p, bufs[name].to(device))
    optimizer.step_count = int(np.asarray(saved["step"]))
    return int(np.asarray(saved["epoch"]))
