"""Poly-decay SGD with per-group LR multipliers — the counterpart of
``irn_tpu.train.optim``'s ``poly_schedule``, ``poly_sgd`` and
``irn_lr_mult``, on ``torch.optim.SGD`` param groups.

The reference's effective hyper-parameters (misc/torchutils.py:9-31,
step/train_irn.py:33-36, pinned by the JAX package's
tests/test_train_step_parity.py): weight decay 1e-4 and a stray momentum
1e-4, LR ``base_lr * (1 - step/max_step)^0.9`` times each group's
multiplier. torch SGD composes them in the JAX chain's order: decay ->
momentum trace -> group multiplier and schedule (one learning rate per
group, set before each step). A multiplier of 0 (the frozen backbone)
keeps a parameter out of the optimizer, which leaves it bit-equal, as the
JAX update of 0 does.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch


def poly_schedule(base_lr: float, max_step: int, power: float = 0.9
                  ) -> Callable[[int], float]:
    """LR = base * (1 - step/max_step)^power, frozen at its last value from
    max_step - 1 on (torchutils.py:21-27)."""

    def schedule(step: int) -> float:
        frac = min(step, max_step - 1) / max_step
        return base_lr * (1.0 - frac) ** power

    return schedule


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


def poly_sgd(named_params, base_lr: float, max_step: int, power: float = 0.9,
             momentum: float = 0.0, weight_decay: float = 0.0,
             mult_fn: Optional[Callable[[tuple], float]] = None) -> PolySGD:
    """SGD + poly LR decay + per-name LR multipliers (0 freezes; 10 is the
    reference's new-head group) over ``model.named_parameters()``."""
    return PolySGD(named_params, base_lr, max_step, power, momentum,
                   weight_decay, mult_fn)
