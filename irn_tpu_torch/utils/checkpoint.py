"""Single-file checkpoints in the JAX package's format: a pickled pytree of
numpy arrays (the counterpart of ``irn_tpu.utils.checkpoint``
save_checkpoint/load_checkpoint), so either framework reads the other's
weights.

Unpickling runs code, so :func:`load_checkpoint` resolves only numpy's
classes: a file that names any other class (a JAX ``.train`` file's optax
states, or anything not written as a numpy pytree) is refused with an
error that names the file and the class, before that class's module is
imported."""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, tree: Any) -> None:
    """Atomic write of a numpy pytree (torch tensors are converted)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(tree), f)
    os.replace(tmp, path)


class CheckpointError(ValueError):
    """A file that is not a numpy pytree checkpoint."""


class _NumpyUnpickler(pickle.Unpickler):
    def __init__(self, f, path: str):
        super().__init__(f)
        self.path = path

    def find_class(self, module: str, name: str):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise CheckpointError(
            f"{self.path}: holds {module}.{name}, not a numpy pytree; "
            "irn_tpu_torch reads only numpy checkpoints (a JAX training "
            "checkpoint holds optax states: resuming across frameworks is "
            "not supported)")


def load_checkpoint(path: str) -> Any:
    with open(path, "rb") as f:
        return _NumpyUnpickler(f, path).load()
