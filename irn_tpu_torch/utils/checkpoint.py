"""Single-file checkpoints in the JAX package's format: a pickled pytree of
numpy arrays (the counterpart of ``irn_tpu.utils.checkpoint``
save_checkpoint/load_checkpoint), so either framework reads the other's
weights. Unpickle only files this project wrote: unpickling runs code."""

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


def load_checkpoint(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)
