"""Carry the reference's parameters across to the port.

``params_from_numpy`` takes a parameter tree of the JAX package, given as a
nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``), and
returns the port's tree with the same keys and shapes.  bfloat16 arrays
(``ml_dtypes``) cannot go through ``torch.from_numpy``, so every leaf goes
through float32, which holds every bfloat16 value exactly, and back to the
config's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.params import map_tree, torch_dtype

__all__ = ["params_from_numpy"]


def params_from_numpy(cfg: ModelConfig, tree: dict, *, device="cuda") -> dict:
    """The port's parameters for ``cfg`` from the reference's ``tree``.
    Raises if a key or a shape differs from ``lm.model_meta(cfg)``."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def one(path, meta, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != meta.shape:
            raise ValueError(f"{path}: shape {arr.shape}, want {meta.shape}")
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=dtype)

    return map_tree(one, lm.model_meta(cfg), tree)
