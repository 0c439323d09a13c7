"""Carry the reference's parameters across to the port.

``params_from_numpy`` takes a parameter tree of the JAX package, given as a
nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``), and
returns the port's tree with the same keys and shapes.  bfloat16 arrays
(``ml_dtypes``) cannot go through ``torch.from_numpy``, so every leaf goes
through float32, which holds every bfloat16 value exactly, and back to the
config's dtype.  ``opt_state_from_numpy`` does the same for the
reference's AdamW state (``{"m", "v", "step"}``), so that a run of the
reference can be continued in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.params import map_tree, torch_dtype

__all__ = ["opt_state_from_numpy", "params_from_numpy"]


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


def opt_state_from_numpy(cfg: ModelConfig, tree: dict, *, device="cuda") -> dict:
    """The port's AdamW state from the reference's (``jax.tree.map(np.asarray,
    opt_state)``): the moments in their own dtype (the reference's
    ``moment_dtype``, float32 or bfloat16) as trees shaped like the
    parameters, the step a 0-d int32 tensor.  Raises where a key or a shape
    differs."""
    device = resolve_device(device)

    def one(path, meta, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != meta.shape:
            raise ValueError(f"{path}: shape {arr.shape}, want {meta.shape}")
        dtype = torch_dtype("bfloat16" if arr.dtype.name == "bfloat16" else "float32")
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=dtype)

    meta = lm.model_meta(cfg)
    return {"m": map_tree(one, meta, tree["m"]), "v": map_tree(one, meta, tree["v"]),
            "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                                 device=device)}
