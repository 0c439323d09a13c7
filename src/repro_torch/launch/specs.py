"""The dry-run's inputs and their shardings for every (arch x shape) cell
(the counterpart of the reference's ``repro/launch/specs.py``).

Inputs are tensors on the meta device (the reference's
``ShapeDtypeStruct``s: shapes and dtypes, no storage), for the function
the shape's kind runs:

  train_4k     -> the train step (params, opt_state, batch)
  prefill_32k  -> lm.prefill(params, batch)
  decode_32k / long_500k -> lm.decode_step(params, tokens, cache, cache_pos)

A spec is a tuple with one entry per dim (a mesh-axis name, a tuple of
them, or None), trailing Nones dropped, over a device-free
``launch/mesh.MeshShape``.  ``placements`` (``models/params.py``, where
the specs are made) binds a spec to a ``DeviceMesh`` as DTensor
placements, the counterpart of the reference's ``named`` (specs bound to a
device mesh as ``NamedSharding``s).  ``shard_cache`` places a full cache
by ``cache_pspecs`` (as ``params.shard_params`` places parameters), and
``placed_structs`` / ``abstract_placed_cache`` give the dry-run's placed
inputs: DTensors over meta shards, one rank's view of the mesh.
"""

from __future__ import annotations

import math

import torch

from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import lm
from repro_torch.models.params import map_tree, placements, shard_tensor, torch_dtype
from repro_torch.training.train_step import dim_spec, dp_axes, mesh_axis_sizes

__all__ = [
    "batch_structs",
    "decode_token_struct",
    "cache_pspecs",
    "batch_pspecs",
    "cell_eligible",
    "placements",
    "placed_structs",
    "shard_cache",
    "abstract_placed_cache",
]


def _struct(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_structs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """A training or prefill batch on the meta device (integers as int32,
    as the reference's)."""
    if cfg.embed_inputs:
        shape = (batch, seq, cfg.num_codebooks) if cfg.num_codebooks > 1 else (batch, seq)
        return {"tokens": _struct(shape, torch.int32), "labels": _struct(shape, torch.int32)}
    out = {"embeds": _struct((batch, seq, cfg.d_model), torch_dtype(cfg.dtype)),
           "labels": _struct((batch, seq), torch.int32)}
    if cfg.attn is not None and cfg.attn.mrope_sections is not None:
        out["positions"] = _struct((batch, seq, 3), torch.int32)
    return out


def decode_token_struct(cfg: ModelConfig, batch: int) -> torch.Tensor:
    if cfg.embed_inputs:
        shape = (batch, 1, cfg.num_codebooks) if cfg.num_codebooks > 1 else (batch, 1)
        return _struct(shape, torch.int32)
    return _struct((batch, 1, cfg.d_model), torch_dtype(cfg.dtype))


def _dp_or_none(mesh, dim: int):
    dp = dp_axes(mesh)
    n = math.prod(mesh_axis_sizes(mesh)[a] for a in dp)
    return dim_spec(dp) if dim % n == 0 and dim > 0 else None


def batch_pspecs(mesh, tree):
    """The leading (batch) dim of every leaf over the DP axes when divisible
    (long_500k's batch of 1 stays replicated).  ``tree``: a tensor or a
    dict of them."""
    def spec(_, leaf):
        dp = _dp_or_none(mesh, leaf.shape[0])
        return (dp,) if dp else ()
    return map_tree(spec, tree)


def cache_pspecs(cfg: ModelConfig, mesh, cache_struct: dict) -> dict:
    """Specs for decode caches.

    Rules (the reference's): the batch dim over the DP axes when divisible;
    the ``model`` axis on kv-heads when divisible (comm-free decode), else
    on the cache sequence dim (a distributed softmax); Mamba states shard
    d_inner over ``model``."""
    m = mesh_axis_sizes(mesh).get("model", 1)

    def spec(path: str, leaf: torch.Tensor) -> tuple:
        keys = path.split("/")
        name = keys[-1]
        specs: list = [None] * leaf.dim()
        b_idx = 1 if keys[0] == "blocks" else 0  # blocks/<slot>/<name>: [periods, B, ...]
        dp = _dp_or_none(mesh, leaf.shape[b_idx])
        if dp:
            specs[b_idx] = dp
        if name in ("k", "v"):
            # [..., B, C, Hkv, hd]
            if leaf.shape[-2] % m == 0:
                specs[-2] = "model"
            elif leaf.shape[-3] % m == 0:
                specs[-3] = "model"
        elif name in ("ckv", "krope"):
            # [..., B, C, r]: shard the cache sequence dim
            if leaf.shape[-2] % m == 0:
                specs[-2] = "model"
        elif name == "conv":
            if leaf.shape[-1] % m == 0:
                specs[-1] = "model"
        elif name == "ssm":
            if leaf.shape[-2] % m == 0:
                specs[-2] = "model"
        while specs and specs[-1] is None:
            specs.pop()
        return tuple(specs)

    return map_tree(spec, cache_struct)


def cell_eligible(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (SSM / hybrid / SWA)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "skipped: pure full-attention arch; 524288-token dense KV decode "
            "is excluded per the assignment (DESIGN.md §4)"
        )
    return True, ""


def placed_structs(tree, specs, mesh):
    """Each meta tensor of ``tree`` as a DTensor on the ``DeviceMesh``
    ``mesh`` placed by its spec in ``specs``: this rank's shard on the meta
    device (no storage), the global shape and strides kept."""
    def one(_, t, spec):
        pl = placements(spec, mesh)
        local = list(t.shape)
        for d, p in enumerate(pl):
            if isinstance(p, Shard):
                if local[p.dim] % mesh.size(d):
                    raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not split into "
                                     f"{mesh.size(d)} (mesh dim {d})")
                local[p.dim] //= mesh.size(d)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
                                  run_check=False, shape=t.shape, stride=t.stride())
    return map_tree(one, tree, specs)


def shard_cache(cfg: ModelConfig, cache: dict, mesh) -> dict:
    """A full cache (``lm.init_cache``'s or a one-rank ``lm.prefill``'s, the
    same on every rank) as DTensors on ``mesh`` placed by ``cache_pspecs``:
    each rank keeps its shard."""
    specs = cache_pspecs(cfg, mesh, cache)
    return map_tree(lambda _, t, spec: shard_tensor(t, mesh, placements(spec, mesh)),
                    cache, specs)


def abstract_placed_cache(cfg: ModelConfig, mesh, batch: int, capacity: int) -> dict:
    """``lm.abstract_cache`` placed by ``cache_pspecs`` on ``mesh``
    (``placed_structs``): the dry-run's decode cache."""
    cache = lm.abstract_cache(cfg, batch, capacity)
    return placed_structs(cache, cache_pspecs(cfg, mesh, cache), mesh)
