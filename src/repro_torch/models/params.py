"""Parameter metadata and initialisation (the counterpart of the
reference's ``repro/models/params.py``).

A parameter tree is a nested dict with the reference's keys; its leaves are
:class:`ParamMeta` before :func:`init_params` and tensors after it.  The
metadata is consumed three ways, as in the reference:

* ``init_params``     — materialise tensors;
* ``abstract_params`` — tensors on the meta device (shapes and dtypes, no
  storage): the dry-run's inputs (``launch/dryrun.py``);
* ``partition_specs`` — the reference's sharding rules, each spec a tuple
  of mesh-axis names or None per dim, trailing Nones dropped (what the
  reference's ``PartitionSpec`` holds).  The dry-run reads the specs for
  the bytes each device would hold; ``shard_params`` places a tree of full
  tensors on a ``DeviceMesh`` by them, as DTensors (each rank keeping its
  own shard), and ``full_params`` gathers a placed tree back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["ParamMeta", "init_params", "abstract_params", "partition_specs", "map_tree",
           "torch_dtype", "TP_RULES", "FSDP_RULES", "shard_tensor", "shard_params",
           "full_params", "placements"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
#: values of a leaf drawn in one float32 call; a larger leaf is drawn in slices
_DRAW_AT_ONCE = 2**31


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim
    init: str = "normal"  # normal | zeros | ones | a_log
    scale: float | None = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


def map_tree(fn: Callable, tree, *rest, path: str = ""):
    """``fn(path, leaf, *other_leaves)`` over nested dicts of equal keys."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or set(other) != set(tree):
                got = sorted(other) if isinstance(other, dict) else type(other).__name__
                raise ValueError(f"tree mismatch at {path or '/'}: "
                                 f"{sorted(tree)} vs {got}")
        return {k: map_tree(fn, tree[k], *(o[k] for o in rest),
                            path=f"{path}/{k}" if path else k)
                for k in sorted(tree)}
    return fn(path, tree, *rest)


def _init_one(meta: ParamMeta, generator: torch.Generator, device, dtype):
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=dtype, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=dtype, device=device)
    if meta.init == "a_log":
        # Mamba: A_log = log(1..d_state) broadcast over channels (and layers)
        d_state = meta.shape[-1]
        a = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32, device=device))
        return a.expand(meta.shape).to(dtype).contiguous()
    # as the reference: fan_in counts every dim but the last, the stacked
    # layer dim included
    fan_in = meta.shape[0] if len(meta.shape) == 1 else int(np.prod(meta.shape[:-1]))
    scale = meta.scale if meta.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    if math.prod(meta.shape) <= _DRAW_AT_ONCE:
        w = torch.randn(meta.shape, generator=generator, device=device, dtype=torch.float32)
        return w.mul_(scale).to(dtype)
    # a stacked leaf of MoE experts (DBRX's w_gate at 8 layers: 8.5 G values)
    # is drawn slice by slice along its first dim, so its float32 draw never
    # needs more than one slice's room
    out = torch.empty(meta.shape, dtype=dtype, device=device)
    for piece in out:
        piece.copy_(torch.randn(piece.shape, generator=generator, device=device,
                                dtype=torch.float32).mul_(scale))
    return out


def init_params(meta_tree, generator: torch.Generator, device, dtype=torch.bfloat16):
    """Materialise a parameter tree from its metadata tree, drawing every
    random leaf from ``generator`` (which must live on ``device``)."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on {device}")
    return map_tree(lambda _, m: _init_one(m, generator, device, dtype), meta_tree)


def abstract_params(meta_tree, dtype=torch.bfloat16):
    """The parameter tree as tensors on the meta device: no storage."""
    return map_tree(lambda _, m: torch.empty(m.shape, dtype=dtype, device="meta"), meta_tree)


# Logical-axis -> mesh-axis preferences, in priority order per axis.
# "model" = tensor-parallel axis; "data" = FSDP axis (params only).
TP_RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "heads_flat": ("model",),  # flattened num_heads*head_dim projections
    "ff": ("model",),
    "experts": ("model",),
    "d_inner": ("model",),
    "lora": (),
    "d_model": (),
    "layers": (),  # stacked period dim never sharded
}

FSDP_RULES: dict[str, tuple[str, ...]] = {
    **TP_RULES,
    "d_model": ("data",),
    "lora": ("data",),
}


def _spec_for(meta: ParamMeta, rules: dict, mesh_axis_sizes: dict) -> tuple:
    """A mesh axis is used at most once per parameter, first come first
    served, and only on a dim it divides."""
    used: set[str] = set()
    out: list[str | None] = []
    for dim, axis in zip(meta.shape, meta.axes):
        chosen = None
        for mesh_axis in rules.get(axis, ()) if axis else ():
            size = mesh_axis_sizes.get(mesh_axis)
            if size and mesh_axis not in used and dim % size == 0:
                chosen = mesh_axis
                used.add(mesh_axis)
                break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def partition_specs(meta_tree, mesh_axis_sizes: dict[str, int], *, fsdp: bool = True):
    """The spec tree of the parameter tree.

    ``mesh_axis_sizes`` maps mesh axis name -> size, e.g. {"data": 16,
    "model": 16} (the "pod" axis never shards parameters: pods are pure DP
    replicas, which is what makes the paper's cross-pod collectives the
    interesting traffic)."""
    rules = FSDP_RULES if fsdp else TP_RULES
    return map_tree(lambda _, m: _spec_for(m, rules, mesh_axis_sizes), meta_tree)


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements, one per dim of the ``DeviceMesh`` ``mesh``,
    of a reference spec (per tensor dim a mesh-axis name, a tuple of names,
    or None): a dim over ``"model"`` is ``Shard(dim)`` on the ``model`` mesh
    dim; a dim over ``("pod", "data")`` is ``Shard(dim)`` on both, the
    tensor dim split by ``pod`` first, then by ``data``; a mesh dim the spec
    does not name is ``Replicate()``.  A tuple must list its axes in mesh
    order, the order in which DTensor splits one dim over two (another
    order would need a strided shard); a mesh axis may shard one dim only."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"spec {spec}: axes {unknown} not in the mesh's {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} lists {axes} out of the mesh's order "
                             f"{names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def shard_tensor(t: torch.Tensor, mesh, pl: tuple) -> DTensor:
    """The DTensor of the full tensor ``t`` (the same on every rank) placed
    on ``mesh`` by the placements ``pl``: this rank's shard, cut locally (no
    communication) and copied, so the full tensor can be freed.  Every
    shard must be even."""
    local = t
    coord = mesh.get_coordinate()
    for d, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(d)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not split into {n} "
                                 f"(mesh dim {d})")
            local = local.chunk(n, p.dim)[coord[d]]
    return DTensor.from_local(local.clone(memory_format=torch.contiguous_format), mesh, pl,
                              run_check=False)


def shard_params(params: dict, specs: dict, mesh) -> dict:
    """``params`` (full tensors, as ``init_params`` or
    ``convert.params_from_numpy`` give them) as DTensors on ``mesh``, each
    placed by its spec in ``specs`` (``partition_specs``' tree)."""
    return map_tree(lambda _, t, spec: shard_tensor(t, mesh, placements(spec, mesh)),
                    params, specs)


def full_params(tree: dict) -> dict:
    """A tree of DTensors as full tensors on every rank (a collective: every
    rank calls it); plain tensors pass as they are."""
    return map_tree(lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
