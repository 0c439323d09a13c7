"""FLOPs, peak memory and collective bytes of a pass on the meta device (the
counterpart of the reference's ``repro/launch/hloanalysis.py``).

The reference compiles each dry-run cell and parses the post-SPMD HLO
text.  The port has no HLO to parse: its dry-run (``launch/dryrun.py``)
runs the cell's own code on meta tensors, which carry shapes and dtypes and
no storage, and counts as it goes.  What takes the place of each of the
reference's fields:

* ``flops`` — the reference's is 2 x (result elements) x (contracted
  elements) of every ``dot``, trip-count weighted: matrix products only.
  Here: the matrix products that ``torch.utils.flop_counter.FlopCounterMode``
  sees in the pass (``mm``, ``bmm``, ``addmm``, einsum's products), the
  backward and the rematerialised forward included, plus what the kernels'
  meta branches count (``kernels/ops.count_meta_flops``: attention's score
  and value products over the tiles inside the frontier, the scan's
  readout), since a kernel's products are not aten ops.
* ``collective_bytes`` — the reference's is the operand bytes of each
  collective op per device, by kind.  Here: the same bytes by the same
  kind names, recorded by a device-free ``core.groups.RecordingMesh`` as
  the port's own collectives run on it (:func:`sync_bytes`), and the
  ZeRO-1 gathers the reference's step makes of its sharded moments
  (:func:`zero1_gather_bytes`), counted from the specs.
* ``peak_bytes`` — in place of ``memory_analysis().temp_size_in_bytes``:
  the peak of the storage that meta tensors created in the pass hold at
  once (:class:`PeakBytes`, a ``TorchDispatchMode``).  Eager PyTorch frees
  a tensor when its last reference goes, so this is what a caching
  allocator would need beyond the arguments, before rounding and
  fragmentation.
* ``hbm_bytes`` — the reference's fused-HLO traffic model (operands and
  results of every top-level fusion) has no counterpart on an unfused
  eager pass: it is absent (:data:`HBM_BYTES_ABSENT`).
* ``num_whiles``, ``unknown_trip_whiles`` — properties of HLO; a Python
  loop runs every trip, so there is nothing to weight.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.groups import RecordingMesh
from repro_torch.kernels import ops
from repro_torch.models.params import map_tree
from repro_torch.training.train_step import sync

__all__ = ["HBM_BYTES_ABSENT", "PassCost", "PeakBytes", "measure", "shard_bytes",
           "shard_shape", "sync_bytes", "tree_shard_bytes", "zero1_gather_bytes"]

HBM_BYTES_ABSENT = ("the reference's hbm_bytes models fused-HLO traffic (operands and "
                    "results of each top-level fusion); an eager pass has no fusions to "
                    "model, so the port records none")


@dataclasses.dataclass
class PassCost:
    """What one pass on meta tensors costs."""

    matmul_flops: float  # FlopCounterMode's count
    kernel_flops: dict[str, float]  # the kernels' meta counts, by dispatcher
    peak_bytes: int  # peak of the storage created in the pass, live at once

    @property
    def flops(self) -> float:
        return self.matmul_flops + sum(self.kernel_flops.values())


class PeakBytes(TorchDispatchMode):
    """Tracks the storage of every meta tensor an op creates while the mode
    is active, from its creation to the death of the last tensor that
    views it, and keeps the peak of the sum.  Storages of the tensors
    given to :meth:`exclude` (the pass's arguments) are not counted."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: dict[int, list[int]] = {}  # storage -> [bytes, live tensors]
        self._excluded: set[int] = set()

    def exclude(self, tensors) -> None:
        self._excluded.update(t.untyped_storage()._cdata for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_meta:
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._excluded:
            return
        if key in self._refs:
            self._refs[key][1] += 1
        else:
            self._refs[key] = [storage.nbytes(), 1]
            self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]


def measure(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on meta tensors, counted: returns (its
    result, :class:`PassCost`).  The arguments' storage is not counted in
    the peak."""
    peak = PeakBytes()
    peak.exclude(t for t in tree_leaves((args, kwargs))
                 if isinstance(t, torch.Tensor) and t.is_meta)
    flops = FlopCounterMode(display=False)
    with ops.count_meta_flops() as kernel_flops, flops, peak:
        out = fn(*args, **kwargs)
    return out, PassCost(matmul_flops=float(flops.get_total_flops()),
                         kernel_flops=dict(kernel_flops), peak_bytes=peak.peak)


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape, spec: tuple, axis_sizes: dict[str, int]) -> tuple[int, ...]:
    """The per-device shape of a tensor of ``shape`` under ``spec`` (each
    sharded dim divided by the product of its axes' sizes)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(axis_sizes[a] for a in _axes_of(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split over {entry} ({n})")
        out[d] //= n
    return tuple(out)


def shard_bytes(t: torch.Tensor, spec: tuple, axis_sizes: dict[str, int]) -> int:
    return math.prod(shard_shape(t.shape, spec, axis_sizes)) * t.element_size()


def tree_shard_bytes(tree, specs, axis_sizes: dict[str, int]) -> int:
    """The bytes one device holds of ``tree`` under the spec tree ``specs``."""
    total = [0]

    def add(_, t, spec):
        total[0] += shard_bytes(t, spec, axis_sizes)
    map_tree(add, tree, specs)
    return total[0]


def sync_bytes(grads: dict, metrics: dict, pods: int, lanes: int,
               backend: str) -> tuple[dict, dict]:
    """The collective bytes per device of ``training.train_step.sync`` (the
    data-parallel gradient and metric sync, ``backend`` ``"xla"`` or
    ``"fulllane"``) over ``pods x lanes`` ranks, each holding ``grads`` and
    ``metrics`` (meta tensors of one device's shapes), run on a
    ``RecordingMesh``: the operand bytes by kind, and what one rank sends
    under each op's direct algorithm, by "op/axis" (``core.groups.Traffic``:
    messages and bytes, and those that cross pods)."""
    mesh = RecordingMesh(pods, lanes)
    sync(grads, metrics, (mesh.pod, mesh.lane), backend)
    return dict(mesh.collective_bytes), mesh.traffic.snapshot()


def zero1_gather_bytes(opt_state: dict, opt_specs: dict, axis_sizes: dict[str, int],
                       dp: tuple[str, ...]) -> int:
    """The operand bytes per device of the all-gathers that replicate the
    ZeRO-1 moments over the data-parallel axes ``dp`` before the update
    (the reference's shard_map step takes them sharded and computes on them
    whole): each moment whose spec uses a DP axis, at its shard's size."""
    total = [0]

    def add(_, t, spec):
        if any(a in dp for entry in spec for a in _axes_of(entry)):
            total[0] += shard_bytes(t, spec, axis_sizes)
    for k in ("m", "v"):
        map_tree(add, opt_state[k], opt_specs[k])
    return total[0]
