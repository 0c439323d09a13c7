"""FLOPs, peak memory and collective bytes of a pass on the meta device (the
counterpart of the reference's ``repro/launch/hloanalysis.py``).

The reference compiles each dry-run cell and parses the post-SPMD HLO
text.  The port has no HLO to parse: its dry-run (``launch/dryrun.py``)
runs the cell's own code on meta tensors, which carry shapes and dtypes and
no storage, and counts as it goes.  What takes the place of each of the
reference's fields:

* ``flops`` — the reference's is 2 x (result elements) x (contracted
  elements) of every ``dot``, trip-count weighted: matrix products only.
  Here: the matrix products of the pass (``mm``, ``bmm``, ``addmm``,
  einsum's products; :class:`LocalFlops`, by ``torch.utils.flop_counter``'s
  registry), the backward and the rematerialised forward included, on
  each rank's local tensors under DTensor, plus what the kernels' meta
  branches count (``kernels/ops.count_meta_flops``: attention's score
  and value products over the tiles inside the frontier, the scan's
  readout), since a kernel's products are not aten ops.
* ``collective_bytes`` — the reference's is the operand bytes of each
  collective op per device, by kind.  Here: the same bytes by the same
  kind names.  A DTensor program (the sharded step, sharded serving) run
  as one rank over a fake process group (``launch/mesh.fake_device_mesh``)
  issues its collectives as ops, which :class:`CollectiveBytes` records as
  they are dispatched: the operand of each (the shard for an all-gather,
  the whole input for a reduce-scatter, as the reference's convention).
  The shard_map step's data-parallel sync is recorded by a device-free
  ``core.groups.RecordingMesh`` as the port's own collectives run on it
  (:func:`sync_bytes`), beside the ZeRO-1 gathers the reference's step
  makes of its sharded moments (:func:`zero1_gather_bytes`), counted from
  the specs.
* ``peak_bytes`` — in place of ``memory_analysis().temp_size_in_bytes``:
  the peak of the storage that meta tensors created in the pass hold at
  once (:class:`PeakBytes`, a ``TorchDispatchMode``).  Eager PyTorch frees
  a tensor when its last reference goes, so this is what a caching
  allocator would need beyond the arguments, before rounding and
  fragmentation.  Under DTensor the modes see each rank's local ops (a
  DTensor op is left to DTensor, whose local ops come back to the modes),
  so FLOPs, bytes and collectives are the rank's own.
* ``hbm_bytes`` — the reference's fused-HLO traffic model (operands and
  results of every top-level fusion) has no counterpart on an unfused
  eager pass: it is absent (:data:`HBM_BYTES_ABSENT`).
* ``num_whiles``, ``unknown_trip_whiles`` — properties of HLO; a Python
  loop runs every trip, so there is nothing to weight.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core.groups import RecordingMesh
from repro_torch.kernels import ops
from repro_torch.models.params import map_tree
from repro_torch.training.train_step import sync

__all__ = ["HBM_BYTES_ABSENT", "COLLECTIVE_KINDS", "CollectiveBytes", "LocalFlops", "Meter",
           "PassCost", "PeakBytes", "measure", "shard_bytes", "shard_shape", "sync_bytes",
           "tree_shard_bytes", "zero1_gather_bytes"]

HBM_BYTES_ABSENT = ("the reference's hbm_bytes models fused-HLO traffic (operands and "
                    "results of each top-level fusion); an eager pass has no fusions to "
                    "model, so the port records none")


#: the reference's HLO kind of each collective op a DTensor program
#: issues (functional collectives, and DTensor's own all-to-all op)
COLLECTIVE_KINDS = {"all_gather_into_tensor": "all-gather",
                    "all_gather_into_tensor_coalesced": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "reduce_scatter_tensor_coalesced": "reduce-scatter",
                    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
                    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")
#: ops of the collectives' namespaces that issue nothing: each returns its
#: input (or a wrapper of its storage) on a device
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def _dtensor_op(types) -> bool:
    return any(issubclass(t, DTensor) for t in types)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class PassCost:
    """What one pass on meta tensors costs."""

    matmul_flops: float  # LocalFlops' count
    kernel_flops: dict[str, float]  # the kernels' meta counts, by dispatcher
    peak_bytes: int  # peak of the storage created in the pass, live at once
    collective_bytes: dict = dataclasses.field(default_factory=dict)  # by kind
    collective_counts: dict = dataclasses.field(default_factory=dict)  # by kind

    @property
    def flops(self) -> float:
        return self.matmul_flops + sum(self.kernel_flops.values())


class LocalFlops(TorchDispatchMode):
    """The matrix-product FLOPs of the ops dispatched while the mode is
    active, by ``torch.utils.flop_counter``'s registry (what
    ``FlopCounterMode`` counts), each at the shapes of the tensors it runs
    on: under DTensor the rank's local ops, not the global ones."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _dtensor_op(types):
            return NotImplemented
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.total += count(*args, **kwargs, out_val=out)
        return out


class CollectiveBytes(TorchDispatchMode):
    """Records every collective op dispatched while the mode is active: its
    operand bytes (the first argument: the shard an all-gather gathers, the
    whole input a reduce-scatter reduces) and count by the reference's kind
    name (:data:`COLLECTIVE_KINDS`; another collective under its op's own
    name).  Under DTensor the collectives its redistributions issue, on
    this rank."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, int] = {}
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _dtensor_op(types):
            return NotImplemented
        name = func._overloadpacket.__name__
        if name in COLLECTIVE_KINDS or (func.namespace in _COLLECTIVE_NS
                                        and name not in _NOT_COLLECTIVES):
            kind = COLLECTIVE_KINDS.get(name, name)
            self.bytes[kind] = self.bytes.get(kind, 0) + _nbytes(args[0])
            self.counts[kind] = self.counts.get(kind, 0) + 1
        return func(*args, **kwargs)


class PeakBytes(TorchDispatchMode):
    """Tracks the storage of every meta tensor an op creates while the mode
    is active, from its creation to the death of the last tensor that
    views it, and keeps the peak of the sum.  Storages of the tensors
    given to :meth:`exclude` (the pass's arguments) are not counted.  A
    collective's output is waited on (``wait_tensor``) and wrapped for
    autograd (``_wrap_tensor_autograd``); on a device each returns its
    input's storage, where their meta kernels allocate: their outputs count
    as their inputs' storage."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: dict[int, list[int]] = {}  # storage -> [bytes, live tensors]
        self._excluded: set[int] = set()

    def exclude(self, tensors) -> None:
        self._excluded.update((t.to_local() if isinstance(t, DTensor) else t)
                              .untyped_storage()._cdata for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_op(types):  # its local ops come back here
            return NotImplemented
        if (func.namespace in _COLLECTIVE_NS and func._overloadpacket.__name__ in _NOT_COLLECTIVES
                and args[0].is_meta):
            out = args[0].view_as(args[0])  # on a device: its input's storage
            if out.untyped_storage()._cdata in self._refs:
                self._track(out)
            return out
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


class Meter:
    """The counting modes of :func:`measure` as a block: inside it,
    :meth:`snapshot` gives the :class:`PassCost` so far (a pass's parts
    are told apart by the difference of two snapshots).  ``args``: the
    pass's arguments, whose storage the peak leaves out."""

    def __init__(self, args=()):
        self.peak = PeakBytes()
        self.peak.exclude(t for t in tree_leaves(args)
                          if isinstance(t, torch.Tensor) and t.is_meta)
        self.flops, self.coll = LocalFlops(), CollectiveBytes()
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> "Meter":
        self.kernel_flops = self._stack.enter_context(ops.count_meta_flops())
        for mode in (self.coll, self.flops, self.peak):
            self._stack.enter_context(mode)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def snapshot(self) -> PassCost:
        return PassCost(matmul_flops=float(self.flops.total),
                        kernel_flops=dict(self.kernel_flops), peak_bytes=self.peak.peak,
                        collective_bytes=dict(self.coll.bytes),
                        collective_counts=dict(self.coll.counts))


def measure(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on meta tensors (plain, or DTensors over meta
    shards), counted: returns (its result, :class:`PassCost`).  The
    arguments' storage is not counted in the peak."""
    with Meter((args, kwargs)) as meter:
        out = fn(*args, **kwargs)
    return out, meter.snapshot()


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
