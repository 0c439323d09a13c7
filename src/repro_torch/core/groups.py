"""Process groups that stand in for the mesh's named axes, and the transport
that runs the collectives on them.

The reference runs its collectives inside ``shard_map`` over a mesh with
the axes ``("pod", "lane")``: an axis name binds a group of devices, its
size (``axis_size``) and the device's index on it (``axis_index``).  Here a
:class:`Mesh2D` built on the world group gives each rank three
:class:`Axis` objects that carry the same:

- ``pod``: the outer axis, the ranks with this rank's lane index, one on
  each pod;
- ``lane``: the inner axis, the ranks of this rank's pod;
- ``world``: both axes, row-major.

Rank ``r`` sits at ``pod = r // lanes``, ``lane = r % lanes``: the
reference's device order under ``P(("pod", "lane"))``.

Each axis runs its collectives through a transport chosen by its group's
backend, never by catching an error:

- NCCL: CUDA tensors go to the collective as they are (CPU tensors raise);
- gloo: CPU tensors go as they are; a CUDA tensor is copied into a pinned
  host buffer, the collective runs on that buffer, and the result is copied
  back to the card.  The copies are counted (``staged_bytes``).

:class:`Traffic` counts, for each (op, axis), the calls and the messages and
bytes this rank sends under the direct algorithm of the op: an alltoall or a
reduce-scatter over ``n`` ranks sends ``1/n`` of the input to each of the
``n - 1`` others, an all-gather the whole input to each, an all-reduce a
reduce-scatter and an all-gather, a point-to-point send one message.  The
backend's own algorithm may move the bytes another way; the count is the
paper's, per rank, and splits off what crosses pods.

:class:`MeshAxes` gives the data-parallel axes of a ``DeviceMesh`` (the
sharded train step's ``(pod, data, model)`` mesh, ``launch/mesh.
make_device_mesh``) as :class:`Axis` objects over the mesh's own dim
groups, ``pod`` outer and ``data`` inner, so the paper's sums run over
them with the same transport and :class:`Traffic` counts as over a
:class:`Mesh2D`.

A DeviceMesh's DTensors issue their collectives straight to the mesh's
groups (``mesh_groups``), not through an :class:`Axis`.  Where several
ranks share one card the world runs on gloo (NCCL admits no two ranks on
one device), and the mesh's groups for tensors on the card are
:class:`StagedGroup` groups (backend ``"gloo_staged"``): process groups
whose every collective copies its CUDA operands into pinned host memory,
runs on an inner gloo group there and copies the results back, counting
the copies in ``staged_bytes``, as an :class:`Axis` stages its own.  The
choice is made by backend when the groups are built, never by catching an
error; the compute stays on the card.

:class:`RecordingMesh` gives the same axes with no process group: each
operation exchanges nothing and records its operand bytes per rank by the
reference's HLO kind names (``all-reduce``, ``reduce-scatter``,
``all-gather``, ``all-to-all``, ``collective-permute``), the convention of
the reference's dry-run (``repro/launch/hloanalysis.py``), not
:class:`Traffic`'s bytes sent to peers.  The dry-run
(``launch/dryrun.py``) runs the gradient sync on meta tensors over one.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Axis", "Mesh2D", "MeshAxes", "RecordingAxis", "RecordingMesh", "StagedGroup",
           "Traffic", "group_backend", "mesh_groups", "register_staged", "STAGED"]

#: the backend name of :class:`StagedGroup`
STAGED = "gloo_staged"

# the non-deprecated name where this PyTorch has one; the same collectives
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

_FIELDS = ("calls", "messages", "bytes", "cross_pod_messages", "cross_pod_bytes",
           "staged_bytes")


class Traffic:
    """What this rank sent, by ``"op/axis"``: the fields of ``_FIELDS``."""

    def __init__(self):
        self.counts: dict[str, dict[str, int]] = {}

    def reset(self) -> None:
        self.counts.clear()

    def snapshot(self) -> dict[str, dict[str, int]]:
        return {k: dict(v) for k, v in self.counts.items()}

    def add(self, op: str, axis: "Axis", **fields: int) -> None:
        c = self.counts.setdefault(f"{op}/{axis.name}", dict.fromkeys(_FIELDS, 0))
        for k, v in fields.items():
            c[k] += v


@dataclasses.dataclass(eq=False)
class Axis:
    """One named axis as seen from this rank: its group, the global ranks of
    the group by index on the axis, and this rank's index."""

    name: str
    group: dist.ProcessGroup
    ranks: tuple[int, ...]
    index: int
    mesh: "Mesh2D | RecordingMesh"

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through a pinned host buffer on this group (a
        :class:`StagedGroup` stages, and counts, for itself)."""
        if self.backend == STAGED:
            return False
        if self.backend == "nccl":
            if not t.is_cuda:
                raise ValueError(f"axis {self.name}: NCCL takes CUDA tensors, got {t.device}")
            return False
        if self.backend == "gloo":
            return t.is_cuda
        raise ValueError(f"axis {self.name}: no transport for backend {self.backend!r}")

    def transport(self, t: torch.Tensor) -> str:
        """How a tensor like ``t`` travels on this axis."""
        staged = self._staged(t) or (self.backend == STAGED and t.is_cuda)
        return f"{self.backend}, staged through pinned host memory" if staged else self.backend

    def _count(self, op: str, per_peer: list[tuple[int, int]]) -> None:
        """Count one call that sends ``nbytes`` to each ``(peer index,
        nbytes)``."""
        mine = self.mesh.pod_of(self.ranks[self.index])
        cross = [b for p, b in per_peer if self.mesh.pod_of(self.ranks[p]) != mine]
        self.mesh.traffic.add(op, self, calls=1, messages=len(per_peer),
                              bytes=sum(b for _, b in per_peer),
                              cross_pod_messages=len(cross), cross_pod_bytes=sum(cross))

    def _others(self, nbytes: int, times: int = 1) -> list[tuple[int, int]]:
        return [(p, nbytes) for p in range(self.size) if p != self.index] * times

    def _run(self, op: str, call, out: torch.Tensor, inp: torch.Tensor) -> None:
        """``call(out, inp, group)`` on this axis, through the host where
        the backend needs it (``out`` may be ``inp``: in place)."""
        if not self._staged(inp):
            call(out, inp, self.group)
            return
        h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
        h_in.copy_(inp)
        h_out = h_in if out is inp else torch.empty(out.shape, dtype=out.dtype,
                                                    pin_memory=True)
        call(h_out, h_in, self.group)
        out.copy_(h_out)
        self.mesh.traffic.add(op, self, staged_bytes=_nbytes(inp) + _nbytes(out))

    def all_reduce(self, t: torch.Tensor) -> None:
        """Sum ``t`` over the axis, in place."""
        self._count("all_reduce", self._others(_nbytes(t) // self.size, times=2))
        self._run("all_reduce", lambda o, i, g: dist.all_reduce(o, group=g), t, t)

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        """``out`` = this rank's ``1/size`` slice (dim 0) of the sum of ``inp``."""
        self._count("reduce_scatter", self._others(_nbytes(inp) // self.size))
        self._run("reduce_scatter", lambda o, i, g: _reduce_scatter(o, i, group=g), out, inp)

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        """``out`` = every rank's ``inp`` concatenated on dim 0, by axis index."""
        self._count("all_gather", self._others(_nbytes(inp)))
        self._run("all_gather", lambda o, i, g: _all_gather(o, i, group=g), out, inp)

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        """Chunk ``j`` of ``inp`` (dim 0, equal chunks) goes to index ``j``;
        chunk ``j`` of ``out`` comes from index ``j``."""
        self._count("all_to_all", self._others(_nbytes(inp) // self.size))
        self._run("all_to_all", lambda o, i, g: dist.all_to_all_single(o, i, group=g),
                  out, inp)

    def exchange(self, sends: list[tuple[torch.Tensor, int]],
                 recvs: list[tuple[torch.Tensor, int]]) -> None:
        """One batch of point-to-point messages: each ``(tensor, peer
        index)`` of ``sends`` is sent, each of ``recvs`` received into, all
        posted together (``dist.batch_isend_irecv``) and waited for."""
        if not sends and not recvs:
            return
        self._count("send", [(p, _nbytes(t)) for t, p in sends])
        staged = any(self._staged(t) for t, _ in sends + recvs)
        ops, copies_back = [], []
        for t, p in sends:
            if staged:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t)
                t = h
            ops.append(dist.P2POp(dist.isend, t, self.ranks[p], self.group))
        for t, p in recvs:
            if staged:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                copies_back.append((t, h))
                t = h
            ops.append(dist.P2POp(dist.irecv, t, self.ranks[p], self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for t, h in copies_back:
            t.copy_(h)
        if staged:
            self.mesh.traffic.add("send", self, staged_bytes=sum(
                _nbytes(t) for t, _ in sends + recvs))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Mesh2D:
    """The (pod, lane) mesh over the world group: ``pods * lanes`` ranks,
    rank ``r`` at pod ``r // lanes`` and lane ``r % lanes``.  Every rank
    must build it, with the same shape: it creates every subgroup, in the
    same order on every rank, as ``dist.new_group`` requires."""

    def __init__(self, pods: int, lanes: int):
        if not dist.is_initialized():
            raise RuntimeError("Mesh2D: init torch.distributed first")
        world, rank = dist.get_world_size(), dist.get_rank()
        if pods * lanes != world:
            raise ValueError(f"Mesh2D: {pods} pods x {lanes} lanes != world size {world}")
        self.pods, self.lanes = pods, lanes
        self.traffic = Traffic()
        pod, lane = divmod(rank, lanes)
        lane_ranks = [tuple(p * lanes + j for j in range(lanes)) for p in range(pods)]
        pod_ranks = [tuple(q * lanes + j for q in range(pods)) for j in range(lanes)]
        lane_groups = [dist.new_group(list(r)) for r in lane_ranks]
        pod_groups = [dist.new_group(list(r)) for r in pod_ranks]
        self.lane = Axis("lane", lane_groups[pod], lane_ranks[pod], lane, self)
        self.pod = Axis("pod", pod_groups[lane], pod_ranks[lane], pod, self)
        self.world = Axis("world", dist.group.WORLD, tuple(range(world)), rank, self)

    def pod_of(self, rank: int) -> int:
        return rank // self.lanes


class StagedGroup(dist.ProcessGroup):
    """A process group on gloo for tensors on the card: each collective
    copies its CUDA operands into pinned host buffers, runs on an inner
    gloo group over them, waits, and copies the results back (CPU operands
    go to gloo as they are).  ``staged_bytes`` counts the copies by op.
    It has the collectives DTensor and :class:`Axis` call (all-reduce,
    all-gather to a list or a tensor, reduce-scatter, all-to-all, their
    coalesced forms, broadcast, barrier), each under the names both
    PyTorch's current and older bindings call it by.  Registered as the backend ``"gloo_staged"`` by
    ``register_staged``."""

    def __init__(self, store, rank: int, size: int, timeout: datetime.timedelta):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        self.staged_bytes: dict[str, int] = {}

    def getBackendName(self) -> str:
        return STAGED

    @property
    def group_name(self) -> str:
        """The name c10d registered this group under (a Python group is not
        told it)."""
        return dist.distributed_c10d._world.pg_names[self]

    def _staged(self, op: str, outs: list, ins: list, call):
        """``call(host outs, host ins)`` -> gloo work, on host copies of the
        CUDA tensors among ``outs`` and ``ins`` (an output that is also an
        input shares its copy), then the outputs copied back."""
        host = {}

        def h(t):
            if not t.is_cuda:
                return t
            if id(t) not in host:
                host[id(t)] = (t, torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
            return host[id(t)][1]

        h_ins = [h(t) for t in ins]
        for t, c in host.values():
            c.copy_(t)
        h_outs = [h(t) for t in outs]
        call(h_outs, h_ins).wait()
        for t in outs:
            if t.is_cuda:
                t.copy_(host[id(t)][1])
        if host:
            self.staged_bytes[op] = self.staged_bytes.get(op, 0) + sum(
                _nbytes(t) for t, _ in host.values())
        return _done()

    def allreduce(self, tensors, opts=None):
        opts = opts or dist.AllreduceOptions()
        return self._staged("allreduce", tensors, tensors,
                            lambda o, i: self._gloo.allreduce(o, opts))

    def broadcast(self, tensors, opts=None):
        opts = opts or dist.BroadcastOptions()
        return self._staged("broadcast", tensors, tensors,
                            lambda o, i: self._gloo.broadcast(o, opts))

    def allgather(self, output_lists, inputs, opts=None):
        n = len(output_lists[0])

        def call(o, i):
            return self._gloo.allgather([o[k * n:(k + 1) * n] for k in range(len(i))], i)
        return self._staged("allgather", [t for lst in output_lists for t in lst], inputs, call)

    def all_gather_single(self, output, input, opts=None):
        return self._staged("all_gather", [output], [input],
                            lambda o, i: self._gloo._allgather_base(o[0], i[0]))

    def reduce_scatter_single(self, output, input, opts=None):
        opts = opts or dist.ReduceScatterOptions()
        return self._staged("reduce_scatter", [output], [input],
                            lambda o, i: self._gloo._reduce_scatter_base(o[0], i[0], opts))

    def all_to_all_single(self, output, input, output_split_sizes=None,
                          input_split_sizes=None, opts=None):
        opts = opts or dist.AllToAllOptions()
        return self._staged("all_to_all", [output], [input],
                            lambda o, i: self._gloo.alltoall_base(
                                o[0], i[0], list(output_split_sizes or []),
                                list(input_split_sizes or []), opts))

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i)
        return _done()

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done()

    def barrier(self, opts=None):
        self._gloo.barrier(opts or dist.BarrierOptions()).wait()
        return _done()

    _allgather_base = all_gather_single
    _reduce_scatter_base = reduce_scatter_single
    alltoall_base = all_to_all_single


def _done():
    """A finished work (the staged collectives return after the copy back)."""
    fut = torch.futures.Future()
    fut.set_result(None)
    return torch._C._distributed_c10d._create_work_from_future(fut)


def _create_staged(store, rank, size, timeout):
    return StagedGroup(store, rank, size, timeout)


def register_staged() -> None:
    """Register :class:`StagedGroup` as the backend :data:`STAGED` (once a
    process)."""
    if not hasattr(dist.Backend, STAGED.upper()):
        dist.Backend.register_backend(STAGED, _create_staged, devices=["cpu", "cuda"])


def group_backend(device) -> str | None:
    """The backend of the mesh groups for tensors on ``device``: the
    world's (None), except :data:`STAGED` for the card under a gloo world."""
    if torch.device(device).type != "cuda" or dist.get_backend() != "gloo":
        return None
    register_staged()
    return STAGED


def mesh_groups(shape: tuple[int, ...], backend: str | None = None) -> list:
    """This rank's group along each dim of the row-major mesh of ``shape``
    over the world (rank ``r`` at ``np.unravel_index(r, shape)``, as
    ``jax.make_mesh`` lays devices out).  Every group of every dim is
    created, in one order on every rank, as ``dist.new_group`` requires,
    on ``backend`` (None: the world's; ``group_backend`` chooses)."""
    if not dist.is_initialized():
        raise RuntimeError("mesh_groups: init torch.distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {tuple(shape)} != world size {world}")
    ranks = np.arange(world).reshape(shape)
    mine = []
    for d in range(len(shape)):
        for line in np.moveaxis(ranks, d, -1).reshape(-1, shape[d]).tolist():
            g = dist.new_group(line, backend=backend)
            if rank in line:
                mine.append(g)
    return mine


class MeshAxes:
    """The data-parallel axes of a ``DeviceMesh`` with ``"data"`` (and
    ``"pod"``) dims as :class:`Axis` objects: ``pod`` (outer) and ``data``
    (inner) on the mesh's own dim groups, and ``world``, both of them
    pod-major (the ranks that share this rank's other coordinates), on a
    group of its own.  A mesh without a ``"pod"`` dim gets a pod axis of
    one rank, so ``(pod, data)`` always names the sync's two axes.  The
    groups this view adds run on the mesh's backend; every rank creates
    every one, in one order.  ``traffic`` counts what the axes' calls
    send (and stage through the host), as :class:`Mesh2D`'s does."""

    def __init__(self, mesh):
        names = mesh.mesh_dim_names
        coord = mesh.get_coordinate()
        rank = dist.get_rank()
        backend = str(dist.get_backend(mesh.get_group("data")))
        self.traffic = Traffic()
        self.device_mesh = mesh
        ranks = mesh.mesh.numpy()
        if "pod" not in names:  # a pod dim of one
            ranks, names = ranks[None], ("pod",) + tuple(names)
            coord = [0] + list(coord)
        dp = [names.index("pod"), names.index("data")]
        rest = [d for d in range(len(names)) if d not in dp]
        lines = np.transpose(ranks, rest + dp).reshape(-1, *(ranks.shape[d] for d in dp))
        groups = {}
        for block in lines:  # every rank: every (other coordinates) block's groups
            for key, members in [("world", block.reshape(-1))] + [
                    (("pod", j), block[:, j]) for j in range(block.shape[1])] + [
                    (("data", i), block[i]) for i in range(block.shape[0])]:
                g = dist.new_group(members.tolist(), backend=backend)
                if rank in members:
                    groups[key if key == "world" else key[0]] = (g, tuple(members.tolist()))
        index = {"pod": coord[dp[0]], "data": coord[dp[1]]}
        self.pod, self.data = (Axis(a, *groups[a], index[a], self) for a in ("pod", "data"))
        w = groups["world"]
        self.world = Axis("world", *w, w[1].index(rank), self)
        self.lanes = self.data.size

    def pod_of(self, rank: int) -> int:
        """The pod index of a rank of this rank's ``world`` axis."""
        return self.world.ranks.index(rank) // self.lanes

    def staged_bytes(self) -> dict[str, int]:
        """The bytes the mesh's and this view's :class:`StagedGroup` groups
        staged through the host, by op."""
        out: dict[str, int] = {}
        groups = [self.device_mesh.get_group(n) for n in self.device_mesh.mesh_dim_names]
        for g in groups + [self.pod.group, self.data.group, self.world.group]:
            for op, n in getattr(g, "staged_bytes", {}).items():
                out[op] = out.get(op, 0) + n
        return out


_KINDS = {"all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
          "all_gather": "all-gather", "all_to_all": "all-to-all"}


class RecordingAxis(Axis):
    """An :class:`Axis` with no group, seen from rank 0: each operation is
    counted in the mesh's :class:`Traffic`, as on a real axis, and adds its
    operand bytes to the mesh's ``collective_bytes`` under the reference's
    kind name; nothing is exchanged and no output is written."""

    def _run(self, op: str, call, out: torch.Tensor, inp: torch.Tensor) -> None:
        c = self.mesh.collective_bytes
        c[_KINDS[op]] = c.get(_KINDS[op], 0) + _nbytes(inp)

    def exchange(self, sends: list[tuple[torch.Tensor, int]],
                 recvs: list[tuple[torch.Tensor, int]]) -> None:
        if not sends and not recvs:
            return
        self._count("send", [(p, _nbytes(t)) for t, p in sends])
        c = self.mesh.collective_bytes
        c["collective-permute"] = c.get("collective-permute", 0) + sum(
            _nbytes(t) for t, _ in sends)


class RecordingMesh:
    """The (pod, lane) mesh of :class:`Mesh2D` as :class:`RecordingAxis`
    objects, seen from rank 0: no process group.  ``collective_bytes``
    holds the operand bytes the collectives run on it recorded, by kind;
    ``traffic`` what rank 0 would send, as on a real mesh."""

    def __init__(self, pods: int, lanes: int):
        self.pods, self.lanes = pods, lanes
        self.traffic = Traffic()
        self.collective_bytes: dict[str, int] = {}
        self.lane = RecordingAxis("lane", None, tuple(range(lanes)), 0, self)
        self.pod = RecordingAxis("pod", None, tuple(q * lanes for q in range(pods)), 0, self)
        self.world = RecordingAxis("world", None, tuple(range(pods * lanes)), 0, self)

    def pod_of(self, rank: int) -> int:
        return rank // self.lanes
