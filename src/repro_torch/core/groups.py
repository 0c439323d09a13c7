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

import torch
import torch.distributed as dist

__all__ = ["Axis", "Mesh2D", "RecordingAxis", "RecordingMesh", "Traffic"]

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
        """Whether ``t`` goes through a pinned host buffer on this group."""
        if self.backend == "nccl":
            if not t.is_cuda:
                raise ValueError(f"axis {self.name}: NCCL takes CUDA tensors, got {t.device}")
            return False
        if self.backend == "gloo":
            return t.is_cuda
        raise ValueError(f"axis {self.name}: no transport for backend {self.backend!r}")

    def transport(self, t: torch.Tensor) -> str:
        """How a tensor like ``t`` travels on this axis."""
        return (f"{self.backend}, staged through pinned host memory" if self._staged(t)
                else self.backend)

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
