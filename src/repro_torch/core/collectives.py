"""The paper's collective families on ``torch.distributed``: the counterpart
of the reference's ``repro/core/collectives.py``.

The reference maps the paper's k-lane insight onto a multi-pod mesh: the
"compute node" is the pod (fast intra-pod links, the paper's shared memory),
the k "lanes" are the concurrent inter-pod streams, and the *full-lane
problem-splitting* family becomes the hierarchical decomposition of
cross-pod collectives:

    cross-pod allreduce  = reduce_scatter(lane) -> allreduce(pod) -> all_gather(lane)
    cross-pod broadcast  = [payload lane-sharded on root pod] -> allreduce(pod) -> all_gather(lane)
    cross-pod alltoall   = regroup -> all_to_all(lane) -> regroup -> all_to_all(pod)

Every function takes :class:`~repro_torch.core.groups.Axis` objects of a
:class:`~repro_torch.core.groups.Mesh2D` where the reference takes axis
names, is called on every rank of those axes (as the reference's are called
inside ``shard_map``), and returns this rank's result without changing its
input.  The k-ported tree algorithms are compiled from the port's copy of
the schedule generators into waves of point-to-point messages; the flat
baselines are one collective on the world group.

The one difference in form: ``jax.lax.all_to_all`` splits any axis, while
``all_to_all_single`` splits only dim 0, so ``fulllane_all_to_all`` regroups
its blocks before each exchange with the ``a2a_pack`` kernel
(``kernels/ops.a2a_pack``): two launches per call on a card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import schedule as sched
from repro_torch.core.groups import Axis
from repro_torch.kernels import ops

__all__ = [
    "axis_size",
    "hierarchical_psum",
    "fulllane_psum",
    "fulllane_broadcast",
    "fulllane_all_to_all",
    "kported_broadcast_ppermute",
    "kported_scatter_ppermute",
    "flat_psum",
    "flat_all_to_all",
]


def axis_size(axis: Axis) -> int:
    return axis.size


def _pad_to_multiple(x: torch.Tensor, m: int) -> tuple[torch.Tensor, int]:
    """``x`` (1-D) padded with zeros to a multiple of ``m``, and the pad."""
    pad = (-x.shape[0]) % m
    if pad == 0:
        return x, 0
    return torch.nn.functional.pad(x, (0, pad)), pad


# ---------------------------------------------------------------------------
# Full-lane (hierarchical) family: the paper's section 2.2.
# ---------------------------------------------------------------------------


def hierarchical_psum(x: torch.Tensor, outer: Axis, inner: Axis) -> torch.Tensor:
    """All-reduce over (outer x inner) by the full-lane decomposition:
    reduce-scatter over ``inner`` (the on-node phase), all-reduce over
    ``outer`` (every inner rank drives its own cross-pod subproblem: all
    lanes busy), all-gather over ``inner``.  The same sum as
    ``flat_psum``; the cross-pod traffic per rank drops from ``2*C`` to
    ``2*C/n``."""
    n = inner.size
    flat, pad = _pad_to_multiple(x.reshape(-1), n)
    part = torch.empty(flat.shape[0] // n, dtype=x.dtype, device=x.device)
    inner.reduce_scatter(part, flat)
    outer.all_reduce(part)
    full = torch.empty_like(flat)
    inner.all_gather(full, part)
    if pad:
        full = full[: flat.shape[0] - pad]
    return full.reshape(x.shape)


# The paper's name for the family:
fulllane_psum = hierarchical_psum


def fulllane_broadcast(x: torch.Tensor, outer: Axis, inner: Axis, *,
                       root: int = 0) -> torch.Tensor:
    """Broadcast a payload that is valid on the root pod only to all pods.

    ``x`` is this rank's shard of a payload sharded over ``inner`` (the
    paper's phase A, the on-node scatter, is the sharding itself).  Phase B:
    each inner rank broadcasts its chunk across pods (n concurrent
    inter-pod subproblems: full-lane).  Phase C: an on-node all-gather
    reassembles the payload.  Returns the whole payload (every inner shard
    concatenated on dim 0) on every rank."""
    seeded = (x.clone(memory_format=torch.contiguous_format) if outer.index == root
              else torch.zeros(x.shape, dtype=x.dtype, device=x.device))
    outer.all_reduce(seeded)  # the chunk broadcast across pods
    out = torch.empty((inner.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    inner.all_gather(out, seeded)
    return out


def fulllane_all_to_all(x: torch.Tensor, outer: Axis, inner: Axis) -> torch.Tensor:
    """Hierarchical all-to-all over the merged (outer, inner) axis.

    The same result as ``flat_all_to_all`` for this rank's input ``[P,
    ...]`` with ``P = No * Ni`` blocks ordered destination-major ``dest = o
    * Ni + i``: block ``x[d]`` of rank ``s`` ends up as block ``s`` of rank
    ``d``.  Phase A combines blocks by destination inner rank with an
    on-node all-to-all; phase B delivers the node-combined blocks with
    ``Ni`` concurrent pod-level all-to-alls.  All data moves twice, but the
    cross-pod traffic of a rank goes in ``No - 1`` combined messages, every
    lane busy."""
    No, Ni = outer.size, inner.size
    P = No * Ni
    if x.shape[0] != P:
        raise ValueError(f"leading dim {x.shape[0]} != mesh size {P}")
    blk = tuple(x.shape[1:])
    B = math.prod(blk)
    # [No, Ni] by (dest outer, dest inner) -> [Ni, No]: chunk l of dim 0
    # holds the blocks for inner rank l of every pod
    y = ops.a2a_pack(x.contiguous().view(No, Ni, 1, B))
    # phase A (on-node): y[j, o] = block from (v, j) destined to (o, l)
    z = torch.empty_like(y)
    inner.all_to_all(z, y)
    # [Ni_src, No] -> [No, Ni_src]: chunk o of dim 0 goes to pod o
    w = ops.a2a_pack(z)
    # phase B (cross-pod): u[q, j] = block from (q, j) destined to (v, l)
    u = torch.empty_like(w)
    outer.all_to_all(u, w)
    return u.view((P,) + blk)


# ---------------------------------------------------------------------------
# k-ported tree algorithms compiled to waves of point-to-point messages
# (section 2.1).
# ---------------------------------------------------------------------------


def _waves(rnd: sched.Round) -> list[list[sched.Msg]]:
    """A round's messages split into waves with at most one message per
    source: the reference's ``ppermute`` takes one message per source, so a
    round of up to k sends per source runs as up to k waves."""
    waves: list[list[sched.Msg]] = []
    per_src: dict[int, int] = {}
    for m in rnd.msgs:
        w = per_src.get(m.src, 0)
        per_src[m.src] = w + 1
        while len(waves) <= w:
            waves.append([])
        waves[w].append(m)
    return waves


def kported_broadcast_ppermute(x: torch.Tensor, axis: Axis, *, k: int,
                               root: int = 0) -> torch.Tensor:
    """The paper's radix-(k+1) divide-and-conquer broadcast from ``root``,
    run as ``ceil(log_{k+1} P)`` rounds of up to k waves.  Each wave is one
    batch of point-to-point messages on ``axis``; a rank that is a
    destination of the wave takes what it receives, the others keep theirs.
    Returns the root's ``x`` on every rank."""
    schedule = sched.kported_broadcast(axis.size, k, c=1, root=root)
    me = axis.index
    cur = x.contiguous()
    for rnd in schedule.rounds:
        for wave in _waves(rnd):
            sends = [(cur, m.dst) for m in wave if m.src == me]
            recv = [(torch.empty_like(cur), m.src) for m in wave if m.dst == me]
            axis.exchange(sends, recv)
            if recv:
                cur = recv[0][0]
    return cur


def kported_scatter_ppermute(x: torch.Tensor, axis: Axis, *, k: int,
                             root: int = 0) -> torch.Tensor:
    """The paper's divide-and-conquer scatter from ``root`` in waves.

    ``x``: this rank's buffer [P, ...]; the root's holds block ``j`` for
    rank ``j`` at ``x[j]``.  Returns this rank's own block, ``x.shape[1:]``.
    Each message carries the blocks of the subrange it seeds, as the
    schedule sizes it; the reference, bound to static shapes, passes the
    whole buffer."""
    P = axis.size
    if x.shape[0] != P:
        raise ValueError(f"leading dim {x.shape[0]} != axis size {P}")
    schedule = sched.kported_scatter(P, k, c=1, root=root)
    me = axis.index
    cur = x.clone(memory_format=torch.contiguous_format)
    for rnd in schedule.rounds:
        for wave in _waves(rnd):
            # each message's blocks are one range of ranks, tuple(range(s, e))
            span = lambda m: slice(m.blocks[0], m.blocks[-1] + 1)  # noqa: E731
            sends = [(cur[span(m)], m.dst) for m in wave if m.src == me]
            recv = [(cur[span(m)], m.src) for m in wave if m.dst == me]
            axis.exchange(sends, recv)
    return cur[me]


# ---------------------------------------------------------------------------
# Flat baselines: one collective on the world group.
# ---------------------------------------------------------------------------


def flat_psum(x: torch.Tensor, outer: Axis, inner: Axis) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    outer.mesh.world.all_reduce(out)
    return out


def flat_all_to_all(x: torch.Tensor, outer: Axis, inner: Axis) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    outer.mesh.world.all_to_all(out, x.contiguous())
    return out
