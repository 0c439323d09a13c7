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

Every function is differentiable (``torch.autograd``): each is linear in
its input, and its backward applies the adjoint map to the cotangent,
through the same ``Axis`` operations (so the backward's traffic is
counted too).  The convention is that of the reference under
``shard_map(..., check_vma=False)``: the gradient each rank gets is that of
the sum of every rank's loss, so the backward of an all-reduce is an
all-reduce.  The adjoints:

- ``flat_psum``: an all-reduce of the cotangent;
- ``hierarchical_psum`` (``fulllane_psum``): the same three phases, since
  the adjoint of an all-gather is a reduce-scatter and the reverse holds;
- ``fulllane_broadcast``: reduce-scatter over ``inner``, all-reduce over
  ``outer``, zero on every pod but ``root``;
- ``flat_all_to_all`` and ``fulllane_all_to_all``: the same op, since the
  global block permutation is an involution (so a full-lane call with its
  backward launches ``a2a_pack`` four times on a card);
- ``kported_broadcast_ppermute``: a reduction to ``root`` along the
  schedule's waves in reverse, each receiver sending its cotangent back to
  its sender and keeping zero (its input was overwritten), each sender
  adding what comes back;
- ``kported_scatter_ppermute``: a gather to ``root`` along the reversed
  waves; only the root's input gets a nonzero gradient.

The reference's own default, ``check_vma=True``, transposes its collectives
otherwise: there ``hierarchical_psum``'s gradient is ``inner.size`` times
``flat_psum``'s, though the two sums are equal (ROADMAP, reference
caveats).  The port follows ``check_vma=False``, where both agree.
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


class _Linear(torch.autograd.Function):
    """A collective as a linear map ``fwd`` with its adjoint: the backward
    applies ``adjoint`` to the cotangent (contiguous, the output's dtype,
    which is the input's)."""

    @staticmethod
    def forward(ctx, x, fwd, adjoint):
        ctx.adjoint = adjoint
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.adjoint(g.contiguous()), None, None


def _linear(x: torch.Tensor, fwd, adjoint=None) -> torch.Tensor:
    """``fwd(x)``, differentiable through ``adjoint`` (None: ``fwd`` is its
    own adjoint)."""
    return _Linear.apply(x, fwd, adjoint or fwd)


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
    ``2*C/n``.  Its own adjoint."""
    return _linear(x, lambda t: _hierarchical_psum(t, outer, inner))


def _hierarchical_psum(x: torch.Tensor, outer: Axis, inner: Axis) -> torch.Tensor:
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

    def fwd(t):
        seeded = (t.clone(memory_format=torch.contiguous_format) if outer.index == root
                  else torch.zeros(t.shape, dtype=t.dtype, device=t.device))
        outer.all_reduce(seeded)  # the chunk broadcast across pods
        out = torch.empty((inner.size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        inner.all_gather(out, seeded)
        return out

    def adjoint(g):
        part = torch.empty((g.shape[0] // inner.size,) + tuple(g.shape[1:]), dtype=g.dtype,
                           device=g.device)
        inner.reduce_scatter(part, g)
        outer.all_reduce(part)
        return part if outer.index == root else torch.zeros_like(part)

    return _linear(x, fwd, adjoint)


def fulllane_all_to_all(x: torch.Tensor, outer: Axis, inner: Axis) -> torch.Tensor:
    """Hierarchical all-to-all over the merged (outer, inner) axis.

    The same result as ``flat_all_to_all`` for this rank's input ``[P,
    ...]`` with ``P = No * Ni`` blocks ordered destination-major ``dest = o
    * Ni + i``: block ``x[d]`` of rank ``s`` ends up as block ``s`` of rank
    ``d``.  Phase A combines blocks by destination inner rank with an
    on-node all-to-all; phase B delivers the node-combined blocks with
    ``Ni`` concurrent pod-level all-to-alls.  All data moves twice, but the
    cross-pod traffic of a rank goes in ``No - 1`` combined messages, every
    lane busy.  Its own adjoint."""
    if x.shape[0] != outer.size * inner.size:
        raise ValueError(f"leading dim {x.shape[0]} != mesh size {outer.size * inner.size}")
    return _linear(x, lambda t: _fulllane_all_to_all(t, outer, inner))


def _fulllane_all_to_all(x: torch.Tensor, outer: Axis, inner: Axis) -> torch.Tensor:
    No, Ni = outer.size, inner.size
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
    return u.view((No * Ni,) + blk)


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


def _reversed_waves(schedule: sched.Schedule) -> list[list[sched.Msg]]:
    """Every wave of ``schedule``, last first: the order of a backward."""
    return [w for rnd in reversed(schedule.rounds) for w in reversed(_waves(rnd))]


def kported_broadcast_ppermute(x: torch.Tensor, axis: Axis, *, k: int,
                               root: int = 0) -> torch.Tensor:
    """The paper's radix-(k+1) divide-and-conquer broadcast from ``root``,
    run as ``ceil(log_{k+1} P)`` rounds of up to k waves.  Each wave is one
    batch of point-to-point messages on ``axis``; a rank that is a
    destination of the wave takes what it receives, the others keep theirs.
    Returns the root's ``x`` on every rank."""
    schedule = sched.kported_broadcast(axis.size, k, c=1, root=root)
    me = axis.index

    def fwd(t):
        cur = t.clone(memory_format=torch.contiguous_format)
        for rnd in schedule.rounds:
            for wave in _waves(rnd):
                sends = [(cur, m.dst) for m in wave if m.src == me]
                recv = [(torch.empty_like(cur), m.src) for m in wave if m.dst == me]
                axis.exchange(sends, recv)
                if recv:
                    cur = recv[0][0]
        return cur

    def adjoint(g):
        acc = g.clone()
        for wave in _reversed_waves(schedule):
            # a receiver's input was overwritten: its cotangent goes back to
            # its sender, which adds it to its own
            sends = [(acc, m.src) for m in wave if m.dst == me]
            recv = [(torch.empty_like(acc), m.dst) for m in wave if m.src == me]
            axis.exchange(sends, recv)
            if sends:
                acc = torch.zeros_like(acc)
            for t, _ in recv:
                acc += t
        return acc

    return _linear(x, fwd, adjoint)


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

    def span(m: sched.Msg) -> slice:
        # each message's blocks are one range of ranks, tuple(range(s, e))
        return slice(m.blocks[0], m.blocks[-1] + 1)

    def fwd(t):
        cur = t.clone(memory_format=torch.contiguous_format)
        for rnd in schedule.rounds:
            for wave in _waves(rnd):
                sends = [(cur[span(m)], m.dst) for m in wave if m.src == me]
                recv = [(cur[span(m)], m.src) for m in wave if m.dst == me]
                axis.exchange(sends, recv)
        return cur[me]

    def adjoint(g):
        acc = torch.zeros((P,) + tuple(g.shape), dtype=g.dtype, device=g.device)
        acc[me] = g
        for wave in _reversed_waves(schedule):
            got = [m for m in wave if m.dst == me]
            gave = [m for m in wave if m.src == me]
            recv = [(torch.empty_like(acc[span(m)]), m.dst) for m in gave]
            axis.exchange([(acc[span(m)], m.src) for m in got], recv)
            for m in got:  # those rows were overwritten by the receive
                acc[span(m)] = 0
            for (t, _), m in zip(recv, gave):
                acc[span(m)] += t
        return acc

    return _linear(x, fwd, adjoint)


# ---------------------------------------------------------------------------
# Flat baselines: one collective on the world group.
# ---------------------------------------------------------------------------


def flat_psum(x: torch.Tensor, outer: Axis, inner: Axis) -> torch.Tensor:
    """The sum over every rank, one all-reduce on the world group.  Its own
    adjoint."""

    def fwd(t):
        out = t.clone(memory_format=torch.contiguous_format)
        outer.mesh.world.all_reduce(out)
        return out

    return _linear(x, fwd)


def flat_all_to_all(x: torch.Tensor, outer: Axis, inner: Axis) -> torch.Tensor:
    """Block ``x[d]`` of rank ``s`` to block ``s`` of rank ``d``, one
    all-to-all on the world group.  Its own adjoint."""

    def fwd(t):
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        outer.mesh.world.all_to_all(out, t.contiguous())
        return out

    return _linear(x, fwd)
