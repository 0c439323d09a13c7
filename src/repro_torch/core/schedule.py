"""Round-based schedule generators for the paper's collective algorithms.

A *schedule* is the paper's object of study: an explicit, round-structured
communication pattern.  Each round is a set of point-to-point messages that
are posted concurrently; a message carries a set of abstract *blocks* so that
schedules can be verified by data-flow execution (a sender must hold every
block it sends at the *start* of the round — no intra-round forwarding).

Block encoding
  broadcast   : the single block ``BCAST_BLOCK`` (the whole payload).
  scatter     : block ``j``  == the final payload of processor ``j``.
  alltoall    : block ``a * p + b`` == the payload travelling ``a -> b``.

Generators implement the algorithms of paper §2 verbatim:

  k-ported (§2.1)
    * ``kported_broadcast``  — radix-(k+1) divide & conquer, local root
      ``r_i = s_i``; ``ceil(log_{k+1} p)`` rounds.
    * ``kported_scatter``    — same recursion, message-size optimal.
    * ``kported_alltoall``   — ``ceil((p-1)/k)`` rounds of k direct sends.
    * ``bruck_alltoall``     — radix-(k+1) message combining,
      ``ceil(log_{k+1} p)`` rounds (paper cites [3, 12]).

  adapted k-lane (§2.3)
    * ``klane_broadcast`` / ``klane_scatter`` — reuse the k-ported pattern
      across nodes with k cooperating on-node processors playing the k
      ports; on-node redistribution by 1-ported binomial trees.
    * ``klane_alltoall``  — ``N-1`` node rounds of n-step pairwise exchange
      plus a final on-node alltoall.

  full-lane problem splitting (§2.2, the paper's [8, 10])
    * ``fulllane_broadcast`` — on-node scatter, n concurrent inter-node
      broadcasts, on-node allgather.
    * ``fulllane_scatter``   — on-node scatter, n concurrent inter-node
      scatters (round and volume optimal).
    * ``fulllane_alltoall``  — on-node combining alltoall, n concurrent
      node-level alltoalls (all data communicated twice).

Pipeline position
-----------------
This module is the *generation* stage of the schedule pipeline

    generate (here) -> compile (core.schedule_ir) -> optimize (core.passes)
                    -> validate (core.validate)   -> simulate (core.simulate)

The generators stay paper-verbatim on purpose: the paper's explicitly
non-optimal round structures (e.g. the k-lane alltoall's (N-1)*n step
latency) are reproduced here and *improved* downstream by the optimizer
passes, so every delta between "paper" and "optimized" is attributable and
machine-checked.  The per-``Msg`` verifiers below remain the ground-truth
oracle that ``core.validate``'s array-native data-flow check is pinned
against in tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Sequence

from repro_torch.core.topology import Topology, log_radix

__all__ = [
    "Msg",
    "Round",
    "Schedule",
    "BCAST_BLOCK",
    "kported_broadcast",
    "kported_scatter",
    "kported_alltoall",
    "bruck_alltoall",
    "klane_broadcast",
    "klane_scatter",
    "klane_alltoall",
    "fulllane_broadcast",
    "fulllane_scatter",
    "fulllane_alltoall",
    "verify_broadcast",
    "verify_scatter",
    "verify_alltoall",
    "ALGORITHMS",
]

BCAST_BLOCK = -1  # sentinel block id: the whole broadcast payload.


@dataclasses.dataclass(frozen=True)
class Msg:
    src: int
    dst: int
    elems: int
    blocks: tuple  # abstract block ids carried by this message

    def __post_init__(self):
        if self.src == self.dst:
            raise ValueError(f"self-message {self.src}->{self.dst}")
        if self.elems < 0:
            raise ValueError("negative message size")


@dataclasses.dataclass(frozen=True)
class Round:
    msgs: tuple[Msg, ...]

    def senders(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for m in self.msgs:
            out[m.src] = out.get(m.src, 0) + 1
        return out

    def receivers(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for m in self.msgs:
            out[m.dst] = out.get(m.dst, 0) + 1
        return out


@dataclasses.dataclass(frozen=True)
class Schedule:
    op: str  # "broadcast" | "scatter" | "alltoall"
    algorithm: str  # e.g. "kported", "klane", "fulllane", "bruck"
    p: int
    k: int
    rounds: tuple[Round, ...]

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    def total_elems(self) -> int:
        return sum(m.elems for r in self.rounds for m in r.msgs)

    def max_port_width(self) -> int:
        """Max number of concurrent sends or receives at any processor in
        any round — 1 for lane-legal schedules, <= k for k-ported ones."""
        width = 0
        for r in self.rounds:
            for cnt in r.senders().values():
                width = max(width, cnt)
            for cnt in r.receivers().values():
                width = max(width, cnt)
        return width


# ---------------------------------------------------------------------------
# Generic radix-(k+1) divide & conquer over an arbitrary ordered rank list.
# This *is* the paper's §2.1 algorithm; with k=1 it degenerates to the
# binomial tree used for the on-node phases of the k-lane algorithms.
# ---------------------------------------------------------------------------


def _split_ranges(s: int, e: int, k: int) -> list[tuple[int, int]]:
    """Split [s, e) into up to k+1 subranges differing in size by <= 1."""
    size = e - s
    parts = min(k + 1, size)
    base, rem = divmod(size, parts)
    out = []
    cur = s
    for i in range(parts):
        nxt = cur + base + (1 if i < rem else 0)
        out.append((cur, nxt))
        cur = nxt
    return out


def _dnc_rounds(
    ranks: Sequence[int],
    k: int,
    root_pos: int,
    payload: Callable[[int, int], tuple[int, tuple]],
) -> list[Round]:
    """Divide & conquer over ``ranks`` (positions 0..m-1), radix k+1.

    ``payload(s, e)`` returns ``(elems, blocks)`` for a message that seeds
    subrange [s, e) — the whole payload for broadcast, the subrange's blocks
    for scatter.
    """
    m = len(ranks)
    if m <= 1:
        return []
    rounds: list[Round] = []
    active: list[tuple[int, int, int]] = [(0, m, root_pos)]  # (s, e, root)
    while any(e - s > 1 for s, e, _ in active):
        msgs: list[Msg] = []
        nxt: list[tuple[int, int, int]] = []
        for s, e, r in active:
            if e - s == 1:
                nxt.append((s, e, r))
                continue
            subs = _split_ranges(s, e, k)
            for (si, ei) in subs:
                if si <= r < ei:
                    nxt.append((si, ei, r))  # root keeps its own subrange
                else:
                    ri = si  # paper: "r_i could be chosen as s_i"
                    elems, blocks = payload(si, ei)
                    msgs.append(
                        Msg(src=ranks[r], dst=ranks[ri], elems=elems, blocks=blocks)
                    )
                    nxt.append((si, ei, ri))
        active = nxt
        rounds.append(Round(tuple(msgs)))
    return rounds


# ---------------------------------------------------------------------------
# §2.1 k-ported algorithms.
# ---------------------------------------------------------------------------


def kported_broadcast(p: int, k: int, c: int, root: int = 0) -> Schedule:
    rounds = _dnc_rounds(
        list(range(p)), k, root, payload=lambda s, e: (c, (BCAST_BLOCK,))
    )
    return Schedule("broadcast", "kported", p, k, tuple(rounds))


def kported_scatter(p: int, k: int, c: int, root: int = 0) -> Schedule:
    """``c`` is the per-processor block size (paper tables' count)."""

    def payload(s: int, e: int) -> tuple[int, tuple]:
        blocks = tuple(range(s, e))
        return c * len(blocks), blocks

    rounds = _dnc_rounds(list(range(p)), k, root, payload=payload)
    return Schedule("scatter", "kported", p, k, tuple(rounds))


def kported_alltoall(p: int, k: int, c: int) -> Schedule:
    """Direct alltoall: round t, proc i sends block (i -> (i+t*k+l) mod p)
    for l = 1..k.  ``c`` is the per-pair block size."""
    rounds: list[Round] = []
    offset = 1
    while offset < p:
        msgs = []
        for l in range(k):
            if offset + l >= p:
                break
            d = offset + l
            for i in range(p):
                j = (i + d) % p
                msgs.append(Msg(i, j, c, (i * p + j,)))
        rounds.append(Round(tuple(msgs)))
        offset += k
    return Schedule("alltoall", "kported", p, k, tuple(rounds))


def bruck_alltoall(p: int, k: int, c: int) -> Schedule:
    """Radix-(k+1) message-combining alltoall (paper's [3]):
    ``ceil(log_{k+1} p)`` rounds at the cost of each block travelling up to
    that many hops.  Block (a -> b) sits at proc q with remaining offset
    (b - q) mod p; round t clears digit t (base k+1) of the offset."""
    r = k + 1
    held: list[set[int]] = [set(i * p + j for j in range(p)) for i in range(p)]
    rounds: list[Round] = []
    phase, radix_pow = 0, 1
    while radix_pow < p:
        msgs = []
        moved: list[list[set[int]]] = [[set() for _ in range(r)] for _ in range(p)]
        for q in range(p):
            for blk in held[q]:
                b = blk % p
                off = (b - q) % p
                digit = (off // radix_pow) % r
                if digit:
                    moved[q][digit].add(blk)
        for q in range(p):
            for digit in range(1, r):
                blks = moved[q][digit]
                if not blks:
                    continue
                dst = (q + digit * radix_pow) % p
                msgs.append(Msg(q, dst, c * len(blks), tuple(sorted(blks))))
        for m in msgs:
            held[m.src] -= set(m.blocks)
            held[m.dst] |= set(m.blocks)
        rounds.append(Round(tuple(msgs)))
        radix_pow *= r
        phase += 1
    return Schedule("alltoall", "bruck", p, k, tuple(rounds))


# ---------------------------------------------------------------------------
# On-node building blocks (1-ported binomial / Bruck patterns on a rank list).
# ---------------------------------------------------------------------------


def _binomial_bcast_rounds(
    ranks: Sequence[int], root_pos: int, elems: int, blocks: tuple
) -> list[Round]:
    return _dnc_rounds(ranks, 1, root_pos, payload=lambda s, e: (elems, blocks))


def _binomial_scatter_rounds(
    ranks: Sequence[int],
    root_pos: int,
    blocks_of: Callable[[int], tuple],
    elems_per_block: int,
) -> list[Round]:
    """Scatter over ``ranks`` where position ``i`` must end up with blocks
    ``blocks_of(i)`` (all the same element count)."""

    def payload(s: int, e: int) -> tuple[int, tuple]:
        blocks: tuple = ()
        for i in range(s, e):
            blocks = blocks + blocks_of(i)
        return elems_per_block * len(blocks), blocks

    return _dnc_rounds(ranks, 1, root_pos, payload=payload)


def _bruck_allgather_rounds(
    ranks: Sequence[int],
    held: list[set[int]],
    elems_per_block: int,
) -> list[Round]:
    """ceil(log2 m) allgather over ``ranks``; ``held[i]`` is the initial
    block set at position i (mutated to the final state)."""
    m = len(ranks)
    rounds = []
    dist = 1
    while dist < m:
        msgs = []
        transfers = []
        for i in range(m):
            dst = (i - dist) % m
            blks = held[i] - held[dst]
            if blks:
                msgs.append(
                    Msg(
                        ranks[i],
                        ranks[dst],
                        elems_per_block * len(blks),
                        tuple(sorted(blks)),
                    )
                )
                transfers.append((dst, set(blks)))
        for dst, blks in transfers:
            held[dst] |= blks
        rounds.append(Round(tuple(msgs)))
        dist *= 2
    return rounds


def _ring_alltoall_rounds(
    ranks: Sequence[int],
    block_of: Callable[[int, int], tuple],
    elems_of: Callable[[int, int], int],
) -> list[Round]:
    """m-1 rounds of pairwise exchange over ``ranks``: round t, position i
    sends ``block_of(i, (i+t) % m)`` to position (i+t) % m."""
    m = len(ranks)
    rounds = []
    for t in range(1, m):
        msgs = []
        for i in range(m):
            j = (i + t) % m
            blocks = block_of(i, j)
            if blocks:
                msgs.append(Msg(ranks[i], ranks[j], elems_of(i, j), blocks))
        rounds.append(Round(tuple(msgs)))
    return rounds


# ---------------------------------------------------------------------------
# §2.3 adapted k-lane algorithms.
# ---------------------------------------------------------------------------


def klane_broadcast(topo: Topology, k: int, c: int, root: int = 0) -> Schedule:
    """k-ported divide & conquer over *nodes*, with the first k processors
    of each informed node acting as the k ports.  Mirrors the paper's
    implementation: a node that first receives the payload does a full
    on-node broadcast (so any of its first k procs can serve as a port)."""
    N, n = topo.num_nodes, topo.procs_per_node
    k = min(k, n)
    root_node = topo.node_of(root)
    rounds: list[Round] = []

    # Phase A: full on-node broadcast at the root node.
    node_ranks = [topo.rank_of(root_node, l) for l in range(n)]
    rounds += _binomial_bcast_rounds(
        node_ranks, topo.local_rank(root), c, (BCAST_BLOCK,)
    )

    # Phase B: k-ported divide & conquer over node ids; whenever a node is
    # seeded we append its on-node broadcast rounds immediately after.
    active: list[tuple[int, int, int]] = [(0, N, root_node)]
    # node order rotated so that root_node participates naturally
    while any(e - s > 1 for s, e, _ in active):
        inter_msgs: list[Msg] = []
        seeded: list[int] = []
        nxt: list[tuple[int, int, int]] = []
        port = {}  # next unused port index per sending node this round
        for s, e, r in active:
            if e - s == 1:
                nxt.append((s, e, r))
                continue
            subs = _split_ranges(s, e, k)
            for (si, ei) in subs:
                if si <= r < ei:
                    nxt.append((si, ei, r))
                else:
                    pi = port.get(r, 0)
                    port[r] = pi + 1
                    src = topo.rank_of(r, pi % n)
                    dst = topo.rank_of(si, 0)
                    inter_msgs.append(Msg(src, dst, c, (BCAST_BLOCK,)))
                    seeded.append(si)
                    nxt.append((si, ei, si))
        active = nxt
        rounds.append(Round(tuple(inter_msgs)))
        # on-node broadcasts at every node seeded this round (concurrent).
        local_rounds: list[list[Msg]] = []
        for v in seeded:
            vranks = [topo.rank_of(v, l) for l in range(n)]
            for i, rnd in enumerate(_binomial_bcast_rounds(vranks, 0, c, (BCAST_BLOCK,))):
                while len(local_rounds) <= i:
                    local_rounds.append([])
                local_rounds[i].extend(rnd.msgs)
        rounds += [Round(tuple(ms)) for ms in local_rounds if ms]
    return Schedule("broadcast", "klane", topo.p, k, tuple(r for r in rounds if r.msgs))


def klane_scatter(topo: Topology, k: int, c: int, root: int = 0) -> Schedule:
    """Adapted k-lane scatter: the node-level k-ported scatter recursion,
    where a receiving node's local root first scatters the outgoing block
    groups to k-1 helpers which then drive the k ports concurrently; a final
    on-node scatter delivers the node's own blocks."""
    N, n = topo.num_nodes, topo.procs_per_node
    k = min(k, n)
    root_node = topo.node_of(root)
    p = topo.p
    rounds: list[Round] = []

    def node_blocks(s: int, e: int) -> tuple:
        return tuple(
            topo.rank_of(v, l) for v in range(s, e) for l in range(n)
        )

    # Node-level recursion state: (s, e, root_node); the node root's local
    # rank 0..  At each step, the node root holds all blocks for [s, e).
    # Before the inter-node round, it scatters the k outgoing groups to
    # helper procs 1..k-1 (group 0 stays with the root) — one on-node round.
    active: list[tuple[int, int, int]] = [(0, N, root_node)]
    holder: dict[int, int] = {root_node: root}  # node -> rank holding its range
    while any(e - s > 1 for s, e, _ in active):
        pre_msgs: list[Msg] = []
        inter_msgs: list[Msg] = []
        nxt: list[tuple[int, int, int]] = []
        for s, e, r in active:
            if e - s == 1:
                nxt.append((s, e, r))
                continue
            subs = _split_ranges(s, e, k)
            h = holder[r]
            outgoing = [
                (si, ei) for (si, ei) in subs if not (si <= r < ei)
            ]
            # on-node pre-distribution: helper j gets group j's blocks
            for j, (si, ei) in enumerate(outgoing):
                helper = topo.rank_of(r, (topo.local_rank(h) + j) % n)
                blocks = node_blocks(si, ei)
                if helper != h:
                    pre_msgs.append(Msg(h, helper, c * len(blocks), blocks))
                inter_msgs.append(
                    Msg(helper, topo.rank_of(si, 0), c * len(blocks), blocks)
                )
                holder[si] = topo.rank_of(si, 0)
                nxt.append((si, ei, si))
            for (si, ei) in subs:
                if si <= r < ei:
                    nxt.append((si, ei, r))
        active = nxt
        if pre_msgs:
            rounds.append(Round(tuple(pre_msgs)))
        rounds.append(Round(tuple(inter_msgs)))

    # Final on-node scatter of each node's own n blocks from its holder.
    final: list[Msg] = []
    local_rounds: list[list[Msg]] = []
    for v in range(N):
        h = holder.get(v)
        if h is None:  # root node kept custody at `root`
            h = root
        vranks = [topo.rank_of(v, l) for l in range(n)]
        rot = topo.local_rank(h)

        def blocks_of(pos: int, v=v, vranks=vranks, rot=rot) -> tuple:
            return (vranks[(pos + rot) % n],)

        sub = _binomial_scatter_rounds(
            [vranks[(i + rot) % n] for i in range(n)], 0, blocks_of, c
        )
        for i, rnd in enumerate(sub):
            while len(local_rounds) <= i:
                local_rounds.append([])
            local_rounds[i].extend(rnd.msgs)
    rounds += [Round(tuple(ms)) for ms in local_rounds if ms]
    return Schedule("scatter", "klane", p, k, tuple(r for r in rounds if r.msgs))


def klane_alltoall(topo: Topology, c: int) -> Schedule:
    """§2.3 alltoall: N-1 node rounds; in round r every proc (v, j) exchanges
    with node (v+r) mod N in n lane-legal steps (step s: (v,j) -> (v+r, (j+s)
    mod n)); a final on-node alltoall.  k is not a parameter (the paper notes
    this); every step saturates whatever off-node bandwidth exists."""
    N, n = topo.num_nodes, topo.procs_per_node
    p = topo.p
    rounds: list[Round] = []
    for r in range(1, N):
        for s in range(n):
            msgs = []
            for v in range(N):
                w = (v + r) % N
                for j in range(n):
                    src = topo.rank_of(v, j)
                    dst = topo.rank_of(w, (j + s) % n)
                    msgs.append(Msg(src, dst, c, (src * p + dst,)))
            rounds.append(Round(tuple(msgs)))
    # final on-node alltoall (n-1 lane-legal steps per node, concurrent).
    for s in range(1, n):
        msgs = []
        for v in range(N):
            for j in range(n):
                src = topo.rank_of(v, j)
                dst = topo.rank_of(v, (j + s) % n)
                msgs.append(Msg(src, dst, c, (src * p + dst,)))
        rounds.append(Round(tuple(msgs)))
    return Schedule("alltoall", "klane", p, topo.k_lanes, tuple(rounds))


# ---------------------------------------------------------------------------
# §2.2 full-lane (problem splitting) algorithms.
# ---------------------------------------------------------------------------


def fulllane_broadcast(topo: Topology, c: int, root: int = 0) -> Schedule:
    """Split c over the n on-node procs; n concurrent 1-ported binomial
    broadcasts over the N nodes (lane group l = procs with local rank l);
    on-node Bruck allgather to reassemble.  The payload is modelled as n
    pseudo-blocks (ids 0..n-1) of ~c/n elements."""
    N, n = topo.num_nodes, topo.procs_per_node
    root_node, root_local = topo.node_of(root), topo.local_rank(root)
    chunk = -(-c // n)  # ceil
    rounds: list[Round] = []

    # Phase A: on-node scatter of the n chunks from the root.
    vranks = [topo.rank_of(root_node, l) for l in range(n)]
    rounds += _binomial_scatter_rounds(
        vranks, root_local, blocks_of=lambda pos: (pos,), elems_per_block=chunk
    )

    # Phase B: n concurrent binomial broadcasts across nodes (chunk l over
    # lane group l).  All groups share round structure -> merge per round.
    group_rounds: list[list[Msg]] = []
    for l in range(n):
        granks = [topo.rank_of(v, l) for v in range(N)]
        sub = _binomial_bcast_rounds(granks, root_node, chunk, (l,))
        for i, rnd in enumerate(sub):
            while len(group_rounds) <= i:
                group_rounds.append([])
            group_rounds[i].extend(rnd.msgs)
    rounds += [Round(tuple(ms)) for ms in group_rounds if ms]

    # Phase C: on-node allgather of the n chunks, concurrently on all nodes.
    ag_rounds: list[list[Msg]] = []
    for v in range(N):
        vranks = [topo.rank_of(v, l) for l in range(n)]
        held = [{l} for l in range(n)]
        sub = _bruck_allgather_rounds(vranks, held, chunk)
        for i, rnd in enumerate(sub):
            while len(ag_rounds) <= i:
                ag_rounds.append([])
            ag_rounds[i].extend(rnd.msgs)
    rounds += [Round(tuple(ms)) for ms in ag_rounds if ms]
    return Schedule("broadcast", "fulllane", topo.p, topo.k_lanes,
                    tuple(r for r in rounds if r.msgs))


def fulllane_scatter(topo: Topology, c: int, root: int = 0) -> Schedule:
    """Round- and volume-optimal: on-node scatter splits the problem into n
    independent scatters (lane group l serves all procs with local rank l);
    then n concurrent 1-ported binomial scatters across nodes."""
    N, n = topo.num_nodes, topo.procs_per_node
    root_node, root_local = topo.node_of(root), topo.local_rank(root)
    rounds: list[Round] = []

    # Phase A: proc (root_node, l) receives the blocks of lane group l.
    vranks = [topo.rank_of(root_node, l) for l in range(n)]

    def lane_blocks(pos: int) -> tuple:
        return tuple(topo.rank_of(v, pos) for v in range(N))

    rounds += _binomial_scatter_rounds(
        vranks, root_local, blocks_of=lane_blocks, elems_per_block=c
    )

    # Phase B: n concurrent binomial scatters over the node dimension.
    group_rounds: list[list[Msg]] = []
    for l in range(n):
        granks = [topo.rank_of(v, l) for v in range(N)]
        sub = _binomial_scatter_rounds(
            granks, root_node,
            blocks_of=lambda pos, l=l: (topo.rank_of(pos, l),),
            elems_per_block=c,
        )
        for i, rnd in enumerate(sub):
            while len(group_rounds) <= i:
                group_rounds.append([])
            group_rounds[i].extend(rnd.msgs)
    rounds += [Round(tuple(ms)) for ms in group_rounds if ms]
    return Schedule("scatter", "fulllane", topo.p, topo.k_lanes,
                    tuple(r for r in rounds if r.msgs))


def fulllane_alltoall(topo: Topology, c: int) -> Schedule:
    """On-node combining alltoall (proc (v, l) collects every block destined
    to local rank l anywhere), then n concurrent node-level alltoalls (lane
    group l delivers straight to the final owners).  All data moves twice —
    the paper's stated cost."""
    N, n = topo.num_nodes, topo.procs_per_node
    p = topo.p
    rounds: list[Round] = []

    # Phase A: on-node alltoall; (v, j) -> (v, l): blocks from (v, j) to any
    # proc with local rank l.  n-1 lane-legal steps, concurrent over nodes.
    for s in range(1, n):
        msgs = []
        for v in range(N):
            for j in range(n):
                l = (j + s) % n
                src = topo.rank_of(v, j)
                dst = topo.rank_of(v, l)
                blocks = tuple(
                    src * p + topo.rank_of(w, l) for w in range(N)
                )
                msgs.append(Msg(src, dst, c * len(blocks), blocks))
        rounds.append(Round(tuple(msgs)))

    # Phase B: lane group l runs an (N-1)-round ring alltoall of combined
    # node blocks (n source-procs x 1 dst-proc = n*c elements per message).
    for t in range(1, N):
        msgs = []
        for v in range(N):
            w = (v + t) % N
            for l in range(n):
                src = topo.rank_of(v, l)
                dst = topo.rank_of(w, l)
                blocks = tuple(
                    topo.rank_of(v, j) * p + dst for j in range(n)
                )
                msgs.append(Msg(src, dst, c * len(blocks), blocks))
        rounds.append(Round(tuple(msgs)))
    return Schedule("alltoall", "fulllane", p, topo.k_lanes, tuple(rounds))


# ---------------------------------------------------------------------------
# Data-flow verification.
# ---------------------------------------------------------------------------


def _execute(schedule: Schedule, initial: dict[int, set]) -> dict[int, set]:
    """Execute a schedule under no-intra-round-forwarding semantics and
    return the final possession map.  Raises on causality violations."""
    held = {i: set(b) for i, b in initial.items()}
    for t, rnd in enumerate(schedule.rounds):
        additions: list[tuple[int, set]] = []
        for m in rnd.msgs:
            missing = set(m.blocks) - held.get(m.src, set())
            if missing:
                raise AssertionError(
                    f"round {t}: {m.src}->{m.dst} sends blocks it does not "
                    f"hold: {sorted(missing)[:5]}"
                )
            additions.append((m.dst, set(m.blocks)))
        for dst, blocks in additions:
            held.setdefault(dst, set()).update(blocks)
    return held


def verify_broadcast(schedule: Schedule, root: int = 0) -> None:
    # The payload may be modelled as a single block (tree algorithms) or as
    # n chunks (full-lane splitting); the root initially holds all of it and
    # every processor must end up with all of it.
    universe = set()
    for rnd in schedule.rounds:
        for m in rnd.msgs:
            universe.update(m.blocks)
    if not universe:
        universe = {BCAST_BLOCK}
    held = _execute(schedule, {root: set(universe)})
    for i in range(schedule.p):
        missing = universe - held.get(i, set())
        assert not missing, f"proc {i} missing payload chunks {sorted(missing)[:5]}"


def verify_scatter(schedule: Schedule, root: int = 0) -> None:
    held = _execute(schedule, {root: set(range(schedule.p))})
    for i in range(schedule.p):
        assert i in held.get(i, set()), f"proc {i} never got its block"


def verify_alltoall(schedule: Schedule) -> None:
    p = schedule.p
    init = {i: set(i * p + j for j in range(p)) for i in range(p)}
    held = _execute(schedule, init)
    for j in range(p):
        for i in range(p):
            assert i * p + j in held[j], f"block {i}->{j} never delivered"


#: registry used by the simulator benchmarks: (op, algorithm) -> generator.
ALGORITHMS = {
    ("broadcast", "kported"): lambda topo, k, c: kported_broadcast(topo.p, k, c),
    ("broadcast", "klane"): lambda topo, k, c: klane_broadcast(topo, k, c),
    ("broadcast", "fulllane"): lambda topo, k, c: fulllane_broadcast(topo, c),
    ("scatter", "kported"): lambda topo, k, c: kported_scatter(topo.p, k, c),
    ("scatter", "klane"): lambda topo, k, c: klane_scatter(topo, k, c),
    ("scatter", "fulllane"): lambda topo, k, c: fulllane_scatter(topo, c),
    ("alltoall", "kported"): lambda topo, k, c: kported_alltoall(topo.p, k, c),
    ("alltoall", "bruck"): lambda topo, k, c: bruck_alltoall(topo.p, k, c),
    ("alltoall", "klane"): lambda topo, k, c: klane_alltoall(topo, c),
    ("alltoall", "fulllane"): lambda topo, k, c: fulllane_alltoall(topo, c),
}
