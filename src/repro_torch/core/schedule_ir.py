"""Compiled structure-of-arrays IR for round-based schedules.

The legacy :mod:`repro_torch.core.schedule` representation materializes every
message as a frozen ``Msg`` dataclass; at paper scale (p = 36*32 = 1152) the
O(p^2)-message alltoall families allocate >1M Python objects per schedule and
dominate both generation and simulation time.  This module is the compiled
counterpart: a :class:`CompiledSchedule` stores one flat numpy array per
message field (``src``, ``dst``, ``elems``) plus a CSR-style ``round_ptr``
delimiting rounds, and the simulator reduces over these arrays with
``np.bincount`` instead of per-message Python dict updates.

Two entry points produce the IR:

* :func:`compile_schedule` flattens any legacy ``Schedule`` (every generator
  keeps working unchanged);
* the ``*_ir`` array-native generators build the O(p^2) alltoall families
  (``kported``, ``bruck``, ``klane``, ``fulllane``) directly as arrays and
  never construct a single ``Msg``.  They are round-for-round,
  message-multiset-identical to their legacy counterparts (pinned by
  ``tests/test_schedule_ir.py``) — including the per-message block CSR.

The IR is the *compile* stage of the schedule pipeline

    generate (core.schedule) -> compile (here) -> optimize (core.passes)
                             -> validate (core.validate) -> simulate

``compiled_schedule(..., optimize="lane"|"ported")`` hands the cached IR to
the optimizer's round-compaction pipeline and caches the (oracle-validated)
rewrite under its own key.

Block-metadata ownership rules
------------------------------
The IR carries per-message abstract block ids in **CSR form**:
``blk_ptr[i]:blk_ptr[i+1]`` delimits message ``i``'s slice of ``blk_ids``
(ids sorted ascending within a message — the canonical order, matching the
legacy ``tuple(sorted(blocks))`` convention).  Block metadata is what makes
a schedule *checkable*: the array-native validity oracle
(:mod:`repro_torch.core.validate`) replays data-flow over these arrays with two
sorts instead of per-message set updates, and the optimizer passes
(:mod:`repro_torch.core.passes`) consult them to keep round merges causally
legal.  Rules:

* the ``*_ir`` generators always attach blocks (array-natively — no Msg
  objects); ``compile_schedule(..., with_blocks=True)`` flattens legacy
  ``Msg.blocks`` into the same canonical form;
* ``compile_schedule`` without ``with_blocks`` still drops the metadata
  (cheapest path when only the cost model is needed); schedules without
  blocks cannot be validated or safely rewritten — ``validate`` and the
  compaction pass refuse them rather than trust them;
* ppermute compilation in ``core.collectives`` remains on the legacy
  ``Msg`` path (it needs per-message python tuples anyway).

Topology-dependent per-round statistics (node classification of each
message) are cached on the compiled schedule per ``procs_per_node``, so
re-simulating the same structure under several machine models — or, via the
schedule cache, at several payload sizes — never re-derives them.

Process-wide schedule cache
---------------------------
:func:`compiled_schedule` memoizes compiled schedules keyed by
``(op, algorithm, topo, k, c, root)``.  Round structure is independent of
the per-block payload ``c`` (only ``elems`` scales with it), which the
cost-model selector exploits by simulating two payload sizes and
interpolating the affine ``A + B*c`` round cost (see
``core.selector.affine_cost``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np

from repro_torch.core import schedule as sched
from repro_torch.core.topology import Topology
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import TRACER

__all__ = [
    "CompiledSchedule",
    "RoundStats",
    "compile_schedule",
    "segmented_arange",
    "gather_block_csr",
    "split_messages",
    "merge_messages",
    "relay_messages",
    "kported_alltoall_ir",
    "bruck_alltoall_ir",
    "klane_alltoall_ir",
    "fulllane_alltoall_ir",
    "IR_GENERATORS",
    "compiled_schedule",
    "schedule_cache_info",
    "schedule_cache_clear",
    "schedule_cache_reset",
    "cache_export",
    "cache_seed",
]


@dataclasses.dataclass(frozen=True)
class RoundStats:
    """Per-(round, proc) and per-(round, node) aggregates for one
    ``procs_per_node`` partitioning of a compiled schedule.

    All 2-D arrays are dense ``[R, p]`` or ``[R, N]`` float64/int64 grids;
    entries for (round, proc/node) pairs with no traffic are zero and masked
    by the corresponding ``*_cnt > 0`` test (matching the legacy simulator,
    which only iterates over dict keys that were touched).
    """

    send_elems: np.ndarray  # [R, p] float64 (exact: integer-valued < 2^53)
    send_cnt: np.ndarray  # [R, p] int64
    send_inter: np.ndarray  # [R, p] bool — proc had >= 1 off-node send
    recv_elems: np.ndarray  # [R, p] float64
    recv_cnt: np.ndarray  # [R, p] int64
    recv_inter: np.ndarray  # [R, p] bool
    node_out: np.ndarray  # [R, N] float64, off-node elems leaving
    node_in: np.ndarray  # [R, N] float64
    node_out_msgs: np.ndarray  # [R, N] int64
    node_in_msgs: np.ndarray  # [R, N] int64
    node_intra: np.ndarray  # [R, N] float64
    node_intra_cnt: np.ndarray  # [R, N] int64
    inter_elems: int  # total off-node traffic
    intra_elems: int  # total on-node traffic


@dataclasses.dataclass(frozen=True)
class CompiledSchedule:
    """Structure-of-arrays schedule: flat message arrays + round offsets.

    ``round_ptr`` has length ``num_rounds + 1``; round ``r`` owns messages
    ``round_ptr[r]:round_ptr[r+1]`` (possibly empty, preserving the legacy
    round count for ``SimResult.rounds`` parity).
    """

    op: str
    algorithm: str
    p: int
    k: int
    src: np.ndarray  # int64 [M]
    dst: np.ndarray  # int64 [M]
    elems: np.ndarray  # int64 [M]
    round_ptr: np.ndarray  # int64 [R+1]
    # optional CSR block metadata: message i carries blk_ids[blk_ptr[i]:
    # blk_ptr[i+1]] (sorted ascending within the message).  None on
    # schedules compiled without blocks; required by validate/passes.
    blk_ptr: np.ndarray | None = None  # int64 [M+1]
    blk_ids: np.ndarray | None = None  # int64 [sum(nblocks)]
    # per-procs_per_node derived statistics (lazily built, shared across
    # simulations of the same structure under different cost params).
    _stats: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def has_blocks(self) -> bool:
        return self.blk_ptr is not None and self.blk_ids is not None

    @property
    def num_rounds(self) -> int:
        return len(self.round_ptr) - 1

    @property
    def num_msgs(self) -> int:
        return int(self.src.size)

    def total_elems(self) -> int:
        return int(self.elems.sum())

    def round_ids(self) -> np.ndarray:
        """Round index of each message (``[M]`` int64)."""
        return np.repeat(
            np.arange(self.num_rounds, dtype=np.int64), np.diff(self.round_ptr)
        )

    def node_of(self, procs_per_node: int) -> tuple[np.ndarray, np.ndarray]:
        """(src_node, dst_node) arrays under a node partitioning."""
        return self.src // procs_per_node, self.dst // procs_per_node

    def max_port_width(self) -> int:
        """Max concurrent sends or receives at any processor in any round
        (parity with ``Schedule.max_port_width``)."""
        if self.num_msgs == 0:
            return 0
        rid = self.round_ids()
        skey = rid * self.p + self.src
        dkey = rid * self.p + self.dst
        n = self.num_rounds * self.p
        return int(
            max(
                np.bincount(skey, minlength=n).max(),
                np.bincount(dkey, minlength=n).max(),
            )
        )

    def stats(self, procs_per_node: int) -> RoundStats:
        """Aggregate per-round statistics under a node partitioning; cached
        per ``procs_per_node`` so repeated simulation shares the work."""
        cached = self._stats.get(procs_per_node)
        if cached is not None:
            return cached
        n = procs_per_node
        p, R = self.p, self.num_rounds
        if p % n:
            raise ValueError(f"p={p} not divisible by procs_per_node={n}")
        N = p // n
        rid = self.round_ids()
        snode = self.src // n
        dnode = self.dst // n
        inter = snode != dnode
        ew = self.elems.astype(np.float64)

        skey = rid * p + self.src
        dkey = rid * p + self.dst
        pm = R * p
        send_elems = np.bincount(skey, weights=ew, minlength=pm).reshape(R, p)
        send_cnt = np.bincount(skey, minlength=pm).reshape(R, p)
        send_inter = (
            np.bincount(skey[inter], minlength=pm).reshape(R, p) > 0
        )
        recv_elems = np.bincount(dkey, weights=ew, minlength=pm).reshape(R, p)
        recv_cnt = np.bincount(dkey, minlength=pm).reshape(R, p)
        recv_inter = (
            np.bincount(dkey[inter], minlength=pm).reshape(R, p) > 0
        )

        nskey = rid * N + snode
        ndkey = rid * N + dnode
        nm = R * N
        node_out = np.bincount(
            nskey[inter], weights=ew[inter], minlength=nm
        ).reshape(R, N)
        node_in = np.bincount(
            ndkey[inter], weights=ew[inter], minlength=nm
        ).reshape(R, N)
        node_out_msgs = np.bincount(nskey[inter], minlength=nm).reshape(R, N)
        node_in_msgs = np.bincount(ndkey[inter], minlength=nm).reshape(R, N)
        node_intra = np.bincount(
            nskey[~inter], weights=ew[~inter], minlength=nm
        ).reshape(R, N)
        node_intra_cnt = np.bincount(nskey[~inter], minlength=nm).reshape(R, N)

        st = RoundStats(
            send_elems=send_elems,
            send_cnt=send_cnt.astype(np.int64),
            send_inter=send_inter,
            recv_elems=recv_elems,
            recv_cnt=recv_cnt.astype(np.int64),
            recv_inter=recv_inter,
            node_out=node_out,
            node_in=node_in,
            node_out_msgs=node_out_msgs.astype(np.int64),
            node_in_msgs=node_in_msgs.astype(np.int64),
            node_intra=node_intra,
            node_intra_cnt=node_intra_cnt.astype(np.int64),
            inter_elems=int(self.elems[inter].sum()),
            intra_elems=int(self.elems[~inter].sum()),
        )
        self._stats[procs_per_node] = st
        return st


# ---------------------------------------------------------------------------
# Compilation from the legacy Msg representation.
# ---------------------------------------------------------------------------


def compile_schedule(
    schedule: sched.Schedule, *, with_blocks: bool = False
) -> CompiledSchedule:
    """Flatten a legacy ``Schedule`` into the array IR.

    ``with_blocks=True`` additionally flattens every ``Msg.blocks`` tuple
    into the CSR block arrays (sorted ascending per message), making the
    result consumable by the validity oracle and the optimizer passes.
    """
    counts = [len(r.msgs) for r in schedule.rounds]
    m = sum(counts)
    src = np.empty(m, dtype=np.int64)
    dst = np.empty(m, dtype=np.int64)
    elems = np.empty(m, dtype=np.int64)
    nblk = np.empty(m, dtype=np.int64) if with_blocks else None
    blk_chunks: list = []
    i = 0
    for r in schedule.rounds:
        for msg in r.msgs:
            src[i] = msg.src
            dst[i] = msg.dst
            elems[i] = msg.elems
            if with_blocks:
                nblk[i] = len(msg.blocks)
                blk_chunks.append(sorted(msg.blocks))
            i += 1
    round_ptr = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=round_ptr[1:])
    blk_ptr = blk_ids = None
    if with_blocks:
        blk_ptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(nblk, out=blk_ptr[1:])
        blk_ids = (
            np.concatenate([np.asarray(b, dtype=np.int64) for b in blk_chunks])
            if blk_chunks
            else np.empty(0, dtype=np.int64)
        )
    return CompiledSchedule(
        op=schedule.op,
        algorithm=schedule.algorithm,
        p=schedule.p,
        k=schedule.k,
        src=src,
        dst=dst,
        elems=elems,
        round_ptr=round_ptr,
        blk_ptr=blk_ptr,
        blk_ids=blk_ids,
    )


# ---------------------------------------------------------------------------
# Message split / merge primitives (array surgery on the CSR block arrays).
# These are the payload-rewrite building blocks of the optimizer passes:
# ``SplitPayloads`` splits via :func:`split_messages`, ``CoalesceMessages``
# fuses via :func:`merge_messages`, and the two are (multiset-)inverses, so
# the validity oracle sees bit-identical block delivery either way.
# ---------------------------------------------------------------------------


def segmented_arange(counts: np.ndarray) -> np.ndarray:
    """``concatenate([arange(c) for c in counts])`` without the Python loop:
    the within-segment offset of every element of a ragged array described
    by per-segment ``counts``.  The CSR-surgery workhorse shared by the
    block-gather/split primitives here and the optimizer passes."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    return np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )


def gather_block_csr(
    blk_ptr: np.ndarray, blk_ids: np.ndarray, order: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Reorder a CSR block array by a message permutation ``order``:
    returns ``(new_blk_ptr, new_blk_ids)`` with message ``i``'s blocks taken
    from old message ``order[i]``, slices concatenated in the new order."""
    nblk = np.diff(blk_ptr)
    g_counts = nblk[order]
    base = np.repeat(blk_ptr[:-1][order], g_counts)
    off = segmented_arange(g_counts)
    new_ptr = np.zeros(order.size + 1, dtype=np.int64)
    np.cumsum(g_counts, out=new_ptr[1:])
    return new_ptr, blk_ids[base + off]


def split_messages(
    cs: CompiledSchedule, factors: np.ndarray
) -> CompiledSchedule:
    """Split message ``i`` into ``factors[i]`` parallel same-round parts.

    Each part keeps the original ``(src, dst)`` and lands in the original
    round, directly after its siblings; ``elems`` is divided as evenly as
    possible (every part nonempty — factors are clamped to ``elems``) and
    the message's block slice is *partitioned* contiguously across the
    parts (parts beyond the block count carry zero blocks).  Because the
    parts partition both the payload and the block set, the per-round
    (src, dst, blk) hop multiset — what the validity oracle replays — is
    exactly that of the input, and :func:`merge_messages` is an inverse up
    to message order within a round.
    """
    factors = np.asarray(factors, dtype=np.int64)
    if factors.shape != (cs.num_msgs,):
        raise ValueError(
            f"factors must have shape ({cs.num_msgs},), got {factors.shape}"
        )
    if cs.num_msgs == 0:
        return cs
    f = np.clip(factors, 1, np.maximum(cs.elems, 1))
    if int(f.max()) <= 1:
        return cs
    total = int(f.sum())
    mid = np.repeat(np.arange(cs.num_msgs, dtype=np.int64), f)
    part = segmented_arange(f)
    base, rem = cs.elems // f, cs.elems % f
    new_elems = base[mid] + (part < rem[mid])
    new_ptr = np.zeros(cs.num_rounds + 1, dtype=np.int64)
    np.cumsum(
        np.bincount(cs.round_ids(), weights=f.astype(np.float64),
                    minlength=cs.num_rounds).astype(np.int64),
        out=new_ptr[1:],
    )
    blk_ptr = blk_ids = None
    if cs.has_blocks:
        nblk = np.diff(cs.blk_ptr)
        bbase, brem = nblk // f, nblk % f
        part_counts = bbase[mid] + (part < brem[mid])
        blk_ptr = np.zeros(total + 1, dtype=np.int64)
        np.cumsum(part_counts, out=blk_ptr[1:])
        # contiguous in-order partition: the flat block array is unchanged
        blk_ids = cs.blk_ids
    return dataclasses.replace(
        cs,
        src=cs.src[mid],
        dst=cs.dst[mid],
        elems=new_elems,
        round_ptr=new_ptr,
        blk_ptr=blk_ptr,
        blk_ids=blk_ids,
        _stats={},
    )


def merge_messages(cs: CompiledSchedule) -> CompiledSchedule:
    """Fuse same-``(round, src, dst)`` messages into one message with the
    summed element count and the concatenated (canonically re-sorted) block
    set.  Returns ``cs`` itself when there is nothing to fuse."""
    if cs.num_msgs == 0:
        return cs
    p = cs.p
    rid = cs.round_ids()
    key = (rid * p + cs.src) * p + cs.dst
    order = np.argsort(key, kind="stable")
    sk = key[order]
    first = np.ones(sk.size, dtype=bool)
    first[1:] = sk[1:] != sk[:-1]
    starts = np.flatnonzero(first)
    if starts.size == cs.num_msgs:
        return cs  # nothing to fuse
    new_src = cs.src[order][starts]
    new_dst = cs.dst[order][starts]
    new_rid = rid[order][starts]
    new_elems = np.add.reduceat(cs.elems[order], starts)
    new_ptr = np.zeros(cs.num_rounds + 1, dtype=np.int64)
    np.cumsum(
        np.bincount(new_rid, minlength=cs.num_rounds), out=new_ptr[1:]
    )
    blk_ptr = blk_ids = None
    if cs.has_blocks:
        gptr, flat = gather_block_csr(cs.blk_ptr, cs.blk_ids, order)
        fused_counts = np.add.reduceat(np.diff(gptr), starts)
        seg_id = np.repeat(
            np.arange(fused_counts.size, dtype=np.int64), fused_counts
        )
        flat = flat[np.lexsort((flat, seg_id))]  # canonical: ascending/msg
        blk_ptr = np.zeros(fused_counts.size + 1, dtype=np.int64)
        np.cumsum(fused_counts, out=blk_ptr[1:])
        blk_ids = flat
    return dataclasses.replace(
        cs,
        src=new_src,
        dst=new_dst,
        elems=new_elems,
        round_ptr=new_ptr,
        blk_ptr=blk_ptr,
        blk_ids=blk_ids,
        _stats={},
    )


def relay_messages(
    cs: CompiledSchedule,
    via_src: np.ndarray,
    via_dst: np.ndarray,
) -> CompiledSchedule:
    """Reroute messages through relay ranks — the fault-repair remap
    primitive.

    ``via_src[i] >= 0`` stages message ``i`` out through a relay: the hop
    ``src -> via_src`` is emitted in a *stage-out* round directly before
    message ``i``'s original round, and the main hop departs from
    ``via_src``.  ``via_dst[i] >= 0`` symmetrically stages it in: the main
    hop lands at ``via_dst`` and a *stage-in* hop ``via_dst -> dst`` is
    emitted directly after the original round.  ``-1`` leaves that side
    untouched.  Every hop carries the message's full payload and block
    slice, so the relayed schedule delivers bit-identical block semantics:

    * stage-out precedes the main hop, so the relay holds the blocks
      strictly before forwarding them (the oracle's causality rule);
    * stage-in follows the main hop but still precedes every later
      original round, so downstream consumers at ``dst`` keep their
      acquisition-before-requirement ordering.

    Rounds are interleaved per original round — ``[stage-out, original,
    stage-in]`` — and a stage round is only materialized when some message
    needs it, so un-relayed regions keep their round structure (and empty
    original rounds are preserved for round-count parity).  The intended
    use is routing off-node traffic around dead network ports: the relay
    hops are *intra-node* (``core.passes.RepairSchedule`` picks surviving
    local ranks), so repair never creates new off-node traffic.
    """
    via_src = np.asarray(via_src, dtype=np.int64)
    via_dst = np.asarray(via_dst, dtype=np.int64)
    if via_src.shape != (cs.num_msgs,) or via_dst.shape != (cs.num_msgs,):
        raise ValueError(
            f"via_src/via_dst must have shape ({cs.num_msgs},), got "
            f"{via_src.shape}/{via_dst.shape}"
        )
    out = via_src >= 0
    inn = via_dst >= 0
    if not out.any() and not inn.any():
        return cs
    if (via_src[out] == cs.src[out]).any() or (
        via_dst[inn] == cs.dst[inn]
    ).any():
        raise ValueError("a message cannot relay through its own endpoint")
    R = cs.num_rounds
    reps = 1 + out.astype(np.int64) + inn.astype(np.int64)
    mid = np.repeat(np.arange(cs.num_msgs, dtype=np.int64), reps)
    pos = segmented_arange(reps)
    # phase 0 = stage-out, 1 = main, 2 = stage-in (per original round)
    phase = pos + (~out).astype(np.int64)[mid]
    main_src = np.where(out, via_src, cs.src)
    main_dst = np.where(inn, via_dst, cs.dst)
    hop_src = np.select(
        [phase == 0, phase == 1],
        [cs.src[mid], main_src[mid]],
        default=via_dst[mid],
    )
    hop_dst = np.select(
        [phase == 0, phase == 1],
        [via_src[mid], main_dst[mid]],
        default=cs.dst[mid],
    )
    rid = cs.round_ids()[mid]
    keys = rid * 3 + phase
    # materialize used stage slots; keep every original round (even empty)
    all_keys = np.union1d(keys, np.arange(R, dtype=np.int64) * 3 + 1)
    new_rid = np.searchsorted(all_keys, keys)
    order = np.argsort(new_rid, kind="stable")
    new_ptr = np.zeros(all_keys.size + 1, dtype=np.int64)
    np.cumsum(np.bincount(new_rid, minlength=all_keys.size), out=new_ptr[1:])
    blk_ptr = blk_ids = None
    if cs.has_blocks:
        blk_ptr, blk_ids = gather_block_csr(cs.blk_ptr, cs.blk_ids, mid[order])
    return dataclasses.replace(
        cs,
        src=hop_src[order],
        dst=hop_dst[order],
        elems=cs.elems[mid][order],
        round_ptr=new_ptr,
        blk_ptr=blk_ptr,
        blk_ids=blk_ids,
        _stats={},
    )


def _from_rounds(
    op: str,
    algorithm: str,
    p: int,
    k: int,
    rounds: list[tuple],
    blocks: list[tuple] | None = None,
) -> CompiledSchedule:
    """Assemble a CompiledSchedule from per-round (src, dst, elems) triples.

    ``blocks`` (parallel to ``rounds``) holds per-round ``(counts, flat)``
    pairs: ``counts[i]`` block ids per message, concatenated in ``flat``.
    """
    if rounds:
        src = np.concatenate([r[0] for r in rounds])
        dst = np.concatenate([r[1] for r in rounds])
        elems = np.concatenate([r[2] for r in rounds])
    else:
        src = dst = elems = np.empty(0, dtype=np.int64)
    round_ptr = np.zeros(len(rounds) + 1, dtype=np.int64)
    np.cumsum([r[0].size for r in rounds], out=round_ptr[1:])
    blk_ptr = blk_ids = None
    if blocks is not None:
        counts = (
            np.concatenate([b[0] for b in blocks])
            if blocks
            else np.empty(0, dtype=np.int64)
        )
        blk_ids = (
            np.concatenate([b[1] for b in blocks])
            if blocks
            else np.empty(0, dtype=np.int64)
        )
        blk_ptr = np.zeros(counts.size + 1, dtype=np.int64)
        np.cumsum(counts, out=blk_ptr[1:])
        blk_ids = blk_ids.astype(np.int64)
    return CompiledSchedule(
        op=op,
        algorithm=algorithm,
        p=p,
        k=k,
        src=src.astype(np.int64),
        dst=dst.astype(np.int64),
        elems=elems.astype(np.int64),
        round_ptr=round_ptr,
        blk_ptr=blk_ptr,
        blk_ids=blk_ids,
    )


# ---------------------------------------------------------------------------
# Array-native generators for the O(p^2)-message alltoall families.
# Each mirrors its legacy generator's round structure and per-round message
# multiset exactly; no Msg objects are ever created.
# ---------------------------------------------------------------------------


def _direct_blocks(p: int, src: np.ndarray, dst: np.ndarray) -> tuple:
    """Per-round block CSR for direct alltoall messages: each message
    carries exactly its (src -> dst) pair block."""
    return np.ones(src.size, dtype=np.int64), src * p + dst


def kported_alltoall_ir(p: int, k: int, c: int) -> CompiledSchedule:
    """Direct alltoall (paper §2.1): ceil((p-1)/k) rounds of k shifted sends.

    Round t covers offsets d = 1+t*k .. min(1+(t+1)*k, p)-1; every processor
    i sends its per-pair block to (i + d) mod p for each offset in the round.
    """
    procs = np.arange(p, dtype=np.int64)
    rounds = []
    blocks = []
    offset = 1
    while offset < p:
        ds = np.arange(offset, min(offset + k, p), dtype=np.int64)
        src = np.tile(procs, ds.size)
        dst = (src + np.repeat(ds, p)) % p
        elems = np.full(src.size, c, dtype=np.int64)
        rounds.append((src, dst, elems))
        blocks.append(_direct_blocks(p, src, dst))
        offset += k
    return _from_rounds("alltoall", "kported", p, k, rounds, blocks)


def bruck_alltoall_ir(p: int, k: int, c: int) -> CompiledSchedule:
    """Radix-(k+1) message-combining alltoall, computed analytically.

    By translation symmetry every processor holds the same multiset of
    remaining offsets.  At the phase with ``radix_pow = (k+1)^t`` the live
    offsets are the multiples of ``radix_pow`` below ``p`` and the block
    count pooled at offset ``o`` is ``min(radix_pow, p - o)`` (the original
    offsets ``o..o+radix_pow-1`` that have collapsed onto it).  Processor q
    sends one message per nonzero digit value d of offset-digit t, carrying
    every pooled block whose digit is d, to ``(q + d*radix_pow) mod p``.

    Blocks are reconstructed analytically too: a block (a -> b) with
    original offset ``o0 = (b - a) mod p`` sits, at the phase clearing digit
    t, on processor ``q = (a + o0 mod radix_pow) mod p`` with collapsed
    offset ``o = o0 - o0 mod radix_pow``; the pooled blocks at (q, o) are
    ``{((q - low) mod p, (q + o) mod p) : low < pooled(o)}`` — common
    destination, ``pooled`` distinct sources.
    """
    r = k + 1
    procs = np.arange(p, dtype=np.int64)
    rounds = []
    blocks = []
    radix_pow = 1
    while radix_pow < p:
        offs = np.arange(0, p, radix_pow, dtype=np.int64)
        digit = (offs // radix_pow) % r
        pooled = np.minimum(radix_pow, p - offs)
        # message size per digit value (same at every processor)
        nblk = np.bincount(digit, weights=pooled.astype(np.float64), minlength=r)
        live = [d for d in range(1, r) if nblk[d] > 0]
        if live:
            # legacy emission order is q-major, digit-minor
            d_arr = np.asarray(live, dtype=np.int64)
            src = np.repeat(procs, d_arr.size)
            dst = (src + np.tile(d_arr * radix_pow, p)) % p
            elems = np.tile(
                (c * nblk[d_arr]).astype(np.int64), p
            )
            rounds.append((src, dst, elems))
            # --- per-message blocks (see docstring derivation) ------------
            m = digit > 0
            order = np.argsort(digit[m], kind="stable")  # digit-major, o asc
            o_ord = offs[m][order]
            pool_ord = pooled[m][order]
            hops = int(pool_ord.sum())
            rep_o = np.repeat(o_ord, pool_ord)
            starts = np.cumsum(pool_ord) - pool_ord
            rep_low = np.arange(hops, dtype=np.int64) - np.repeat(starts, pool_ord)
            # [p, hops]: row q = its blocks in (digit, o, low) template order
            blk_mat = ((procs[:, None] - rep_low[None, :]) % p) * p + (
                (procs[:, None] + rep_o[None, :]) % p
            )
            cnt_d = np.bincount(
                digit[m], weights=pooled[m].astype(np.float64), minlength=r
            ).astype(np.int64)
            counts = np.tile(cnt_d[d_arr], p)  # q-major, digit-minor
            flat = blk_mat.ravel()
            seg = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
            flat = flat[np.lexsort((flat, seg))]  # canonical: ascending/msg
            blocks.append((counts, flat))
        else:
            rounds.append(
                (
                    np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int64),
                )
            )
            blocks.append(
                (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
            )
        radix_pow *= r
    return _from_rounds("alltoall", "bruck", p, k, rounds, blocks)


def klane_alltoall_ir(topo: Topology, c: int) -> CompiledSchedule:
    """§2.3 alltoall: N-1 node rounds of n lane-legal steps, then a final
    on-node alltoall of n-1 steps; one c-element message per processor per
    step."""
    N, n, p = topo.num_nodes, topo.procs_per_node, topo.p
    idx = np.arange(p, dtype=np.int64)
    v, j = idx // n, idx % n
    elems = np.full(p, c, dtype=np.int64)
    rounds = []
    blocks = []
    for t in range(1, N):
        w = (v + t) % N
        for s in range(n):
            dst = w * n + (j + s) % n
            rounds.append((idx, dst, elems))
            blocks.append(_direct_blocks(p, idx, dst))
    for s in range(1, n):
        dst = v * n + (j + s) % n
        rounds.append((idx, dst, elems))
        blocks.append(_direct_blocks(p, idx, dst))
    return _from_rounds("alltoall", "klane", p, topo.k_lanes, rounds, blocks)


def fulllane_alltoall_ir(topo: Topology, c: int) -> CompiledSchedule:
    """§2.2 alltoall: n-1 on-node combining steps (N blocks per message)
    followed by N-1 node-ring steps of node-combined messages (n blocks)."""
    N, n, p = topo.num_nodes, topo.procs_per_node, topo.p
    idx = np.arange(p, dtype=np.int64)
    v, j = idx // n, idx % n
    rounds = []
    blocks = []
    elems_a = np.full(p, c * N, dtype=np.int64)
    cnt_a = np.full(p, N, dtype=np.int64)
    for s in range(1, n):
        dst = v * n + (j + s) % n
        rounds.append((idx, dst, elems_a))
        # (v, j) -> (v, l): blocks src*p + rank(w, l) for all nodes w
        flat = (
            idx[:, None] * p
            + np.arange(N, dtype=np.int64)[None, :] * n
            + (dst % n)[:, None]
        ).ravel()
        blocks.append((cnt_a, flat))
    elems_b = np.full(p, c * n, dtype=np.int64)
    cnt_b = np.full(p, n, dtype=np.int64)
    for t in range(1, N):
        dst = ((v + t) % N) * n + j
        rounds.append((idx, dst, elems_b))
        # (v, l) -> (w, l): node-combined blocks rank(v, j')*p + dst, all j'
        flat = (
            (v[:, None] * n + np.arange(n, dtype=np.int64)[None, :]) * p
            + dst[:, None]
        ).ravel()
        blocks.append((cnt_b, flat))
    return _from_rounds("alltoall", "fulllane", p, topo.k_lanes, rounds, blocks)


#: (op, algorithm) -> array-native generator with the ALGORITHMS signature.
IR_GENERATORS: dict[tuple[str, str], Callable] = {
    ("alltoall", "kported"): lambda topo, k, c: kported_alltoall_ir(topo.p, k, c),
    ("alltoall", "bruck"): lambda topo, k, c: bruck_alltoall_ir(topo.p, k, c),
    ("alltoall", "klane"): lambda topo, k, c: klane_alltoall_ir(topo, c),
    ("alltoall", "fulllane"): lambda topo, k, c: fulllane_alltoall_ir(topo, c),
}


# ---------------------------------------------------------------------------
# Process-wide schedule cache (thread-safe; optimized entries fingerprinted).
#
# Optimized schedules are keyed on ``(op, algorithm, topo, k, c,
# root, opt_mode, pipeline_fingerprint)`` — the fingerprint
# (:func:`repro_torch.core.passes.pipeline_fingerprint`) hashes the pass names +
# a version salt, so changing a pipeline's composition or semantics
# invalidates exactly the entries it produced.  On top of the per-``c``
# entries sits a **recipe cache**: a pipeline whose passes are all
# ``recipe_safe`` (payload-independent message permutations / re-roundings
# — reorder, color without a machine, compaction) produces the *same*
# rewrite at every payload size, so the pipeline runs once on a
# tagged-payload copy (``elems = arange(M)`` — the output's elems array IS
# the permutation) and every other payload replays the recorded
# ``(morder, round_ptr)`` with one gather.  That is what stops the
# selector's ``opt:`` candidates from re-running the whole pass pipeline
# on every ``crossover_table`` probe: probes differ only in ``c``.  The
# first recipe application is still oracle-validated; replays at other
# payloads are not re-checked — block structure and round assignment are
# identical and the oracle never reads ``elems``.
# ---------------------------------------------------------------------------

_LOCK = threading.RLock()
_CACHE: dict[tuple, CompiledSchedule] = {}
_RECIPES: dict[tuple, dict] = {}
_CACHE_HITS = 0
_CACHE_MISSES = 0
_RECIPE_HITS = 0
_RECIPE_MISSES = 0
# Keys seeded from the on-disk artifact store (repro_torch.store warm-start).
# Membership survives FIFO eviction on purpose: a rebuild of *any* key the
# store had already materialized is a recompile the serving layer promised
# not to pay — counted in _STORE_RECOMPILES and the
# ``schedule_cache.store_recompiles`` metric (the load benchmark's
# "zero recompiles of store-resident artifacts" acceptance gate).
_STORE_RESIDENT: set[tuple] = set()
_STORE_RECOMPILES = 0
_CACHE_MAX = 512
# Paper-scale alltoall entries cost tens of MB each (message arrays plus the
# lazily-built [R, p] stats grids), so bound resident bytes as well as count;
# insertion evicts oldest-first (FIFO) until both bounds hold.  The bound is
# only enforced at insertion: stats grids built *after* an entry is cached
# grow resident bytes past the cap until the next insertion re-measures
# (acceptable overshoot — one klane p=1152 stats set is ~120 MB).
_CACHE_MAX_BYTES = 512 * 1024 * 1024


def _entry_bytes(cs: CompiledSchedule) -> int:
    n = cs.src.nbytes + cs.dst.nbytes + cs.elems.nbytes + cs.round_ptr.nbytes
    if cs.has_blocks:
        n += cs.blk_ptr.nbytes + cs.blk_ids.nbytes
    for st in cs._stats.values():
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            if isinstance(v, np.ndarray):
                n += v.nbytes
    return n


def compiled_schedule(
    op,
    algorithm: str | None = None,
    topo: Topology | None = None,
    k: int | None = None,
    c: int | None = None,
    root: int = 0,
    *,
    optimize: str | None = None,
    faults=None,
) -> CompiledSchedule:
    """Cached compiled schedule for an ``ALGORITHMS`` family.

    **PlanRequest overload**: the first argument may
    be a :class:`repro_torch.api.PlanRequest` instead of the op string, in which
    case only ``algorithm`` is required — the topology, generation ``k``
    and payload ``c`` are derived from the request exactly the way the
    selector's fallback rung derives them (``k = min(k_lanes,
    procs_per_node)``; ``c`` is the total payload for broadcast, the
    per-proc/per-pair block otherwise), an ``"opt:"``-prefixed algorithm
    selects the ``"color"`` pipeline, and the request's faults ride along::

        compiled_schedule(PlanRequest("alltoall", 869, num_nodes=3,
                                      procs_per_node=4, k_lanes=2),
                          plan.algorithm)

    The positional 9-argument form below stays the compiler-internal
    entry point.

    Alltoall families come from the array-native generators; the tree
    families (O(p log p) messages) generate the legacy schedule and compile
    it.  Cached process-wide keyed by ``(op, algorithm, topo, k, c, root,
    optimize)`` — cached entries share their lazily-built per-topology round
    statistics, so re-simulating a cached schedule under the same machine
    shape is pure array arithmetic.

    ``faults`` (a :class:`repro_torch.core.faults.FaultSpec`) requests the
    *repaired* schedule for a degraded machine: the healthy (optionally
    optimized) entry is built first, then rewritten by
    :func:`repro_torch.core.passes.repair_schedule` and oracle-revalidated.  The
    fault fingerprint is folded into the cache key, so healthy-topology
    entries — including recipe replays — are never served under faults
    (the cache-invalidation rule: a tuned schedule cached for a
    healthy topology is silently wrong the moment the topology degrades).

    ``optimize`` selects an optimizer pipeline from
    :data:`repro_torch.core.passes.OPT_MODES` (``"lane"`` keeps strict
    lane-legality, ``"ported"`` compacts adjacent rounds up to port width k,
    ``"reorder"`` list-schedules messages into the earliest dependency- and
    budget-legal round regardless of adjacency, ``"split"`` splits payloads
    across the k lanes, ``"color"`` runs the conflict-graph coloring packer
    at the auto-chosen budget); the optimized schedule is validated by the
    array-native oracle before it enters the cache.  Optimized entries are
    keyed on the pass pipeline's fingerprint as well, and pipelines whose
    passes are all payload-independent (``recipe_safe``) run once per
    structure and replay as a recorded permutation recipe at every other
    payload size — see the cache notes above.  Split factors clamp to
    ``elems``, so optimized entries are piecewise-affine in ``c`` — the
    selector's piecewise fits (``selector.piecewise_cost``) handle any
    regime flip the rewrites cause.
    """
    global _CACHE_HITS, _CACHE_MISSES, _RECIPE_HITS, _RECIPE_MISSES
    global _STORE_RECOMPILES
    if not isinstance(op, str):
        req = op  # duck-typed PlanRequest (api imports this module, not v.v.)
        if algorithm is None:
            raise TypeError(
                "compiled_schedule(PlanRequest, ...) requires an algorithm "
                "(e.g. plan(request).algorithm)"
            )
        alg, opt_mode = algorithm, optimize
        if alg.startswith("opt:"):
            alg, opt_mode = alg[4:], "color"
        req_faults = req.faults
        if req_faults is not None and req_faults.is_healthy:
            req_faults = None
        return compiled_schedule(
            req.op,
            alg,
            Topology(req.num_nodes, req.procs_per_node, req.k_lanes),
            min(req.k_lanes, req.procs_per_node),
            req.payload_elems if req.op == "broadcast"
            else max(1, req.payload_elems),
            root,
            optimize=opt_mode,
            faults=req_faults,
        )
    fingerprint = None
    passes = None
    if optimize is not None:
        from repro_torch.core.passes import OPT_MODES, pipeline_fingerprint

        try:
            factory = OPT_MODES[optimize]
        except KeyError:
            raise ValueError(
                f"unknown optimize mode {optimize!r}; expected one of "
                f"{sorted(OPT_MODES)}"
            ) from None
        passes = factory(topo)
        fingerprint = pipeline_fingerprint(passes)
    fault_fp = None
    if faults is not None and not faults.is_healthy:
        fault_fp = faults.fingerprint()
    key = (
        op,
        algorithm,
        topo.num_nodes,
        topo.procs_per_node,
        topo.k_lanes,
        k,
        c,
        root,
        optimize,
        fingerprint,
        fault_fp,
    )
    with _LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            _CACHE_HITS += 1
        else:
            _CACHE_MISSES += 1
            if key in _STORE_RESIDENT:
                _STORE_RECOMPILES += 1
                obs_metrics.counter("schedule_cache.store_recompiles").inc()
    if hit is not None:
        obs_metrics.counter("schedule_cache.hits").inc()
        if TRACER:
            TRACER.event("cache.hit", op=op, algorithm=algorithm,
                         optimize=optimize, c=c, fault_fp=fault_fp)
        return hit
    obs_metrics.counter("schedule_cache.misses").inc()
    if root != 0:
        raise ValueError("the ALGORITHMS registry generates root=0 schedules")
    sp = TRACER.start(
        "compile", op=op, algorithm=algorithm, nodes=topo.num_nodes,
        ppn=topo.procs_per_node, lanes=topo.k_lanes, k=k, c=c,
        optimize=optimize, fingerprint=fingerprint, fault_fp=fault_fp,
    ) if TRACER else None
    try:
        cs, path = _build_entry(op, algorithm, topo, k, c, root,
                                optimize=optimize, faults=faults,
                                fault_fp=fault_fp, passes=passes, key=key)
    except BaseException:
        if sp:
            TRACER.finish(sp, path="error")
        raise
    if sp:
        TRACER.finish(sp, path=path, rounds=cs.num_rounds, msgs=cs.num_msgs)
    new_bytes = _entry_bytes(cs)
    with _LOCK:
        while _CACHE and (
            len(_CACHE) >= _CACHE_MAX
            or _cache_bytes() + new_bytes > _CACHE_MAX_BYTES
        ):
            _CACHE.pop(next(iter(_CACHE)))
        _CACHE[key] = cs
    return cs


def _build_entry(op, algorithm, topo, k, c, root, *, optimize, faults,
                 fault_fp, passes, key) -> tuple[CompiledSchedule, str]:
    """The cache-miss build path of :func:`compiled_schedule`, factored out
    so the compile trace span has a single open/close boundary."""
    if fault_fp is not None:
        # repair is a rewrite of the healthy entry (which stays cached and
        # reusable for other fault sets), never a regeneration
        base = compiled_schedule(op, algorithm, topo, k, c, root,
                                 optimize=optimize)
        from repro_torch.core.passes import repair_schedule

        cs, _ = repair_schedule(base, faults, topo=topo)
        return cs, "repair"
    if optimize is not None:
        base = compiled_schedule(op, algorithm, topo, k, c, root)
        if all(getattr(ps, "recipe_safe", False) for ps in passes):
            return _optimize_via_recipe(base, key[:6] + key[7:], passes), "recipe"
        from repro_torch.core.passes import optimize_schedule

        cs, _ = optimize_schedule(base, optimize, topo=topo, validate=True)
        return cs, "optimize"
    gen = IR_GENERATORS.get((op, algorithm))
    if gen is not None:
        return gen(topo, k, c), "generate"
    legacy = sched.ALGORITHMS[(op, algorithm)](topo, k, c)
    return compile_schedule(legacy, with_blocks=True), "compile_legacy"


def _optimize_via_recipe(
    base: CompiledSchedule, recipe_key: tuple, passes: list
) -> CompiledSchedule:
    """Optimize ``base`` through a payload-independent pipeline, running the
    passes at most once per structure: the pipeline is replayed on a
    tagged-payload copy whose ``elems`` are the message indices, so the
    output's ``elems`` array *is* the message permutation; every subsequent
    payload size applies the recorded ``(morder, round_ptr)`` with one
    gather.  The first materialized application is machine-checked by the
    validity oracle (raising on corruption, exactly like the non-recipe
    path); replays at other payloads reuse that verdict — the oracle never
    reads ``elems`` and the block structure is identical by construction."""
    global _RECIPE_HITS, _RECIPE_MISSES
    from repro_torch.core.passes import PassManager
    from repro_torch.core.validate import validate_schedule

    # counter updates stay inside _LOCK: plain += on module globals is a
    # read-modify-write and concurrent recipe replays would lose increments
    # (the cache counters above already do this)
    with _LOCK:
        rec = _RECIPES.get(recipe_key)
        if rec is None:
            _RECIPE_MISSES += 1
        else:
            _RECIPE_HITS += 1
    if rec is None:
        obs_metrics.counter("schedule_recipes.misses").inc()
        if TRACER:
            TRACER.event("recipe.miss", op=recipe_key[0], algorithm=recipe_key[1])
        tagged = dataclasses.replace(
            base,
            elems=np.arange(base.num_msgs, dtype=np.int64),
            _stats={},
        )
        out, _ = PassManager(passes).run(tagged)
        rec = (
            {"identity": True, "validated": True}
            if out is tagged
            else {
                "identity": False,
                "validated": False,
                "morder": out.elems.copy(),
                "round_ptr": out.round_ptr.copy(),
            }
        )
        with _LOCK:
            rec = _RECIPES.setdefault(recipe_key, rec)
    else:
        obs_metrics.counter("schedule_recipes.hits").inc()
        if TRACER:
            TRACER.event("recipe.replay", op=recipe_key[0],
                         algorithm=recipe_key[1])
    if rec["identity"]:
        return base
    morder = rec["morder"]
    blk_ptr, blk_ids = gather_block_csr(base.blk_ptr, base.blk_ids, morder)
    cs = dataclasses.replace(
        base,
        src=base.src[morder],
        dst=base.dst[morder],
        elems=base.elems[morder],
        round_ptr=rec["round_ptr"],
        blk_ptr=blk_ptr,
        blk_ids=blk_ids,
        _stats={},
    )
    if not rec["validated"]:
        osp = TRACER.start("oracle", mode="full", where="recipe") if TRACER \
            else None
        try:
            report = validate_schedule(cs)
        except BaseException:
            if osp:
                TRACER.finish(osp, outcome="error")
            raise
        if osp:
            TRACER.finish(osp, ok=report.ok)
        report.raise_if_invalid()
        rec["validated"] = True
    return cs


def _cache_bytes() -> int:
    return sum(_entry_bytes(cs) for cs in _CACHE.values())


def cache_export() -> tuple[dict[tuple, CompiledSchedule], dict[tuple, dict]]:
    """One coherent snapshot of the process cache: ``(entries, recipes)``
    as plain dicts keyed by the full cache/recipe key tuples.  This is the
    persistence boundary for :class:`repro_torch.store.ArtifactStore` — the
    values are the cached frozen ``CompiledSchedule`` objects themselves
    (safe to share: entries are never mutated after insertion) and
    shallow copies of the recipe dicts."""
    with _LOCK:
        return dict(_CACHE), {rk: dict(rec) for rk, rec in _RECIPES.items()}


def cache_seed(
    entries: dict[tuple, CompiledSchedule],
    recipes: dict[tuple, dict] | None = None,
    *,
    resident: bool = True,
) -> int:
    """Warm-start the process cache with prebuilt entries (the
    :class:`repro_torch.store.ArtifactStore` load path).  Existing keys are kept
    (a live entry is never clobbered by a disk copy), insertion respects
    the count/byte bounds with the same FIFO eviction as a compile miss,
    and seeding moves no hit/miss counters — a warm start is neither.
    With ``resident=True`` the seeded keys are tracked so any later
    rebuild of one of them counts as a store recompile
    (``schedule_cache_info()["store_recompiles"]``).  Returns the number
    of schedule entries actually inserted."""
    inserted = 0
    with _LOCK:
        for key, cs in entries.items():
            if resident:
                _STORE_RESIDENT.add(key)
            if key in _CACHE:
                continue
            new_bytes = _entry_bytes(cs)
            while _CACHE and (
                len(_CACHE) >= _CACHE_MAX
                or _cache_bytes() + new_bytes > _CACHE_MAX_BYTES
            ):
                _CACHE.pop(next(iter(_CACHE)))
            _CACHE[key] = cs
            inserted += 1
        for rk, rec in (recipes or {}).items():
            _RECIPES.setdefault(rk, rec)
    return inserted


def schedule_cache_info() -> dict:
    # the store's race counter rides along so one info() call answers
    # "is the shared store healthy" too (lazy import: the store imports
    # this module lazily in the other direction)
    from repro_torch.store.artifacts import read_race_count

    races = read_race_count()
    with _LOCK:
        return {
            "hits": _CACHE_HITS,
            "misses": _CACHE_MISSES,
            "recipe_hits": _RECIPE_HITS,
            "recipe_misses": _RECIPE_MISSES,
            "size": len(_CACHE),
            "recipes": len(_RECIPES),
            "bytes": _cache_bytes(),
            "store_resident": len(_STORE_RESIDENT),
            "store_recompiles": _STORE_RECOMPILES,
            "store_read_races": races,
        }


def schedule_cache_clear() -> None:
    """Drop every cached entry and recipe, and zero the counters."""
    global _CACHE_HITS, _CACHE_MISSES, _RECIPE_HITS, _RECIPE_MISSES
    global _STORE_RECOMPILES
    with _LOCK:
        _CACHE.clear()
        _RECIPES.clear()
        _STORE_RESIDENT.clear()
        _CACHE_HITS = 0
        _CACHE_MISSES = 0
        _RECIPE_HITS = 0
        _RECIPE_MISSES = 0
        _STORE_RECOMPILES = 0


def schedule_cache_reset() -> None:
    """Zero the hit/miss counters while *keeping* cached entries and
    recipes — the ``schedule_cache_info`` counterpart for measuring the
    hit rate of one workload window without cold-starting the cache
    (``schedule_cache_clear`` drops the entries too).  Store-resident
    key tracking survives; only the recompile counter rewinds."""
    global _CACHE_HITS, _CACHE_MISSES, _RECIPE_HITS, _RECIPE_MISSES
    global _STORE_RECOMPILES
    with _LOCK:
        _CACHE_HITS = 0
        _CACHE_MISSES = 0
        _RECIPE_HITS = 0
        _RECIPE_MISSES = 0
        _STORE_RECOMPILES = 0
