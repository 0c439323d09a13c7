"""Schedule optimizer: IR rewrite passes over :class:`CompiledSchedule`.

The paper's k-lane adaptations are explicitly non-optimal: the k-lane
alltoall pays ``(N-1)*n`` rounds of per-round latency even though a node's
``k`` lanes could carry ``k`` of those steps concurrently, and every
multi-phase lane algorithm serializes phases that touch disjoint
processors.  Träff's companion decomposition paper (arXiv:1910.13373)
shows lane-parallel restructuring recovers most of that gap.  The
compiled IR makes such rewrites cheap — a rewrite is array surgery on
``round_ptr``/message arrays, and re-simulation is O(numpy) — so this
module adds the missing optimization layer between schedule generation and
simulation:

    generate -> compile (schedule_ir) -> optimize (this module)
             -> validate (core.validate) -> simulate (core.simulate)

Pipeline
--------
The optimizer sits between compilation and validation; within it, a
:class:`PassManager` fixpoint-iterates a pass pipeline, timing each rewrite
under the machine model and oracle-checking everything it keeps::

    compiled IR ──▶ PassManager ──ReorderRounds──▶ earliest-fit repack
                        │  ▲      ──ColorRounds───▶ bitset conflict coloring
                        │  │          (64-color uint64 windows; budget rung
                        │  │           from choose_color_budget; tree-aware
                        │  │           byte caps in the bandwidth regime)
                        │  │      ──SplitPayloads─▶ cost-aware lane split
                        │  │      ──RepairSchedule▶ fault repair:
                        │  │          relay inter hops off dead network
                        │  │          ports via surviving local ranks
                        │  │          (schedule_ir.relay_messages), then
                        │  │          ColorRounds re-pack under the
                        │  │          reduced per-node lane budget —
                        │  │          a rewrite, never a regeneration
                        │  └──────CoalesceMessages/CompactRounds─ fixpoint
                        ▼
        objective: (time, rounds, msgs) lexicographic, keep-if-better
          (ReorderRounds is the never-slower first-fit baseline the
           ColorRounds packing must lex-beat to land)
                        │
                        ▼
        validate.revalidate_schedule ──window-confined rewrite──▶ only the
          affected blocks' hop chains rechecked (rewrite_window diff);
          full validate_schedule otherwise — every kept rewrite is
          machine-checked either way
                        │
                        ▼
                 simulate / BENCH_schedules.json trajectory (per-pass deltas)
                        │
                        ▼
        schedule_ir optimized-schedule cache: entries keyed on
          (op, algorithm, topo, k, c, root, opt_mode,
          pipeline_fingerprint); recipe_safe pipelines run once per
          structure and replay as a (morder, round_ptr) recipe at every
          other payload size

Cost model sharing: the cost-aware passes price rewrites with the
*simulator's own* per-round formulas
(:func:`repro_torch.core.simulate.port_time` for the port terms,
:func:`repro_torch.core.simulate.lane_time` for the node rail term the budget
chooser's proxy uses), so a predicted gain is exactly the gain the
trajectory will record — there is no second, drifting copy of the machine
model.

Bitset-coloring memory bound: a naive DSATUR adjacency for an
O(p^2)-message alltoall would need ``p^2 msgs x p^2/64`` uint64 words
(~2e10 at p=1152); even per-message forbidden-color sets over all R
colors are ``M x R/64`` words.  ``ColorRounds`` therefore colors through
a sliding 64-color window whose packed per-(processor, side) bitsets are
O(p) total, with one transient uint64 per candidate.  When packing
degenerates anyway, the window still advances (termination is
unconditional) and the lex race simply keeps the first-fit
``ReorderRounds`` baseline — the pass "falls back to first-fit" by losing
the race, never by shipping a worse schedule.

Passes
------
* :class:`ReorderRounds` — **non-adjacent round reordering**: a greedy list
  scheduler over the block-dependency DAG (edges exported by
  :func:`repro_torch.core.validate.block_dependencies`).  Each round, in order,
  is packed into the *earliest* existing round group that (a) keeps every
  processor within the port budget, (b) lies strictly after every group
  that delivers a block the round forwards, and (c) does not mix on-node
  and off-node traffic at any single processor (mixing would re-price a
  processor's intra-node bytes at network alpha/beta, the one way a merge
  could cost time).  Under (a)–(c) every per-round cost term is subadditive
  under round union, so reordering — like compaction — is provably never
  slower, while reaching merges adjacency-restricted compaction cannot
  (e.g. interleaving the k-lane alltoall's trailing on-node phase, or
  packing a tree algorithm's disjoint waves).
* :class:`ColorRounds` — **conflict-graph coloring packer**: the
  message-granularity successor to ``ReorderRounds``.  Messages are the
  vertices of a conflict graph whose edges are the port budget (two
  messages sharing a sender or receiver compete for its port), the
  intra/inter class-purity rule, and the causality partial order exported
  by :func:`repro_torch.core.validate.block_dependencies`; rounds are the colors.
  The packer colors greedily in saturation-degree (DSATUR-style) order —
  most port-contended messages first, the causality order respected by
  construction — so it can split an original round apart (e.g. pull a
  broadcast tree's independent waves forward past a blocked sibling),
  which no round-granularity pass can.  Not provably never-slower (it is
  not a pure round union), hence raced against the first-fit baseline
  under ``policy="lex"``.
* :class:`CompactRounds` — lane-aware *adjacent* round compaction;
  kept as the cheap payload-independent mode the selector's affine fits
  can rely on.  ``limit=1`` stays strictly lane-legal, ``limit=k`` targets
  the k concurrent non-blocking sends a node's lanes can drive.
* :class:`SplitPayloads` — **k-lane payload splitting** (the decomposition
  trick of Träff's arXiv:1910.13373): a large message's ``elems`` and
  ``blk_ids`` are split across the node's k lanes into parallel same-round
  messages via :func:`repro_torch.core.schedule_ir.split_messages`; the inverse
  :func:`~repro_torch.core.schedule_ir.merge_messages` restores the original, so
  the oracle sees bit-identical block delivery either way.  Splitting is
  never slower in either port model *provided* ``parts`` does not exceed
  the machine's lane count (oversplitting past k costs serial alpha
  batches in the ported model), and strictly faster in the k-ported model
  whenever a processor posts fewer messages than it has ports — so the
  ``"split"`` OPT mode derives ``parts`` from the topology rather than
  trusting a generator's port parameter.  With ``machine=`` the pass is
  **cost-aware**: per-message split factors come from evaluating
  the simulator's own alpha/beta formulas per traffic class — splits that
  the model prices at zero gain (e.g. any split in the 1-ported model when
  the node's lanes are already stream-saturated) are skipped instead of
  bloating the message count for the lex policy to reject wholesale.
* :class:`CoalesceMessages` — fuse same-``(src, dst)`` messages within a
  round (summed elems, concatenated blocks); not monotone (stream count
  feeds the lane bandwidth term), so run it under an evaluating policy.
* :class:`RepairSchedule` — **fault repair**: rewrite a healthy
  schedule so it stays correct and routable on a degraded machine
  (:mod:`repro_torch.core.faults`).  Inter-node messages whose endpoint's
  network port died are relayed through a surviving local rank
  (:func:`repro_torch.core.schedule_ir.relay_messages` — intra-node stage hops
  before/after the original round, so the oracle's strict
  acquisition-before-forwarding order holds by construction), then the
  schedule is re-packed with :class:`ColorRounds` under the reduced
  per-node lane budget.  Repair is a *rewrite, never a regeneration* —
  cached recipes and optimized structures stay useful — and the repaired
  schedule is re-proved by the data-flow oracle to deliver bit-identical
  block semantics.  Dead *nodes* are unrepairable by rewrite (their data
  is gone): the pass raises :class:`repro_torch.core.faults.
  UnrepairableFaultError` and :func:`repair_schedule` reverts to the
  input, deferring to the elastic layer's remesh.

:class:`PassManager` composes passes, records per-pass round/message/time
deltas (the optimizer trajectory surfaced by ``benchmarks.run --json``),
reverts non-improving passes under ``policy="improved"`` (time only) or
``policy="lex"`` (time, then rounds, then message count — strict
lexicographic improvement), optionally ``fixpoint``-iterates the pipeline
until no pass applies, and — because an optimizer that silently corrupts a
schedule is worse than no optimizer — machine-checks every rewrite with the
array-native validity oracle: ``validate=True`` raises on a broken rewrite,
``check=True`` reverts it and records the failure instead.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.faults import (
    FaultSpec,
    UnrepairableFaultError,
    degradation_of,
)
from repro_torch.core.schedule_ir import (
    CompiledSchedule,
    gather_block_csr,
    merge_messages,
    relay_messages,
    segmented_arange,
    split_messages,
)
from repro_torch.core.simulate import lane_time, port_time, simulate
from repro_torch.core.topology import Machine, Topology
from repro_torch.core.validate import (
    block_dependencies,
    initial_holds,
    revalidate_schedule,
    rewrite_window,
    validate_schedule,
    window_hop_fraction,
)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import TRACER

__all__ = [
    "ReorderRounds",
    "ColorRounds",
    "CompactRounds",
    "SplitPayloads",
    "CoalesceMessages",
    "RepairSchedule",
    "repair_schedule",
    "PassRecord",
    "PassManager",
    "optimize_schedule",
    "OPT_MODES",
    "choose_color_budget",
    "pipeline_fingerprint",
    "mode_fingerprint",
    "PASS_PIPELINE_VERSION",
]

#: Version salt for :func:`pipeline_fingerprint`.  Bump whenever a pass's
#: *semantics* change without its ``name`` changing — the optimized-schedule
#: cache in :mod:`repro_torch.core.schedule_ir` keys on the fingerprint, so a bump
#: invalidates every cached rewrite produced by the old semantics.
PASS_PIPELINE_VERSION = "pr5.1"


def pipeline_fingerprint(passes: Sequence) -> str:
    """Stable fingerprint of a pass pipeline: the version salt plus every
    pass's parameter-bearing ``name``, hashed.  Two pipelines with the same
    fingerprint produce the same rewrite on the same input, so the
    process-wide schedule cache may key optimized entries on it."""
    names = ",".join(getattr(ps, "name", type(ps).__name__) for ps in passes)
    raw = f"{PASS_PIPELINE_VERSION}|{names}"
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def mode_fingerprint(mode: str, topo: "Topology | None" = None) -> str:
    """The current fingerprint of one :data:`OPT_MODES` pipeline as it
    would be instantiated for ``topo`` — the validity check the on-disk
    artifact store (:mod:`repro_torch.store`) runs at warm-start: a persisted
    optimized entry whose recorded fingerprint no longer equals
    ``mode_fingerprint(entry.optimize, entry.topo)`` was produced by a
    pipeline that has since changed (version salt bump or pass/parameter
    change) and must be evicted, not served."""
    try:
        factory = OPT_MODES[mode]
    except KeyError:
        raise ValueError(
            f"unknown optimize mode {mode!r}; expected one of {sorted(OPT_MODES)}"
        ) from None
    return pipeline_fingerprint(factory(topo))


# ---------------------------------------------------------------------------
# Passes.  A pass is any object with .name and .apply(cs) -> CompiledSchedule
# (pure: the input schedule is never mutated).
# ---------------------------------------------------------------------------


class ReorderRounds:
    """Non-adjacent round reordering: greedy earliest-fit list scheduling.

    Treats the compiled IR as a block-dependency DAG (edges from the
    validity oracle's block-hop events, :func:`block_dependencies`) and
    re-packs every round into the earliest *round group* that fits,
    regardless of source-round adjacency.  A round fits a group iff

    * **port budget** — no processor exceeds ``limit`` concurrent sends or
      receives in the group (``limit=None`` resolves to the schedule's own
      ``k``: a node's k lanes are saturated by k concurrent streams);
    * **causality** — the group lies strictly after the group of every
      message that delivers a block this round forwards (the oracle's
      strict-acquisition rule, so reordering can never create intra-round
      forwarding); and
    * **class purity** — no processor ends up with both on-node and
      off-node traffic in one group.  The simulator prices *all* of a
      processor's round traffic at network alpha/beta once any of it is
      off-node, so mixing is the single way a merge could re-price bytes
      upward; banning it makes every per-round cost term subadditive under
      round union and the pass provably never slower.

    ``procs_per_node`` is required for the class test (the IR itself does
    not know the node partitioning).  Requires block metadata.
    """

    #: payload-independent message permutation + re-rounding: eligible for
    #: the schedule cache's recipe layer (see schedule_ir).
    recipe_safe = True

    def __init__(self, limit: int | None = None, *, procs_per_node: int):
        self.limit = limit
        self.procs_per_node = procs_per_node
        self.name = (
            f"reorder_rounds[limit={'k' if limit is None else limit},"
            f"n={procs_per_node}]"
        )

    def apply(self, cs: CompiledSchedule) -> CompiledSchedule:
        if not cs.has_blocks:
            raise ValueError(
                "ReorderRounds needs block metadata to honour the "
                "dependency DAG; generate the schedule with blocks"
            )
        n = self.procs_per_node
        p, R, M = cs.p, cs.num_rounds, cs.num_msgs
        if p % n:
            raise ValueError(f"p={p} not divisible by procs_per_node={n}")
        if R <= 1 or M == 0:
            return cs
        limit = max(self.limit if self.limit is not None else cs.k, 1)
        rid = cs.round_ids()

        # --- per-round provider rounds (from the block-dependency DAG) ----
        dep_ptr, dep_ids = block_dependencies(cs)
        req_round = np.repeat(rid, np.diff(dep_ptr))
        prov_round = rid[dep_ids]
        fwd = prov_round < req_round  # invalid same/later-round deps are
        # ignored here; the post-pass oracle check reports them instead
        order = np.argsort(req_round[fwd], kind="stable")
        prov_sorted = prov_round[fwd][order]
        prov_ptr = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(np.bincount(req_round[fwd], minlength=R), out=prov_ptr[1:])

        # --- group state (at most R groups) -------------------------------
        send_cnt = np.zeros((R, p), dtype=np.int32)
        recv_cnt = np.zeros((R, p), dtype=np.int32)
        send_cls = np.zeros((R, p), dtype=np.uint8)  # 1=intra, 2=inter, 3=mix
        recv_cls = np.zeros((R, p), dtype=np.uint8)
        g_max_send = np.zeros(R, dtype=np.int64)
        g_max_recv = np.zeros(R, dtype=np.int64)
        g_send_union = np.zeros(R, dtype=np.uint8)
        g_recv_union = np.zeros(R, dtype=np.uint8)
        num_groups = 0
        group_of_round = np.full(R, -1, dtype=np.int64)

        def _cls_of(procs, inter):
            return (
                (np.bincount(procs[inter], minlength=p) > 0).astype(np.uint8)
                << 1
            ) | (np.bincount(procs[~inter], minlength=p) > 0).astype(np.uint8)

        def _cls_ok(gcls, ccls):
            # per-proc rule: empty on either side, or identical class
            return not bool(np.any((gcls != 0) & (ccls != 0) & (gcls != ccls)))

        for r in range(R):
            a, b = int(cs.round_ptr[r]), int(cs.round_ptr[r + 1])
            if a == b:
                continue  # empty round: contributes nothing, drop it
            srcs, dsts = cs.src[a:b], cs.dst[a:b]
            s_bc = np.bincount(srcs, minlength=p)
            r_bc = np.bincount(dsts, minlength=p)
            inter = (srcs // n) != (dsts // n)
            scls = _cls_of(srcs, inter)
            rcls = _cls_of(dsts, inter)
            s_union = int(np.bitwise_or.reduce(scls))
            r_union = int(np.bitwise_or.reduce(rcls))
            s_max, r_max = int(s_bc.max()), int(r_bc.max())
            uniform = bool(s_bc.min() == s_max and r_bc.min() == r_max)
            ts = tr = None
            if not uniform:
                ts, tr = np.flatnonzero(s_bc), np.flatnonzero(r_bc)

            lo, hi = prov_ptr[r], prov_ptr[r + 1]
            lb = 0
            if hi > lo:
                lb = 1 + int(group_of_round[prov_sorted[lo:hi]].max())

            g = lb
            while g < num_groups:
                # O(1) capacity pre-check (exact for uniform rounds)
                if (
                    g_max_send[g] + s_max <= limit
                    and g_max_recv[g] + r_max <= limit
                ):
                    fits = True
                elif uniform:
                    fits = False
                else:
                    fits = bool(
                        (send_cnt[g, ts] + s_bc[ts]).max() <= limit
                        and (recv_cnt[g, tr] + r_bc[tr]).max() <= limit
                    )
                if fits:
                    gu, ru = int(g_send_union[g]), int(g_recv_union[g])
                    # scalar fast path: an empty side, or both sides pure
                    # and equal (union in (1, 2) means every touched proc
                    # has that single class) — else fall to the per-proc test
                    s_pure = gu == 0 or (gu == s_union and s_union in (1, 2))
                    r_pure = ru == 0 or (ru == r_union and r_union in (1, 2))
                    if not (s_pure and r_pure):
                        fits = _cls_ok(send_cls[g], scls) and _cls_ok(
                            recv_cls[g], rcls
                        )
                if fits:
                    break
                g += 1
            if g == num_groups:
                num_groups += 1
            send_cnt[g] += s_bc
            recv_cnt[g] += r_bc
            send_cls[g] |= scls
            recv_cls[g] |= rcls
            g_max_send[g] = int(send_cnt[g].max())
            g_max_recv[g] = int(recv_cnt[g].max())
            g_send_union[g] |= s_union
            g_recv_union[g] |= r_union
            group_of_round[r] = g

        if num_groups == R and bool(
            (group_of_round == np.arange(R)).all()
        ):
            return cs  # nothing moved

        g_of_msg = group_of_round[rid]
        morder = np.argsort(g_of_msg, kind="stable")
        new_ptr = np.zeros(num_groups + 1, dtype=np.int64)
        np.cumsum(
            np.bincount(g_of_msg, minlength=num_groups), out=new_ptr[1:]
        )
        blk_ptr, blk_ids = gather_block_csr(cs.blk_ptr, cs.blk_ids, morder)
        return dataclasses.replace(
            cs,
            src=cs.src[morder],
            dst=cs.dst[morder],
            elems=cs.elems[morder],
            round_ptr=new_ptr,
            blk_ptr=blk_ptr,
            blk_ids=blk_ids,
            _stats={},
        )


# --- bitset coloring helpers ------------------------------------------------

#: bit weight of each color slot in a 64-color window.
_BITW = np.uint64(1) << np.arange(64, dtype=np.uint64)
_U0 = np.uint64(0)
_U1 = np.uint64(1)
_UALL = np.uint64(0xFFFFFFFFFFFFFFFF)
#: low-mask table: _BIT_LOW[i] has bits 0..i-1 set (colors below slot i).
_BIT_LOW = _BITW - _U1


def _ctz64(x: np.ndarray) -> np.ndarray:
    """Index of the lowest set bit of each (nonzero) ``uint64``.  The
    isolated low bit is a power of two, which float64 represents exactly up
    to 2**63, so ``log2`` of the isolated bit is exact."""
    low = x & (~x + _U1)
    return np.log2(low.astype(np.float64)).astype(np.int64)


def _side_groups(keys: np.ndarray, prank: np.ndarray):
    """Sort one endpoint side's candidates by ``(keys, prank)`` — a single
    argsort on the fused key, since prank values are globally unique — and
    return ``(order, firsts, start_idx, gid_ord)``: the sort order, the
    group-first flags, the index (into the sorted array) of each element's
    group leader, and each sorted element's group id."""
    n = keys.size
    mul = np.int64(prank.max()) + 1 if n else np.int64(1)
    order = np.argsort(keys * mul + prank)
    sk = keys[order]
    firsts = np.ones(n, dtype=bool)
    if n:
        firsts[1:] = sk[1:] != sk[:-1]
    start_idx = np.maximum.accumulate(np.where(firsts, np.arange(n), 0))
    gid_ord = np.cumsum(firsts) - 1
    return order, firsts, start_idx, gid_ord


def _dag_depth(dep_ptr: np.ndarray, dep_ids: np.ndarray) -> int:
    """Critical-path length (in messages) of the block-dependency DAG: a
    lower bound on any coloring's round count.  Wave relaxation over the
    CSR — one ``reduceat`` per level, and the level count is the answer."""
    M = dep_ptr.size - 1
    rows = np.flatnonzero(np.diff(dep_ptr))
    if rows.size == 0:
        return 1 if M else 0
    starts = dep_ptr[rows]
    depth = np.ones(M, dtype=np.int64)
    for _ in range(M):
        upd = np.maximum.reduceat(depth[dep_ids], starts) + 1
        if bool((depth[rows] >= upd).all()):
            break
        depth[rows] = np.maximum(depth[rows], upd)
    return int(depth.max())


def choose_color_budget(
    cs: CompiledSchedule,
    *,
    procs_per_node: int,
    machine: Machine | None = None,
    ported: bool = False,
    mults: Sequence[int] = (1, 2, 4, 8),
    dep_csr: tuple[np.ndarray, np.ndarray] | None = None,
) -> tuple[int, int]:
    """Cost-aware budget chooser: pick the ``ColorRounds`` ladder
    rung ``mult`` (port budget ``mult * cs.k``) by a cheap proxy of the
    packed schedule's simulated time, instead of racing the whole ladder.

    The proxy prices each rung with the *simulator's own* per-round
    formulas: the packed color count is lower-bounded by
    ``max(ceil(msgs/L))`` over senders and receivers and by the
    block-dependency critical path, each sender's bytes spread evenly over
    its colors feed :func:`repro_torch.core.simulate.port_time`, and the node
    rail term comes from :func:`repro_torch.core.simulate.lane_time` — so the
    rung ranking follows the same alpha/beta trade-off the lex race would
    measure, at the cost of one array reduction per rung instead of a full
    coloring + simulation.  Without a ``machine`` the chooser is purely
    structural (and payload-independent): the deepest rung that still
    shrinks the color-count lower bound — in the alpha-dominated regime
    deeper packing amortizes more per-round latencies, and the selector
    races ``opt:`` candidates against their bases anyway.

    Returns ``(mult, limit)``.
    """
    p, M = cs.p, cs.num_msgs
    k = max(cs.k, 1)
    if M == 0:
        return mults[0], max(mults[0] * k, 1)
    if dep_csr is None:
        dep_csr = block_dependencies(cs)
    depth = _dag_depth(*dep_csr)
    ms = np.bincount(cs.src, minlength=p)
    mr = np.bincount(cs.dst, minlength=p)

    def colors_lb(limit: int) -> int:
        return int(
            max(
                -(-ms.max() // limit),
                -(-mr.max() // limit),
                depth,
                1,
            )
        )

    if machine is None:
        best = mults[0]
        best_lb = colors_lb(max(mults[0] * k, 1))
        for m in mults[1:]:
            lb = colors_lb(max(m * k, 1))
            if lb < best_lb:
                best, best_lb = m, lb
        return best, max(best * k, 1)

    cost, klanes = machine.cost, machine.topo.k_lanes
    n = procs_per_node
    ew = cs.elems.astype(np.float64)
    bytes_s = np.bincount(cs.src, weights=ew, minlength=p)
    bytes_r = np.bincount(cs.dst, weights=ew, minlength=p)
    inter = (cs.src // n) != (cs.dst // n)
    s_inter = np.bincount(cs.src[inter], minlength=p) > 0
    r_inter = np.bincount(cs.dst[inter], minlength=p) > 0
    N = p // n
    node_out = np.bincount(cs.src[inter] // n, weights=ew[inter], minlength=N)
    node_in = np.bincount(cs.dst[inter] // n, weights=ew[inter], minlength=N)
    node_msgs = np.maximum(
        np.bincount(cs.src[inter] // n, minlength=N),
        np.bincount(cs.dst[inter] // n, minlength=N),
    )
    best, best_t = mults[0], None
    for m in mults:
        L = max(m * k, 1)
        C = colors_lb(L)
        cols_s = np.maximum(-(-ms // L), 1)
        cols_r = np.maximum(-(-mr // L), 1)
        t_s = port_time(
            cost, bytes_s / cols_s, np.minimum(ms, L), s_inter, klanes,
            ported=ported,
        )
        t_r = port_time(
            cost, bytes_r / cols_r, np.minimum(mr, L), r_inter, klanes,
            ported=ported, alpha_batches=False,
        )
        t_row = max(
            float(np.where(ms > 0, t_s, 0.0).max()),
            float(np.where(mr > 0, t_r, 0.0).max()),
        )
        if node_msgs.any():
            t_n = lane_time(
                cost,
                np.maximum(node_out, node_in) / C,
                np.maximum(node_msgs // C, 1),
                klanes,
            )
            t_row = max(t_row, float(np.where(node_msgs > 0, t_n, 0.0).max()))
        t_est = C * t_row
        if best_t is None or t_est < best_t - 1e-12 * max(1.0, abs(best_t)):
            best, best_t = m, t_est
    return best, max(best * k, 1)


class ColorRounds:
    """Conflict-graph coloring round packer: DSATUR-style greedy coloring at
    **message** granularity.

    The conflict graph has one vertex per message; rounds are the colors.
    Two messages conflict — cannot share a color — through

    * **port budget**: more than ``limit`` messages sharing a sender (or a
      receiver) cannot be concurrent (``limit=None`` resolves to
      ``mult * cs.k``; the ``mult`` rungs let a lex pipeline race packing
      depths, since in the alpha-dominated regime deeper packing amortizes
      more per-round latencies against the same total beta cost);
    * **class purity**: the per-processor intra/inter mixing ban of
      :class:`ReorderRounds`, refined to message granularity — mixing
      re-prices a processor's on-node bytes at network alpha/beta, so an
      intra message that was intra-priced in the *input* round may never
      share a color with off-node traffic at either endpoint; an intra
      message whose input round already carried off-node traffic at that
      endpoint was already network-priced, so packing it with inter
      traffic re-prices nothing (this is what lets the packer reproduce —
      and then beat — input rounds that themselves mix classes, e.g. the
      k-ported trees' node-boundary waves);
    * **causality**: the partial order exported by
      :func:`repro_torch.core.validate.block_dependencies` — a message is colored
      strictly after every provider of a block it forwards (zero-block
      split parts inherit their siblings' constraints via the export's
      lift, so the packer cannot hoist a part ahead of its payload's
      producer).

    Coloring order is the DSATUR recipe adapted to capacities, batched:
    colors are filled in **64-color windows**
    whose per-(processor, side) state is packed ``uint64`` bitsets — one
    bit per window color for "at port capacity", "has off-node (A)
    traffic", and "has intra-priced on-node (C) traffic".  Every batch
    iteration assigns *many colors at once*: each dependency-ready
    candidate's forbidden-color set is a handful of bitwise ORs over the
    bitsets of its two endpoints, its target color is the lowest clear bit
    at or above its per-sender chunk slot (position in the sender's
    priority queue divided by the budget — exactly where sequential
    per-color filling would land it), and per-(endpoint, color) conflicts
    are resolved by priority rank in one sort.  The per-color Python loop
    of the earlier packer (one iteration per emitted round, intractable
    wall-clock at the ~1.3M messages a paper-scale alltoall compiles to)
    becomes a loop over 64-color windows with a few batch iterations each;
    there is no per-message Python anywhere.

    **Memory bound**: the windowing is what keeps the bitsets linear — a
    full conflict-graph adjacency for an O(p^2)-message alltoall would be
    ``p^2 msgs x p^2/64`` uint64 words (the naive DSATUR bitset layout,
    ~2e10 words at p=1152), and even per-message forbidden sets over all
    R colors would be ``M x R/64`` words.  The window holds one uint64 per
    (processor, side, state-kind) plus a ``[p, 64]`` count grid, i.e.
    O(p) — candidates carry one transient uint64 each.  If the packing
    degenerates anyway (pathological inputs), the pass still terminates —
    each window advances monotonically — and the lex race in
    ``OPT_MODES``/OPT3 simply rejects the result, falling back to the
    first-fit ``ReorderRounds`` baseline.

    With ``machine=`` the packer is additionally **tree-aware**:
    in the bandwidth regime (a single message's serialized bytes cost more
    than a message latency, ``beta * max_msg_elems > alpha``) eager
    packing would concentrate a broadcast root's per-round bytes into few
    colors and pay more in serialized port bytes than it saves in alphas —
    exactly where the earlier packer lost the race on kported/fulllane bcast.
    The tree-aware objective caps each (processor, side)'s messages per
    color so its per-color bytes cannot exceed its densest *input* round
    (never below one message), de-prioritizing root-byte concentration
    while leaving the alpha-regime packing depth untouched.

    ``mult=None`` delegates the budget rung to
    :func:`choose_color_budget` (cost-aware with ``machine=``, structural
    otherwise).

    The result is not a pure round union of its input, so — unlike
    ``ReorderRounds``/``CompactRounds`` — it is *not* provably never
    slower; run it under an evaluating policy (``"lex"``) with the
    first-fit pass as the baseline, as ``OPT_MODES``/the OPT3 benchmark
    table do.  Requires block metadata.
    """

    def __init__(
        self,
        limit: int | None = None,
        *,
        procs_per_node: int,
        mult: int | None = 1,
        machine: Machine | None = None,
        ported: bool = False,
    ):
        self.limit = limit
        self.mult = mult
        self.procs_per_node = procs_per_node
        self.machine = machine
        self.ported = ported
        # payload-independent (recipe-cacheable) unless the machine-costed
        # tree-aware caps / budget chooser read message sizes
        self.recipe_safe = machine is None
        if limit is not None:
            lim = str(limit)
        elif mult is None:
            lim = "auto"
        else:
            lim = f"{mult}k"
        # machine-costed runs encode the port model too: the chooser and
        # caps price with it, so two port models are two distinct rewrites
        # (pipeline_fingerprint hashes names — they must not collide)
        cost = (
            f",cost,{'ported' if ported else '1ported'}"
            if machine is not None
            else ""
        )
        self.name = f"color_rounds[limit={lim},n={procs_per_node}{cost}]"

    def _side_caps(
        self, cs: CompiledSchedule, limit: int, pool: np.ndarray,
        qptr: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-(processor, side) per-color message caps.  Default: the port
        budget.  Tree-aware mode (machine given, bandwidth regime): also
        capped so one color's bytes at that endpoint cannot exceed the
        endpoint's densest input round (floored at one message)."""
        p = cs.p
        lim_s = np.full(p, limit, dtype=np.int64)
        lim_r = np.full(p, limit, dtype=np.int64)
        if self.machine is None or cs.num_msgs == 0:
            return lim_s, lim_r
        cost = self.machine.cost
        max_msg = float(cs.elems.max())
        if cost.beta_inter * max_msg <= cost.alpha_inter:
            return lim_s, lim_r  # alpha regime: concentration is free
        st = cs.stats(self.procs_per_node)
        ew = cs.elems.astype(np.float64)
        # densest single message per sender (pool is src-sorted) / receiver
        mx_s = np.zeros(p)
        nz = np.flatnonzero(np.diff(qptr))
        if nz.size:
            mx_s[nz] = np.maximum.reduceat(ew[pool], qptr[:-1][nz])
        rorder = np.argsort(cs.dst, kind="stable")
        rptr = np.zeros(p + 1, dtype=np.int64)
        np.cumsum(np.bincount(cs.dst, minlength=p), out=rptr[1:])
        mx_r = np.zeros(p)
        nz = np.flatnonzero(np.diff(rptr))
        if nz.size:
            mx_r[nz] = np.maximum.reduceat(ew[rorder], rptr[:-1][nz])
        cap_s = np.floor_divide(
            st.send_elems.max(axis=0), np.maximum(mx_s, 1.0)
        ).astype(np.int64)
        cap_r = np.floor_divide(
            st.recv_elems.max(axis=0), np.maximum(mx_r, 1.0)
        ).astype(np.int64)
        lim_s = np.clip(cap_s, 1, limit)
        lim_r = np.clip(cap_r, 1, limit)
        return lim_s, lim_r

    def apply(self, cs: CompiledSchedule) -> CompiledSchedule:
        if not cs.has_blocks:
            raise ValueError(
                "ColorRounds needs block metadata to honour the "
                "dependency DAG; generate the schedule with blocks"
            )
        n = self.procs_per_node
        p, R, M = cs.p, cs.num_rounds, cs.num_msgs
        if p % n:
            raise ValueError(f"p={p} not divisible by procs_per_node={n}")
        if R <= 1 or M == 0:
            return cs

        # --- causality DAG + transpose (provider -> dependents) -----------
        dep_ptr, dep_ids = block_dependencies(cs)
        remaining = np.diff(dep_ptr).astype(np.int64)  # uncolored providers
        dep_req = np.repeat(np.arange(M, dtype=np.int64), np.diff(dep_ptr))
        t_ids = dep_req[np.argsort(dep_ids, kind="stable")]
        t_ptr = np.zeros(M + 1, dtype=np.int64)
        np.cumsum(np.bincount(dep_ids, minlength=M), out=t_ptr[1:])

        if self.limit is not None:
            limit = max(self.limit, 1)
        elif self.mult is None:
            _, limit = choose_color_budget(
                cs,
                procs_per_node=n,
                machine=self.machine,
                ported=self.ported,
                dep_csr=(dep_ptr, dep_ids),
            )
        else:
            limit = max(self.mult * cs.k, 1)

        # --- per-side traffic categories for the class-purity test --------
        # A (=2): off-node; C (=0): on-node, intra-priced in the input
        # round; B (=1): on-node but the endpoint already had off-node
        # traffic in its input round, i.e. already network-priced.  Packing
        # may mix A with B freely; A with C would re-price C's bytes
        # upward, so it is banned per (processor, side, color).
        inter = (cs.src // n) != (cs.dst // n)
        st_in = cs.stats(n)
        rid_in = cs.round_ids()
        cat_s = np.where(
            inter, 2, st_in.send_inter[rid_in, cs.src].astype(np.int8)
        ).astype(np.int8)
        cat_r = np.where(
            inter, 2, st_in.recv_inter[rid_in, cs.dst].astype(np.int8)
        ).astype(np.int8)

        # --- saturation-degree priority (static proxy) --------------------
        # conflict degree = messages competing for either endpoint's port;
        # ties break in generation order, which keeps the phase structure
        # of regular schedules intact.
        deg = (
            np.bincount(cs.src, minlength=p)[cs.src]
            + np.bincount(cs.dst, minlength=p)[cs.dst]
        )
        prank = np.empty(M, dtype=np.int64)
        prank[np.argsort(-deg, kind="stable")] = np.arange(M, dtype=np.int64)

        # per-sender queues in priority order (CSR over src) — one fused-key
        # argsort (prank is a permutation, so the key is collision-free)
        pool = np.argsort(cs.src * np.int64(M) + prank)
        qptr = np.zeros(p + 1, dtype=np.int64)
        np.cumsum(np.bincount(cs.src, minlength=p), out=qptr[1:])
        head = qptr[:-1].copy()
        qend = qptr[1:]

        lim_s, lim_r = self._side_caps(cs, limit, pool, qptr)
        span_cap = lim_s * 64  # max placeable per sender per window

        color_of = np.full(M, -1, dtype=np.int64)
        floor = np.zeros(M, dtype=np.int64)  # min color from providers
        done = np.zeros(M, dtype=bool)
        uncolored = M
        base = 0  # first color of the current 64-color window
        while uncolored:
            # --- fresh window state: packed uint64 bitsets per (proc, side)
            s_cnt = np.zeros((p, 64), dtype=np.int32)
            r_cnt = np.zeros((p, 64), dtype=np.int32)
            full_s = np.zeros(p, dtype=np.uint64)  # at-capacity colors
            full_r = np.zeros(p, dtype=np.uint64)
            hasA_s = np.zeros(p, dtype=np.uint64)  # off-node traffic colors
            hasA_r = np.zeros(p, dtype=np.uint64)
            hasC_s = np.zeros(p, dtype=np.uint64)  # intra-priced colors
            hasC_r = np.zeros(p, dtype=np.uint64)
            # advance queue heads to each sender's first uncolored entry —
            # one cumulative sum + searchsorted per *window*, then build the
            # window's candidate pool once: per sender, the queue prefix the
            # window's colors can hold.  Dependency-blocked entries stay in
            # the pool (they may become ready mid-window); batch iterations
            # below only ever shrink it.
            pre = np.zeros(M + 1, dtype=np.int64)
            np.cumsum(~done[pool], out=pre[1:])
            head = np.minimum(np.searchsorted(pre, pre[head] + 1) - 1, qend)
            sizes = np.minimum(qend - head, span_cap)
            W = pool[np.repeat(head, sizes) + segmented_arange(sizes)]
            W = W[~done[W]]
            wlive = np.ones(W.size, dtype=bool)  # uncolored, not deferred
            wtry = np.full(W.size, -1, dtype=np.int64)  # last tried color
            while uncolored:
                # ~done guards entries colored through the escape path
                ok = wlive & (~done[W]) & (remaining[W] == 0)
                ok_idx = np.flatnonzero(ok)
                cand = W[ok_idx]
                escape = False
                if not cand.size:
                    if not bool((wlive & ~done[W]).any()):
                        break  # pool fully consumed: advance the window
                    ready = np.flatnonzero((~done) & (remaining == 0))
                    if not ready.size:
                        raise AssertionError(
                            "ColorRounds: unfinished coloring with no ready "
                            "message — cyclic block dependencies (invalid "
                            "input)"
                        )
                    # the pool holds only dependency-blocked entries but
                    # ready work hides beyond a blocked sender prefix
                    # (rare): feed the top-priority ready message through
                    # the same batched machinery to unjam the pool
                    cand = ready[[int(np.argmin(prank[ready]))]]
                    escape = True
                csrc, cdst = cs.src[cand], cs.dst[cand]
                cas, car = cat_s[cand], cat_r[cand]
                # tentative chunk slot on first consideration: position
                # among the sender's pending candidates (cand is
                # sender-major in priority order) plus its already-placed
                # window load, divided by its cap — where sequential
                # per-color filling would land it.  Retries resume
                # *next-fit* from the color they last lost (class/capacity
                # losers bump minimally instead of herding or skipping
                # refillable slots).
                runs = np.ones(cand.size, dtype=bool)
                runs[1:] = csrc[1:] != csrc[:-1]
                gstart = np.maximum.accumulate(
                    np.where(runs, np.arange(cand.size), 0)
                )
                pos = np.arange(cand.size) - gstart
                used = s_cnt.sum(axis=1, dtype=np.int64)
                lo = (used[csrc] + pos) // lim_s[csrc]
                if not escape:
                    last = wtry[ok_idx]
                    lo = np.where(last < 0, lo, last + 1)
                lo = np.maximum(lo, floor[cand] - base)
                # forbidden colors: packed bitset adjacency — port-full
                # colors at either endpoint, class-purity conflicts, and
                # everything below the chunk/causality floor
                defer = lo >= 64
                lo_c = np.clip(lo, 0, 63).astype(np.uint64)
                forbid = (_BIT_LOW[lo_c] | full_s[csrc] | full_r[cdst])
                forbid |= np.where(cas == 0, hasA_s[csrc], _U0)
                forbid |= np.where(cas == 2, hasC_s[csrc], _U0)
                forbid |= np.where(car == 0, hasA_r[cdst], _U0)
                forbid |= np.where(car == 2, hasC_r[cdst], _U0)
                forbid = np.where(defer, _UALL, forbid)
                free = ~forbid
                alive = free != _U0
                if not escape:
                    # window exhausted for these candidates: out of the
                    # pool until the next window
                    wlive[ok_idx[~alive]] = False
                if not alive.any():
                    if escape:
                        break  # not even the escape fits: advance window
                    continue  # deferred some; recheck what remains
                widx = ok_idx[alive] if not escape else None
                cand, csrc, cdst = cand[alive], csrc[alive], cdst[alive]
                cas, car = cas[alive], car[alive]
                crel = _ctz64(free[alive])
                if widx is not None:
                    wtry[widx] = crel  # losers resume next-fit from here
                pr = prank[cand]
                # one fused-key sort per endpoint side serves both the
                # class-purity and the capacity selection
                sides = []
                for procs, cats in ((csrc, cas), (cdst, car)):
                    sides.append(
                        (procs, cats, *_side_groups(procs * 64 + crel, pr))
                    )
                # class purity inside this batch: per (endpoint, color)
                # group the highest-priority candidate decides which of
                # A/C survives (B mixes with both)
                sel = np.ones(cand.size, dtype=bool)
                for procs, cats, order, firsts, start_idx, gid_ord in sides:
                    cats_ord = cats[order]
                    first_cat = cats_ord[start_idx]
                    hasA = (np.bincount(gid_ord, cats_ord == 2) > 0)[gid_ord]
                    drop = (
                        (cats_ord == 0) & hasA & (first_cat != 0)
                    ) | ((cats_ord == 2) & (first_cat == 0))
                    sel[order[drop]] = False
                # capacity: top surviving takers per (endpoint, color) in
                # priority order, sender side first (mirrors the
                # sequential packer); survivor rank via a prefix sum over
                # the already-sorted groups
                for (procs, cats, order, firsts, start_idx, _), cnt, lim in (
                    (sides[0], s_cnt, lim_s), (sides[1], r_cnt, lim_r),
                ):
                    k_ord = sel[order].astype(np.int64)
                    ex = np.cumsum(k_ord) - k_ord  # survivors before elem
                    surv = ex - ex[start_idx]
                    po, co = procs[order], crel[order]
                    bad = (k_ord != 0) & (surv >= (lim[po] - cnt[po, co]))
                    sel[order[bad]] = False
                tsel = np.flatnonzero(sel)
                if not tsel.size:
                    # guaranteed progress: the top-priority live candidate
                    # alone is always legal at its free color
                    tsel = np.array([int(np.argmin(pr))], dtype=np.int64)
                take, tcrel = cand[tsel], crel[tsel]
                tsrc, tdst = csrc[tsel], cdst[tsel]
                done[take] = True
                if widx is not None:
                    wlive[widx[tsel]] = False
                col = base + tcrel
                color_of[take] = col
                uncolored -= int(take.size)
                # --- update window state: counts, then OR the new bits
                # straight into the packed bitsets (counts only grow and
                # caps are static, so a full/class bit never clears)
                s_cnt += np.bincount(
                    tsrc * 64 + tcrel, minlength=p * 64
                ).reshape(p, 64).astype(np.int32)
                r_cnt += np.bincount(
                    tdst * 64 + tcrel, minlength=p * 64
                ).reshape(p, 64).astype(np.int32)
                fs = s_cnt[tsrc, tcrel] >= lim_s[tsrc]
                np.bitwise_or.at(full_s, tsrc[fs], _BITW[tcrel[fs]])
                fr = r_cnt[tdst, tcrel] >= lim_r[tdst]
                np.bitwise_or.at(full_r, tdst[fr], _BITW[tcrel[fr]])
                tcs, tcr = cat_s[take], cat_r[take]
                np.bitwise_or.at(
                    hasA_s, tsrc[tcs == 2], _BITW[tcrel[tcs == 2]]
                )
                np.bitwise_or.at(
                    hasC_s, tsrc[tcs == 0], _BITW[tcrel[tcs == 0]]
                )
                np.bitwise_or.at(
                    hasA_r, tdst[tcr == 2], _BITW[tcrel[tcr == 2]]
                )
                np.bitwise_or.at(
                    hasC_r, tdst[tcr == 0], _BITW[tcrel[tcr == 0]]
                )
                rep = t_ptr[take + 1] - t_ptr[take]
                if int(rep.sum()):  # release dependents of new providers
                    hit = np.repeat(t_ptr[take], rep) + segmented_arange(rep)
                    dmsg = t_ids[hit]
                    remaining -= np.bincount(dmsg, minlength=M)
                    np.maximum.at(floor, dmsg, np.repeat(col, rep) + 1)
            base += 64

        g = int(color_of.max()) + 1
        if g == R and bool((color_of == cs.round_ids()).all()):
            return cs  # coloring reproduced the input rounds
        morder = np.argsort(color_of, kind="stable")
        new_ptr = np.zeros(g + 1, dtype=np.int64)
        np.cumsum(np.bincount(color_of, minlength=g), out=new_ptr[1:])
        blk_ptr, blk_ids = gather_block_csr(cs.blk_ptr, cs.blk_ids, morder)
        return dataclasses.replace(
            cs,
            src=cs.src[morder],
            dst=cs.dst[morder],
            elems=cs.elems[morder],
            round_ptr=new_ptr,
            blk_ptr=blk_ptr,
            blk_ids=blk_ids,
            _stats={},
        )


class CompactRounds:
    """Greedy adjacent-round merging under a port budget + data-flow rule.

    ``limit`` is the max concurrent sends (and receives) per processor in a
    merged round: 1 keeps lane-legality, ``None`` resolves to the
    schedule's own ``k`` (lane-aware: a node's k lanes are saturated by k
    concurrent streams, so merging past k buys no bandwidth, only queueing).

    Merging moves messages to *earlier* rounds only, so the single causal
    hazard is a message landing in the same merged round as an acquisition
    it depends on; the pass consults the IR block arrays and refuses such
    merges.  Requires block metadata (``cs.has_blocks``).
    """

    recipe_safe = True  # payload-independent round_ptr rewrite

    def __init__(self, limit: int | None = None):
        self.limit = limit
        self.name = f"compact_rounds[limit={'k' if limit is None else limit}]"

    def apply(self, cs: CompiledSchedule) -> CompiledSchedule:
        if not cs.has_blocks:
            raise ValueError(
                "CompactRounds needs block metadata to check round-merge "
                "causality; generate the schedule with blocks"
            )
        limit = max(self.limit if self.limit is not None else cs.k, 1)
        p, R = cs.p, cs.num_rounds
        if R <= 1:
            return cs
        nblk = np.diff(cs.blk_ptr)
        # per-block-hop keys (same encoding as the validity oracle)
        if cs.blk_ids.size:
            bmin = int(cs.blk_ids.min())
            bspan = int(cs.blk_ids.max()) - bmin + 1
        else:
            bmin, bspan = 0, 1
        req_key = np.repeat(cs.src, nblk) * bspan + (cs.blk_ids - bmin)
        acq_key = np.repeat(cs.dst, nblk) * bspan + (cs.blk_ids - bmin)
        analytic = initial_holds(
            cs.op, p, np.repeat(cs.src, nblk), cs.blk_ids
        )
        # messages are round-contiguous, so block offsets at round
        # boundaries come straight off the CSR
        hop_ptr = cs.blk_ptr[cs.round_ptr]

        boundaries = [0]  # round indices starting a merged round
        send = np.zeros(p, dtype=np.int64)
        recv = np.zeros(p, dtype=np.int64)
        open_acq = np.empty(0, dtype=np.int64)  # sorted keys acquired in group
        open_started = False
        for r in range(R):
            a, b = cs.round_ptr[r], cs.round_ptr[r + 1]
            if a == b:
                continue  # empty round: merges into anything, emits nothing
            ha, hb = hop_ptr[r], hop_ptr[r + 1]
            s_cnt = np.bincount(cs.src[a:b], minlength=p)
            r_cnt = np.bincount(cs.dst[a:b], minlength=p)
            if open_started:
                fits = (
                    int((send + s_cnt).max()) <= limit
                    and int((recv + r_cnt).max()) <= limit
                )
                if fits and open_acq.size:
                    need = req_key[ha:hb][~analytic[ha:hb]]
                    if need.size:
                        i = np.searchsorted(open_acq, need)
                        i = np.minimum(i, open_acq.size - 1)
                        fits = not bool((open_acq[i] == need).any())
            else:
                fits = False
            if fits:
                send += s_cnt
                recv += r_cnt
            else:
                boundaries.append(r)
                send, recv = s_cnt, r_cnt
                open_acq = np.empty(0, dtype=np.int64)
                open_started = True
            open_acq = np.union1d(open_acq, acq_key[ha:hb])
        # boundaries[0] is a sentinel; drop it if the first nonempty round
        # re-appended itself (it always does unless the schedule is empty).
        starts = boundaries[1:] if len(boundaries) > 1 else []
        if not starts:  # all rounds empty
            new_ptr = np.array([0, cs.num_msgs], dtype=np.int64)
        else:
            new_ptr = np.concatenate(
                [cs.round_ptr[starts], [cs.num_msgs]]
            ).astype(np.int64)
        return dataclasses.replace(cs, round_ptr=new_ptr, _stats={})


class SplitPayloads:
    """Split large messages across the node's k lanes: each message whose
    sender posts fewer than ``parts`` messages in its round is split into
    parallel same-round messages (``parts // posted`` of them, clamped to
    the element count) via :func:`repro_torch.core.schedule_ir.split_messages` —
    the k-lane decomposition trick.

    Splitting partitions both ``elems`` and ``blk_ids``, so the oracle's
    block-hop multiset is unchanged and
    :func:`~repro_torch.core.schedule_ir.merge_messages` is the exact inverse.
    Cost-wise the pass is never slower *as long as* ``parts`` does not
    exceed the simulating machine's lane count: extra streams only raise
    the lane bandwidth divisor (``min(streams, k)``) and, in the k-ported
    model, the per-processor port divisor — where a processor drives one
    big message through one of its k ports, splitting cuts its port term
    toward ``beta * elems / k``.  Past the machine's k, however, the
    ported model charges ``alpha * ceil(msgs / k)`` serial batches, so an
    oversplit *pessimizes*.  ``parts=None`` falls back to ``cs.k`` — the
    generator's port parameter, which may exceed the machine's lanes — so
    either pass the machine's ``k_lanes`` explicitly (the ``"split"`` OPT
    mode does) or run under an evaluating policy such as ``"lex"``.

    **Cost-aware mode**: with ``machine=`` the pass prices every
    candidate split with the simulator's own per-sender port formula
    (:func:`repro_torch.core.simulate.port_time`) and only splits where the
    alpha/beta trade-off of the message's traffic class predicts a strict
    gain: the per-sender port term must drop (k-ported model: the sender's
    bytes spread over more of its k streams without exceeding them).  In
    the 1-ported model *no* split can pay: the port term serializes a
    sender's bytes regardless of message count, and whenever a node drives
    fewer streams than lanes those streams come from at most that many
    senders, so the worst port term already dominates the node lane term
    (``beta*max_proc_bytes >= beta*node_bytes/streams``) — splitting only
    shrinks the smaller term.  The cost-aware pass is therefore an exact
    identity there, where the uniform mode emits every split as message
    bloat the lex policy must then reject wholesale.
    """

    #: split factors clamp to ``elems`` (and the costed mode prices bytes),
    #: so the rewrite is payload-dependent: never recipe-cacheable.
    recipe_safe = False

    def __init__(
        self,
        parts: int | None = None,
        *,
        machine: Machine | None = None,
        ported: bool = False,
    ):
        self.parts = parts
        self.machine = machine
        self.ported = ported
        if machine is not None:
            self.name = (
                f"split_payloads[cost,k={machine.topo.k_lanes},"
                f"{'ported' if ported else '1ported'}]"
            )
        else:
            self.name = (
                f"split_payloads[parts={'k' if parts is None else parts}]"
            )

    def apply(self, cs: CompiledSchedule) -> CompiledSchedule:
        if self.machine is not None:
            return self._apply_costed(cs)
        parts = max(self.parts if self.parts is not None else cs.k, 1)
        if parts <= 1 or cs.num_msgs == 0:
            return cs
        p = cs.p
        skey = cs.round_ids() * p + cs.src
        posted = np.bincount(skey, minlength=cs.num_rounds * p)[skey]
        factors = np.maximum(parts // posted, 1)
        return split_messages(cs, factors)

    def _apply_costed(self, cs: CompiledSchedule) -> CompiledSchedule:
        topo, cost = self.machine.topo, self.machine.cost
        k, n = topo.k_lanes, topo.procs_per_node
        p, R = cs.p, cs.num_rounds
        if k <= 1 or cs.num_msgs == 0 or not self.ported:
            # 1-ported: the port term serializes a sender's bytes regardless
            # of message count, and it dominates the node lane term in every
            # lane-starved round (see the class docstring) — no split pays.
            return cs
        if p % n:
            raise ValueError(f"p={p} not divisible by procs_per_node={n}")
        rid = cs.round_ids()
        skey = rid * p + cs.src
        # per-(round, sender) aggregates: the port term's inputs
        posted = np.bincount(skey, minlength=R * p)
        e_tot = np.bincount(
            skey, weights=cs.elems.astype(np.float64), minlength=R * p
        )
        inter = (cs.src // n) != (cs.dst // n)
        s_inter = np.bincount(skey[inter], minlength=R * p) > 0
        # lane-filling factor: split each of the sender's messages so its
        # round posts as close to k streams as possible without exceeding
        # them (past k the ported model charges serial alpha batches)
        f_proc = np.maximum(k // np.maximum(posted, 1), 1)
        # predicted per-sender port gain, priced by the simulator's formula
        t0 = port_time(cost, e_tot, posted, s_inter, k, ported=True)
        t1 = port_time(cost, e_tot, posted * f_proc, s_inter, k, ported=True)
        factors = np.where(((t0 - t1) > 0.0)[skey], f_proc[skey], 1)
        return split_messages(cs, factors)


class CoalesceMessages:
    """Fuse same-(src, dst) messages within each round: one message with
    the summed element count and the concatenated (re-sorted) block set
    (:func:`repro_torch.core.schedule_ir.merge_messages`, the inverse of
    :class:`SplitPayloads`).  Changes the node stream count, so gate it
    behind an evaluating policy when stream count feeds the lane bandwidth
    term."""

    name = "coalesce_messages"
    #: payload-independent, but fuses messages (sums elems), so the
    #: tagged-elems recipe trick cannot replay it: not recipe-cacheable.
    recipe_safe = False

    def apply(self, cs: CompiledSchedule) -> CompiledSchedule:
        return merge_messages(cs)


class RepairSchedule:
    """Fault-repair rewrite: make a schedule correct and
    routable on the degraded machine described by a
    :class:`~repro_torch.core.faults.FaultSpec`.

    Two rewrite steps, both pure array surgery:

    1. **Relay off dead network ports.**  Every inter-node message whose
       sender or receiver lost its network port is rerouted through the
       lowest-numbered surviving live-port rank on the same node
       (:func:`repro_torch.core.schedule_ir.relay_messages`): an intra-node
       stage-out hop before the original round and/or a stage-in hop after
       it.  Every hop carries the full payload and block slice, so block
       semantics are bit-identical — the relay acquires strictly before it
       forwards, and the final owner still receives every block before any
       round that consumes it.  Intra-node messages are untouched (shared
       memory does not ride the NIC).
    2. **Re-pack under the reduced lane budget.**  When the fault set
       shrinks a node's surviving rails below the schedule's packing width
       (or step 1 staged new hops), the schedule is re-colored with the
       existing bitset :class:`ColorRounds` at ``limit = min surviving
       lanes`` — the same packer the optimizer uses, so a repaired
       ``opt:`` schedule keeps its packed structure wherever the budget
       still allows it.

    Unrepairable faults — a dead *node* whose traffic the schedule still
    carries (its data is gone), or a dead-port endpoint with no surviving
    live-port rank on its node — raise
    :class:`~repro_torch.core.faults.UnrepairableFaultError`; the
    :func:`repair_schedule` entry point catches it and reverts (repair is a
    rewrite, never a regeneration — regeneration on a shrunk topology is
    the elastic layer's ``plan_remesh`` job, not the repairer's).

    The rewrite relays payloads (duplicating ``elems`` across hops), so it
    is *not* recipe-cacheable; degraded entries are cached per fault
    fingerprint by ``schedule_ir.compiled_schedule(faults=...)`` instead.
    """

    recipe_safe = False

    def __init__(self, spec: FaultSpec, *, topo: Topology):
        spec.validate(topo)
        self.spec = spec
        self.topo = topo
        self.name = (
            f"repair_schedule[{spec.fingerprint()},n={topo.procs_per_node}]"
        )

    def apply(self, cs: CompiledSchedule) -> CompiledSchedule:
        spec, topo = self.spec, self.topo
        if spec.is_healthy or cs.num_msgs == 0:
            return cs
        if cs.p != topo.p:
            raise ValueError(
                f"schedule has p={cs.p} but repair topology has p={topo.p}"
            )
        N, n = topo.num_nodes, topo.procs_per_node
        deg = degradation_of(spec, topo)

        # dead nodes: their ranks' data is unreachable — no rewrite can
        # deliver it, so any schedule still touching them is unrepairable
        if deg.dead_node.any():
            touched = deg.dead_rank[cs.src] | deg.dead_rank[cs.dst]
            if bool(touched.any()):
                raise UnrepairableFaultError(
                    f"dead node(s) {list(spec.dead_nodes)} own data the "
                    "schedule must route; rewrite cannot preserve block "
                    "semantics — shrink the job (plan_remesh) instead"
                )

        relayed = False
        if deg.dead_port.any():
            inter = (cs.src // n) != (cs.dst // n)
            need_src = inter & deg.dead_port[cs.src]
            need_dst = inter & deg.dead_port[cs.dst]
            if bool(need_src.any()) or bool(need_dst.any()):
                live = (~deg.dead_port).reshape(N, n)
                has_live = live.any(axis=1)
                proxy = np.where(
                    has_live,
                    np.arange(N, dtype=np.int64) * n + np.argmax(live, axis=1),
                    -1,
                )
                if bool(
                    (need_src & (proxy[cs.src // n] < 0)).any()
                    or (need_dst & (proxy[cs.dst // n] < 0)).any()
                ):
                    raise UnrepairableFaultError(
                        "a node lost every live network port; no surviving "
                        "local rank to relay through — shrink the job instead"
                    )
                via_src = np.where(need_src, proxy[cs.src // n], -1)
                via_dst = np.where(need_dst, proxy[cs.dst // n], -1)
                rsp = TRACER.start(
                    "repair.relay",
                    relayed_src=int(need_src.sum()),
                    relayed_dst=int(need_dst.sum()),
                ) if TRACER else None
                try:
                    cs = relay_messages(cs, via_src, via_dst)
                except BaseException:
                    if rsp:
                        TRACER.finish(rsp, outcome="error")
                    raise
                if rsp:
                    TRACER.finish(rsp, msgs_after=cs.num_msgs)
                obs_metrics.counter("repair.relayed_msgs").inc(
                    int(need_src.sum()) + int(need_dst.sum())
                )
                relayed = True

        # reduced per-node port budget: the narrowest surviving lane count
        alive_lanes = deg.lanes[~deg.dead_node]
        k_eff = max(1, int(alive_lanes.min())) if alive_lanes.size else 1
        if relayed or cs.max_port_width() > k_eff:
            trigger = "relayed" if relayed else "overwidth"
            psp = TRACER.start("repair.repack", k_eff=k_eff,
                               trigger=trigger) if TRACER else None
            try:
                cs = ColorRounds(limit=k_eff, procs_per_node=n).apply(cs)
            except BaseException:
                if psp:
                    TRACER.finish(psp, outcome="error")
                raise
            if psp:
                TRACER.finish(psp, rounds_after=cs.num_rounds)
            obs_metrics.counter("repair.repacks").inc()
        return cs


def repair_schedule(
    cs: CompiledSchedule,
    spec: FaultSpec,
    *,
    topo: Topology | None = None,
    machine: Machine | None = None,
    validate: bool = True,
) -> tuple[CompiledSchedule, list[PassRecord]]:
    """One-call fault repair: rewrite ``cs`` for the degraded machine and
    oracle-check the result; returns ``(repaired, records)``.

    The revert contract (graceful degradation): when the fault set is
    unrepairable by rewrite — dead nodes, or a node with no surviving
    live-port rank — the input schedule is returned *unchanged* with an
    ``applied=False`` record, never an exception.  Callers that must make
    progress anyway (the selector's fallback ladder, the chaos harness)
    pair the revert with an elastic remesh; the degraded simulator prices
    the un-repaired schedule at ``inf``, so a reverted repair can never
    win a selection race.  A genuinely broken rewrite (oracle violation)
    still raises — corruption is a bug, not a degraded mode.
    """
    if topo is None and machine is not None:
        topo = machine.topo
    if topo is None:
        raise ValueError("repair_schedule needs topo= or machine=")
    ps = RepairSchedule(spec, topo=topo)
    t0 = time.perf_counter()
    sp = TRACER.start("repair", fingerprint=spec.fingerprint()) if TRACER \
        else None
    try:
        new = ps.apply(cs)
    except UnrepairableFaultError:
        obs_metrics.counter("repair.reverted").inc()
        if sp:
            TRACER.finish(sp, applied=False, outcome="unrepairable")
        return cs, [
            PassRecord(
                name=ps.name,
                applied=False,
                rounds_before=cs.num_rounds,
                rounds_after=cs.num_rounds,
                msgs_before=cs.num_msgs,
                msgs_after=cs.num_msgs,
                time_before_us=None,
                time_after_us=None,
                wall_s=time.perf_counter() - t0,
                oracle_ok=None,
            )
        ]
    except BaseException:
        if sp:
            TRACER.finish(sp, applied=False, outcome="error")
        raise
    ok = None
    if validate and new is not cs:
        osp = TRACER.start("repair.oracle") if TRACER else None
        tv = time.perf_counter()
        try:
            report = validate_schedule(new)
        except BaseException:
            if osp:
                TRACER.finish(osp, outcome="error")
            raise
        obs_metrics.counter("repair.oracle_checks").inc()
        obs_metrics.gauge("repair.last_oracle_verify_s").set(
            time.perf_counter() - tv
        )
        ok = report.ok
        if osp:
            TRACER.finish(osp, ok=ok)
        if not ok and sp:
            TRACER.finish(sp, applied=False, outcome="oracle_violation")
        report.raise_if_invalid()
    obs_metrics.counter("repair.applied" if new is not cs
                        else "repair.noop").inc()
    if sp:
        TRACER.finish(sp, applied=new is not cs, outcome="ok",
                      rounds_after=new.num_rounds, msgs_after=new.num_msgs)
    return new, [
        PassRecord(
            name=ps.name,
            applied=new is not cs,
            rounds_before=cs.num_rounds,
            rounds_after=new.num_rounds,
            msgs_before=cs.num_msgs,
            msgs_after=new.num_msgs,
            time_before_us=None,
            time_after_us=None,
            wall_s=time.perf_counter() - t0,
            oracle_ok=ok,
        )
    ]


# ---------------------------------------------------------------------------
# Pass manager.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PassRecord:
    """Per-pass delta, the optimizer-trajectory unit surfaced in
    BENCH_schedules.json.  ``oracle_ok`` is None when the pass was not
    oracle-checked (no ``validate``/``check``, or it returned its input
    unchanged); ``iteration`` is the fixpoint sweep the record belongs to."""

    name: str
    applied: bool
    rounds_before: int
    rounds_after: int
    msgs_before: int
    msgs_after: int
    time_before_us: float | None
    time_after_us: float | None
    wall_s: float
    oracle_ok: bool | None = None
    iteration: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PassManager:
    """Compose rewrite passes with delta accounting and optional reverts.

    Policies decide whether a pass result replaces the current schedule:

    * ``"always"`` — keep every rewrite;
    * ``"improved"`` — keep when the re-simulated time does not increase
      (requires ``machine``);
    * ``"lex"`` — keep on strict lexicographic improvement of
      ``(time, rounds, msgs)`` with a relative time tolerance (requires
      ``machine``): faster wins, equal-time-fewer-rounds wins, and a
      payload split that buys nothing is rejected rather than kept.

    ``fixpoint=True`` re-runs the whole pipeline until a sweep applies no
    pass (bounded by ``max_iters``), so e.g. a reorder that only becomes
    legal after a split still lands.

    Oracle integration: ``validate=True`` checks every structurally-new
    rewrite with :func:`repro_torch.core.validate.validate_schedule` and *raises*
    on corruption; ``check=True`` instead *reverts* the broken pass and
    records ``oracle_ok=False`` — the pipeline degrades to a no-op instead
    of shipping a corrupt schedule.  Optimized schedules are machine-
    checked, never trusted.

    With ``incremental=True`` (the default) a checked rewrite whose
    :func:`repro_torch.core.validate.rewrite_window` confines the diff to a small
    round window (< half the block-hop events) is rechecked by the
    *incremental* oracle — only the affected blocks' hop chains — instead
    of a full O(E log E) replay.  The incremental verdict is only sound
    against a valid input, so the manager full-validates the current
    schedule once, lazily, before the first incremental use (and falls
    back to full per-pass validation if that input check fails, preserving
    the exact non-incremental semantics on garbage inputs).
    """

    def __init__(
        self,
        passes: Sequence,
        *,
        machine: Machine | None = None,
        ported: bool = False,
        policy: str = "always",
        validate: bool = False,
        check: bool = False,
        fixpoint: bool = False,
        max_iters: int = 4,
        incremental: bool = True,
    ):
        if policy not in ("always", "improved", "lex"):
            raise ValueError(f"unknown policy {policy!r}")
        if policy in ("improved", "lex") and machine is None:
            raise ValueError(f'policy="{policy}" needs a machine to time on')
        self.passes = list(passes)
        self.machine = machine
        self.ported = ported
        self.policy = policy
        self.validate = validate
        self.check = check
        self.fixpoint = fixpoint
        self.max_iters = max(int(max_iters), 1)
        self.incremental = incremental

    def _time(self, cs: CompiledSchedule) -> float | None:
        if self.machine is None:
            return None
        return simulate(cs, self.machine, ported=self.ported).time_us

    @staticmethod
    def _lex_better(t_new, new: CompiledSchedule, t_cur, cur) -> bool:
        tol = 1e-9 * max(1.0, abs(t_cur))
        if t_new < t_cur - tol:
            return True
        if t_new > t_cur + tol:
            return False
        if new.num_rounds != cur.num_rounds:
            return new.num_rounds < cur.num_rounds
        return new.num_msgs < cur.num_msgs

    def _check(self, cs, new, prev_ok):
        """Oracle-check a structurally-new rewrite; incremental when the
        diff is window-confined and small and the input is known-valid.
        Returns ``(report, prev_ok)`` (``prev_ok`` memoizes the lazy input
        validation across passes: None = not yet checked)."""
        sp = TRACER.start("oracle") if TRACER else None
        mode = "full"
        try:
            if self.incremental and prev_ok is not False:
                window = rewrite_window(cs, new)
                if (
                    window is not None
                    and window_hop_fraction(cs, new, window) < 0.5
                ):
                    if prev_ok is None:
                        prev_ok = validate_schedule(cs).ok
                    if prev_ok:
                        mode = "incremental"
                        report = revalidate_schedule(
                            new, prev=cs, window=window
                        )
            if mode == "full":
                report = validate_schedule(new)
        except BaseException:
            if sp:
                TRACER.finish(sp, outcome="error")
            raise
        obs_metrics.counter(f"oracle.{mode}").inc()
        if sp:
            TRACER.finish(sp, mode=mode, ok=report.ok)
        return report, prev_ok

    def run(
        self, cs: CompiledSchedule
    ) -> tuple[CompiledSchedule, list[PassRecord]]:
        records: list[PassRecord] = []
        run_sp = TRACER.start(
            "optimize",
            passes=[getattr(ps, "name", type(ps).__name__) for ps in self.passes],
            policy=self.policy, fixpoint=self.fixpoint,
            incremental=self.incremental,
        ) if TRACER else None
        try:
            cs, records = self._run_inner(cs, records)
        except BaseException:
            if run_sp:
                TRACER.finish(run_sp, outcome="error")
            raise
        if run_sp:
            TRACER.finish(
                run_sp, outcome="ok", sweeps=records[-1].iteration + 1
                if records else 0,
                applied=sum(1 for r in records if r.applied),
            )
        return cs, records

    def _run_inner(
        self, cs: CompiledSchedule, records: list[PassRecord]
    ) -> tuple[CompiledSchedule, list[PassRecord]]:
        t_cur = self._time(cs)
        prev_ok: bool | None = None  # lazy input validity, for incremental
        sweeps = self.max_iters if self.fixpoint else 1
        for it in range(sweeps):
            progressed = False
            for ps in self.passes:
                name = getattr(ps, "name", type(ps).__name__)
                sp = TRACER.start(f"pass:{name}", iteration=it) if TRACER \
                    else None
                t0 = time.perf_counter()
                try:
                    new = ps.apply(cs)
                    changed = new is not cs
                    ok = None
                    if changed and (self.validate or self.check):
                        report, prev_ok = self._check(cs, new, prev_ok)
                        ok = report.ok
                        if not ok and not self.check:
                            report.raise_if_invalid()
                    if ok is False:
                        t_new = None  # corrupt rewrite: never timed
                    elif not changed:
                        t_new = t_cur  # identity result: skip re-simulation
                    else:
                        t_new = self._time(new)
                except BaseException:
                    if sp:
                        TRACER.finish(sp, outcome="error")
                    raise
                if ok is False:
                    keep = False
                elif self.policy == "always":
                    keep = True
                elif self.policy == "improved":
                    keep = t_new <= t_cur
                else:  # lex
                    keep = self._lex_better(t_new, new, t_cur, cs)
                if changed and not keep:
                    # reverted rewrite: either the oracle caught corruption
                    # (check=True) or the policy rejected the trade
                    reason = "oracle" if ok is False else "policy"
                    obs_metrics.counter(f"passes.reverted.{reason}").inc()
                    if TRACER:
                        TRACER.event("pass.revert", pass_name=name,
                                     reason=reason)
                if sp:
                    TRACER.finish(
                        sp, applied=keep, changed=changed,
                        rounds_before=cs.num_rounds, rounds_after=new.num_rounds,
                        msgs_before=cs.num_msgs, msgs_after=new.num_msgs,
                        time_before_us=t_cur, time_after_us=t_new,
                        oracle_ok=ok,
                    )
                records.append(
                    PassRecord(
                        name=name,
                        applied=keep,
                        rounds_before=cs.num_rounds,
                        rounds_after=new.num_rounds,
                        msgs_before=cs.num_msgs,
                        msgs_after=new.num_msgs,
                        time_before_us=t_cur,
                        time_after_us=t_new,
                        wall_s=time.perf_counter() - t0,
                        oracle_ok=ok,
                        iteration=it,
                    )
                )
                if keep:
                    progressed = progressed or changed
                    cs, t_cur = new, t_new
                    if ok:  # the kept rewrite was machine-checked valid
                        prev_ok = True
            if not progressed:
                break
        return cs, records


def _reorder_pipeline(topo: Topology | None) -> list:
    if topo is None:
        raise ValueError(
            'optimize mode "reorder" needs a topology (the class-purity '
            "test requires procs_per_node); pass topo= or machine="
        )
    return [ReorderRounds(limit=None, procs_per_node=topo.procs_per_node)]


def _split_pipeline(topo: Topology | None) -> list:
    if topo is None:
        raise ValueError(
            'optimize mode "split" needs a topology (parts must come from '
            "the machine's lane count, not a generator's port parameter); "
            "pass topo= or machine="
        )
    return [SplitPayloads(parts=topo.k_lanes)]


def _color_pipeline(topo: Topology | None) -> list:
    if topo is None:
        raise ValueError(
            'optimize mode "color" needs a topology (the class-purity '
            "test requires procs_per_node); pass topo= or machine="
        )
    n = topo.procs_per_node
    return [ColorRounds(limit=None, procs_per_node=n, mult=None)]


#: optimize= knob values -> pass pipeline factory (called with the target
#: Topology, or None when the caller has none).  "lane"/"ported" are the
#: adjacent compactions; "reorder" is the non-adjacent first-fit list
#: scheduler (never slower by construction, so it is safe under
#: policy="always"); "split" is the k-lane payload decomposition at the
#: *topology's* lane count (neutral in the 1-ported model, a win in the
#: k-ported one); "color" is the conflict-graph coloring packer at the
#: budget rung :func:`choose_color_budget` picks (structural
#: chooser here, since the selector pipeline carries no machine; this
#: keeps the pipeline payload-independent and therefore recipe-cacheable
#: across payload sizes).  ColorRounds is not provably never-slower, so
#: the selector *races* opt: candidates built from it against their
#: unoptimized bases rather than trusting them; the OPT3 benchmark table
#: runs the cost-priced chooser (machine=) against the first-fit baseline
#: under the lex policy, where the rung is evaluated before it lands.
OPT_MODES: dict[str, Callable[[Topology | None], list]] = {
    "lane": lambda topo: [CompactRounds(limit=1)],
    "ported": lambda topo: [CompactRounds(limit=None)],
    "reorder": _reorder_pipeline,
    "split": _split_pipeline,
    "color": _color_pipeline,
}


def optimize_schedule(
    cs: CompiledSchedule,
    mode: str = "ported",
    *,
    topo: Topology | None = None,
    machine: Machine | None = None,
    validate: bool = True,
) -> tuple[CompiledSchedule, list[PassRecord]]:
    """One-call optimizer entry: run the ``mode`` pipeline, oracle-check the
    result, return ``(optimized, records)``.  ``topo`` (or ``machine``,
    from which it is taken) supplies the node partitioning to the passes
    that need one."""
    try:
        factory = OPT_MODES[mode]
    except KeyError:
        raise ValueError(
            f"unknown optimize mode {mode!r}; expected one of {sorted(OPT_MODES)}"
        ) from None
    if topo is None and machine is not None:
        topo = machine.topo
    pm = PassManager(factory(topo), machine=machine, validate=validate)
    return pm.run(cs)
