"""Hierarchical alpha-beta cost simulation of round-based schedules.

This is the reproduction oracle for the paper's experimental tables: the
paper's absolute numbers are artifacts of one OmniPath cluster and three MPI
libraries, so *reproduction* means recovering the same orderings and scaling
behaviour of the algorithm families under a calibrated machine model.

The model (paper §2.4, made concrete):

* A message of ``m`` elements costs ``alpha + beta * m``; alpha/beta differ
  for on-node (shared memory) and off-node (network) messages.
* **Lane constraint** (the k-lane model): a node can drive at most ``k``
  concurrent off-node streams at full rail bandwidth.  If ``M > k`` off-node
  messages are concurrently in flight at a node, bandwidth is shared: the
  effective beta is multiplied by ``M / k`` (paper: "bandwidth is equally
  shared among the processors").
* **Port constraint**: a single processor drives its messages through one
  port.  A processor posting ``m`` non-blocking messages in a round pays one
  alpha (software pipelining — the paper's observation that more non-blocking
  sends are beneficial) but serializes their bytes through its port.
* **Shared-memory cap**: the aggregate on-node traffic of a round is limited
  by ``node_bw_elems`` (the paper's open question "how much communication can
  the shared memory sustain?" — on Hydra, measurably less than 32 concurrent
  full-bandwidth streams).
* In ``ported`` mode the per-processor port constraint is lifted up to k
  concurrent messages (the idealized k-ported machine, for theory-vs-practice
  comparisons).

Round time = max over processors and nodes of their completion terms; the
schedule time is the sum over rounds (rounds are barrier-synchronized, which
matches the paper's measurement loop).

Two implementations share this model:

* :func:`simulate` — the production path.  It accepts either a legacy
  ``Schedule`` (compiled on the fly) or a ``CompiledSchedule`` and reduces
  over the IR's per-round aggregate arrays (``np.bincount`` grids), which is
  O(numpy) instead of O(Python-per-message).
* :func:`simulate_msgs` — the original per-``Msg`` reference loop, kept for
  the block-carrying verification schedules and as the equivalence oracle;
  ``tests/test_schedule_ir.py`` pins both paths to *identical* ``SimResult``
  values (every arithmetic expression below is written operation-for-
  operation like the reference so the floats match bit-exactly).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from repro_torch.core.schedule import Schedule
from repro_torch.core.topology import Machine

__all__ = [
    "simulate",
    "simulate_payload_scaled",
    "simulate_msgs",
    "SimResult",
    "port_time",
    "lane_time",
]


# ---------------------------------------------------------------------------
# Costing hooks: THE per-round cost formulas, shared between the simulator
# and the cost-aware optimizer passes.  ``repro_torch.core.passes``
# evaluates ``port_time`` to price a rewrite (per-message split factors
# from the alpha/beta trade-off per traffic class) with exactly the
# arithmetic the simulator will charge — no second, drifting copy of the
# model.  ``lane_time`` is consumed on the same terms by the
# budget chooser (``passes.choose_color_budget``): its packed-time proxy
# prices each coloring rung's node rail term with this exact formula, so
# the rung it picks is the rung the lex race would have kept.
# Every expression is written operation-for-operation like the per-``Msg``
# reference so the floats stay bit-exact.
# ---------------------------------------------------------------------------


def port_time(cost, elems, nmsgs, inter, k, *, ported, alpha_batches=True):
    """Per-processor port completion term for one round (vectorized).

    ``elems``/``nmsgs`` are the processor's total round traffic and message
    count on one side (send or receive); ``inter`` selects the network
    alpha/beta whenever any of that traffic is off-node.  In the k-ported
    model the processor drives ``min(nmsgs, k)`` concurrent streams;
    ``alpha_batches=True`` (the send side) additionally charges
    ``alpha * ceil(nmsgs / k)`` serial posting batches.
    """
    elems = np.asarray(elems, dtype=np.float64)
    nmsgs = np.asarray(nmsgs)
    beta = np.where(inter, cost.beta_inter, cost.beta_intra)
    alpha = np.where(inter, cost.alpha_inter, cost.alpha_intra)
    if ported:
        denom = np.minimum(nmsgs, k)
        t = alpha + beta * elems / np.where(denom, denom, 1)
        if alpha_batches:
            eff = -(-nmsgs // k)  # ceil(nmsgs / k) serial alpha batches
            t = np.maximum(t, alpha * eff)
        return t
    return alpha + beta * elems


def lane_time(cost, elems, streams, k):
    """Per-node lane bandwidth term: ``streams`` concurrent off-node
    messages share the node's k rails; fewer streams than rails leave
    bandwidth idle (which is what k-lane payload splitting reclaims)."""
    elems = np.asarray(elems, dtype=np.float64)
    return cost.alpha_inter + cost.beta_inter * elems / np.minimum(
        np.maximum(streams, 1), k
    )


@dataclasses.dataclass(frozen=True)
class SimResult:
    time_us: float
    rounds: int
    inter_elems: int  # total off-node traffic
    intra_elems: int  # total on-node traffic
    max_node_inflight: int  # worst concurrent off-node streams at one node

    def __repr__(self):
        return (
            f"SimResult(time={self.time_us:.2f}us rounds={self.rounds} "
            f"inter={self.inter_elems} intra={self.intra_elems} "
            f"inflight={self.max_node_inflight})"
        )


def simulate(schedule, machine: Machine, *, ported: bool = False) -> SimResult:
    """Simulate a schedule (legacy ``Schedule`` or ``CompiledSchedule``)."""
    from repro_torch.core.schedule_ir import CompiledSchedule, compile_schedule

    if isinstance(schedule, Schedule):
        schedule = compile_schedule(schedule)
    if not isinstance(schedule, CompiledSchedule):
        raise TypeError(f"cannot simulate {type(schedule).__name__}")
    return _simulate_ir(schedule, machine, ported=ported)


def _simulate_ir(cs, machine: Machine, *, ported: bool) -> SimResult:
    topo, cost = machine.topo, machine.cost
    k = topo.k_lanes
    if cs.num_msgs == 0:
        return SimResult(0.0, cs.num_rounds, 0, 0, 0)
    st = cs.stats(topo.procs_per_node)
    R = cs.num_rounds

    # Degraded-machine view: ``None`` for healthy machines, which
    # keeps every arithmetic expression below bit-exact with the reference.
    # Under faults the SAME port_time/lane_time hooks price the round, with
    # per-node surviving-lane counts and derated betas broadcast into the
    # [R, p]/[R, N] grids; traffic that touches a dead port or dead node is
    # unroutable and prices at inf (repair it first, or remesh).
    deg = machine.degradation()
    if deg is not None:
        k_nodes = deg.lanes  # [N]
        scale_n = deg.beta_scale  # [N]
        k_procs = np.repeat(k_nodes, topo.procs_per_node)  # [p]
        scale_p = np.repeat(scale_n, topo.procs_per_node)  # [p]

    # --- per-processor port terms (vectorized over the [R, p] grids) -------
    # beta/alpha selection matches the reference: the slower network params
    # apply whenever any of the processor's round traffic is off-node.
    s_mask = st.send_cnt > 0
    if deg is None:
        t_send = port_time(
            cost, st.send_elems, st.send_cnt, st.send_inter, k, ported=ported
        )
    else:
        t_send = port_time(
            cost,
            np.where(st.send_inter, st.send_elems * scale_p, st.send_elems),
            st.send_cnt,
            st.send_inter,
            np.maximum(k_procs, 1),
            ported=ported,
        )
        t_send = np.where(
            (st.send_inter & deg.dead_port) | (s_mask & deg.dead_rank),
            np.inf,
            t_send,
        )
    t_send = np.where(s_mask, t_send, 0.0)

    r_mask = st.recv_cnt > 0
    if deg is None:
        t_recv = port_time(
            cost,
            st.recv_elems,
            st.recv_cnt,
            st.recv_inter,
            k,
            ported=ported,
            alpha_batches=False,
        )
    else:
        t_recv = port_time(
            cost,
            np.where(st.recv_inter, st.recv_elems * scale_p, st.recv_elems),
            st.recv_cnt,
            st.recv_inter,
            np.maximum(k_procs, 1),
            ported=ported,
            alpha_batches=False,
        )
        t_recv = np.where(
            (st.recv_inter & deg.dead_port) | (r_mask & deg.dead_rank),
            np.inf,
            t_recv,
        )
    t_recv = np.where(r_mask, t_recv, 0.0)

    # --- per-node lane bandwidth terms -------------------------------------
    streams = np.maximum(st.node_out_msgs, st.node_in_msgs)
    n_mask = streams > 0
    max_inflight = int(streams.max()) if streams.size else 0
    if deg is None:
        t_node = lane_time(
            cost, np.maximum(st.node_out, st.node_in), streams, k
        )
    else:
        t_node = lane_time(
            cost,
            np.maximum(st.node_out, st.node_in) * scale_n,
            streams,
            np.maximum(k_nodes, 1),
        )
        t_node = np.where(n_mask & (k_nodes == 0), np.inf, t_node)
    t_node = np.where(n_mask, t_node, 0.0)

    # --- shared-memory aggregate cap ---------------------------------------
    i_mask = st.node_intra_cnt > 0
    t_intra = cost.alpha_intra + st.node_intra / cost.node_bw_elems
    if deg is not None:
        t_intra = np.where(i_mask & deg.dead_node, np.inf, t_intra)
    t_intra = np.where(i_mask, t_intra, 0.0)

    round_times = np.maximum(
        np.maximum(t_send.max(axis=1), t_recv.max(axis=1)),
        np.maximum(t_node.max(axis=1), t_intra.max(axis=1)),
    )
    # Sequential accumulation in round order — bit-identical to the
    # reference's ``total_time += round_time`` loop (np.sum pairs terms).
    total_time = 0.0
    for rt in round_times.tolist():
        total_time += rt

    return SimResult(
        time_us=total_time,
        rounds=R,
        inter_elems=st.inter_elems,
        intra_elems=st.intra_elems,
        max_node_inflight=max_inflight,
    )


def simulate_payload_scaled(
    cs, machine: Machine, payloads, *, ported: bool = False
) -> np.ndarray:
    """Price one schedule *structure* at many payload sizes in one stacked
    pass — the batched-selector fast path.

    ``cs`` must be compiled at **unit payload** (``c=1``) for a family
    whose message sizes scale linearly with ``c`` (every alltoall
    generator, and their ``recipe_safe`` ``opt:`` permutations: ``elems``
    is a per-message block count times ``c``).  The per-round cost grids
    are then exactly the unit grids scaled by ``c`` — integer-valued
    float64 products well under 2**53, so each scaled term is the *same
    float* ``_simulate_ir`` computes from a schedule compiled at that
    payload — and all Q payloads evaluate through one ``[Q, R, p]``
    broadcasted pass instead of Q schedule compilations + simulations.

    Bit-exactness is load-bearing: ``plan_batch()`` must equal N separate
    ``plan()`` calls (tests pin this), so every expression below mirrors
    ``_simulate_ir`` operation for operation, including the sequential
    per-round accumulation.  Degraded machines take the per-query path
    (`simulate`); batching is a healthy-traffic optimization.

    Returns ``float64 [Q]`` times in microseconds, aligned with
    ``payloads``.
    """
    from repro_torch.core.schedule_ir import CompiledSchedule

    if not isinstance(cs, CompiledSchedule):
        raise TypeError(f"cannot simulate {type(cs).__name__}")
    if machine.degradation() is not None:
        raise NotImplementedError(
            "simulate_payload_scaled prices healthy machines; degraded "
            "queries go through simulate() per payload"
        )
    topo, cost = machine.topo, machine.cost
    k = topo.k_lanes
    C = np.asarray(payloads, dtype=np.float64).reshape(-1, 1, 1)  # [Q,1,1]
    Q = C.shape[0]
    if cs.num_msgs == 0 or Q == 0:
        return np.zeros(Q, dtype=np.float64)
    st = cs.stats(topo.procs_per_node)
    R = cs.num_rounds

    s_mask = st.send_cnt > 0
    t_send = port_time(
        cost, st.send_elems * C, st.send_cnt, st.send_inter, k, ported=ported
    )
    t_send = np.where(s_mask, t_send, 0.0)

    r_mask = st.recv_cnt > 0
    t_recv = port_time(
        cost, st.recv_elems * C, st.recv_cnt, st.recv_inter, k,
        ported=ported, alpha_batches=False,
    )
    t_recv = np.where(r_mask, t_recv, 0.0)

    streams = np.maximum(st.node_out_msgs, st.node_in_msgs)
    n_mask = streams > 0
    t_node = lane_time(
        cost, np.maximum(st.node_out, st.node_in) * C, streams, k
    )
    t_node = np.where(n_mask, t_node, 0.0)

    i_mask = st.node_intra_cnt > 0
    t_intra = cost.alpha_intra + (st.node_intra * C) / cost.node_bw_elems
    t_intra = np.where(i_mask, t_intra, 0.0)

    round_times = np.maximum(
        np.maximum(t_send.max(axis=2), t_recv.max(axis=2)),
        np.maximum(t_node.max(axis=2), t_intra.max(axis=2)),
    )  # [Q, R]
    # Sequential accumulation in round order, vectorized over queries —
    # identical float association to _simulate_ir's scalar loop.
    total = np.zeros(Q, dtype=np.float64)
    for r in range(R):
        total = total + round_times[:, r]
    return total


def simulate_msgs(
    schedule: Schedule, machine: Machine, *, ported: bool = False
) -> SimResult:
    """Reference per-``Msg`` simulation (the original implementation)."""
    if machine.degradation() is not None:
        # The reference loop prices healthy machines only; silently charging
        # healthy costs for a degraded machine would be a wrong oracle.
        raise NotImplementedError(
            "simulate_msgs prices healthy machines; use simulate() for a "
            "FaultedMachine"
        )
    topo, cost = machine.topo, machine.cost
    k = topo.k_lanes
    total_time = 0.0
    inter_total = 0
    intra_total = 0
    max_inflight = 0

    for rnd in schedule.rounds:
        if not rnd.msgs:
            continue
        # --- classify traffic ------------------------------------------------
        proc_send_elems: dict[int, int] = defaultdict(int)  # port serialization
        proc_send_msgs: dict[int, int] = defaultdict(int)
        proc_recv_elems: dict[int, int] = defaultdict(int)
        proc_recv_msgs: dict[int, int] = defaultdict(int)
        node_out: dict[int, int] = defaultdict(int)  # off-node elems leaving
        node_in: dict[int, int] = defaultdict(int)
        node_out_msgs: dict[int, int] = defaultdict(int)
        node_in_msgs: dict[int, int] = defaultdict(int)
        node_intra: dict[int, int] = defaultdict(int)
        proc_send_inter: set[int] = set()  # procs with >= 1 off-node send
        proc_recv_inter: set[int] = set()

        for m in rnd.msgs:
            sv, dv = topo.node_of(m.src), topo.node_of(m.dst)
            if sv == dv:
                intra_total += m.elems
                node_intra[sv] += m.elems
            else:
                inter_total += m.elems
                node_out[sv] += m.elems
                node_in[dv] += m.elems
                node_out_msgs[sv] += 1
                node_in_msgs[dv] += 1
                proc_send_inter.add(m.src)
                proc_recv_inter.add(m.dst)
            proc_send_elems[m.src] += m.elems
            proc_send_msgs[m.src] += 1
            proc_recv_elems[m.dst] += m.elems
            proc_recv_msgs[m.dst] += 1

        # --- per-processor port terms ----------------------------------------
        # Use the slower (network) alpha/beta whenever any of a processor's
        # traffic in the round is off-node; schedules never mix intra and
        # inter traffic at one processor within a round in practice.
        round_time = 0.0
        for proc, elems in proc_send_elems.items():
            nmsgs = proc_send_msgs[proc]
            inter = proc in proc_send_inter
            beta = cost.beta_inter if inter else cost.beta_intra
            alpha = cost.alpha_inter if inter else cost.alpha_intra
            if ported:
                # idealized k-ported proc: k concurrent streams
                eff = -(-nmsgs // k)  # ceil(nmsgs / k) serial batches
                t = alpha + beta * elems / min(nmsgs, k)
                t = max(t, alpha * eff)
            else:
                t = alpha + beta * elems  # one port, pipelined non-blocking
            round_time = max(round_time, t)
        for proc, elems in proc_recv_elems.items():
            inter = proc in proc_recv_inter
            beta = cost.beta_inter if inter else cost.beta_intra
            alpha = cost.alpha_inter if inter else cost.alpha_intra
            if ported:
                t = alpha + beta * elems / min(proc_recv_msgs[proc], k)
            else:
                t = alpha + beta * elems
            round_time = max(round_time, t)

        # --- per-node lane bandwidth terms ------------------------------------
        for v in set(node_out) | set(node_in):
            out_e, in_e = node_out.get(v, 0), node_in.get(v, 0)
            streams = max(node_out_msgs.get(v, 0), node_in_msgs.get(v, 0))
            max_inflight = max(max_inflight, streams)
            # k full-duplex rails; if more streams than lanes, bytes queue.
            t = cost.alpha_inter + cost.beta_inter * max(out_e, in_e) / min(
                max(streams, 1), k
            )
            round_time = max(round_time, t)

        # --- shared-memory aggregate cap --------------------------------------
        for v, elems in node_intra.items():
            t = cost.alpha_intra + elems / cost.node_bw_elems
            round_time = max(round_time, t)

        total_time += round_time

    return SimResult(
        time_us=total_time,
        rounds=schedule.num_rounds,
        inter_elems=inter_total,
        intra_elems=intra_total,
        max_node_inflight=max_inflight,
    )
