"""Static schedule analyzer: invariant diagnostics + lower-bound
certificates.

The data-flow oracle (:mod:`repro_torch.core.validate`) proves *semantics*:
every sent block was held, every required final lands.  This module
checks the invariants the oracle does not cover — the resource and
payload discipline a schedule must obey to mean what the simulator
prices:

* **port/lane budget** — per-(round, proc) concurrent message counts
  against the schedule's nominal ``k`` (warning: the coloring packer
  intentionally over-packs and lets the simulator serialize) or against
  an explicit budget (error: the caller asserted a hard cap);
* **degraded budgets under a** :class:`~repro_torch.core.faults.FaultSpec` —
  a dead rank must appear in no message, a NIC-dead rank in no off-node
  message, a zero-lane node in no off-node traffic (errors: these are
  exactly what :func:`~repro_torch.core.passes.repair_schedule` guarantees);
* **intra/inter class purity** — a proc mixing on-node and off-node
  traffic in one round gets all of it priced at network alpha/beta
  (warning: legal but wasteful — the refined ColorRounds categories can
  justify some mixes the static view cannot distinguish);
* **dead messages** — self-sends and zero/negative-payload messages
  (errors: no generator or validated pass emits them);
* **payload conservation per (owner, block)** — every proc receiving a
  block must receive the *same* total element count (apportioned over
  each message's block list), and senders of move-semantics ops
  (scatter/alltoall) must never emit more of a block than they took in
  (errors; reported per block).

:func:`analyze_schedule` returns an :class:`AnalysisReport` of
structured :class:`Diagnostic` records; ``report.ok`` is False iff any
diagnostic is error-severity.  ``raise_if_failed`` mirrors the oracle's
``raise_if_invalid`` — it arms a forensics auto-dump before raising.

**Lower-bound certificates** (:func:`lower_bound` / :func:`certify`)
state how far a schedule sits from optimal on a machine model — the
ROADMAP's "certify the packer" gap column, without a SAT solver.  The
bounds are the paper's counting arguments priced on the cost model:

* rounds: ``ceil(log_{k+1} p)`` (the informed set grows by at most
  ``k+1`` per round), plus scatter's root-injection bound
  ``ceil((p-1)/k)`` (relays cannot help the root);
* time: the max of the alpha chain (``rounds_lb * alpha_min``), the
  per-proc port bandwidth bottleneck (required volume over ``k`` streams
  at the cheapest beta) and the per-node lane bottleneck (required
  off-node volume over ``k_lanes`` rails at ``beta_inter``).

Every component underestimates every correct schedule under either port
model, so ``gap_vs_lb = sim_us / lb_us >= 1`` and finite; the ``LB``
table in ``BENCH_schedules.json`` tracks it per paper-scale cell.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.topology import Machine
from repro_torch.obs import metrics as obs_metrics

__all__ = [
    "Diagnostic",
    "AnalysisReport",
    "analyze_schedule",
    "lower_bound",
    "certify",
]

#: Relative slack for payload-conservation comparisons: apportioning a
#: message's elems over its block list divides exactly in the common case
#: but float64 division still needs an epsilon at 2^53-scale payloads.
_CONS_RTOL = 1e-9


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One static-analysis finding.

    ``check`` names the analyzer rule (``port-budget``, ``lane-budget``,
    ``degraded-budget``, ``class-purity``, ``dead-message``,
    ``conservation``, ``structure``); ``severity`` is ``error`` (the
    schedule must not be served), ``warning`` (legal but suspicious or
    wasteful) or ``info``.  ``count`` collapses repeated instances of the
    same finding; ``round``/``proc`` locate the first instance when one
    is identifiable.
    """

    check: str
    severity: str
    message: str
    count: int = 1
    round: int | None = None
    proc: int | None = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    """Result of :func:`analyze_schedule` on one compiled schedule."""

    op: str
    algorithm: str
    p: int
    k: int
    rounds: int
    msgs: int
    diagnostics: tuple[Diagnostic, ...]
    lb: dict | None = None

    @property
    def ok(self) -> bool:
        return not any(d.severity == "error" for d in self.diagnostics)

    @property
    def errors(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "error")

    @property
    def warnings(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "warning")

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d

    def summary(self) -> str:
        by = {}
        for diag in self.diagnostics:
            key = (diag.severity, diag.check)
            by[key] = by.get(key, 0) + diag.count
        parts = [f"{sev}:{chk}={n}" for (sev, chk), n in sorted(by.items())]
        state = "ok" if self.ok else "FAILED"
        return (f"analyze[{self.op}/{self.algorithm} p={self.p} "
                f"k={self.k}]: {state}"
                + (f" ({', '.join(parts)})" if parts else ""))

    def raise_if_failed(self) -> None:
        """Raise ``AssertionError`` on the first error-severity finding,
        auto-dumping forensics first (armed runs get a post-mortem, the
        test suite's intentional corruptions stay silent) — the same
        contract as ``ValidationReport.raise_if_invalid``."""
        if self.ok:
            return
        from repro_torch.obs import forensics

        forensics.auto_dump("static_analysis", extra=self.as_dict())
        first = self.errors[0]
        raise AssertionError(
            f"static analysis failed for {self.op}/{self.algorithm}: "
            f"[{first.check}] {first.message} "
            f"({len(self.errors)} error diagnostic(s))"
        )


def _diag(out: list, check: str, severity: str, message: str, **kw) -> None:
    out.append(Diagnostic(check=check, severity=severity, message=message,
                          **kw))


def _check_structure(cs, out: list) -> None:
    rp = np.asarray(cs.round_ptr)
    if rp.size < 1 or rp[0] != 0 or rp[-1] != cs.num_msgs \
            or np.any(np.diff(rp) < 0):
        _diag(out, "structure", "error",
              "round_ptr is not a monotone CSR over the message arrays")
    if cs.num_msgs:
        bad = (cs.src < 0) | (cs.src >= cs.p) | (cs.dst < 0) | (cs.dst >= cs.p)
        nbad = int(bad.sum())
        if nbad:
            i = int(np.argmax(bad))
            _diag(out, "structure", "error",
                  f"{nbad} message(s) name ranks outside [0, {cs.p}) "
                  f"(first: msg {i}: {int(cs.src[i])}->{int(cs.dst[i])})",
                  count=nbad)


def _check_dead_messages(cs, out: list) -> None:
    if cs.num_msgs == 0:
        return
    rid = cs.round_ids()
    selfs = cs.src == cs.dst
    n_self = int(selfs.sum())
    if n_self:
        i = int(np.argmax(selfs))
        _diag(out, "dead-message", "error",
              f"{n_self} self-send(s) (first: round {int(rid[i])}, "
              f"proc {int(cs.src[i])} -> itself)",
              count=n_self, round=int(rid[i]), proc=int(cs.src[i]))
    empty = cs.elems <= 0
    n_empty = int(empty.sum())
    if n_empty:
        i = int(np.argmax(empty))
        _diag(out, "dead-message", "error",
              f"{n_empty} message(s) with non-positive payload (first: "
              f"round {int(rid[i])}, {int(cs.src[i])}->{int(cs.dst[i])}, "
              f"elems={int(cs.elems[i])})",
              count=n_empty, round=int(rid[i]), proc=int(cs.src[i]))


def _round_proc_counts(cs, procs) -> np.ndarray:
    """[R, p] int64 message counts for one side (``procs`` = src or dst)."""
    rid = cs.round_ids()
    counts = np.bincount(rid * cs.p + procs,
                         minlength=cs.num_rounds * cs.p)
    return counts.reshape(cs.num_rounds, cs.p)


def _check_port_budget(cs, out: list, port_budget: int | None) -> None:
    if cs.num_msgs == 0:
        return
    budget = port_budget if port_budget is not None else cs.k
    severity = "error" if port_budget is not None else "warning"
    for side, procs in (("send", cs.src), ("recv", cs.dst)):
        grid = _round_proc_counts(cs, procs)
        over = grid > budget
        n_over = int(over.sum())
        if n_over:
            r, q = np.unravel_index(int(np.argmax(over)), grid.shape)
            width = int(grid.max())
            _diag(out, "port-budget", severity,
                  f"{n_over} (round, proc) cell(s) exceed the {side} port "
                  f"budget {budget} (max width {width}; first: round "
                  f"{int(r)}, proc {int(q)} with {int(grid[r, q])}); the "
                  f"simulator serializes the excess",
                  count=n_over, round=int(r), proc=int(q))


def _check_lane_budget(cs, out: list, topo, lane_budget: int | None) -> None:
    if cs.num_msgs == 0 or topo.num_nodes < 2:
        return
    n = topo.procs_per_node
    budget = lane_budget if lane_budget is not None else topo.k_lanes
    severity = "error" if lane_budget is not None else "warning"
    rid = cs.round_ids()
    snode, dnode = cs.node_of(n)
    inter = snode != dnode
    if not inter.any():
        return
    N = topo.num_nodes
    for side, nodes in (("out", snode), ("in", dnode)):
        counts = np.bincount(rid[inter] * N + nodes[inter],
                             minlength=cs.num_rounds * N)
        grid = counts.reshape(cs.num_rounds, N)
        over = grid > budget
        n_over = int(over.sum())
        if n_over:
            r, nd = np.unravel_index(int(np.argmax(over)), grid.shape)
            _diag(out, "lane-budget", severity,
                  f"{n_over} (round, node) cell(s) drive more than "
                  f"{budget} concurrent {side}bound off-node stream(s) "
                  f"(first: round {int(r)}, node {int(nd)} with "
                  f"{int(grid[r, nd])}); the lanes serialize the excess",
                  count=n_over, round=int(r))


def _check_class_purity(cs, out: list, topo) -> None:
    if cs.num_msgs == 0 or topo.num_nodes < 2:
        return
    rid = cs.round_ids()
    snode, dnode = cs.node_of(topo.procs_per_node)
    inter = snode != dnode
    mixed_total = 0
    first = None
    for side, procs in (("send", cs.src), ("recv", cs.dst)):
        key = rid * cs.p + procs
        size = cs.num_rounds * cs.p
        n_inter = np.bincount(key[inter], minlength=size)
        n_intra = np.bincount(key[~inter], minlength=size)
        mixed = (n_inter > 0) & (n_intra > 0)
        n_mixed = int(mixed.sum())
        if n_mixed:
            mixed_total += n_mixed
            if first is None:
                flat = int(np.argmax(mixed))
                first = (side, flat // cs.p, flat % cs.p)
    if mixed_total:
        side, r, q = first
        _diag(out, "class-purity", "warning",
              f"{mixed_total} (round, proc, side) cell(s) mix on-node and "
              f"off-node traffic (first: round {r}, proc {q}, {side} side); "
              f"the simulator prices the whole cell at network alpha/beta",
              count=mixed_total, round=r, proc=q)


def _check_conservation(cs, out: list, *, relays_expected: bool = False) -> None:
    if not cs.has_blocks or cs.num_msgs == 0:
        _diag(out, "conservation", "info",
              "no block metadata; payload-conservation check skipped")
        return
    from repro_torch.core.validate import initial_holds

    nblk = np.diff(cs.blk_ptr)
    zero_blk = nblk == 0
    if zero_blk.any():
        n0 = int(zero_blk.sum())
        _diag(out, "dead-message", "error",
              f"{n0} message(s) carry a non-empty payload but no blocks",
              count=n0)
    keep = ~zero_blk
    # apportion each message's elems uniformly over its block list — exact
    # for the uniform-block schedules every generator and validated pass
    # emits, and the basis of all flow sums below
    share = np.where(nblk > 0, cs.elems / np.maximum(nblk, 1), 0.0)
    h_share = np.repeat(share[keep], nblk[keep])
    h_src = np.repeat(cs.src[keep], nblk[keep])
    h_dst = np.repeat(cs.dst[keep], nblk[keep])
    h_blk = cs.blk_ids[np.repeat(keep, nblk)]
    if h_blk.size == 0:
        return
    bmin = int(h_blk.min())
    bspan = int(h_blk.max()) - bmin + 1

    def flow(procs):
        key = procs * bspan + (h_blk - bmin)
        uniq, inv = np.unique(key, return_inverse=True)
        tot = np.zeros(uniq.size)
        np.add.at(tot, inv, h_share)
        return uniq, tot

    in_key, inflow = flow(h_dst)
    out_key, outflow = flow(h_src)

    # (1) uniform delivery: every proc receiving block b receives the same
    # total element count — you get the whole block or none of it
    in_blk = in_key % bspan
    order = np.argsort(in_blk, kind="stable")
    sb, st = in_blk[order], inflow[order]
    starts = np.ones(sb.size, dtype=bool)
    starts[1:] = sb[1:] != sb[:-1]
    grp = np.cumsum(starts) - 1
    gmax = np.full(int(grp[-1]) + 1, -np.inf)
    gmin = np.full(int(grp[-1]) + 1, np.inf)
    np.maximum.at(gmax, grp, st)
    np.minimum.at(gmin, grp, st)
    tol = _CONS_RTOL * np.maximum(gmax, 1.0)
    uneven = (gmax - gmin) > tol
    n_uneven = int(uneven.sum())
    if n_uneven:
        g = int(np.argmax(uneven))
        b = int(sb[starts.nonzero()[0][g]]) + bmin
        # broadcast generators chunk the payload with remainders under
        # coarse block ids (the full-lane tail piece rides the last id),
        # so apportioning is a lower-resolution view there — note it, but
        # only scatter/alltoall block semantics make unevenness a defect.
        # Fault-repaired schedules relay on purpose: the proxy rank keeps
        # its own copy AND receives the relayed one, so under a FaultSpec
        # unevenness is advisory and checks (2)/(3) carry the error load.
        severity = ("error" if cs.op in ("scatter", "alltoall")
                    and not relays_expected else "info")
        _diag(out, "conservation", severity,
              f"{n_uneven} block(s) delivered unevenly (first: block {b} "
              f"arrives as {gmin[g]:g} elems at one proc and {gmax[g]:g} "
              f"at another) — payload conservation per (owner, block) "
              f"is broken",
              count=n_uneven)

    # (2) move semantics (scatter/alltoall route each block to exactly one
    # final owner): a non-origin proc must never emit more of a block than
    # it took in.  Broadcast copies on purpose, so fan-out is exempt.
    if cs.op in ("scatter", "alltoall"):
        out_proc = out_key // bspan
        out_blk = out_key % bspan + bmin
        origin = initial_holds(cs.op, cs.p, out_proc, out_blk)
        idx = np.searchsorted(in_key, out_key)
        idx = np.minimum(idx, max(in_key.size - 1, 0))
        got = np.where(
            (in_key.size > 0) & (in_key[idx] == out_key), inflow[idx], 0.0
        )
        amplified = ~origin & (outflow > got * (1.0 + _CONS_RTOL))
        n_amp = int(amplified.sum())
        if n_amp:
            i = int(np.argmax(amplified))
            _diag(out, "conservation", "error",
                  f"{n_amp} (proc, block) flow(s) send more than they "
                  f"received (first: proc {int(out_proc[i])} emits "
                  f"{outflow[i]:g} elems of block {int(out_blk[i])} but "
                  f"took in {got[i]:g})",
                  count=n_amp, proc=int(out_proc[i]))

        # (3) cross-block terminal uniformity: every scatter/alltoall block
        # carries the same payload c, so the net amount retained at a
        # block's required final owner (inflow minus re-emission) must be
        # identical across blocks.  Each block has only ONE receiver, so
        # check (1) is vacuous here — this is what actually pins down a
        # tampered elems field on an origin-sourced message.  Blocks whose
        # final owner IS the origin never move (their c is invisible to
        # flow sums), so they are excluded.
        blocks = np.unique(h_blk)
        if cs.op == "scatter":
            owner = blocks.copy()
            org = np.zeros_like(blocks)
        else:
            owner = blocks % cs.p
            org = blocks // cs.p
        moved = owner != org
        blocks, owner = blocks[moved], owner[moved]
        if blocks.size > 1:
            tkey = owner * bspan + (blocks - bmin)

            def lookup(keys, vals):
                if keys.size == 0:
                    return np.zeros(tkey.size)
                j = np.minimum(np.searchsorted(keys, tkey), keys.size - 1)
                return np.where(keys[j] == tkey, vals[j], 0.0)

            delivered = lookup(in_key, inflow) - lookup(out_key, outflow)
            dmax, dmin = float(delivered.max()), float(delivered.min())
            if (dmax - dmin) > _CONS_RTOL * max(dmax, 1.0):
                b_lo = int(blocks[int(np.argmin(delivered))])
                b_hi = int(blocks[int(np.argmax(delivered))])
                _diag(out, "conservation", "error",
                      f"terminal delivery is non-uniform across blocks: "
                      f"block {b_lo} nets {dmin:g} elems at its final "
                      f"owner while block {b_hi} nets {dmax:g} — every "
                      f"{cs.op} block carries the same payload, so "
                      f"conservation per (owner, block) is broken")


def _check_degraded_budget(cs, out: list, topo, faults) -> None:
    from repro_torch.core.faults import degradation_of

    if cs.num_msgs == 0:
        return
    deg = degradation_of(faults, topo)
    rid = cs.round_ids()
    dead = deg.dead_rank[cs.src] | deg.dead_rank[cs.dst]
    n_dead = int(dead.sum())
    if n_dead:
        i = int(np.argmax(dead))
        q = int(cs.src[i]) if deg.dead_rank[cs.src[i]] else int(cs.dst[i])
        _diag(out, "degraded-budget", "error",
              f"{n_dead} message(s) touch a dead rank (first: round "
              f"{int(rid[i])}, {int(cs.src[i])}->{int(cs.dst[i])}, dead "
              f"rank {q})",
              count=n_dead, round=int(rid[i]), proc=q)
    n = topo.procs_per_node
    snode, dnode = cs.node_of(n)
    inter = snode != dnode
    # NIC-dead ranks keep shared memory: only off-node traffic is illegal
    nic = deg.dead_port & ~deg.dead_rank
    nic_hit = inter & (nic[cs.src] | nic[cs.dst])
    n_nic = int(nic_hit.sum())
    if n_nic:
        i = int(np.argmax(nic_hit))
        q = int(cs.src[i]) if nic[cs.src[i]] else int(cs.dst[i])
        _diag(out, "degraded-budget", "error",
              f"{n_nic} off-node message(s) touch a NIC-dead rank (first: "
              f"round {int(rid[i])}, {int(cs.src[i])}->{int(cs.dst[i])}, "
              f"rank {q} has no live port)",
              count=n_nic, round=int(rid[i]), proc=q)
    dark = (deg.lanes <= 0) & ~deg.dead_node
    if dark.any():
        dark_hit = inter & (dark[snode] | dark[dnode])
        n_dark = int(dark_hit.sum())
        if n_dark:
            i = int(np.argmax(dark_hit))
            nd = int(snode[i]) if dark[snode[i]] else int(dnode[i])
            _diag(out, "degraded-budget", "error",
                  f"{n_dark} off-node message(s) cross a zero-lane node "
                  f"(first: round {int(rid[i])}, node {nd} has no "
                  f"surviving lane)",
                  count=n_dark, round=int(rid[i]))


def analyze_schedule(
    cs,
    machine: Machine | None = None,
    *,
    procs_per_node: int | None = None,
    faults=None,
    port_budget: int | None = None,
    lane_budget: int | None = None,
) -> AnalysisReport:
    """Statically check one :class:`CompiledSchedule`.

    ``machine`` (or a bare ``procs_per_node``) supplies the node
    partitioning for the lane/purity/degraded checks; without either,
    only the partition-free checks run.  ``faults`` (a healthy-or-not
    :class:`FaultSpec`) switches on the degraded-budget checks against
    ``degradation_of(faults, topo)``.  ``port_budget``/``lane_budget``
    turn the respective conformance checks from advisory warnings into
    hard errors at the given cap (the caller asserts the budget; the
    default compares against the schedule's own ``k`` and the topology's
    ``k_lanes`` and only warns, because the coloring packer over-packs
    on purpose and the simulator serializes the excess).
    """
    topo = None
    if machine is not None:
        topo = machine.topo
    elif procs_per_node is not None:
        from repro_torch.core.topology import Topology

        if cs.p % procs_per_node:
            raise ValueError(
                f"p={cs.p} is not divisible by procs_per_node={procs_per_node}"
            )
        topo = Topology(cs.p // procs_per_node, procs_per_node,
                        min(cs.k, procs_per_node))

    out: list[Diagnostic] = []
    _check_structure(cs, out)
    # every other check indexes messages by round (or sums flows over the
    # CSR), so a structurally broken schedule gets only the structure
    # finding — crashing on garbage would defeat the analyzer's purpose
    structural_ok = not out
    if faults is not None and not faults.is_healthy and topo is None:
        raise ValueError(
            "degraded-budget checks need machine= or procs_per_node="
        )
    if structural_ok:
        _check_dead_messages(cs, out)
        _check_port_budget(cs, out, port_budget)
        if topo is not None:
            _check_lane_budget(cs, out, topo, lane_budget)
            _check_class_purity(cs, out, topo)
        _check_conservation(
            cs, out,
            relays_expected=faults is not None and not faults.is_healthy,
        )
        if faults is not None and not faults.is_healthy:
            _check_degraded_budget(cs, out, topo, faults)

    report = AnalysisReport(
        op=cs.op, algorithm=cs.algorithm, p=int(cs.p), k=int(cs.k),
        rounds=cs.num_rounds, msgs=cs.num_msgs, diagnostics=tuple(out),
    )
    obs_metrics.counter("analyze.runs").inc()
    if not report.ok:
        obs_metrics.counter("analyze.failures").inc()
    return report


def lower_bound(
    op: str, machine: Machine, k: int, c: int, *, ported: bool = False
) -> dict:
    """Analytic round/time lower bounds for ``op`` at per-block payload
    ``c`` on ``machine`` with ``k`` ports — valid for *every* correct
    schedule under either port model, so any simulated time divided by
    ``time_us`` is a certificate ratio ``>= 1``.

    ``c`` is the op's table convention: total payload for broadcast,
    per-proc block for scatter, per-pair block for alltoall.
    """
    topo, cost = machine.topo, machine.cost
    p, n, N, kl = topo.p, topo.procs_per_node, topo.num_nodes, topo.k_lanes
    k = max(1, int(k))
    log_rounds = int(math.ceil(math.log(p, k + 1))) if p > 1 else 0
    if op == "broadcast":
        rounds_lb = log_rounds
        vol_proc = float(c)           # every non-root must take in c
        vol_node = float(c)           # every non-root node too
    elif op == "scatter":
        rounds_lb = max(log_rounds, math.ceil((p - 1) / k))
        vol_proc = float((p - 1) * c)  # the root injects everything
        vol_node = float((p - n) * c)  # off-node share leaving root's node
    elif op == "alltoall":
        rounds_lb = log_rounds
        vol_proc = float((p - 1) * c)  # every proc sends p-1 blocks
        vol_node = float(n * (p - n) * c)  # every node's off-node share
    else:
        raise ValueError(f"unknown op {op!r}")

    alpha_min = min(cost.alpha_intra, cost.alpha_inter)
    beta_min = min(cost.beta_intra, cost.beta_inter)
    alpha_term = rounds_lb * alpha_min
    port_term = vol_proc * beta_min / k
    lane_term = vol_node * cost.beta_inter / kl if N > 1 else 0.0
    time_us = max(alpha_term, port_term, lane_term)
    return {
        "op": op,
        "p": p,
        "k": k,
        "c": int(c),
        "ported": bool(ported),
        "rounds_lb": int(rounds_lb),
        "alpha_term_us": alpha_term,
        "port_term_us": port_term,
        "lane_term_us": lane_term,
        "time_us": time_us,
    }


def certify(
    cs, machine: Machine, c: int, *, ported: bool = False,
    sim_us: float | None = None,
) -> dict:
    """Lower-bound certificate for one compiled schedule: the analytic
    bound plus the schedule's simulated time and the gap ratios.  A
    ``gap_vs_lb`` of 1.0 means provably optimal on this model; the LB
    bench table tracks the ratio so packer regressions surface as a
    growing gap."""
    lb = lower_bound(cs.op, machine, cs.k, c, ported=ported)
    if sim_us is None:
        from repro_torch.core.simulate import simulate

        sim_us = simulate(cs, machine, ported=ported).time_us
    gap = float(sim_us) / lb["time_us"] if lb["time_us"] > 0 else float("inf")
    return {
        **lb,
        "algorithm": cs.algorithm,
        "rounds": cs.num_rounds,
        "sim_us": float(sim_us),
        "gap_vs_lb": gap,
        "round_gap": (cs.num_rounds / lb["rounds_lb"]
                      if lb["rounds_lb"] else float("inf")),
    }
