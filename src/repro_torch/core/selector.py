"""Cost-model-driven collective algorithm selection.

The paper's conclusion is that no single family wins everywhere (k-ported
trees win at small payloads where the full-lane pre/post phases cost extra
rounds; full-lane wins at bandwidth-bound sizes).  Production collective
libraries encode exactly this as a size-switched algorithm table; here the
table is *derived from the machine model* by simulating each candidate
schedule at the requested payload size — the "tuned collectives" layer the
paper says native MPI libraries get wrong.

``select()`` is used by the distribution layer to pick the gradient-allreduce
and MoE-dispatch implementations per (op, payload, mesh); the choice is
recorded so EXPERIMENTS.md can show the crossover points.

Hot-path design (the serving/training loop calls this online):

* schedules come from the process-wide compiled-schedule cache
  (``schedule_ir.compiled_schedule``) — the O(p^2) alltoall families are
  generated array-natively and never allocate per-message objects;
* a schedule's round structure is independent of the payload ``c`` — only
  message sizes scale — so each round's cost is a max of affine functions of
  ``c`` and the schedule cost is piecewise-affine, in practice affine over
  each payload regime.  ``affine_cost`` therefore simulates an algorithm at
  just *two* probe payloads and interpolates ``A + B*c``;
  ``crossover_table`` uses the probes at the endpoints of the requested size
  sweep, so the table costs 2 simulations per algorithm instead of one per
  (algorithm, size) cell, with the endpoint cells exact by construction;
* every family also enters the race as an ``opt:``-prefixed candidate — the
  schedule-optimizer rewrite (``core.passes`` ``"color"`` mode: the
  conflict-graph coloring packer, validated by the ``core.validate``
  oracle) — so the table reflects what a tuned library could actually run,
  not just the paper's verbatim schedules.  The coloring packer is not
  provably never-slower (unlike the first-fit it replaces here), but
  the base family is always in the same race, so a losing rewrite ranks
  behind rather than ships; it *can* change which cost term dominates
  mid-sweep (packed rounds trade alphas against serialized port bytes),
  and payload splitting clamps its factors to ``c`` — so ``opt:``
  candidates are only *piecewise* affine in ``c``.
  ``piecewise_cost`` therefore fits **3 probes** (endpoints + geometric
  midpoint) into two affine segments; families that regime-flip mid-sweep
  select correctly where a single 2-probe fit would misrank the interior.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import threading

import warnings

from repro_torch.core.faults import FaultSpec, apply_faults
from repro_torch.core.schedule_ir import compiled_schedule
from repro_torch.core.simulate import simulate, simulate_payload_scaled
from repro_torch.core.topology import CostParams, Machine, Topology, tpu_v5e_machine
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import TRACER

__all__ = [
    "select",
    "select_batch",
    "Choice",
    "CandidateRecord",
    "Decision",
    "last_decision",
    "selector_cache_reset",
    "selector_cache_info",
    "crossover_table",
    "affine_cost",
    "piecewise_cost",
    "piecewise_eval",
]


@dataclasses.dataclass(frozen=True)
class Choice:
    op: str
    algorithm: str
    est_us: float
    candidates: tuple[tuple[str, float], ...]  # (algorithm, est_us), sorted


@dataclasses.dataclass(frozen=True)
class CandidateRecord:
    """One raced candidate inside a :class:`Decision`.

    ``status`` says what happened to it — the distinction the chaos report
    needs between a price-out and a deadline skip:

    * ``"priced"`` — simulated; ``est_us`` holds the price (may be ``inf``
      for an unrepairable-but-returned degraded schedule);
    * ``"unavailable"`` — the family does not generate on this mesh;
    * ``"deadline-skipped"`` — an ``opt:`` candidate never raced because
      the deadline had already expired;
    * ``"oracle-rejected"`` — the degraded rewrite failed oracle
      validation and fell down the ladder (faulted runs only).
    """

    algorithm: str
    rung: str  # "base" | "opt"
    status: str
    est_us: float | None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Decision:
    """Full record of one selection race (``select(..., explain=True)``).

    Names every candidate with its price and fate, which fallback rung
    produced the winner (``"raced"`` — a normal race — or
    ``"final-fallback"`` — every candidate failed to price and the first
    generatable base family shipped at ``inf``), the winner's margin over
    the runner-up, and the probe count/wall the race cost."""

    op: str
    payload_elems: int
    num_nodes: int
    procs_per_node: int
    k_lanes: int
    faults_fp: str | None
    deadline_s: float | None
    candidates: tuple[CandidateRecord, ...]
    winner: str
    est_us: float
    margin_us: float | None  # runner-up minus winner; None without one
    rung_fired: str  # "raced" | "final-fallback"
    probes: int  # _sim_payload attempts the race made
    wall_s: float
    choice: Choice

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["choice"] = dataclasses.asdict(self.choice)
        return d


_LAST_LOCK = threading.Lock()
_LAST_DECISION: Decision | None = None


def last_decision() -> Decision | None:
    """The :class:`Decision` from the most recent *uncached* selection race
    in this process (``explain=True`` calls always race; plain ``select``
    races once per distinct argument tuple and then serves its lru cache,
    which does not refresh this)."""
    with _LAST_LOCK:
        return _LAST_DECISION


def _proxy_machine(machine: Machine, max_n: int = 16) -> tuple[Machine, float]:
    """Shrink the intra-node dimension for fast simulation; payload-per-proc
    scaling keeps the bandwidth terms honest (round counts change only by
    O(log) which the alpha term absorbs conservatively).

    The proxy must never change the lane count: the old ``min(k_lanes,
    max_n)`` clamp silently halved (or worse) every k-lane family's node
    bandwidth whenever ``k_lanes > max_n``, with no compensation in the
    returned scale.  The intra-node dimension therefore
    shrinks only down to the lane count — a mesh whose lanes need all its
    processors is simulated at full size rather than mispriced."""
    topo = machine.topo
    proxy_n = max(max_n, topo.k_lanes)
    if topo.procs_per_node <= proxy_n:
        return machine, 1.0
    scale = topo.procs_per_node / proxy_n
    proxy = Machine(
        topo=Topology(topo.num_nodes, proxy_n, topo.k_lanes),
        cost=machine.cost,
    )
    return proxy, scale


def _machine_for(num_nodes: int, procs_per_node: int, k_lanes: int,
                 cost: CostParams | None = None) -> Machine:
    """The mesh priced at ``cost``; None prices at the reference's TPU v5e
    costs, so that every answer equals the reference's bit for bit."""
    if cost is None:
        cost = tpu_v5e_machine(num_pods=num_nodes, k_lanes=k_lanes).cost
    return Machine(topo=Topology(num_nodes, procs_per_node, k_lanes), cost=cost)


def _candidate_algs(op: str, topo: Topology) -> list[str]:
    """Base families plus their ``opt:``-prefixed rewrites (the schedule
    optimizer's round-compacted variants, which can flip the paper's
    crossover points in the latency regime)."""
    from repro_torch.core.schedule import ALGORITHMS

    algs = []
    for (sop, alg) in ALGORITHMS:
        if sop != op:
            continue
        if alg == "kported" and op == "alltoall" and topo.p > 64:
            continue  # O(p^2/k) messages; never competitive at pod scale
        algs.append(alg)
        algs.append(f"opt:{alg}")
    return algs


def _parse_alg(alg: str) -> tuple[str, str | None]:
    """``"opt:klane"`` -> ``("klane", "color")``; plain names pass through.
    ``"color"`` (the conflict-graph coloring packer) supersedes the
    ``"reorder"`` first-fit as the opt: pipeline.  Unlike reorder it
    is not provably never slower — but the selector *races* every opt:
    candidate against its unoptimized base, so a cell where eager coloring
    loses (bandwidth-bound trees) simply ranks behind the base instead of
    shipping."""
    if alg.startswith("opt:"):
        return alg[4:], "color"
    return alg, None


@functools.lru_cache(maxsize=8192)
def _sim_payload(
    op: str,
    alg: str,
    payload_elems: int,
    num_nodes: int,
    procs_per_node: int,
    k_lanes: int,
    faults: FaultSpec | None = None,
    cost: CostParams | None = None,
) -> float | None:
    """Simulated time (us) of one algorithm at one payload on the proxy of
    the requested mesh, priced at ``cost`` (see :func:`_machine_for`); None
    if the family cannot be generated there.

    Under ``faults`` the proxy shrink is skipped — the spec's node/rank
    indices address the *real* topology — and the schedule is the
    fault-repaired one (``compiled_schedule(faults=...)``), priced on the
    degraded machine.  ``inf`` is a legitimate return there (an
    unrepairable schedule the degraded simulator refuses to route); the
    ladder in :func:`select` ranks it last rather than dropping it."""
    machine = _machine_for(num_nodes, procs_per_node, k_lanes, cost)
    if faults is not None and not faults.is_healthy:
        proxy, scale = apply_faults(machine, faults), 1.0
    else:
        faults = None
        proxy, scale = _proxy_machine(machine)
    topo = proxy.topo
    c = max(1, int(payload_elems / scale)) if op != "broadcast" else payload_elems
    k = min(topo.k_lanes, topo.procs_per_node)
    base_alg, optimize = _parse_alg(alg)
    try:
        cs = compiled_schedule(op, base_alg, topo, k, c, optimize=optimize,
                               faults=faults)
    except AssertionError:
        raise  # validity-oracle failure on an opt: rewrite — never swallow
    except Exception:
        return None  # family not generatable at this topology
    return simulate(cs, proxy).time_us


def select(
    op: str,
    payload_elems: int,
    *,
    num_nodes: int = 2,
    procs_per_node: int = 256,
    k_lanes: int = 8,
    faults: FaultSpec | None = None,
    deadline_s: float | None = None,
    explain: bool = False,
    cost: CostParams | None = None,
) -> Choice | Decision:
    """Pick the cheapest algorithm family for ``op`` at ``payload_elems``
    (total payload for broadcast; per-proc block for scatter; per-pair block
    for alltoall) on the given (node, lane) machine shape.

    **Graceful degradation**: with ``faults`` set, every candidate
    is the fault-*repaired* schedule priced on the degraded machine, and the
    race runs as a bounded-time fallback ladder under ``deadline_s``:

    1. the unoptimized families race first — cheap to generate, and one of
       them is the guaranteed runnable fallback;
    2. ``opt:`` candidates (optimize + repair, the expensive rung) join the
       race only while the deadline has not expired — ``deadline_s=0``
       skips them entirely;
    3. if every simulation failed (or the deadline killed the whole race),
       the first base family that *generates* is returned with an ``inf``
       estimate — the selector never comes back empty-handed.

    A reverted repair (e.g. a dead node) prices at ``inf`` on the degraded
    machine, so it ranks behind any actually-runnable candidate but still
    satisfies "always returns a schedule" for the elastic layer to act on.

    **Observability**: ``explain=True`` returns the full
    :class:`Decision` record — every raced candidate with its price and
    fate, the winner's margin, which rung fired, probe count and wall —
    instead of the bare :class:`Choice` (read it as ``decision.choice``).
    ``explain`` runs bypass the selection cache so the record reflects
    *this* race (the underlying ``_sim_payload`` probes stay cached, so
    a repeat explain is cheap); plain calls are cached per argument tuple
    as before.  :func:`last_decision` returns the record of the most
    recent uncached race either way.

    ``cost`` prices every candidate (see :func:`_machine_for`); None is the
    reference's TPU v5e costs.

    .. deprecated::
        ``explain=True`` (the ``Choice | Decision`` union return) is a
        thin shim over :func:`repro_torch.api.explain`; new code should call
        ``explain(PlanRequest(...))`` and keep ``select`` returning only
        :class:`Choice`.
    """
    if explain:
        warnings.warn(
            "select(..., explain=True) is deprecated; use "
            "repro_torch.api.explain(PlanRequest(...)) which always returns the "
            "Decision record",
            DeprecationWarning,
            stacklevel=2,
        )
        return _select_impl(op, payload_elems, num_nodes, procs_per_node,
                            k_lanes, faults, deadline_s, cost=cost)
    return _select_cached(op, payload_elems, num_nodes, procs_per_node,
                          k_lanes, faults, deadline_s, cost=cost)


@functools.lru_cache(maxsize=4096)
def _select_cached(
    op: str,
    payload_elems: int,
    num_nodes: int,
    procs_per_node: int,
    k_lanes: int,
    faults: FaultSpec | None,
    deadline_s: float | None,
    include_opt: bool = True,
    cost: CostParams | None = None,
) -> Choice:
    return _select_impl(op, payload_elems, num_nodes, procs_per_node,
                        k_lanes, faults, deadline_s, include_opt,
                        cost=cost).choice


def _select_impl(
    op: str,
    payload_elems: int,
    num_nodes: int,
    procs_per_node: int,
    k_lanes: int,
    faults: FaultSpec | None,
    deadline_s: float | None,
    include_opt: bool = True,
    cost: CostParams | None = None,
) -> Decision:
    global _LAST_DECISION
    if faults is not None and faults.is_healthy:
        faults = None
    faults_fp = faults.fingerprint() if faults is not None else None
    machine = _machine_for(num_nodes, procs_per_node, k_lanes, cost)
    if faults is not None:
        race_topo = machine.topo  # fault indices address the real topology
    else:
        race_topo = _proxy_machine(machine)[0].topo
    sp = TRACER.start("select", op=op, payload_elems=payload_elems,
                      faults_fp=faults_fp, deadline_s=deadline_s) if TRACER \
        else None
    try:
        t0 = time.monotonic()
        wall0 = time.perf_counter()

        def expired() -> bool:
            return deadline_s is not None and time.monotonic() - t0 >= deadline_s

        algs = _candidate_algs(op, race_topo)
        base_algs = [a for a in algs if not a.startswith("opt:")]
        # include_opt=False (PlanRequest(optimize=False)) races base families
        # only — distinct from deadline_s=0, which *records* the opt: rung as
        # deadline-skipped; an un-requested rung leaves no record at all.
        opt_algs = [a for a in algs if a.startswith("opt:")] if include_opt else []

        recs: list[CandidateRecord] = []
        probes = 0
        candidates: dict[str, float] = {}
        for alg in base_algs:  # the guaranteed rung: never deadline-gated
            probes += 1
            t = _sim_payload(op, alg, payload_elems, num_nodes, procs_per_node,
                             k_lanes, faults, cost)
            if t is not None:
                candidates[alg] = t
            recs.append(CandidateRecord(
                algorithm=alg, rung="base",
                status="priced" if t is not None else "unavailable", est_us=t))
        for alg in opt_algs:  # the expensive rung: only while under deadline
            if expired():
                recs.append(CandidateRecord(
                    algorithm=alg, rung="opt", status="deadline-skipped",
                    est_us=None))
                continue
            probes += 1
            status = "priced"
            try:
                t = _sim_payload(op, alg, payload_elems, num_nodes,
                                 procs_per_node, k_lanes, faults, cost)
            except AssertionError:
                if faults is None:
                    raise  # healthy opt: oracle failure is a bug, not a mode
                t = None  # degraded rewrite rejected — fall down the ladder
                status = "oracle-rejected"
            if t is not None:
                candidates[alg] = t
            elif status == "priced":
                status = "unavailable"
            recs.append(CandidateRecord(algorithm=alg, rung="opt",
                                        status=status, est_us=t))

        if not candidates:
            # final rung: return the first family that generates at all
            k = min(race_topo.k_lanes, race_topo.procs_per_node)
            c = payload_elems if op == "broadcast" else max(1, payload_elems)
            choice = None
            for alg in base_algs:
                try:
                    compiled_schedule(op, alg, race_topo, k, c, faults=faults)
                except Exception:
                    continue
                choice = Choice(op=op, algorithm=alg, est_us=float("inf"),
                                candidates=((alg, float("inf")),))
                break
            if choice is None:
                if sp:
                    TRACER.finish(sp, outcome="unusable")
                    sp = None  # closed here: the boundary handler must not
                raise RuntimeError(
                    f"no {op} family generates on {race_topo} — topology unusable"
                )
            decision = Decision(
                op=op, payload_elems=payload_elems, num_nodes=num_nodes,
                procs_per_node=procs_per_node, k_lanes=k_lanes,
                faults_fp=faults_fp, deadline_s=deadline_s,
                candidates=tuple(recs), winner=choice.algorithm,
                est_us=choice.est_us, margin_us=None,
                rung_fired="final-fallback", probes=probes,
                wall_s=time.perf_counter() - wall0, choice=choice,
            )
        else:
            ranked = tuple(sorted(candidates.items(), key=lambda kv: kv[1]))
            best, est = ranked[0]
            choice = Choice(op=op, algorithm=best, est_us=est, candidates=ranked)
            decision = Decision(
                op=op, payload_elems=payload_elems, num_nodes=num_nodes,
                procs_per_node=procs_per_node, k_lanes=k_lanes,
                faults_fp=faults_fp, deadline_s=deadline_s,
                candidates=tuple(recs), winner=best, est_us=est,
                margin_us=ranked[1][1] - est if len(ranked) > 1 else None,
                rung_fired="raced", probes=probes,
                wall_s=time.perf_counter() - wall0, choice=choice,
            )
        obs_metrics.counter("selector.races").inc()
        obs_metrics.counter(f"selector.rung.{decision.rung_fired}").inc()
        if sp:
            TRACER.finish(sp, winner=decision.winner, est_us=decision.est_us,
                          rung_fired=decision.rung_fired, probes=probes,
                          margin_us=decision.margin_us)
    except BaseException:
        if sp:
            TRACER.finish(sp, outcome="error")
        raise
    with _LAST_LOCK:
        _LAST_DECISION = decision
    return decision


def select_batch(queries, *, cost: CostParams | None = None) -> list[Choice]:
    """Answer many healthy selector queries in one call.

    ``queries`` is a sequence of ``(op, payload_elems, num_nodes,
    procs_per_node, k_lanes)`` tuples; the result list is aligned with it
    and each entry equals — bit for bit — what ``select()`` returns for
    the same arguments.  Faulted or deadline-bounded queries do not
    belong here; :func:`repro_torch.api.plan_batch` routes those through the
    per-query ladder.

    Instead of looping ``select()`` (one compile + one simulation per
    (candidate, payload)), queries are grouped by ``(op, mesh)`` and each
    candidate algorithm is compiled **once at unit payload**; all the
    group's payloads are then priced through one stacked pass of the
    array-native simulator (``simulate_payload_scaled``, exact because
    alltoall message sizes are linear in ``c``).  Tree ops (broadcast /
    scatter) chunk payloads with remainders — not linear in ``c`` — so
    they fall back to the cached per-query race, which amortizes across
    the batch anyway.  ``cost`` prices every query, as in :func:`select`.
    """
    queries = list(queries)
    results: list[Choice | None] = [None] * len(queries)
    groups: dict[tuple, list[tuple[int, int]]] = {}
    for i, q in enumerate(queries):
        op, payload, nn, ppn, kl = q
        if op == "alltoall":
            groups.setdefault((op, nn, ppn, kl), []).append((i, int(payload)))
        else:
            results[i] = _select_cached(op, payload, nn, ppn, kl, None, None,
                                        cost=cost)
    for (op, nn, ppn, kl), items in groups.items():
        machine = _machine_for(nn, ppn, kl, cost)
        proxy, scale = _proxy_machine(machine)
        topo = proxy.topo
        k = min(topo.k_lanes, topo.procs_per_node)
        payloads = sorted({p for _, p in items})
        index = {p: j for j, p in enumerate(payloads)}
        # the same proxy payload scaling _sim_payload applies per query
        cvals = [max(1, int(p / scale)) for p in payloads]
        algs = _candidate_algs(op, topo)
        # price base families before opt: rewrites so candidate insertion
        # order — the tie-break sorted() preserves — matches select()
        ordered = ([a for a in algs if not a.startswith("opt:")]
                   + [a for a in algs if a.startswith("opt:")])
        prices = {}  # alg -> float64 [len(payloads)] stacked prices
        for alg in ordered:
            base_alg, optimize = _parse_alg(alg)
            try:
                cs_unit = compiled_schedule(op, base_alg, topo, k, 1,
                                            optimize=optimize)
            except AssertionError:
                raise  # healthy opt: oracle failure is a bug, not a mode
            except Exception:
                continue  # family not generatable at this topology
            prices[alg] = simulate_payload_scaled(cs_unit, proxy, cvals)
        obs_metrics.counter("selector.batch.groups").inc()
        obs_metrics.counter("selector.batch.queries").inc(len(items))
        for i, payload in items:
            j = index[payload]
            candidates = {alg: float(ts[j]) for alg, ts in prices.items()}
            if not candidates:
                # every family failed to price: per-query final fallback
                results[i] = _select_cached(op, payload, nn, ppn, kl,
                                            None, None, cost=cost)
                continue
            ranked = tuple(sorted(candidates.items(), key=lambda kv: kv[1]))
            best, est = ranked[0]
            results[i] = Choice(op=op, algorithm=best, est_us=est,
                                candidates=ranked)
    return results


def selector_cache_reset() -> None:
    """Drop every selector-level memo — the cached Choices, the payload
    probes, and the affine/piecewise fits — plus the last-decision record
    (``schedule_cache_reset``'s counterpart one layer up).  The artifact
    store calls this at warm-start: a ``Choice`` cached before the store
    swapped the process cache underneath it may name a price the bumped
    pipeline no longer produces, and an lru entry is unkeyed by pipeline
    fingerprint, so invalidation has to be wholesale."""
    global _LAST_DECISION
    _select_cached.cache_clear()
    _sim_payload.cache_clear()
    affine_cost.cache_clear()
    piecewise_cost.cache_clear()
    with _LAST_LOCK:
        _LAST_DECISION = None
    obs_metrics.counter("selector.cache_resets").inc()


def selector_cache_info() -> dict:
    """Hit/miss/size counters for every selector-level lru cache."""
    out = {}
    for name, fn in (("select", _select_cached), ("sim_payload", _sim_payload),
                     ("affine", affine_cost), ("piecewise", piecewise_cost)):
        ci = fn.cache_info()
        out[name] = {"hits": ci.hits, "misses": ci.misses,
                     "size": ci.currsize, "max": ci.maxsize}
    return out


@functools.lru_cache(maxsize=4096)
def affine_cost(
    op: str,
    alg: str,
    c_lo: int,
    c_hi: int,
    num_nodes: int = 2,
    procs_per_node: int = 256,
    k_lanes: int = 8,
    cost: CostParams | None = None,
) -> tuple[float, float] | None:
    """Fit ``time(c) ~= A + B*c`` from two probe payloads.

    Round structure is payload-independent, so within one payload regime the
    simulated cost is affine in ``c``; the fit is exact at the probes and an
    interpolation in between (over-estimating at most by the convexity of
    the piecewise-affine max, which is what the crossover table tolerates).
    Returns ``(A, B)`` or None if the family cannot be generated.
    """
    t_lo = _sim_payload(op, alg, c_lo, num_nodes, procs_per_node, k_lanes,
                        cost=cost)
    if t_lo is None:
        return None
    if c_hi == c_lo:
        return t_lo, 0.0
    t_hi = _sim_payload(op, alg, c_hi, num_nodes, procs_per_node, k_lanes,
                        cost=cost)
    if t_hi is None:
        return None
    slope = (t_hi - t_lo) / (c_hi - c_lo)
    return t_lo - slope * c_lo, slope


#: relative slope disagreement between the two fitted segments above which
#: ``piecewise_cost`` spends a fourth probe (adaptive placement): slopes
#: that differ this much mean the regime knee sits somewhere inside a
#: segment, and a single interior probe cannot say where.
SLOPE_DISAGREEMENT = 0.25


@functools.lru_cache(maxsize=4096)
def piecewise_cost(
    op: str,
    alg: str,
    c_lo: int,
    c_hi: int,
    num_nodes: int = 2,
    procs_per_node: int = 256,
    k_lanes: int = 8,
    cost: CostParams | None = None,
) -> tuple[int, float, float, float, float] | None:
    """Piecewise-affine fit ``(c_mid, A1, B1, A2, B2)`` from 3-4 probes.

    Probes at ``c_lo``, the geometric midpoint, and ``c_hi``; segment 1
    (``A1 + B1*c``) covers ``c <= c_mid``, segment 2 the rest.  Exact at
    all three probes, so the two-segment fit catches a family whose
    dominating cost term flips somewhere inside the sweep — the ``opt:``
    rewrites and payload splitting do exactly that — where the 2-probe
    affine fit would silently misprice the whole interior.

    **Adaptive probe placement**: when the two
    segments' slopes disagree by more than :data:`SLOPE_DISAGREEMENT`
    (relative), the knee is real but its location is only bracketed to one
    side of the midpoint; the fit then bisects once more — a fourth probe
    at the geometric midpoint of the segment carrying more of the cost
    variation (where the knee must live) — and keeps
    the two-segment fit whose breakpoint explains the off-breakpoint probe
    best (total probes capped at 4).  Returns None if the family cannot be
    generated on this mesh.
    """
    t_lo = _sim_payload(op, alg, c_lo, num_nodes, procs_per_node, k_lanes,
                        cost=cost)
    if t_lo is None:
        return None
    if c_hi <= c_lo:
        return c_lo, t_lo, 0.0, t_lo, 0.0
    c_mid = int(round(math.sqrt(float(c_lo) * float(c_hi))))
    c_mid = min(max(c_mid, c_lo + 1), c_hi - 1) if c_hi > c_lo + 1 else c_lo
    t_hi = _sim_payload(op, alg, c_hi, num_nodes, procs_per_node, k_lanes,
                        cost=cost)
    if t_hi is None:
        return None
    if c_mid <= c_lo:  # sweep too narrow for a midpoint: plain affine
        b = (t_hi - t_lo) / (c_hi - c_lo)
        return c_lo, t_lo - b * c_lo, b, t_lo - b * c_lo, b
    t_mid = _sim_payload(op, alg, c_mid, num_nodes, procs_per_node, k_lanes,
                         cost=cost)
    if t_mid is None:
        return None
    b1 = (t_mid - t_lo) / (c_mid - c_lo)
    b2 = (t_hi - t_mid) / (c_hi - c_mid)
    disagree = abs(b2 - b1) > SLOPE_DISAGREEMENT * max(abs(b1), abs(b2), 1e-30)
    if disagree:
        # bisect (geometrically) the segment carrying more of the cost
        # variation — the knee lives where the time actually moves
        left = abs(t_mid - t_lo) > abs(t_hi - t_mid)
        lo2, hi2 = (c_lo, c_mid) if left else (c_mid, c_hi)
        c_x = int(round(math.sqrt(float(max(lo2, 1)) * float(hi2))))
        c_x = min(max(c_x, lo2 + 1), hi2 - 1)
        if lo2 < c_x < hi2:
            t_x = _sim_payload(op, alg, c_x, num_nodes, procs_per_node,
                               k_lanes, cost=cost)
            if t_x is not None:
                probes = sorted({c_lo: t_lo, c_mid: t_mid, c_hi: t_hi,
                                 c_x: t_x}.items())
                best, best_err = None, None
                for kn in range(1, len(probes) - 1):
                    ck, tk = probes[kn]
                    s1 = (tk - probes[0][1]) / (ck - probes[0][0])
                    s2 = (probes[-1][1] - tk) / (probes[-1][0] - ck)
                    fit = (ck, probes[0][1] - s1 * probes[0][0], s1,
                           tk - s2 * ck, s2)
                    err = sum(
                        abs(piecewise_eval(fit, cq) - tq)
                        for cq, tq in probes[1:-1]
                    )
                    if best_err is None or err < best_err:
                        best, best_err = fit, err
                return best
    return c_mid, t_lo - b1 * c_lo, b1, t_mid - b2 * c_mid, b2


def piecewise_eval(
    fit: tuple[int, float, float, float, float], c: int
) -> float:
    """Evaluate a :func:`piecewise_cost` fit at payload ``c``."""
    c_mid, a1, b1, a2, b2 = fit
    return a1 + b1 * c if c <= c_mid else a2 + b2 * c


def crossover_table(
    op: str,
    sizes=None,
    *,
    num_nodes: int = 2,
    procs_per_node: int = 256,
    k_lanes: int = 8,
    cost: CostParams | None = None,
) -> list[tuple[int, str, float]]:
    """The size-switched algorithm table for one op — EXPERIMENTS.md exhibit.

    Simulates each candidate algorithm at only 3 probe payloads (sweep
    endpoints + geometric midpoint) and ranks interior sizes from the
    interpolated piecewise-affine cost; the full table costs 3 simulations
    per algorithm regardless of sweep length, with the endpoint cells exact
    by construction and regime flips inside the sweep resolved by the
    second segment.
    """
    if sizes is None:
        sizes = [1 << s for s in range(0, 27, 2)]
    mesh = {
        "num_nodes": num_nodes,
        "procs_per_node": procs_per_node,
        "k_lanes": k_lanes,
    }
    c_lo, c_hi = min(sizes), max(sizes)
    machine = _machine_for(**mesh, cost=cost)
    proxy, _ = _proxy_machine(machine)
    fits: dict[str, tuple[int, float, float, float, float]] = {}
    for alg in _candidate_algs(op, proxy.topo):
        fit = piecewise_cost(op, alg, c_lo, c_hi, **mesh, cost=cost)
        if fit is not None:
            fits[alg] = fit
    out = []
    for s in sizes:
        ranked = sorted(
            (piecewise_eval(fit, s), alg) for alg, fit in fits.items()
        )
        est, best = ranked[0]
        out.append((s, best, est))
    return out
