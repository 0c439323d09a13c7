"""Store-aware admission for the serving engine (jax-free).

``DecodePlanner`` pins the per-decode-step collective plans —
broadcast / scatter / alltoall for the engine's shapes, one
:func:`repro_torch.api.plan_batch` call — at construction, and replans *only*
on a :class:`repro_torch.training.elastic.FaultEvent`.  The steady-state
decode loop therefore never re-prices collectives: ``plans()`` is a
dict lookup.

Replanning is bounded: each fault event triggers exactly one replan,
retried under a deterministic :class:`~repro_torch.core.resilience.BackoffPolicy`
inside a :class:`~repro_torch.core.resilience.DeadlineBudget`, guarded by a
:class:`~repro_torch.core.resilience.CircuitBreaker`.  When the breaker is
open or the budget runs out, the planner falls to the selector's
guaranteed deadline-exempt base rung (``deadline_s=0.0`` skips every
``opt:`` candidate, and the base paper families always race) — the
engine never stalls waiting on an ``opt:`` race.

Faults accumulate across events the way hardware actually degrades: a
second lane fault on the same node costs a second rail
(``FaultSpec.dead_lanes`` counts rails lost per node); a node fault
retires the node.  This module is deliberately jax-free so the chaos
harness and the numpy-only CI job can drive replanning without an
accelerator stack — ``serving.engine`` imports it, not the reverse.
"""

from __future__ import annotations

import functools
import time

from repro_torch.core.faults import FaultSpec
from repro_torch.core.resilience import BackoffPolicy, CircuitBreaker, \
    DeadlineBudget, call_with_retries
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import TRACER

__all__ = ["DecodePlanner"]

#: replan-latency buckets (seconds): cached fault fingerprints land at the
#: bottom, cold compiles of repaired schedules in the middle.
_REPLAN_EDGES = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0)


class DecodePlanner:
    """Pin decode-collective plans once; replan only on fault events.

    ``plan_batch_fn`` is injectable (default :func:`repro_torch.api.plan_batch`)
    so tests and chaos drills can fail the planning dependency and watch
    the breaker trip.  ``cost`` (a ``CostParams``) is handed to the default
    ``plan_batch`` on every call; None prices at the reference's TPU v5e
    costs.  An injected ``plan_batch_fn`` is called as it is, with the
    requests alone.
    """

    def __init__(self, *, num_slots: int, d_model: int,
                 num_codebooks: int = 1,
                 num_nodes: int = 2, procs_per_node: int = 8,
                 k_lanes: int = 2,
                 replan_deadline_s: float = 0.25,
                 backoff: BackoffPolicy | None = None,
                 breaker: CircuitBreaker | None = None,
                 plan_batch_fn=None,
                 cost=None):
        from repro_torch import api

        self.num_slots = num_slots
        self.d_model = d_model
        self.num_codebooks = num_codebooks
        self.mesh = (num_nodes, procs_per_node, k_lanes)
        self.replan_deadline_s = replan_deadline_s
        self.backoff = backoff if backoff is not None \
            else BackoffPolicy(base_s=1e-3, max_s=5e-2, max_attempts=3)
        self.breaker = breaker if breaker is not None \
            else CircuitBreaker("engine.replan", failure_threshold=3,
                                reset_s=1.0)
        self.cost = cost
        self._plan_batch = plan_batch_fn if plan_batch_fn is not None \
            else functools.partial(api.plan_batch, cost=cost)
        self._dead_lanes: dict[int, int] = {}  # node -> rails lost
        self._dead_nodes: set[int] = set()
        self.replan_count = 0
        self.replan_reports: list[dict] = []
        # pin at construction: the full healthy race, cached thereafter
        self._plans = {pl.op: pl
                       for pl in self._plan_batch(self._requests(None, None))}
        obs_metrics.counter("engine.plans_pinned").inc(len(self._plans))
        TRACER.event("engine.plans_pinned", mesh=self.mesh,
                     algs={op: pl.algorithm
                           for op, pl in self._plans.items()})

    # ------------------------------------------------------------------
    def _requests(self, faults: FaultSpec | None,
                  deadline_s: float | None) -> list:
        """The engine's three per-decode-step collectives (the same
        shapes ``ServeEngine.plan_decode_collectives`` prices)."""
        from repro_torch import api

        nn, ppn, kl = self.mesh
        p = nn * ppn
        bcast = self.num_slots * max(1, self.num_codebooks)
        act = self.num_slots * self.d_model
        common = dict(num_nodes=nn, procs_per_node=ppn, k_lanes=kl,
                      faults=faults, deadline_s=deadline_s)
        return [
            api.PlanRequest("broadcast", bcast, **common),
            api.PlanRequest("scatter", max(1, act // p), **common),
            api.PlanRequest("alltoall", max(1, act // (p * p)), **common),
        ]

    def current_faults(self) -> FaultSpec | None:
        if not self._dead_lanes and not self._dead_nodes:
            return None
        return FaultSpec(
            dead_lanes=tuple(sorted(self._dead_lanes.items())),
            dead_nodes=tuple(sorted(self._dead_nodes)),
        )

    def plans(self) -> dict:
        """The pinned ``{op: Plan}`` — a dict copy, no re-pricing."""
        return dict(self._plans)

    # ------------------------------------------------------------------
    def observe_fault(self, event) -> dict:
        """Fold one fault event into the accumulated spec and replan the
        pinned set exactly once, under retry/backoff and the deadline
        budget; a tripped breaker (or exhausted budget) falls to the
        deadline-exempt base rung.  Returns a replan report."""
        kind = getattr(event, "kind", "node")
        node = int(getattr(event, "node", 0))
        if kind == "node":
            self._dead_nodes.add(node)
        else:
            self._dead_lanes[node] = self._dead_lanes.get(node, 0) + 1
        spec = self.current_faults()
        t0 = time.perf_counter()
        budget = DeadlineBudget(self.replan_deadline_s) \
            if self.replan_deadline_s and self.replan_deadline_s > 0 else None
        outcome = "replanned"
        sp = TRACER.start("engine.replan", kind=kind, node=node) \
            if TRACER else None
        try:
            def attempt():
                # opt: candidates get whatever budget is left; 0.0 means
                # the selector skips them (base rung only)
                left = budget.remaining() if budget is not None else None
                return self._plan_batch(self._requests(spec, left))

            try:
                plans = call_with_retries(
                    attempt, policy=self.backoff, budget=budget,
                    retry_on=(Exception,), breaker=self.breaker,
                    name="engine.replan", salt=f"{kind}:{node}")
            except Exception:
                # breaker open or retries/budget exhausted: the base
                # families always race deadline-exempt, so this rung
                # cannot stall on an opt: probe
                outcome = "base-rung"
                obs_metrics.counter("engine.replan.base_rung").inc()
                plans = self._plan_batch(self._requests(spec, 0.0))
            self._plans = {pl.op: pl for pl in plans}
            self.replan_count += 1
            wall_s = time.perf_counter() - t0
            obs_metrics.counter("engine.replans").inc()
            obs_metrics.histogram(
                "engine.replan_latency_s", edges=_REPLAN_EDGES
            ).observe(wall_s)
        except BaseException:
            if sp:
                TRACER.finish(sp, outcome="error")
            raise
        if sp:
            TRACER.finish(sp, outcome=outcome, wall_s=round(wall_s, 6))
        report = {
            "kind": kind,
            "node": node,
            "outcome": outcome,
            "wall_s": wall_s,
            "faults": spec.fingerprint() if spec is not None else None,
            "algs": {op: pl.algorithm for op, pl in self._plans.items()},
        }
        self.replan_reports.append(report)
        return report
