"""Unified planning API: one request type, three entry points.

Everything a caller previously threaded through ``select()``'s growing
keyword surface — and ``compiled_schedule()``'s nine positionals — is one
frozen :class:`PlanRequest`; the answers are :func:`plan` (one query),
:func:`plan_batch` (many queries through the batched selector front-end),
and :func:`explain` (the full :class:`~repro_torch.core.selector.Decision`
race record).  A :class:`Plan` names the winning algorithm with its
priced candidate table and materializes the runnable compiled schedule
on demand.

Migration table (old call → ``PlanRequest`` form):

===============================================  =============================================
Old call                                          New call
===============================================  =============================================
``select(op, c, num_nodes=…, …)``                 ``plan(PlanRequest(op, c, num_nodes=…, …))``
``select(op, c, …).algorithm``                    ``plan(req).algorithm``
``select(op, c, …, explain=True)`` *(deprecated,  ``explain(PlanRequest(op, c, …))``
returns the ``Choice | Decision`` union)*
``select(op, c, faults=f, deadline_s=d)``         ``plan(PlanRequest(op, c, faults=f,``
                                                  ``deadline_s=d))``
``[select(op, c, …) for c in cs]``                ``plan_batch([PlanRequest(op, c, …) …])``
``compiled_schedule(op, alg, topo, k, c, …)``     ``compiled_schedule(req, alg)`` or
                                                  ``plan(req).schedule()``
===============================================  =============================================

``select()`` itself stays as the cost-model engine underneath; only its
``explain=True`` union return is deprecated (it warns and forwards
here).  ``PlanRequest(optimize=False)`` races the base paper families
only — the one capability the old keyword surface never exposed.

**Engine admission.**  The serving engine consumes this API
through :class:`repro_torch.serving.planner.DecodePlanner`:
``ServeEngine(..., plan_mesh=(num_nodes, procs_per_node, k_lanes))``
pins the three decode collectives with one :func:`plan_batch` call at
construction, and ``replan_deadline_s`` bounds the per-fault-event
replan (retried under seeded backoff, guarded by the ``engine.replan``
circuit breaker; a tripped breaker replans with ``deadline_s=0.0`` —
the deadline-exempt base rung, which every request type guarantees).
Steady-state decode steps never re-enter the selector race.

**Cost.**  :func:`plan`, :func:`plan_batch` and :func:`explain` take one
keyword, ``cost`` (a :class:`~repro_torch.core.topology.CostParams`), that
prices every candidate.  None prices at the reference's TPU v5e costs, and
then every answer equals the reference's bit for bit; a GPU cluster is
priced at ``NVLINK_IB.cost``.  The cost is no field of
:class:`PlanRequest`, and :meth:`Plan.schedule` does not depend on it.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import selector as _selector
from repro_torch.core.faults import FaultSpec
from repro_torch.core.schedule_ir import compiled_schedule
from repro_torch.core.selector import Choice, Decision
from repro_torch.core.topology import CostParams

__all__ = ["PlanRequest", "Plan", "plan", "plan_batch", "explain"]

_OPS = ("broadcast", "scatter", "alltoall")


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One planning query: what to run, how big, on what machine shape,
    under which faults/deadline, and whether ``opt:`` rewrites may race.

    ``payload_elems`` follows the selector's convention: total elements
    for broadcast, per-proc block for scatter, per-pair block for
    alltoall.  Hashable and frozen, so requests are dict keys and cache
    keys for free."""

    op: str
    payload_elems: int
    num_nodes: int = 2
    procs_per_node: int = 256
    k_lanes: int = 8
    faults: FaultSpec | None = None
    deadline_s: float | None = None
    optimize: bool = True

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}; expected one of {_OPS}")
        if self.payload_elems < 0:
            raise ValueError("payload_elems must be >= 0")
        if min(self.num_nodes, self.procs_per_node, self.k_lanes) < 1:
            raise ValueError("machine shape dimensions must be >= 1")

    @property
    def is_healthy(self) -> bool:
        return self.faults is None or self.faults.is_healthy

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["faults"] = self.faults.fingerprint() if self.faults is not None \
            else None
        return d


@dataclasses.dataclass(frozen=True)
class Plan:
    """The answer to one :class:`PlanRequest`: the winning algorithm
    (possibly ``opt:``-prefixed), its estimated time, and the full priced
    candidate table, with the request attached for provenance."""

    request: PlanRequest
    algorithm: str
    est_us: float
    candidates: tuple[tuple[str, float], ...]

    @property
    def op(self) -> str:
        return self.request.op

    def schedule(self):
        """Materialize the runnable compiled schedule for this plan on the
        request's (real, un-proxied) topology — the ``PlanRequest``
        overload of :func:`repro_torch.core.schedule_ir.compiled_schedule`."""
        return compiled_schedule(self.request, self.algorithm)

    def as_dict(self) -> dict:
        return {
            "request": self.request.as_dict(),
            "algorithm": self.algorithm,
            "est_us": self.est_us,
            "candidates": [list(c) for c in self.candidates],
        }


def _wrap(request: PlanRequest, choice: Choice) -> Plan:
    return Plan(request=request, algorithm=choice.algorithm,
                est_us=choice.est_us, candidates=choice.candidates)


def plan(request: PlanRequest, *, cost: CostParams | None = None) -> Plan:
    """Pick the cheapest algorithm family for one request (the cached
    ``select()`` race, including the graceful-degradation ladder
    when the request carries faults or a deadline)."""
    faults = request.faults if not request.is_healthy else None
    choice = _selector._select_cached(
        request.op, request.payload_elems, request.num_nodes,
        request.procs_per_node, request.k_lanes, faults,
        request.deadline_s, request.optimize, cost=cost,
    )
    return _wrap(request, choice)


def plan_batch(requests, *, cost: CostParams | None = None) -> list[Plan]:
    """Answer many requests per call; equal to ``[plan(r) for r in
    requests]`` — exactly, including the float prices — but healthy
    alltoall queries run through the batched selector front-end
    (``selector.select_batch``): one unit-payload compile per candidate
    per mesh, all payloads priced in one stacked simulator pass.
    Faulted, deadline-bounded, or ``optimize=False`` requests take the
    per-query ladder — those modes are racing *policies*, not prices, and
    never batch."""
    requests = list(requests)
    results: list[Plan | None] = [None] * len(requests)
    fast_idx: list[int] = []
    fast_q: list[tuple] = []
    for i, req in enumerate(requests):
        if req.is_healthy and req.deadline_s is None and req.optimize:
            fast_idx.append(i)
            fast_q.append((req.op, req.payload_elems, req.num_nodes,
                           req.procs_per_node, req.k_lanes))
        else:
            results[i] = plan(req, cost=cost)
    if fast_q:
        for i, choice in zip(fast_idx, _selector.select_batch(fast_q, cost=cost)):
            results[i] = _wrap(requests[i], choice)
    return results


def explain(request: PlanRequest, *, cost: CostParams | None = None) -> Decision:
    """The full race record for one request: every candidate with its
    price and fate, the winner's margin, which fallback rung fired, and
    the probe count/wall.  Always runs the race (the underlying payload
    probes stay cached) so the record reflects *this* call — the
    replacement for the deprecated ``select(..., explain=True)``."""
    faults = request.faults if not request.is_healthy else None
    return _selector._select_impl(
        request.op, request.payload_elems, request.num_nodes,
        request.procs_per_node, request.k_lanes, faults,
        request.deadline_s, request.optimize, cost=cost,
    )
