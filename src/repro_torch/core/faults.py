"""Fault model for degraded k-lane machines.

The paper's experimental setting is a dual-rail (k=2) OmniPath cluster, and
the most likely production incident in a k-lane system is losing a rail, a
NIC, or a node mid-job.  This module gives those incidents a first-class,
deterministic representation:

* :class:`FaultSpec` — a frozen, hashable description of the fault set:
  dead rails (per node or cluster-wide), dead ranks, dead nodes, and
  derated links.  Specs canonicalize on construction so equal fault sets
  hash and fingerprint identically regardless of the order they were
  listed in.
* :func:`sample_faults` — deterministic seeded sampling of a ``FaultSpec``
  against a topology (the chaos harness and CI smoke both draw from it).
* :func:`apply_faults` — produce a degraded :class:`~repro_torch.core.topology.
  Machine` (a :class:`FaultedMachine`) whose per-node surviving-lane counts
  and derated link costs the simulator prices through the *existing*
  ``port_time`` / ``lane_time`` hooks; no second cost model.

Fault semantics (what each field means physically):

* ``dead_rails`` / ``dead_lanes`` — network rails lost cluster-wide / at a
  specific node.  The node's concurrent off-node stream budget shrinks; no
  message is semantically lost.  Repair = re-pack under the reduced
  per-node port budget.
* ``dead_ranks`` — the rank's *network port* (its lane-driving NIC path)
  is dead: the rank can no longer send or receive off-node traffic, but it
  is still alive on shared memory.  Repair = relay its inter-node messages
  through a surviving local rank (``schedule_ir.relay_messages``), which
  preserves block semantics exactly.
* ``dead_nodes`` — the whole node is unreachable (power/switch loss).  Its
  data is gone, so no schedule rewrite can preserve block semantics:
  ``RepairSchedule`` *reverts* (returns its input unchanged) and the
  elastic layer (``training.elastic.plan_remesh``) shrinks the job instead.
  The simulator prices any schedule that still routes traffic through a
  dead node at ``inf`` so the selector never picks one.
* ``derated_links`` — a node's network links run at a fraction of nominal
  bandwidth (flapping optics, congested uplink): its inter-node beta is
  multiplied by the given factor (>= 1).  Structure-preserving; pricing
  only.

The degraded machine feeds ``core.simulate`` via ``Machine.degradation()``
(base machines return ``None`` — the healthy fast path is bit-exact with
the per-``Msg`` reference and stays untouched).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core.topology import Machine, Topology

__all__ = [
    "FaultSpec",
    "FaultedMachine",
    "Degradation",
    "degradation_of",
    "UnrepairableFaultError",
    "apply_faults",
    "sample_faults",
    "HEALTHY",
]


class UnrepairableFaultError(ValueError):
    """The fault set admits no semantics-preserving schedule rewrite
    (dead node, or a node with no surviving live-port rank to relay
    through).  Callers fall back to regeneration or an elastic remesh."""


def _canon_pairs(pairs, *, value_type=int):
    """Sort/merge ``(node, value)`` pairs into a canonical tuple."""
    merged: dict[int, float] = {}
    for node, val in pairs:
        node = int(node)
        if value_type is int:
            merged[node] = merged.get(node, 0) + int(val)
        else:
            merged[node] = merged.get(node, 1.0) * float(val)
    return tuple(sorted((n, value_type(v)) for n, v in merged.items()))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A canonical, hashable fault set against a node-major topology.

    All fields default to "no fault"; the empty spec is :data:`HEALTHY`.
    Node/rank indices are validated lazily against a topology (specs are
    topology-independent values; :func:`apply_faults` checks ranges).
    """

    dead_rails: int = 0  # rails lost at EVERY node (cluster-wide)
    dead_lanes: tuple[tuple[int, int], ...] = ()  # (node, rails lost there)
    dead_ranks: tuple[int, ...] = ()  # ranks whose network port is dead
    dead_nodes: tuple[int, ...] = ()  # whole nodes lost
    derated_links: tuple[tuple[int, float], ...] = ()  # (node, beta multiplier)

    def __post_init__(self):
        if self.dead_rails < 0:
            raise ValueError("dead_rails must be >= 0")
        object.__setattr__(
            self, "dead_lanes", _canon_pairs(self.dead_lanes, value_type=int)
        )
        object.__setattr__(
            self, "dead_ranks", tuple(sorted({int(r) for r in self.dead_ranks}))
        )
        object.__setattr__(
            self, "dead_nodes", tuple(sorted({int(v) for v in self.dead_nodes}))
        )
        object.__setattr__(
            self,
            "derated_links",
            _canon_pairs(self.derated_links, value_type=float),
        )
        for _, cnt in self.dead_lanes:
            if cnt < 1:
                raise ValueError("dead_lanes counts must be >= 1")
        for _, f in self.derated_links:
            if f < 1.0:
                raise ValueError("derated_links factors must be >= 1")

    @property
    def is_healthy(self) -> bool:
        return (
            self.dead_rails == 0
            and not self.dead_lanes
            and not self.dead_ranks
            and not self.dead_nodes
            and not self.derated_links
        )

    def fingerprint(self) -> str:
        """Stable short id of the fault set — folded into the schedule-cache
        key so healthy-topology entries are never served under faults."""
        blob = "faults.v1|{}|{}|{}|{}|{}".format(
            self.dead_rails,
            self.dead_lanes,
            self.dead_ranks,
            self.dead_nodes,
            self.derated_links,
        )
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def validate(self, topo: Topology) -> None:
        """Range-check the spec against a concrete topology."""
        N, k, p = topo.num_nodes, topo.k_lanes, topo.p
        if self.dead_rails > k:
            raise ValueError(f"dead_rails={self.dead_rails} > k_lanes={k}")
        for v, cnt in self.dead_lanes:
            if not 0 <= v < N:
                raise ValueError(f"dead_lanes node {v} out of range [0, {N})")
            if self.dead_rails + cnt > k:
                raise ValueError(
                    f"node {v} loses {self.dead_rails + cnt} of {k} rails"
                )
        for r in self.dead_ranks:
            if not 0 <= r < p:
                raise ValueError(f"dead_ranks rank {r} out of range [0, {p})")
        for v in self.dead_nodes:
            if not 0 <= v < N:
                raise ValueError(f"dead_nodes node {v} out of range [0, {N})")
        for v, _ in self.derated_links:
            if not 0 <= v < N:
                raise ValueError(f"derated_links node {v} out of range [0, {N})")


HEALTHY = FaultSpec()


@dataclasses.dataclass(frozen=True, eq=False)
class Degradation:
    """Vectorized view of a ``FaultSpec`` against one topology — exactly the
    arrays ``core.simulate`` needs to price the degraded machine through
    ``port_time`` / ``lane_time``."""

    lanes: np.ndarray  # [N] int64: surviving rails per node (0 = dead node)
    beta_scale: np.ndarray  # [N] float64: inter-node beta multiplier
    dead_port: np.ndarray  # [p] bool: rank cannot drive off-node traffic
    dead_rank: np.ndarray  # [p] bool: rank is gone entirely (dead node)
    dead_node: np.ndarray  # [N] bool


def degradation_of(spec: FaultSpec, topo: Topology) -> Degradation:
    N, n, k = topo.num_nodes, topo.procs_per_node, topo.k_lanes
    lanes = np.full(N, k - spec.dead_rails, dtype=np.int64)
    for v, cnt in spec.dead_lanes:
        lanes[v] -= cnt
    lanes = np.maximum(lanes, 0)
    dead_node = np.zeros(N, dtype=bool)
    if spec.dead_nodes:
        dead_node[list(spec.dead_nodes)] = True
    lanes[dead_node] = 0
    beta_scale = np.ones(N, dtype=np.float64)
    for v, f in spec.derated_links:
        beta_scale[v] *= f
    dead_rank = np.repeat(dead_node, n)
    dead_port = dead_rank.copy()
    if spec.dead_ranks:
        dead_port[list(spec.dead_ranks)] = True
    return Degradation(
        lanes=lanes,
        beta_scale=beta_scale,
        dead_port=dead_port,
        dead_rank=dead_rank,
        dead_node=dead_node,
    )


@dataclasses.dataclass(frozen=True)
class FaultedMachine(Machine):
    """A ``Machine`` carrying a fault set.  ``topo``/``cost`` keep the
    *healthy* shape (schedules stay addressable by their original ranks);
    the degradation arrays tell the simulator which resources survive."""

    spec: FaultSpec = HEALTHY

    def degradation(self) -> Degradation | None:
        if self.spec.is_healthy:
            return None
        return degradation_of(self.spec, self.topo)


def apply_faults(machine: Machine, spec: FaultSpec) -> Machine:
    """Degrade ``machine`` by ``spec``.  The result prices through the
    simulator's existing ``port_time``/``lane_time`` hooks: per-node
    surviving lanes bound each node's concurrent off-node streams, derated
    links scale its inter-node beta, and traffic that touches a dead port
    or dead node costs ``inf`` (unroutable — repair it first)."""
    spec.validate(machine.topo)
    if spec.is_healthy:
        return machine
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.trace import TRACER

    obs_metrics.counter("faults.applied").inc()
    if TRACER:
        TRACER.event("faults.apply", fingerprint=spec.fingerprint(),
                     dead_rails=spec.dead_rails,
                     dead_lanes=len(spec.dead_lanes),
                     dead_ranks=len(spec.dead_ranks),
                     dead_nodes=len(spec.dead_nodes),
                     derated_links=len(spec.derated_links))
    return FaultedMachine(topo=machine.topo, cost=machine.cost, spec=spec)


def sample_faults(
    topo: Topology,
    *,
    seed: int,
    dead_rails: int = 0,
    n_dead_lanes: int = 0,
    n_dead_ranks: int = 0,
    n_dead_nodes: int = 0,
    n_derated_links: int = 0,
    derate_factor: float = 2.0,
) -> FaultSpec:
    """Deterministically sample a ``FaultSpec`` for ``topo``.

    The same ``(topo, seed, counts)`` always yields the same spec — the
    chaos harness and the CI smoke depend on replayable fault sets.  Dead
    ranks and per-node dead lanes are drawn on *surviving* nodes only, and
    at least one live-port rank is kept per surviving node so the sampled
    set stays repairable by construction.
    """
    rng = np.random.default_rng(seed)
    N, n, k = topo.num_nodes, topo.procs_per_node, topo.k_lanes

    n_dead_nodes = min(n_dead_nodes, N - 1)  # keep the job alive
    dead_nodes = (
        rng.choice(N, size=n_dead_nodes, replace=False) if n_dead_nodes else []
    )
    alive = np.setdiff1d(np.arange(N), dead_nodes)

    # per-node dead lanes, never below 1 surviving rail on a live node
    lane_budget = {int(v): k - dead_rails - 1 for v in alive}
    dead_lanes: list[tuple[int, int]] = []
    for _ in range(n_dead_lanes):
        cands = [v for v, b in lane_budget.items() if b > 0]
        if not cands:
            break
        v = int(rng.choice(cands))
        lane_budget[v] -= 1
        dead_lanes.append((v, 1))

    # dead ports on surviving nodes, at least one live port kept per node
    port_budget = {int(v): n - 1 for v in alive}
    dead_ranks: list[int] = []
    for _ in range(n_dead_ranks):
        cands = [v for v, b in port_budget.items() if b > 0]
        if not cands:
            break
        v = int(rng.choice(cands))
        locals_left = [
            loc
            for loc in range(n)
            if topo.rank_of(v, loc) not in dead_ranks
        ]
        loc = int(rng.choice(locals_left[1:]))  # keep local rank 0 alive
        port_budget[v] -= 1
        dead_ranks.append(topo.rank_of(v, loc))

    derated = []
    if n_derated_links:
        cands = alive if alive.size else np.arange(N)
        picks = rng.choice(
            cands, size=min(n_derated_links, cands.size), replace=False
        )
        derated = [(int(v), float(derate_factor)) for v in picks]

    return FaultSpec(
        dead_rails=min(dead_rails, k - 1),
        dead_lanes=tuple(dead_lanes),
        dead_ranks=tuple(dead_ranks),
        dead_nodes=tuple(int(v) for v in dead_nodes),
        derated_links=tuple(derated),
    )
