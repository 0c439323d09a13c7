"""Fault-tolerance control logic, copied from the reference's
``repro/training/elastic.py`` (pure Python): straggler detection
(``StragglerMonitor``, which ``launch/train.py`` times every step through),
fault events (``FaultEvent``, which ``ServeEngine.inject_fault`` and the
decode planner consume) and elastic re-meshing plans (``plan_remesh``,
``plan_remesh_for_faults``).

This is the decision layer: it decides, the launcher acts.  A re-meshed job
resumes from a committed checkpoint (``training/checkpoint.py``) on the
step-keyed data stream (``training/data.py``); a dead lane is survived by a
repaired schedule (``core/faults.py``), a dead node only by a remesh.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "StragglerMonitor",
    "plan_remesh",
    "RemeshPlan",
    "FaultEvent",
    "plan_remesh_for_faults",
]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """A detected hardware fault, as reported by the transport layer or the
    chaos harness (:mod:`tools.chaos`).  ``kind`` is ``"lane"`` (a network
    rail/NIC on ``node`` died — the job can limp along on repaired
    schedules, see ``core.faults``) or ``"node"`` (the node is gone — only
    a remesh restores progress)."""

    kind: str  # "lane" | "node"
    node: int
    step: int = 0
    detail: str = ""

    def __post_init__(self):
        if self.kind not in ("lane", "node"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class StragglerMonitor:
    """EMA-based per-step deadline.  ``observe`` returns an action:
    "ok", "warn" (late but under hard limit), or "evict" (the host exceeded
    the hard multiple ``evict_factor`` times in a row)."""

    def __init__(self, *, ema_decay: float = 0.9, warn_factor: float = 1.5,
                 evict_factor: float = 3.0, patience: int = 3):
        self.ema_decay = ema_decay
        self.warn_factor = warn_factor
        self.evict_factor = evict_factor
        self.patience = patience
        self.ema: float | None = None
        self.strikes = 0
        self.warnings = 0

    def deadline(self) -> float | None:
        return None if self.ema is None else self.ema * self.warn_factor

    def observe(self, step_seconds: float) -> str:
        if self.ema is None:
            self.ema = step_seconds
            return "ok"
        action = "ok"
        if step_seconds > self.ema * self.evict_factor:
            self.strikes += 1
            action = "evict" if self.strikes >= self.patience else "warn"
        elif step_seconds > self.ema * self.warn_factor:
            self.warnings += 1
            self.strikes = 0
            action = "warn"
        else:
            self.strikes = 0
        # stragglers must not poison the baseline: clamp EMA update
        obs = min(step_seconds, self.ema * self.warn_factor)
        self.ema = self.ema * self.ema_decay + obs * (1 - self.ema_decay)
        return action

    def observe_fault(self, event: FaultEvent) -> str:
        """Fold an explicit fault report into the same warn/evict policy the
        timing path drives.  A dead *node* is an immediate evict (no amount
        of patience brings it back); a dead *lane* is one strike — the node
        still makes progress on repaired schedules, so it is evicted only
        after ``patience`` lane faults without a clean recovery in between.
        """
        if event.kind == "node":
            self.strikes = max(self.strikes, self.patience)
            return "evict"
        self.strikes += 1
        self.warnings += 1
        return "evict" if self.strikes >= self.patience else "warn"


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    """What the launcher should do after losing ``failed_pods`` pods /
    ``failed_hosts`` hosts."""

    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    global_batch: int  # keep per-device batch constant => shrink global
    restart_step: int
    feasible: bool
    note: str = ""


def plan_remesh(
    *,
    num_pods: int,
    pods_lost: int,
    data_axis: int,
    model_axis: int,
    global_batch: int,
    last_committed_step: int,
) -> RemeshPlan:
    """Elastic policy: pods are DP replicas, so losing pods shrinks the
    ``pod`` axis (never the ``model`` axis — parameters are sharded over it
    and re-sharding mid-run would need a full repartition).  Batch scales
    with the surviving DP capacity so per-device memory/compute (and thus
    the compiled executable shape per pod) is unchanged."""
    healthy = num_pods - pods_lost
    if healthy < 1:
        return RemeshPlan((), (), 0, last_committed_step, False,
                          "no healthy pods")
    scale = healthy / num_pods
    new_batch = max(1, int(global_batch * scale))
    if healthy == 1:
        shape = (data_axis, model_axis)
        axes = ("data", "model")
    else:
        shape = (healthy, data_axis, model_axis)
        axes = ("pod", "data", "model")
    return RemeshPlan(
        mesh_shape=shape,
        mesh_axes=axes,
        global_batch=new_batch,
        restart_step=last_committed_step,
        feasible=True,
        note=f"{healthy}/{num_pods} pods; global batch {global_batch}->{new_batch}",
    )


def plan_remesh_for_faults(
    events: list[FaultEvent] | tuple[FaultEvent, ...],
    *,
    num_pods: int,
    data_axis: int,
    model_axis: int,
    global_batch: int,
    last_committed_step: int,
) -> RemeshPlan:
    """Deterministic shrink plan from a batch of fault events: only ``node``
    faults cost a pod (lane faults are survivable via schedule repair — see
    ``core.faults`` — and never shrink the mesh); duplicate reports of the
    same node count once.  The same event set always yields the same plan,
    in any order — the chaos harness and its CI smoke replay on this."""
    dead = sorted({e.node for e in events if e.kind == "node"})
    plan = plan_remesh(
        num_pods=num_pods,
        pods_lost=len(dead),
        data_axis=data_axis,
        model_axis=model_axis,
        global_batch=global_batch,
        last_committed_step=last_committed_step,
    )
    if dead:
        plan = dataclasses.replace(
            plan, note=f"dead pods {dead}; {plan.note}"
        )
    return plan
