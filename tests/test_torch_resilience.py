"""The port's resilience layer against the reference's: ``core.resilience``
(seeded backoff, deadline budgets, the circuit breaker, retries),
``serving.planner.DecodePlanner`` (pin, replan on fault events, the breaker
falling to the base rung) and the rest of ``training.elastic``
(``FaultEvent``, ``StragglerMonitor.observe_fault``, ``plan_remesh``,
``plan_remesh_for_faults``).

Each case runs the same script on both sides, with injected clocks where
time decides, and compares what it observes exactly.  A replan's requests
carry the deadline budget left when it ran, a wall-clock reading, so the
planner's plans compare by algorithm, ``est_us`` and candidates, and its
reports without ``wall_s``; the planners' ``replan_deadline_s`` is large
enough that the deadline never fires here.
"""

from __future__ import annotations

import dataclasses
import itertools
import types

import pytest

from repro import api as j_api
from repro.core import resilience as j_resilience
from repro.core import selector as j_selector
from repro.core.schedule_ir import schedule_cache_clear as j_schedule_cache_clear
from repro.serving import planner as j_planner
from repro.training import elastic as j_elastic
from repro_torch import api as t_api
from repro_torch.core import resilience as t_resilience
from repro_torch.core import selector as t_selector
from repro_torch.core import topology as t_topology
from repro_torch.core.schedule_ir import schedule_cache_clear as t_schedule_cache_clear
from repro_torch.serving import planner as t_planner
from repro_torch.training import elastic as t_elastic

SIDES = {
    "ref": types.SimpleNamespace(api=j_api, resilience=j_resilience, planner=j_planner,
                                 elastic=j_elastic),
    "port": types.SimpleNamespace(api=t_api, resilience=t_resilience, planner=t_planner,
                                  elastic=t_elastic),
}
#: the reference's planner arguments, with a deadline that never fires here
PLANNER_KW = dict(num_slots=4, d_model=128, num_nodes=2, procs_per_node=4, k_lanes=2,
                  replan_deadline_s=60.0)


@pytest.fixture(autouse=True)
def fresh_caches():
    for clear in (j_schedule_cache_clear, t_schedule_cache_clear,
                  j_selector.selector_cache_reset, t_selector.selector_cache_reset):
        clear()
    yield
    for clear in (j_schedule_cache_clear, t_schedule_cache_clear,
                  j_selector.selector_cache_reset, t_selector.selector_cache_reset):
        clear()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _both(script):
    """``script(side)`` on each side; the port's observations must equal
    the reference's."""
    want, got = script(SIDES["ref"]), script(SIDES["port"])
    assert got == want
    return got


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_backoff_delays_equal(seed):
    def script(side):
        out = []
        for kw in ({}, {"base_s": 0.01, "factor": 2.0, "max_s": 0.05, "max_attempts": 6},
                   {"base_s": 0.001, "jitter": 0.0, "max_attempts": 4}):
            pol = side.resilience.BackoffPolicy(seed=seed, **kw)
            out += [list(pol.delays(salt)) for salt in ("", "path-a", "lane:0")]
        return out

    assert any(_both(script))


def test_deadline_budget_equal():
    def script(side):
        clk = FakeClock()
        b = side.resilience.DeadlineBudget(1.0, clock=clk)
        out = []
        for dt in (0.0, 0.25, 0.5, 0.2, 0.1):
            clk.advance(dt)
            out.append((b.elapsed(), b.remaining(), b.expired(), b.clamp(0.3)))
        return out

    _both(script)


def test_circuit_breaker_transitions_equal():
    """The reference's open, half-open, close cycle, under an injected
    clock: state, admission and trip count after every call."""
    def script(side):
        clk = FakeClock()
        br = side.resilience.CircuitBreaker("t", failure_threshold=2, reset_s=1.0, clock=clk)
        out = []
        for op in ("allow", "fail", "fail", "allow", 0.5, "allow", 0.6, "allow", "fail",
                   1.1, "allow", "ok", "fail", "ok", "fail", "allow"):
            if isinstance(op, float):
                clk.advance(op)
            elif op == "allow":
                out.append(br.allow())
            else:
                (br.record_failure if op == "fail" else br.record_success)()
            out.append((br.state, br.trip_count))
        return out

    _both(script)


def test_call_with_retries_equal():
    """Success after transient failures (the seeded sleeps), exhaustion, a
    deadline budget, an open breaker."""
    def script(side):
        r = side.resilience
        out = []
        slept, state = [], {"fail": 2}

        def flaky():
            if state["fail"] > 0:
                state["fail"] -= 1
                raise OSError("transient")
            return "ok"

        out.append((r.call_with_retries(flaky, policy=r.BackoffPolicy(base_s=0.01, max_s=0.1,
                                                                      max_attempts=4),
                                        sleep=slept.append, name="t", salt="s"), slept))
        clk, calls = FakeClock(), {"n": 0}

        def slow():
            calls["n"] += 1
            clk.advance(0.6)
            raise OSError("slow failure")

        for budget in (None, r.DeadlineBudget(1.0, clock=clk)):
            calls["n"] = 0
            with pytest.raises(OSError):
                r.call_with_retries(slow, policy=r.BackoffPolicy(base_s=0.1, max_s=1.0,
                                                                 max_attempts=5),
                                    budget=budget, sleep=lambda s: None)
            out.append(calls["n"])
        br = r.CircuitBreaker("t", failure_threshold=1, reset_s=10.0, clock=clk)
        br.record_failure()
        with pytest.raises(r.BreakerOpen):
            r.call_with_retries(flaky, breaker=br, sleep=lambda s: None)
        out.append(br.state)
        return out

    _both(script)


def _plans(planner) -> dict:
    return {op: (pl.algorithm, pl.est_us, pl.candidates) for op, pl in planner.plans().items()}


def _report(rep) -> dict:
    return {k: v for k, v in rep.items() if k != "wall_s"}


EVENTS = {
    "lane": [("lane", 0)],
    "lane twice": [("lane", 0), ("lane", 0)],
    "lane then node": [("lane", 0), ("node", 1)],
    "node": [("node", 1)],
}


@pytest.mark.parametrize("mesh", [(2, 4, 2), (2, 8, 2)], ids=["2x4x2", "2x8x2"])
@pytest.mark.parametrize("events", list(EVENTS), ids=list(EVENTS))
def test_decode_planner_pins_and_replans_equal(events, mesh):
    def script(side):
        planner = side.planner.DecodePlanner(
            **{**PLANNER_KW, "num_nodes": mesh[0], "procs_per_node": mesh[1],
               "k_lanes": mesh[2]})
        out = [_plans(planner)]
        for step, (kind, node) in enumerate(EVENTS[events], 1):
            rep = planner.observe_fault(side.elastic.FaultEvent(kind=kind, node=node,
                                                                step=step))
            out += [_report(rep), _plans(planner), planner.replan_count,
                    dataclasses.asdict(planner.current_faults())]
        return out

    got = _both(script)
    assert got[-2] == len(EVENTS[events])
    assert all(r["outcome"] == "replanned" for r in got[1::4])


def test_decode_planner_at_a_given_cost():
    """``cost`` reaches every ``plan_batch`` call of the planner: its plans
    are those of ``api.plan_batch`` at that cost, and not those at None."""
    cost = t_topology.NVLINK_IB.cost
    planner = t_planner.DecodePlanner(**PLANNER_KW, cost=cost)
    assert _plans(planner) == {pl.op: (pl.algorithm, pl.est_us, pl.candidates)
                               for pl in t_api.plan_batch(planner._requests(None, None),
                                                          cost=cost)}
    assert _plans(planner) != _plans(t_planner.DecodePlanner(**PLANNER_KW))
    planner.observe_fault(t_elastic.FaultEvent(kind="lane", node=0, step=1))
    assert _plans(planner) == {
        pl.op: (pl.algorithm, pl.est_us, pl.candidates)
        for pl in t_api.plan_batch(planner._requests(planner.current_faults(), None),
                                   cost=cost)}


def test_failing_plan_batch_fn_trips_both_breakers_at_the_same_call():
    """An outage of the planning dependency: the same failing
    ``plan_batch_fn`` on each side trips its breaker at the same call, and
    both fall to the deadline-exempt base rung with the same plans."""
    def script(side):
        calls = []

        def flaky(reqs):
            calls.append((reqs[0].faults is not None, reqs[0].deadline_s == 0.0))
            if reqs[0].faults is not None and reqs[0].deadline_s != 0.0:
                raise OSError("planner outage")
            return side.api.plan_batch(reqs)

        planner = side.planner.DecodePlanner(
            **PLANNER_KW,
            backoff=side.resilience.BackoffPolicy(base_s=0.0, max_s=0.0, max_attempts=2),
            breaker=side.resilience.CircuitBreaker("test.replan", failure_threshold=3,
                                                   reset_s=30.0, clock=FakeClock()),
            plan_batch_fn=flaky)
        out = []
        for step in range(1, 4):
            rep = planner.observe_fault(side.elastic.FaultEvent(kind="lane", node=step % 2,
                                                                step=step))
            out.append((_report(rep), _plans(planner), planner.breaker.state,
                        planner.breaker.trip_count, list(calls)))
        return out

    got = _both(script)
    # the third failing call trips the breaker: the second event's retry
    assert [s for _, _, s, _, _ in got] == ["closed", "open", "open"]
    assert [r["outcome"] for r, *_ in got] == ["base-rung"] * 3


def test_straggler_monitor_observes_faults_equally():
    def script(side):
        e = side.elastic
        mon = e.StragglerMonitor(patience=3)
        out = [mon.observe(t) for t in (1.0, 1.0, 2.0, 4.0, 1.0)]
        for kind, node in (("lane", 0), ("lane", 1), ("lane", 0), ("node", 2)):
            out.append((mon.observe_fault(e.FaultEvent(kind=kind, node=node)), mon.strikes,
                        mon.warnings))
        with pytest.raises(ValueError, match="unknown fault kind"):
            e.FaultEvent(kind="rail", node=0)
        return out

    _both(script)


@pytest.mark.parametrize("num_pods,pods_lost", [(4, 0), (4, 1), (4, 3), (4, 4), (2, 1)])
def test_plan_remesh_equal(num_pods, pods_lost):
    def script(side):
        return dataclasses.asdict(side.elastic.plan_remesh(
            num_pods=num_pods, pods_lost=pods_lost, data_axis=2, model_axis=4,
            global_batch=256, last_committed_step=5))

    _both(script)


def test_plan_remesh_for_faults_equal_in_any_order():
    events = [("node", 1), ("lane", 0), ("node", 1), ("node", 3), ("lane", 2)]

    def script(side):
        e = side.elastic
        return [dataclasses.asdict(e.plan_remesh_for_faults(
            [e.FaultEvent(kind=k, node=n, step=i) for i, (k, n) in enumerate(order)],
            num_pods=4, data_axis=2, model_axis=4, global_batch=256,
            last_committed_step=9))
            for order in itertools.permutations(events[:4])]

    got = _both(script)
    assert all(g == got[0] for g in got)
