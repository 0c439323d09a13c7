"""The port's planning API (``repro_torch.api``: ``plan``, ``plan_batch``,
``explain``) and its selector against the reference's, on a grid of requests.

Every op on the meshes (2, 4, 2), (2, 8, 2) and (3, 4, 3), at payloads 1, 7
and 1024, healthy, with one dead lane and with one dead node, with and
without ``opt:`` candidates (``optimize=False``), and at ``deadline_s`` None
and 0.0 (the deadline-exempt base rung: any other deadline makes the answer
depend on the wall clock).  Both sides run the same numpy operations in the
same order, so the tolerance is exact: ``Plan.as_dict()`` ``==``, prices
float ``==``, schedules ``np.array_equal``.  ``Decision.wall_s`` is a
wall-clock reading and is left out.  A decision on a dead node prices every
candidate at ``inf``, so its margin is ``nan``: decisions compare by their
``repr``, which is exact for every float and equal for two ``nan``.

With ``cost=None`` the port prices at the reference's TPU v5e costs and must
equal it.  With ``cost=NVLINK_IB.cost`` it must equal the reference run with
``repro.core.selector._machine_for`` patched, in the test, to price at that
cost; both selectors' caches are cleared around it.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro import api as j_api
from repro.core import faults as j_faults
from repro.core import selector as j_selector
from repro.core import topology as j_topology
from repro_torch import api as t_api
from repro_torch.core import faults as t_faults
from repro_torch.core import selector as t_selector
from repro_torch.core import topology as t_topology

OPS = ("broadcast", "scatter", "alltoall")
MESHES = [(2, 4, 2), (2, 8, 2), (3, 4, 3)]
PAYLOADS = (1, 7, 1024)
FAULTS = (None, {"dead_lanes": ((1, 1),)}, {"dead_nodes": (1,)})
GRID = [(op, mesh) for op in OPS for mesh in MESHES]
IDS = [f"{op}-{'x'.join(map(str, mesh))}" for op, mesh in GRID]


def _requests(api, faults_mod, op, mesh) -> list:
    nn, ppn, kl = mesh
    return [api.PlanRequest(op, c, num_nodes=nn, procs_per_node=ppn, k_lanes=kl,
                            faults=None if f is None else faults_mod.FaultSpec(**f),
                            deadline_s=d, optimize=o)
            for c in PAYLOADS for f in FAULTS for o in (True, False) for d in (None, 0.0)]


def _decision(d) -> str:
    return repr({k: v for k, v in d.as_dict().items() if k != "wall_s"})


@pytest.fixture
def fresh_selectors():
    j_selector.selector_cache_reset()
    t_selector.selector_cache_reset()
    yield
    j_selector.selector_cache_reset()
    t_selector.selector_cache_reset()


@pytest.fixture
def reference_at_nvlink_cost(monkeypatch, fresh_selectors):
    """The reference's selector pricing at ``NVLINK_IB.cost``."""
    def machine_for(num_nodes, procs_per_node, k_lanes):
        return j_topology.Machine(topo=j_topology.Topology(num_nodes, procs_per_node, k_lanes),
                                  cost=j_topology.NVLINK_IB.cost)

    monkeypatch.setattr(j_selector, "_machine_for", machine_for)


def _check_against_reference(op, mesh, cost):
    jreqs = _requests(j_api, j_faults, op, mesh)
    treqs = _requests(t_api, t_faults, op, mesh)
    for jr, tr in zip(jreqs, treqs, strict=True):
        assert tr.as_dict() == jr.as_dict() and hash(tr) == hash(jr)
        want = j_api.plan(jr)
        got = t_api.plan(tr, cost=cost)
        assert got.as_dict() == want.as_dict(), jr
        assert _decision(t_api.explain(tr, cost=cost)) == _decision(j_api.explain(jr)), jr
    got = [p.as_dict() for p in t_api.plan_batch(treqs, cost=cost)]
    assert got == [p.as_dict() for p in j_api.plan_batch(jreqs)]
    assert got == [t_api.plan(r, cost=cost).as_dict() for r in treqs]


@pytest.mark.parametrize("op,mesh", GRID, ids=IDS)
def test_plan_batch_and_explain_equal_the_reference(op, mesh, fresh_selectors):
    _check_against_reference(op, mesh, None)


@pytest.mark.parametrize("op,mesh", GRID, ids=IDS)
def test_plan_at_nvlink_cost_equals_the_reference_at_that_cost(op, mesh,
                                                               reference_at_nvlink_cost):
    _check_against_reference(op, mesh, t_topology.NVLINK_IB.cost)


@pytest.mark.parametrize("op", OPS)
def test_tpu_cost_given_equals_cost_none(op, fresh_selectors):
    """``cost=None`` is the reference's TPU v5e cost, and the NVLink/IB cost
    prices otherwise."""
    reqs = _requests(t_api, t_faults, op, (2, 8, 2))
    none = [p.as_dict() for p in t_api.plan_batch(reqs)]
    assert none == [p.as_dict() for p in t_api.plan_batch(reqs, cost=t_topology.TPU_V5E.cost)]
    nv = [p.as_dict() for p in t_api.plan_batch(reqs, cost=t_topology.NVLINK_IB.cost)]
    assert [p["est_us"] for p in nv] != [p["est_us"] for p in none]


@pytest.mark.parametrize("op,mesh", GRID, ids=IDS)
def test_plan_schedule_equals_the_reference(op, mesh, fresh_selectors):
    """``Plan.schedule()`` does not depend on the cost: the winner at either
    cost materialises the reference's schedule for the same algorithm."""
    jreqs = _requests(j_api, j_faults, op, mesh)[::4]  # deadline None, optimize True
    treqs = _requests(t_api, t_faults, op, mesh)[::4]
    for jr, tr in zip(jreqs, treqs, strict=True):
        for cost in (None, t_topology.NVLINK_IB.cost):
            got = t_api.plan(tr, cost=cost)
            want = j_api.compiled_schedule(jr, got.algorithm)
            cs = got.schedule()
            for name in ("src", "dst", "elems", "round_ptr", "blk_ptr", "blk_ids"):
                assert np.array_equal(getattr(cs, name), getattr(want, name)), (jr, name)


@pytest.mark.parametrize("op", OPS)
def test_crossover_table_and_fits_equal_the_reference(op, reference_at_nvlink_cost):
    """``crossover_table``, ``affine_cost`` and ``piecewise_cost`` at the
    NVLink/IB cost, against the patched reference."""
    mesh = {"num_nodes": 2, "procs_per_node": 8, "k_lanes": 2}
    sizes = [1, 16, 256, 4096]
    cost = t_topology.NVLINK_IB.cost
    assert t_selector.crossover_table(op, sizes, **mesh, cost=cost) == \
        j_selector.crossover_table(op, sizes, **mesh)
    for alg in ("kported", "opt:kported"):
        args = (op, alg, 1, 4096, 2, 8, 2)
        assert t_selector.affine_cost(*args, cost=cost) == j_selector.affine_cost(*args)
        assert t_selector.piecewise_cost(*args, cost=cost) == j_selector.piecewise_cost(*args)


def test_select_batch_equals_select(fresh_selectors):
    """The batched selector's answer per query equals ``select``'s, at both
    costs (the reference's own contract, held on the port)."""
    queries = [(op, c, 2, 8, 2) for op in OPS for c in (1, 7, 1024, 4096)]
    for cost in (None, t_topology.NVLINK_IB.cost):
        got = t_selector.select_batch(queries, cost=cost)
        assert got == [t_selector.select(op, c, num_nodes=nn, procs_per_node=ppn,
                                         k_lanes=kl, cost=cost)
                       for op, c, nn, ppn, kl in queries]
