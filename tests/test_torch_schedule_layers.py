"""The port's copies of the planner's schedule layers (``repro_torch.core``:
``schedule_ir``, ``simulate``, ``validate``, ``analyze``, ``passes``,
``faults``) against the reference's (``repro.core``), on the same grid.

Every ``(op, algorithm)`` of ``schedule.ALGORITHMS`` on the meshes (2, 4, 2),
(2, 8, 2), (3, 4, 3) and (4, 8, 4), at payloads 1, 7 and 1024, healthy, with
one dead lane and with one dead node.  Both sides run the same numpy
operations in the same order, so the tolerance is exact: arrays
``np.array_equal``, prices float ``==``, reports ``==``.  Where the
reference raises (a family that does not generate on a mesh, a fault it
cannot repair), the port must raise the same exception type and message.
The optimizer's ``PassRecord.wall_s`` is a wall-clock reading and is left
out of every comparison.
"""

from __future__ import annotations

import dataclasses
import importlib
import types

import numpy as np
import pytest

from repro.core import analyze as j_analyze
from repro.core import faults as j_faults
from repro.core import passes as j_passes
from repro.core import schedule as j_schedule
from repro.core import schedule_ir as j_ir
from repro.core import topology as j_topology
from repro.core import validate as j_validate
from repro_torch.core import analyze as t_analyze
from repro_torch.core import faults as t_faults
from repro_torch.core import passes as t_passes
from repro_torch.core import schedule_ir as t_ir
from repro_torch.core import simulate as t_simulate
from repro_torch.core import topology as t_topology
from repro_torch.core import validate as t_validate

# ``repro.core`` re-exports the function ``simulate`` under its module's name
j_simulate = importlib.import_module("repro.core.simulate")

SIDES = {
    "ref": types.SimpleNamespace(analyze=j_analyze, faults=j_faults, passes=j_passes,
                                 ir=j_ir, simulate=j_simulate, topology=j_topology,
                                 validate=j_validate),
    "port": types.SimpleNamespace(analyze=t_analyze, faults=t_faults, passes=t_passes,
                                  ir=t_ir, simulate=t_simulate, topology=t_topology,
                                  validate=t_validate),
}
OPS_ALGS = sorted(j_schedule.ALGORITHMS)
MESHES = [(2, 4, 2), (2, 8, 2), (3, 4, 3), (4, 8, 4)]
PAYLOADS = (1, 7, 1024)
FAULTS = {"healthy": None, "dead lane": {"dead_lanes": ((1, 1),)},
          "dead node": {"dead_nodes": (1,)}}
GRID = [(op, alg, mesh) for op, alg in OPS_ALGS for mesh in MESHES]
IDS = [f"{op}-{alg}-{'x'.join(map(str, mesh))}" for op, alg, mesh in GRID]
ARRAYS = ("src", "dst", "elems", "round_ptr", "blk_ptr", "blk_ids")


def _outcome(fn):
    """``("ok", value)``, or ``("raised", type name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 -- the exception is what is compared
        return ("raised", type(e).__name__, str(e))


def _spec(side, fault):
    return None if FAULTS[fault] is None else side.faults.FaultSpec(**FAULTS[fault])


def _compiled(side, op, alg, mesh, c, fault, optimize=None):
    topo = side.topology.Topology(*mesh)
    k = min(mesh[2], mesh[1])
    return _outcome(lambda: side.ir.compiled_schedule(op, alg, topo, k, c,
                                                      optimize=optimize,
                                                      faults=_spec(side, fault)))


def _machines(side, mesh, fault):
    """The mesh at the TPU v5e cost and at the NVLink/IB cost, degraded by
    ``fault``."""
    t = side.topology
    spec = _spec(side, fault)
    for cost in (t.TPU_V5E.cost, t.NVLINK_IB.cost):
        m = t.Machine(topo=t.Topology(*mesh), cost=cost)
        yield m if spec is None else side.faults.apply_faults(m, spec)


def _arrays(cs) -> dict:
    return {"op": cs.op, "algorithm": cs.algorithm, "p": cs.p, "k": cs.k,
            **{a: getattr(cs, a) for a in ARRAYS}}


def _assert_same_schedule(want, got, ctx):
    """Two outcomes of ``_compiled``: the same exception, or schedules
    equal array for array."""
    assert want[0] == got[0], (ctx, want, got)
    if want[0] == "raised":
        assert want == got, ctx
        return
    _assert_same_arrays(_arrays(want[1]), _arrays(got[1]), ctx)


def _assert_same_arrays(w: dict, g: dict, ctx):
    for name in w:
        if name in ARRAYS and w[name] is not None:
            assert g[name] is not None and np.array_equal(w[name], g[name]), (ctx, name)
            assert w[name].dtype == g[name].dtype, (ctx, name)
        else:
            assert w[name] == g[name], (ctx, name)


def _cases(op, mesh):
    for c in PAYLOADS:
        for fault in FAULTS:
            yield c, fault


@pytest.mark.parametrize("op,alg,mesh", GRID, ids=IDS)
def test_compiled_schedules_equal(op, alg, mesh):
    for c, fault in _cases(op, mesh):
        want = _compiled(SIDES["ref"], op, alg, mesh, c, fault)
        got = _compiled(SIDES["port"], op, alg, mesh, c, fault)
        _assert_same_schedule(want, got, (c, fault))
        if fault == "healthy":  # every family generates on these meshes
            assert want[0] == "ok", want


@pytest.mark.parametrize("op,alg,mesh", GRID, ids=IDS)
def test_simulate_equal_at_both_costs(op, alg, mesh):
    for c, fault in _cases(op, mesh):
        per_side = {}
        for name, side in SIDES.items():
            cs = _compiled(side, op, alg, mesh, c, fault)
            if cs[0] == "raised":
                continue
            per_side[name] = [
                _outcome(lambda m=m: dataclasses.asdict(side.simulate.simulate(cs[1], m)))
                for m in _machines(side, mesh, fault)]
            if fault == "healthy":  # the batched selector's stacked pass
                unit = _compiled(side, op, alg, mesh, 1, fault)[1]
                per_side[name] += [_outcome(lambda m=m: [
                    float(x) for x in side.simulate.simulate_payload_scaled(unit, m, PAYLOADS)])
                    for m in _machines(side, mesh, fault)] if op == "alltoall" else []
        assert per_side.get("ref") == per_side.get("port"), (c, fault)


@pytest.mark.parametrize("op,alg,mesh", GRID, ids=IDS)
def test_validation_and_analysis_reports_equal(op, alg, mesh):
    for c, fault in _cases(op, mesh):
        per_side = {}
        for name, side in SIDES.items():
            cs = _compiled(side, op, alg, mesh, c, fault)
            if cs[0] == "raised":
                continue
            cs = cs[1]
            spec = _spec(side, fault)
            machines = list(_machines(side, mesh, fault))
            per_side[name] = (
                _outcome(lambda: dataclasses.asdict(side.validate.validate_schedule(cs))),
                [_outcome(lambda m=m: side.analyze.analyze_schedule(cs, m, faults=spec).as_dict())
                 for m in machines],
                [_outcome(lambda m=m: side.analyze.certify(cs, m, c)) for m in machines],
            )
        assert per_side.get("ref") == per_side.get("port"), (c, fault)


def _records(records) -> list:
    return [{k: v for k, v in r.as_dict().items() if k != "wall_s"} for r in records]


@pytest.mark.parametrize("op,alg,mesh", GRID, ids=IDS)
def test_optimizer_pipeline_and_digest_equal(op, alg, mesh):
    """The ``opt:`` rewrite the selector races (``optimize="color"``, fault
    repair after it), the pipelines' digests, and ``optimize_schedule`` /
    ``repair_schedule`` with their pass records, at both costs."""
    for c, fault in _cases(op, mesh):
        want = _compiled(SIDES["ref"], op, alg, mesh, c, fault, optimize="color")
        got = _compiled(SIDES["port"], op, alg, mesh, c, fault, optimize="color")
        _assert_same_schedule(want, got, (c, fault, "color"))
    per_side = {}
    for name, side in SIDES.items():
        topo = side.topology.Topology(*mesh)
        digests = {mode: side.passes.mode_fingerprint(mode, topo)
                   for mode in sorted(side.passes.OPT_MODES)}
        base = _compiled(side, op, alg, mesh, 7, "healthy")
        runs = []
        if base[0] == "ok":
            for m in _machines(side, mesh, "healthy"):
                for mode in ("ported", "color"):
                    out = _outcome(lambda: side.passes.optimize_schedule(
                        base[1], mode, topo=topo, machine=m))
                    runs.append(out if out[0] == "raised"
                                else (_arrays(out[1][0]), _records(out[1][1])))
            spec = side.faults.FaultSpec(**FAULTS["dead lane"])
            out = _outcome(lambda: side.passes.repair_schedule(base[1], spec, topo=topo))
            runs.append(out if out[0] == "raised"
                        else (_arrays(out[1][0]), _records(out[1][1])))
        per_side[name] = (digests, runs)
    assert per_side["ref"][0] == per_side["port"][0]
    for w, g in zip(per_side["ref"][1], per_side["port"][1], strict=True):
        if w[0] == "raised" or g[0] == "raised":
            assert w == g
            continue
        _assert_same_arrays(w[0], g[0], "optimize")
        assert w[1] == g[1]


def _plain(x):
    """Arrays as (dtype, values), so that ``==`` compares them whole."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    return x


def test_fault_fingerprints_and_sampling_equal():
    """``FaultSpec`` fingerprints, ``degradation_of`` and the seeded
    ``sample_faults`` draw the same on both sides."""
    for mesh in MESHES:
        out = {}
        for name, side in SIDES.items():
            topo = side.topology.Topology(*mesh)
            specs = [side.faults.sample_faults(topo, seed=s, n_dead_lanes=1, n_dead_ranks=1)
                     for s in range(4)] + [_spec(side, f) for f in ("dead lane", "dead node")]
            out[name] = [(s.fingerprint(), dataclasses.asdict(s),
                          _plain(dataclasses.asdict(side.faults.degradation_of(s, topo))))
                         for s in specs]
        assert out["ref"] == out["port"], mesh
