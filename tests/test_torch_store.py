"""The port's schedule store (``repro_torch.store``) against the reference's
(``repro.store``): round trips under ``tmp_path`` roots, stores written by one
package and warm-started by the other bit for bit (the on-disk layout, the
keys and the pipeline digests are the reference's), and the read-race count,
the IO fault injector and the quarantine behaving as the reference's on the
cases of ``tests/test_store.py``, each case run on both sides and its
observations compared."""

from __future__ import annotations

import errno
import types

import numpy as np
import pytest

from repro.core import faults as j_faults
from repro.core import resilience as j_resilience
from repro.core import schedule_ir as j_ir
from repro.core import selector as j_selector
from repro.core import topology as j_topology
from repro.store import artifacts as j_artifacts
from repro_torch.core import faults as t_faults
from repro_torch.core import resilience as t_resilience
from repro_torch.core import schedule_ir as t_ir
from repro_torch.core import selector as t_selector
from repro_torch.core import topology as t_topology
from repro_torch.store import artifacts as t_artifacts

SIDES = {
    "ref": types.SimpleNamespace(ir=j_ir, selector=j_selector, topology=j_topology,
                                 artifacts=j_artifacts, resilience=j_resilience,
                                 faults=j_faults),
    "port": types.SimpleNamespace(ir=t_ir, selector=t_selector, topology=t_topology,
                                  artifacts=t_artifacts, resilience=t_resilience,
                                  faults=t_faults),
}
FAMILIES = ("kported", "bruck", "klane", "fulllane")
ARRAYS = ("src", "dst", "elems", "round_ptr", "blk_ptr", "blk_ids")


def _arrays(cs) -> dict:
    return {a: getattr(cs, a) for a in ARRAYS if getattr(cs, a) is not None}


def _assert_identical(a: dict, b: dict, ctx=""):
    assert set(a) == set(b), ctx
    for name in a:
        assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), \
            (ctx, name)


def _population(side):
    """Every alltoall family, broadcast and scatter, one optimized entry and
    one fault-repaired entry (the reference's store tests' population)."""
    spec = side.faults.FaultSpec(dead_lanes=((1, 1),))
    topo = side.topology.Topology(2, 8, 2)
    for fam in FAMILIES:
        side.ir.compiled_schedule("alltoall", fam, topo, 2, 87)
    side.ir.compiled_schedule("broadcast", "kported", topo, 2, 4096)
    side.ir.compiled_schedule("scatter", "klane", topo, 2, 512)
    side.ir.compiled_schedule("alltoall", "klane", topo, 2, 869, optimize="color")
    side.ir.compiled_schedule("alltoall", "fulllane", topo, 2, 87, faults=spec)


def _forget(side):
    """A simulated restart: the process remembers nothing."""
    side.ir.schedule_cache_clear()
    side.selector.selector_cache_reset()


@pytest.fixture(autouse=True)
def fresh_caches():
    for side in SIDES.values():
        _forget(side)
    yield
    for side in SIDES.values():
        _forget(side)
        side.artifacts.set_io_fault_injector(None)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("ref", "port"),
                                           ("port", "ref")])
def test_store_written_by_one_side_warm_starts_the_other(writer, reader, tmp_path):
    w, r = SIDES[writer], SIDES[reader]
    _population(w)
    counts = w.artifacts.ArtifactStore(tmp_path / "store").persist_cache()
    entries, recipes = w.ir.cache_export()
    assert (counts["schedules"], counts["recipes"]) == (len(entries), len(recipes)) != (0, 0)
    want = {key: _arrays(cs) for key, cs in entries.items()}
    replay = _arrays(w.ir.compiled_schedule("alltoall", "klane", w.topology.Topology(2, 8, 2),
                                            2, 123, optimize="color"))
    _forget(w)

    store = r.artifacts.ArtifactStore(tmp_path / "store")
    report = store.warm_start()
    assert report["schedules"] == report["seeded"] == len(want)
    assert report["recipes"] == len(recipes)
    assert report["evicted"] == report["corrupt"] == 0
    warmed, _ = r.ir.cache_export()
    assert set(warmed) == set(want)
    for key, arrs in want.items():
        _assert_identical(_arrays(warmed[key]), arrs, key)
        _assert_identical(_arrays(store.get_schedule(key)), arrs, key)
    # the same queries are all hits; an optimized one at a payload the store
    # never saw replays the stored recipe to the writer's bits
    r.ir.schedule_cache_reset()
    _population(r)
    info = r.ir.schedule_cache_info()
    assert info["misses"] == 0 and info["store_recompiles"] == 0 and info["hits"] > 0
    got = _arrays(r.ir.compiled_schedule("alltoall", "klane", r.topology.Topology(2, 8, 2), 2,
                                         123, optimize="color"))
    assert r.ir.schedule_cache_info()["recipe_hits"] > info["recipe_hits"]
    _assert_identical(got, replay, "recipe replay")


def test_store_layout_and_names_equal(tmp_path):
    """Both packages write the same files under the same names, and read
    each other's headers: the default root and ``REPRO_STORE`` too."""
    files = {}
    for name, side in SIDES.items():
        _population(side)
        store = side.artifacts.ArtifactStore(tmp_path / name)
        store.persist_cache()
        files[name] = sorted(str(p.relative_to(tmp_path / name))
                             for p in (tmp_path / name).rglob("*") if p.is_file())
        assert [e["key"] for e in store.entries()] == [
            e["key"] for e in SIDES["ref"].artifacts.ArtifactStore(tmp_path / name).entries()]
    assert files["ref"] == files["port"]
    assert t_artifacts.STORE_SCHEMA_VERSION == j_artifacts.STORE_SCHEMA_VERSION
    assert t_artifacts.default_store_root() == j_artifacts.default_store_root()


def _torn(side, root) -> list:
    _population(side)
    store = side.artifacts.ArtifactStore(root)
    store.persist_cache()
    entries, _ = side.ir.cache_export()
    key = sorted(entries, key=repr)[0]
    path = store._sched_path(key)
    races0 = side.artifacts.read_race_count()
    path.write_bytes(b"PK\x03\x04 torn mid-evict")
    obs = [store.get_schedule(key) is None, path.exists(),
           side.artifacts.read_race_count() - races0,
           side.ir.schedule_cache_info()["store_read_races"] - races0]
    obs.append(store.put_schedule(key, entries[key]) is not None)
    obs.append({k: v.tolist() for k, v in _arrays(store.get_schedule(key)).items()})
    return obs


def _enoent(side, root) -> list:
    _population(side)
    store = side.artifacts.ArtifactStore(root)
    store.persist_cache()
    entries, _ = side.ir.cache_export()
    key = sorted(entries, key=repr)[0]
    races0 = side.artifacts.read_race_count()

    def vanish(op, path):  # the evictor wins between exists() and load
        if op == "read":
            raise FileNotFoundError(path)

    side.artifacts.set_io_fault_injector(vanish)
    try:
        obs = [store.get_schedule(key) is None]
    finally:
        side.artifacts.set_io_fault_injector(None)
    obs.append(side.artifacts.read_race_count() - races0)
    obs.append({k: v.tolist() for k, v in _arrays(store.get_schedule(key)).items()})
    return obs


def _quarantine(side, root) -> list:
    _population(side)
    side.artifacts.ArtifactStore(root).persist_cache()
    entries, _ = side.ir.cache_export()
    key, other = sorted(entries, key=repr)[:2]
    flaky = side.artifacts.ArtifactStore(
        root, retry=side.resilience.BackoffPolicy(base_s=0.0, max_s=0.0, max_attempts=2),
        quarantine_after=2)
    victim = str(flaky._sched_path(key))
    calls = {"n": 0}

    def eio(op, path):
        if op == "read" and path == victim:
            calls["n"] += 1
            raise OSError(errno.EIO, "bad sector", path)

    side.artifacts.set_io_fault_injector(eio)
    obs = []
    try:
        for _ in range(3):
            obs.append((flaky.get_schedule(key) is None, calls["n"],
                        victim in flaky.quarantine_info()["quarantined"]))
    finally:
        side.artifacts.set_io_fault_injector(None)
    obs.append(flaky.get_schedule(other) is not None)
    return obs


def _bounds(side, root) -> list:
    _population(side)
    store = side.artifacts.ArtifactStore(root)
    store.persist_cache()
    n = len(store.entries())
    return [n, side.artifacts.ArtifactStore(root, max_entries=2).enforce_bounds(),
            len(store.entries()), side.artifacts.ArtifactStore(root).enforce_bounds()]


@pytest.mark.parametrize("case", [_torn, _enoent, _quarantine, _bounds],
                         ids=["torn artifact", "ENOENT mid-read", "quarantine",
                              "LRU bounds"])
def test_store_faults_behave_as_the_reference(case, tmp_path):
    want = case(SIDES["ref"], tmp_path / "ref")
    got = case(SIDES["port"], tmp_path / "port")
    assert got == want
