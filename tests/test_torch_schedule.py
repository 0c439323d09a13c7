"""The port's copy of the schedule generators (``repro_torch.core.schedule``
and ``topology``) against the reference's: every generator gives the same
rounds of ``(src, dst, elems, blocks)`` messages, for every entry of
``ALGORITHMS``, at small topologies, k from 1 to 5, and several roots."""

import pytest

from repro.core import schedule as ref_sched
from repro.core import topology as ref_topo
from repro_torch.core import schedule as sched
from repro_torch.core import topology as topo

TOPOLOGIES = [(2, 4), (4, 2), (3, 3), (1, 5), (5, 1), (4, 4)]  # (nodes, procs per node)
KS = [1, 2, 3, 4, 5]


def _flat(s) -> tuple:
    """A schedule as plain data, so the two packages' classes compare."""
    return (s.op, s.algorithm, s.p, s.k,
            tuple(tuple((m.src, m.dst, m.elems, m.blocks) for m in r.msgs) for r in s.rounds))


def _outcome(make) -> tuple:
    """The schedule, or the error the generator raises, as plain data."""
    try:
        return _flat(make())
    except (ValueError, AssertionError) as e:
        return ("raises", type(e).__name__, str(e))


def test_the_registries_name_the_same_generators():
    assert sorted(sched.ALGORITHMS) == sorted(ref_sched.ALGORITHMS)
    assert sched.__all__ == ref_sched.__all__
    assert topo.__all__ == ref_topo.__all__


@pytest.mark.parametrize("nodes,ppn", TOPOLOGIES)
@pytest.mark.parametrize("key", sorted(ref_sched.ALGORITHMS), ids="-".join)
def test_every_generator_gives_the_reference_schedule(key, nodes, ppn):
    port_t = topo.Topology(nodes, ppn, min(2, ppn))
    ref_t = ref_topo.Topology(nodes, ppn, min(2, ppn))
    for k in KS:
        for c in (1, 3):
            want = _outcome(lambda: ref_sched.ALGORITHMS[key](ref_t, k, c))
            got = _outcome(lambda: sched.ALGORITHMS[key](port_t, k, c))
            assert got == want, (key, nodes, ppn, k, c)
            if got[0] != "raises":
                verify = getattr(sched, f"verify_{key[0]}")
                verify(sched.ALGORITHMS[key](port_t, k, c))


ROOTED = {  # generator name: takes a Topology (True) or p (False)
    "kported_broadcast": False, "kported_scatter": False,
    "klane_broadcast": True, "klane_scatter": True,
    "fulllane_broadcast": True, "fulllane_scatter": True,
}


@pytest.mark.parametrize("name", sorted(ROOTED))
@pytest.mark.parametrize("nodes,ppn", [(2, 4), (3, 3), (4, 4)])
def test_rooted_generators_at_several_roots(name, nodes, ppn):
    port_t = topo.Topology(nodes, ppn, min(2, ppn))
    ref_t = ref_topo.Topology(nodes, ppn, min(2, ppn))
    p = nodes * ppn
    fulllane = name.startswith("fulllane")
    for root in sorted({0, 1, ppn, p // 2, p - 1}):
        for k in [None] if fulllane else KS:
            def call(mod, t):
                gen = getattr(mod, name)
                first = t if ROOTED[name] else t.p
                args = (first, 2) if fulllane else (first, k, 2)
                return gen(*args, root=root)

            want = _outcome(lambda: call(ref_sched, ref_t))
            got = _outcome(lambda: call(sched, port_t))
            assert got == want, (name, nodes, ppn, root, k)
            if got[0] != "raises":
                getattr(sched, f"verify_{name.split('_')[1]}")(call(sched, port_t), root=root)
