"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms, and a one-call snapshot.

Always on (unlike the tracer): the instrumented sites fire per-pass,
per-compile, per-select, or per-decode-step — never per-message — so the
cost is a dict lookup + integer add.  The hot part of
:meth:`Histogram.observe` is ``bisect`` into a fixed edge tuple plus one
in-place array add: no per-event Python object allocation.

All mutation goes through one registry lock, so snapshots are coherent
and concurrent writers never lose increments (plain ``+=`` on a shared
int is not atomic under free-threading).  numpy is optional — bucket
counts degrade to a Python list when it is unavailable (the CI fast job
installs numpy, but the module must import anywhere the tracer does).

Usage::

    from repro_torch.obs import metrics
    metrics.counter("schedule_cache.hits").inc()
    metrics.histogram("engine.replan_latency_s",
                      edges=(1e-4, 1e-3, 1e-2, 1e-1, 1.0)).observe(dt)
    print(metrics.render_text())          # human snapshot
    json.dump(metrics.snapshot(), fh)     # machine snapshot
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Any

try:
    import numpy as _np
except ImportError:  # pragma: no cover - numpy is present everywhere we run
    _np = None

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "render_text",
    "reset",
    "clear",
]

_LOCK = threading.RLock()
_REGISTRY: dict[str, "Counter | Gauge | Histogram"] = {}

#: Default histogram edges: geometric seconds ladder, 10us .. 100s.
DEFAULT_EDGES = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)


class Counter:
    """Monotone counter."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        with _LOCK:
            self._value += n

    @property
    def value(self) -> int | float:
        return self._value

    def _reset(self) -> None:
        self._value = 0

    def _snapshot(self) -> dict[str, Any]:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        with _LOCK:
            self._value = v

    def add(self, dv: float) -> None:
        with _LOCK:
            self._value += dv

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0

    def _snapshot(self) -> dict[str, Any]:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram.

    ``edges`` are ascending bucket boundaries; bucket ``i`` counts values
    in ``[edges[i-1], edges[i])`` — an exact edge hit lands in the bucket
    *above* it (``bisect_right``) — with one overflow bucket above the
    last edge.  Bucket counts live in an int64 array; a scalar
    ``observe`` is a bisect + in-place add, ``observe_many`` is one
    vectorized ``searchsorted``/``bincount``.
    """

    __slots__ = ("name", "edges", "_counts", "_sum", "_n")

    def __init__(self, name: str, edges: tuple[float, ...] = DEFAULT_EDGES):
        if not edges or list(edges) != sorted(edges):
            raise ValueError("edges must be a non-empty ascending sequence")
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        nb = len(self.edges) + 1
        self._counts = (_np.zeros(nb, dtype=_np.int64) if _np is not None
                        else [0] * nb)
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        i = bisect_right(self.edges, v)
        with _LOCK:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    def observe_many(self, values) -> None:
        if _np is None:
            for v in values:
                self.observe(v)
            return
        arr = _np.asarray(values, dtype=_np.float64)
        # side="right" matches bisect_right in observe() on exact edge hits
        idx = _np.searchsorted(self.edges, arr, side="right")
        add = _np.bincount(idx, minlength=len(self.edges) + 1)
        with _LOCK:
            self._counts += add.astype(_np.int64)
            self._sum += float(arr.sum())
            self._n += int(arr.size)

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def counts(self) -> list[int]:
        with _LOCK:
            return [int(c) for c in self._counts]

    @property
    def mean(self) -> float:
        return self._sum / self._n if self._n else 0.0

    def percentile(self, q: float) -> float:
        """Bucket-resolution percentile estimate: the smallest upper edge
        whose cumulative count covers fraction ``q`` of observations
        (``q`` in [0, 1]).  Values in the overflow bucket report the last
        edge — a histogram cannot see past it.  Returns 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with _LOCK:
            n = self._n
            counts = [int(c) for c in self._counts]
        if n == 0:
            return 0.0
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                return self.edges[min(i, len(self.edges) - 1)]
        return self.edges[-1]

    def _reset(self) -> None:
        nb = len(self.edges) + 1
        if _np is not None:
            self._counts[:] = 0
        else:
            self._counts = [0] * nb
        self._sum = 0.0
        self._n = 0

    def _snapshot(self) -> dict[str, Any]:
        return {
            "type": "histogram",
            "edges": list(self.edges),
            "counts": [int(c) for c in self._counts],
            "sum": self._sum,
            "count": self._n,
            "mean": self.mean,
        }


def counter(name: str) -> Counter:
    """Get-or-create the named counter."""
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = Counter(name)
        elif not isinstance(m, Counter):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, not Counter")
        return m


def gauge(name: str) -> Gauge:
    """Get-or-create the named gauge."""
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = Gauge(name)
        elif not isinstance(m, Gauge):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, not Gauge")
        return m


def histogram(name: str, edges: tuple[float, ...] = DEFAULT_EDGES) -> Histogram:
    """Get-or-create the named histogram.  ``edges`` applies only on
    first creation; later callers get the existing instance."""
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = Histogram(name, edges)
        elif not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, not Histogram")
        return m


def snapshot() -> dict[str, dict]:
    """One coherent machine-readable snapshot of every metric."""
    with _LOCK:
        return {name: m._snapshot() for name, m in sorted(_REGISTRY.items())}


def render_text() -> str:
    """Human-readable snapshot, one metric per line."""
    lines = []
    for name, snap in snapshot().items():
        if snap["type"] == "histogram":
            lines.append(
                f"{name}  count={snap['count']} sum={snap['sum']:.6g} "
                f"mean={snap['mean']:.6g} buckets={snap['counts']}"
            )
        else:
            lines.append(f"{name}  {snap['value']}")
    return "\n".join(lines)


def reset() -> None:
    """Zero every registered metric (registry entries survive)."""
    with _LOCK:
        for m in _REGISTRY.values():
            m._reset()


def clear() -> None:
    """Drop every registered metric."""
    with _LOCK:
        _REGISTRY.clear()
