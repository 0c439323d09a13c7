"""Structured tracing: nested spans, a ring-buffer flight recorder, and
JSONL / Chrome trace-event exporters.

Design constraints:

* **Zero dependencies** — stdlib only; importable anywhere the package
  is, even without numpy.
* **Disabled fast path** — the process-wide :data:`TRACER` is falsy when
  disabled, so every instrumentation site reduces to one truthiness
  check::

      sp = TRACER.start("compile", op=op) if TRACER else None
      ...
      if sp:
          TRACER.finish(sp, outcome="built")

  Coarse (non-hot) sites can use the ``span()`` context manager or
  ``event()`` helpers instead, which no-op internally on the same check.
* **Flight recorder** — finished spans and instant events land in a
  preallocated ring buffer (default 65536 records); when full, the
  oldest records are overwritten, so the recorder always holds the most
  recent pipeline activity for forensics dumps.
* **Monotonic clock** — timestamps are ``time.perf_counter_ns() // 1000``
  microseconds, matching Chrome trace-event ``ts``/``dur`` units.

Record shape (one dict per finished span / event)::

    {"name": str, "ph": "X"|"i", "ts": int_us, "dur": int_us (X only),
     "pid": int, "tid": int, "sid": int, "parent": int|None,
     "depth": int, "args": {...}}

Span nesting is tracked per-thread (a thread-local stack): ``parent`` is
the sid of the enclosing *open* span on the same thread, ``depth`` its
nesting level.  Chrome's flame view reconstructs nesting from ts/dur
alone; ``parent``/``sid``/``depth`` make the JSONL export queryable
without interval arithmetic.

Enable programmatically (``trace.enable()``) or via ``REPRO_TRACE=1`` in
the environment.  Exporters: :meth:`Tracer.export_jsonl` (one record per
line) and :meth:`Tracer.export_chrome` (a ``{"traceEvents": [...]}``
document loadable in Perfetto / ``chrome://tracing``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

__all__ = [
    "Span",
    "Tracer",
    "TRACER",
    "enable",
    "disable",
    "enabled",
    "span",
    "event",
    "json_default",
]


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


def json_default(obj: Any) -> Any:
    """``json.dumps(default=...)`` hook: numpy scalars/arrays and other
    non-JSON attribute values degrade to something serializable instead
    of killing an export or a forensics dump."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return obj.item()
        except (TypeError, ValueError):
            pass
    tolist = getattr(obj, "tolist", None)
    if callable(tolist):
        try:
            return obj.tolist()
        except (TypeError, ValueError):
            pass
    return repr(obj)


class Span:
    """An open span handle returned by :meth:`Tracer.start`.

    Mutable on purpose: ``finish()`` merges closing attributes into
    ``attrs`` and stamps ``dur``.  Never recorded itself — ``finish``
    writes a plain dict into the ring buffer.
    """

    __slots__ = ("name", "ts", "sid", "parent", "depth", "attrs")

    def __init__(self, name: str, ts: int, sid: int, parent: int | None,
                 depth: int, attrs: dict[str, Any]):
        self.name = name
        self.ts = ts
        self.sid = sid
        self.parent = parent
        self.depth = depth
        self.attrs = attrs


class _NullCM:
    """Shared no-op context manager for disabled ``span()`` calls."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CM = _NullCM()


class Tracer:
    """Process-wide flight recorder.  Falsy while disabled."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._enabled = False
        self._lock = threading.Lock()
        self._cap = capacity
        self._ring: list[dict | None] = [None] * capacity
        self._idx = 0          # next write slot
        self._total = 0        # records ever written (monotone; wraparound
        #                        detection + records_since marks)
        self._next_sid = 0
        self._tls = threading.local()
        self._pid = os.getpid()

    # -- enable/disable ----------------------------------------------------

    def __bool__(self) -> bool:
        return self._enabled

    def enable(self, capacity: int | None = None) -> None:
        """Turn the tracer on.  ``capacity`` (if given) resizes and clears
        the ring buffer; otherwise existing records are kept."""
        with self._lock:
            if capacity is not None and capacity != self._cap:
                if capacity < 1:
                    raise ValueError("capacity must be >= 1")
                self._cap = capacity
                self._ring = [None] * capacity
                self._idx = 0
                self._total = 0
            self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self._cap
            self._idx = 0
            self._total = 0

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def start(self, name: str, **attrs: Any) -> Span:
        """Open a nested span.  Pair with :meth:`finish`.  Hot sites guard
        the call site itself (``... if TRACER else None``)."""
        st = self._stack()
        parent = st[-1].sid if st else None
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        sp = Span(name, _now_us(), sid, parent, len(st), attrs)
        st.append(sp)
        return sp

    def finish(self, sp: Span, **attrs: Any) -> None:
        """Close ``sp`` and record it.  Extra ``attrs`` merge over the
        opening ones.  Tolerates out-of-order finishes (pops through)."""
        end = _now_us()
        st = self._stack()
        while st:
            top = st.pop()
            if top is sp:
                break
        if attrs:
            sp.attrs.update(attrs)
        self._record({
            "name": sp.name, "ph": "X", "ts": sp.ts, "dur": end - sp.ts,
            "pid": self._pid, "tid": threading.get_ident(),
            "sid": sp.sid, "parent": sp.parent, "depth": sp.depth,
            "args": sp.attrs,
        })

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instant event (no duration).  No-ops when disabled so
        coarse sites may call it unguarded."""
        if not self._enabled:
            return
        st = self._stack()
        parent = st[-1].sid if st else None
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        self._record({
            "name": name, "ph": "i", "ts": _now_us(),
            "pid": self._pid, "tid": threading.get_ident(),
            "sid": sid, "parent": parent, "depth": len(st),
            "args": attrs,
        })

    @contextmanager
    def _span_cm(self, name: str, attrs: dict[str, Any]) -> Iterator[Span]:
        sp = self.start(name, **attrs)
        try:
            yield sp
        finally:
            self.finish(sp)

    def span(self, name: str, **attrs: Any):
        """Context manager form; a shared no-op object when disabled."""
        if not self._enabled:
            return _NULL_CM
        return self._span_cm(name, attrs)

    def _record(self, rec: dict) -> None:
        with self._lock:
            self._ring[self._idx] = rec
            self._idx = (self._idx + 1) % self._cap
            self._total += 1

    # -- reading -----------------------------------------------------------

    def mark(self) -> int:
        """Opaque position marker for :meth:`records_since`."""
        with self._lock:
            return self._total

    @property
    def total(self) -> int:
        """Records ever written (monotone; exceeds ``capacity`` after
        wraparound)."""
        return self._total

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def dropped(self) -> int:
        """Records overwritten by ring wraparound."""
        with self._lock:
            return max(0, self._total - self._cap)

    def records(self) -> list[dict]:
        """Recorded span/event dicts, oldest first."""
        with self._lock:
            if self._total <= self._cap:
                out = self._ring[: self._total]
            else:
                out = self._ring[self._idx:] + self._ring[: self._idx]
        return [r for r in out if r is not None]

    def records_since(self, mark: int) -> list[dict]:
        """Records written after ``mark`` (a prior :meth:`mark` value)
        that are still in the ring."""
        recs = self.records()
        with self._lock:
            first = max(0, self._total - self._cap)  # total-index of recs[0]
        skip = max(0, mark - first)
        return recs[skip:]

    # -- export ------------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        """One record per line; returns the record count."""
        recs = self.records()
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r, default=json_default) + "\n")
        return len(recs)

    def export_chrome(self, path: str) -> int:
        """Chrome trace-event format (Perfetto / ``chrome://tracing``).
        Spans become complete ("X") events; instant events use ph="i"
        with thread scope.  Returns the event count."""
        events = []
        for r in self.records():
            ev = {
                "name": r["name"], "cat": "repro", "ph": r["ph"],
                "ts": r["ts"], "pid": r["pid"], "tid": r["tid"],
                "args": r["args"],
            }
            if r["ph"] == "X":
                ev["dur"] = r["dur"]
            else:
                ev["s"] = "t"
            events.append(ev)
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f, default=json_default)
        return len(events)


#: The process-wide flight recorder every pipeline site guards on.
TRACER = Tracer()


def enable(capacity: int | None = None) -> None:
    TRACER.enable(capacity)


def disable() -> None:
    TRACER.disable()


def enabled() -> bool:
    return bool(TRACER)


def span(name: str, **attrs: Any):
    return TRACER.span(name, **attrs)


def event(name: str, **attrs: Any) -> None:
    TRACER.event(name, **attrs)


if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    TRACER.enable()
