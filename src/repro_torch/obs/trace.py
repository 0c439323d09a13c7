"""Structured tracing: nested spans, a ring-buffer flight recorder, and
JSONL / Chrome trace-event exporters.

Design constraints:

* **Zero dependencies** — stdlib only; importable anywhere the package
  is, even without numpy.  torch is imported lazily, and only where it is
  already loaded: a profiler check and a device span's CUDA events.
* **Disabled fast path** — the process-wide :data:`TRACER` is falsy unless
  it is *live* (enabled, or a torch profiler is recording: one flag
  check) or a CUDA graph is being captured under :meth:`Tracer.capturing`,
  so every instrumentation site reduces to one truthiness check::

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
* **Device spans** — ``start(name, device=True)`` (or ``span``) also
  records a timed CUDA event on the current stream when the span opens
  and when it closes.  The record then carries ``dev_ts`` and ``dev_dur``
  (microseconds, on the same ``perf_counter`` clock): each event is mapped
  through the device's anchor, an event recorded on the idle device right
  after a ``synchronize`` together with its host time, as ``dev_ts =
  t_anchor - elapsed(event, anchor)``.  One anchor serves many spans: the
  engine takes a fresh one at each admission and the trainer at each step
  (``resolve(anchor=True)``); the device's clock and the host's keep pace
  (an H100 read under 5 ppm apart over 10 s).  They are ``None`` until
  :meth:`Tracer.resolve` (which :meth:`records` and the exporters also
  call), and stay ``None`` where CUDA is not in use: a CPU run writes no
  device number.
* **Profiler ranges** — while a torch profiler records, every span also
  opens ``torch.profiler.record_function("repro." + name)``, so the
  profiled trace holds the tracer's spans on the profiler's own clock.
* **Graph markers** — inside :meth:`Tracer.capturing` (a CUDA graph's
  capture), a device span records *external* timed events, which the
  graph replays, and writes no record; :meth:`Tracer.replayed` turns the
  markers of one replay into records, resolved like any device span.

Record shape (one dict per finished span / event)::

    {"name": str, "ph": "X"|"i", "ts": int_us, "dur": int_us (X only),
     "pid": int, "tid": int, "sid": int, "parent": int|None,
     "depth": int, "args": {...},
     "dev_ts": float_us|None, "dev_dur": float_us|None (device spans only)}

Span nesting is tracked per-thread (a thread-local stack): ``parent`` is
the sid of the enclosing *open* span on the same thread, ``depth`` its
nesting level.  Chrome's flame view reconstructs nesting from ts/dur
alone; ``parent``/``sid``/``depth`` make the JSONL export queryable
without interval arithmetic.

Enable programmatically (``trace.enable()``) or via ``REPRO_TRACE=1`` in
the environment.  Exporters: :meth:`Tracer.export_jsonl` (one record per
line) and :meth:`Tracer.export_chrome` (a ``{"traceEvents": [...]}``
document loadable in Perfetto / ``chrome://tracing``, the device spans on
a track of their own).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

__all__ = [
    "Span",
    "Marker",
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


#: the chrome export's track (``tid``) of the device spans
DEVICE_TID = 0
#: ``torch._C._autograd._profiler_enabled``, bound once torch is loaded
_profiler_enabled = None


def _profiling() -> bool:
    """Whether a torch profiler is recording; False while torch is not
    loaded (nothing can profile then)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled()


def _cuda():
    """``torch.cuda`` where torch is loaded and CUDA is in use, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda


def _timed_pair(cuda, external: bool = False) -> list:
    """Two timed events on the current stream, the first recorded now."""
    kw = {"external": True} if external else {}
    pair = [cuda.Event(enable_timing=True, **kw), cuda.Event(enable_timing=True, **kw)]
    pair[0].record()
    return pair


def _anchor(cuda) -> tuple:
    """An event recorded on the idle current device right after a
    ``synchronize``, and its host time (us): the midpoint of its record
    call and the wait's return."""
    cuda.synchronize()
    ev = cuda.Event(enable_timing=True)
    t0 = time.perf_counter_ns()
    ev.record()
    ev.synchronize()
    t1 = time.perf_counter_ns()
    return ev, (t0 + t1) / 2000.0


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

    __slots__ = ("name", "ts", "sid", "parent", "depth", "attrs", "keep", "timed",
                 "events", "device", "marker", "ranged")

    def __init__(self, name: str, ts: int, sid: int, parent: int | None,
                 depth: int, attrs: dict[str, Any]):
        self.name = name
        self.ts = ts
        self.sid = sid
        self.parent = parent
        self.depth = depth
        self.attrs = attrs
        self.keep = True  # write a record at finish (the tracer is live)
        self.timed = False  # a device span: its record has dev_ts / dev_dur
        self.events = None  # a device span's [start, end] CUDA events
        self.device = None  # their device index
        self.marker = None  # the graph marker's index, inside a capture
        self.ranged = None  # the open ``record_function``, while profiling


class Marker:
    """A device span captured into a CUDA graph (:meth:`Tracer.capturing`):
    its name and attributes, the index of the enclosing marker of the same
    capture (None at its top), and its external start and end events,
    which every replay of the graph records again."""

    __slots__ = ("name", "attrs", "parent", "depth", "events", "device")

    def __init__(self, name: str, attrs: dict[str, Any], parent: int | None,
                 depth: int, events: list, device: int):
        self.name = name
        self.attrs = attrs
        self.parent = parent
        self.depth = depth
        self.events = events
        self.device = device


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
        self._pending: list[tuple] = []  # (record, start, end, device) to resolve
        self._capture: int | None = None  # the capturing thread's ident
        self._markers: list[Marker] | None = None
        self._open_markers: list[int] = []
        self._anchors: dict[int, tuple] = {}  # device -> (event, host time in us)

    # -- enable/disable ----------------------------------------------------

    def __bool__(self) -> bool:
        return self._enabled or self._capture is not None or _profiling()

    @property
    def live(self) -> bool:
        """Enabled, or a torch profiler is recording: spans write records."""
        return self._enabled or _profiling()

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
            self._pending = []
            self._anchors = {}

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def start(self, name: str, device: bool = False, **attrs: Any) -> Span:
        """Open a nested span.  Pair with :meth:`finish`.  Hot sites guard
        the call site itself (``... if TRACER else None``).  ``device``: a
        device span (the module docstring), timed by CUDA events where CUDA
        is in use, or a graph marker inside :meth:`capturing`."""
        st = self._stack()
        parent = st[-1].sid if st else None
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        sp = Span(name, _now_us(), sid, parent, len(st), attrs)
        profiling = _profiling()
        sp.keep = self._enabled or profiling
        sp.timed = device
        if device:
            if self._capture == threading.get_ident():
                self._mark(sp)
            elif sp.keep:
                cuda = _cuda()
                # an event recorded inside another capture is never timed
                if cuda is not None and not cuda.is_current_stream_capturing():
                    sp.device = cuda.current_device()
                    sp.events = _timed_pair(cuda)
        if profiling:
            import torch

            sp.ranged = torch.profiler.record_function("repro." + name)
            sp.ranged.__enter__()
        st.append(sp)
        return sp

    def _mark(self, sp: Span) -> None:
        """``sp`` as the capture's next marker: external events, which the
        graph records at every replay.  It writes no record: nothing ran
        yet, and each replay's records stand for it."""
        sp.keep = False
        cuda = _cuda()
        if cuda is None:
            return
        sp.device = cuda.current_device()
        sp.events = _timed_pair(cuda, external=True)
        opened = self._open_markers
        sp.marker = len(self._markers)
        self._markers.append(Marker(sp.name, dict(sp.attrs), opened[-1] if opened else None,
                                    len(opened), sp.events, sp.device))
        opened.append(sp.marker)

    def finish(self, sp: Span, **attrs: Any) -> None:
        """Close ``sp`` and record it.  Extra ``attrs`` merge over the
        opening ones.  Tolerates out-of-order finishes (pops through)."""
        end = _now_us()
        st = self._stack()
        while st:
            top = st.pop()
            if top is sp:
                break
        if sp.events is not None:
            sp.events[1].record()
        if sp.marker is not None and self._open_markers:
            self._open_markers.pop()
        if sp.ranged is not None:
            sp.ranged.__exit__(None, None, None)
        if not sp.keep:
            return
        if attrs:
            sp.attrs.update(attrs)
        rec = {
            "name": sp.name, "ph": "X", "ts": sp.ts, "dur": end - sp.ts,
            "pid": self._pid, "tid": threading.get_ident(),
            "sid": sp.sid, "parent": sp.parent, "depth": sp.depth,
            "args": sp.attrs,
        }
        if sp.timed:
            rec["dev_ts"] = rec["dev_dur"] = None
        if sp.events is not None:
            with self._lock:
                self._pending.append((rec, sp.events[0], sp.events[1], sp.device))
        self._record(rec)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instant event (no duration).  No-ops when not live so
        coarse sites may call it unguarded."""
        if not self.live:
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

    # -- device spans ------------------------------------------------------

    @contextmanager
    def capturing(self) -> Iterator[list[Marker]]:
        """Around a CUDA graph's capture on this thread: the device spans
        opened inside become the graph's markers (the yielded list, in
        capture order) and write no record.  The tracer is truthy
        meanwhile, so every device span's site runs, live or not."""
        if self._capture is not None:
            raise RuntimeError("a capture is already open")
        markers: list[Marker] = []
        self._markers, self._open_markers = markers, []
        self._capture = threading.get_ident()
        try:
            yield markers
        finally:
            self._capture = self._markers = None
            self._open_markers = []

    def replayed(self, markers: list[Marker]) -> None:
        """Records for one replay of a graph captured with ``markers``,
        children of the span open on this thread, pending until
        :meth:`resolve`.  Live only; resolve before the graph's next
        replay, which records its events again."""
        if not self.live or not markers:
            return
        st = self._stack()
        parent = st[-1].sid if st else None
        now = _now_us()
        with self._lock:
            first = self._next_sid
            self._next_sid += len(markers)
        for i, m in enumerate(markers):
            rec = {
                "name": m.name, "ph": "X", "ts": now, "dur": 0,
                "pid": self._pid, "tid": threading.get_ident(), "sid": first + i,
                "parent": parent if m.parent is None else first + m.parent,
                "depth": len(st) + m.depth, "args": dict(m.attrs, graph=True),
                "dev_ts": None, "dev_dur": None,
            }
            with self._lock:
                self._pending.append((rec, m.events[0], m.events[1], m.device))
            self._record(rec)

    @property
    def pending(self) -> int:
        """Device spans recorded and not yet resolved."""
        return len(self._pending)

    def resolve(self, anchor: bool = False, wait: bool = False) -> None:
        """Fill ``dev_ts`` / ``dev_dur`` of every pending device span.  The
        caller has waited for the work they timed (the engine calls it after
        its readback), so their events are complete and nothing waits here;
        ``wait``: synchronize first.  Each event is mapped through its
        device's anchor; ``anchor`` takes a fresh one first (a synchronize),
        and a device without one gets one."""
        with self._lock:
            pend, self._pending = self._pending, []
        if not pend:
            return
        cuda = _cuda()
        for dev in sorted({p[3] for p in pend}):
            with cuda.device(dev):
                if anchor or dev not in self._anchors:
                    self._anchors[dev] = _anchor(cuda)
                elif wait:
                    cuda.synchronize()
            ev, t_us = self._anchors[dev]
            for rec, s, e, d in pend:
                if d == dev:
                    rec["dev_ts"] = t_us - s.elapsed_time(ev) * 1e3
                    rec["dev_dur"] = s.elapsed_time(e) * 1e3

    @contextmanager
    def _span_cm(self, name: str, device: bool, attrs: dict[str, Any]) -> Iterator[Span]:
        sp = self.start(name, device, **attrs)
        try:
            yield sp
        finally:
            self.finish(sp)

    def span(self, name: str, device: bool = False, **attrs: Any):
        """Context manager form; a shared no-op object (which yields None)
        when the tracer is falsy."""
        if not self:
            return _NULL_CM
        return self._span_cm(name, device, attrs)

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
        """Recorded span/event dicts, oldest first, device spans resolved."""
        self.resolve(wait=True)
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
        with thread scope; device spans also appear at their device times
        on a track of their own (``tid`` :data:`DEVICE_TID`), and a graph
        marker there alone.  Returns the event count."""
        events = []
        for r in self.records():
            if r.get("dev_ts") is not None:
                events.append({"name": r["name"], "cat": "repro.device", "ph": "X",
                               "ts": r["dev_ts"], "dur": r["dev_dur"], "pid": r["pid"],
                               "tid": DEVICE_TID, "args": r["args"]})
            if r["args"].get("graph"):
                continue
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
        if any(e["tid"] == DEVICE_TID for e in events):
            events.append({"name": "thread_name", "ph": "M", "pid": self._pid,
                           "tid": DEVICE_TID, "args": {"name": "device (CUDA events)"}})
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
    return TRACER.live


def span(name: str, device: bool = False, **attrs: Any):
    return TRACER.span(name, device, **attrs)


def event(name: str, **attrs: Any) -> None:
    TRACER.event(name, **attrs)


if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    TRACER.enable()
