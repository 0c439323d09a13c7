"""The program's own spans in a traced slice: the records of the port's
tracer (``src/repro_torch/obs/trace.py``) written while the slice was
profiled, their device intervals put on the profiler's clock, and the
device's busy time inside them.

While a profiler records, the tracer is live: every span it opens is also a
``record_function`` range named ``repro.<span>``, which the slice holds
among its host operators, and a device span carries its device interval
(``dev_ts``, ``dev_dur``, from CUDA events) on the tracer's own clock.  The
tracer's clock is put on the profiler's through a host span that both hold
(``ANCHORS``): the median offset between the slice's ranges of that name
and the tracer's last records of it, which the drivers write last.  One
offset serves the whole slice: on an H100 the tracer's clock, the
profiler's host and device records and CUDA events kept pace to under 5
ppm over 10 s.  (The slice keeps no device-side ``repro.<span>``
annotations, which would need no offset.)  A program without such spans (a
parent commit, the CPU) gives no view, and its readers return None.
"""

from __future__ import annotations

import bisect

__all__ = ["ANCHORS", "View", "tracer_records", "view", "busy_in"]

#: host spans, each held by the tracer and the profiler, that map the clocks
ANCHORS = ("engine.step", "train.step")
RANGE = "repro."


def tracer_records() -> list:
    """The program tracer's records (its device spans resolved)."""
    from repro_torch.obs.trace import TRACER

    return TRACER.records()


class View:
    """The tracer's records inside a slice, their times on the profiler's
    clock (``offset`` added)."""

    def __init__(self, recs: list, every: list, offset: float):
        self.recs = recs
        self.offset = offset
        self._by_sid = {r["sid"]: r for r in every}

    def named(self, name: str) -> list:
        return [r for r in self.recs if r["name"] == name]

    def under(self, name: str, ancestor: str) -> list:
        """The records called ``name`` that have an ancestor ``ancestor``."""
        out = []
        for r in self.named(name):
            p = self._by_sid.get(r["parent"])
            while p is not None and p["name"] != ancestor:
                p = self._by_sid.get(p["parent"])
            if p is not None:
                out.append(r)
        return out

    def device_intervals(self, recs: list) -> list | None:
        """``(start, end)`` of each record's device span on the profiler's
        clock; None if any has no device time (the CPU, or no events)."""
        if any(r.get("dev_ts") is None for r in recs):
            return None
        out = []
        for r in recs:
            s = r["dev_ts"] + self.offset
            out.append((s, s + r["dev_dur"]))
        return out


def _offset(sl, recs: list) -> float | None:
    for name in ANCHORS:
        prof = sorted(s for n, s, _ in sl.host_ops if n == RANGE + name)
        mine = sorted(r["ts"] for r in recs if r["name"] == name and r["ph"] == "X")
        if prof and len(mine) >= len(prof):
            diffs = sorted(p - m for p, m in zip(prof, mine[-len(prof):]))
            return diffs[len(diffs) // 2]
    return None


def view(sl, records: list | None = None) -> View | None:
    """The tracer's records inside ``sl``, or None where the program wrote
    none there.  ``records``: the tracer's (default: ``tracer_records()``)."""
    if sl is None:
        return None
    every = tracer_records() if records is None else records
    offset = _offset(sl, every)
    if offset is None:
        return None
    inside = [r for r in every if r["ph"] == "X"
              and sl.start_us <= r["ts"] + offset <= sl.end_us]
    return View(inside, every, offset)


def busy_in(sl, intervals: list) -> float:
    """The device's busy time (us) over the slice's device records whose
    midpoint falls inside one of ``intervals``: the union of those records."""
    ivs = sorted(intervals)
    starts = [s for s, _ in ivs]
    reach, hi = [], float("-inf")  # the furthest end among the intervals up to each
    for _, e in ivs:
        hi = max(hi, e)
        reach.append(hi)
    picked = []
    for rec in sl.records:
        mid = 0.5 * (rec[1] + rec[2])
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= reach[i]:
            picked.append(rec)
    return sl.busy_us(picked)
