"""A traced slice of a run: ``torch.profiler`` over it, reduced to plain
records that the per-layer readers take.

``profiled(fn)`` runs ``fn`` under the profiler (host and device
activities) and returns a ``Slice``: the device's records (kernels,
copies, memsets) as ``(name, start_us, end_us)``, the benchmark's own spans
(``span(name)``, ``record_function`` ranges named ``portbench.<name>``) and
the host's operators.  Every span that the drivers open ends in a wait for
the device (sampling reads tokens back; a train step reads its loss), so a
record belongs to the span in which it starts.

The kernel-name classifier is a copy of ``launch/profile_serve.py``'s: the
port's own kernels (``kernels/csrc``), cuBLAS's GEMMs, and the rest.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

__all__ = ["Slice", "profiled", "span", "union_us", "kind", "PORT_KERNEL"]

#: the names of the port's hand-written kernels (``kernels/csrc``)
PORT_KERNEL = re.compile(r"rmsnorm|flash_|mamba_scan|a2a_pack")
#: cuBLAS's and cuBLASLt's GEMM kernels on Hopper
CUBLAS_KERNEL = re.compile(r"gemm|xmma|cutlass|cublas|nvjet|splitKreduce", re.I)
#: device records that are no kernel
COPY = re.compile(r"^(Memcpy|Memset)")
FLASH_FWD = re.compile(r"flash_fwd_kernel")
SCAN_FUSED_FWD = re.compile(r"mamba_scan_fused_kernel")
SCAN_FUSED_BWD = re.compile(r"mamba_scan_fused_bwd")
_PREFIX = "portbench."
#: a breakdown's names are cut to this many characters (templates run long)
NAME_CHARS = 160


def kind(name: str) -> str:
    """"port", "cublas", "copy" or "other" (PyTorch's own kernels)."""
    if COPY.search(name):
        return "copy"
    if PORT_KERNEL.search(name):
        return "port"
    if CUBLAS_KERNEL.search(name):
        return "cublas"
    return "other"


def span(name: str):
    """A host span the traced slice records (a no-op without a profiler)."""
    import torch

    return torch.profiler.record_function(_PREFIX + name)


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, hi = 0.0, None
    for s, e in sorted(intervals):
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total


@dataclasses.dataclass
class Slice:
    records: list  # (name, start_us, end_us) of every device record, by start
    spans: list  # (name, start_us, end_us) of the benchmark's spans, by start
    host_ops: list  # (name, start_us, end_us) of the host's operators, by start
    start_us: float
    end_us: float

    @property
    def window_us(self) -> float:
        return self.end_us - self.start_us

    def busy_us(self, records=None) -> float:
        recs = self.records if records is None else records
        return union_us((s, e) for _, s, e in recs)

    def spans_named(self, name: str) -> list:
        return [(s, e) for n, s, e in self.spans if n == name]

    def within(self, name: str) -> list:
        """The device records that start inside a span called ``name``."""
        spans = self.spans_named(name)
        starts = [s for s, _ in spans]
        out = []
        for rec in self.records:
            i = bisect.bisect_right(starts, rec[1]) - 1
            if i >= 0 and rec[1] <= spans[i][1]:
                out.append(rec)
        return out

    def idle_by_host(self, top: int = 10) -> list:
        """The device's idle time inside the slice, summed by what the host
        was doing at each gap's middle (the innermost host operator or span
        then running), largest first."""
        busy = sorted((s, e) for _, s, e in self.records)
        gaps, hi = [], self.start_us
        for s, e in busy:
            if s > hi:
                gaps.append((hi, s))
            hi = max(hi, e)
        if self.end_us > hi:
            gaps.append((hi, self.end_us))
        host = sorted(self.host_ops + [(_PREFIX + n, s, e) for n, s, e in self.spans],
                      key=lambda r: r[1])
        starts = [h[1] for h in host]
        by = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid) - 1
            name = "(no host operator)"
            for j in range(i, max(-1, i - 400), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            by[name] = by.get(name, 0.0) + (g1 - g0)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:NAME_CHARS], us / 1e6] for n, us in ranked]

    def top_device_ops(self, top: int = 10) -> list:
        by = {}
        for n, s, e in self.records:
            by[n] = by.get(n, 0.0) + (e - s)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:NAME_CHARS], us / 1e6] for n, us in ranked]


def profiled(fn) -> tuple:
    """``(fn(), Slice)``: ``fn`` run under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("traced"):
            out = fn()
        torch.cuda.synchronize()
    records, spans, host = [], [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                records.append((e.name, float(tr.start), float(tr.end)))
        elif e.name.startswith(_PREFIX):
            spans.append((e.name[len(_PREFIX):], float(tr.start), float(tr.end)))
        else:
            host.append((e.name, float(tr.start), float(tr.end)))
    records.sort(key=lambda r: r[1])
    spans.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    whole = [(s, e) for n, s, e in spans if n == "traced"]
    start, end = whole[0] if whole else (records[0][1], records[-1][2])
    spans = [r for r in spans if r[0] != "traced"]
    return out, Slice(records, spans, host, start, end)

