"""Observability: the port's own copies of the reference's stdlib-only
``obs/trace.py`` (span flight recorder), ``obs/metrics.py`` (counters,
gauges, histograms) and ``obs/forensics.py`` (the flight recorder and a
metrics snapshot dumped to a ``*.forensics.json`` artifact when an oracle
or analyzer check fails, once armed by ``forensics.enable`` or
``REPRO_FORENSICS``).  The serving engine records its ``decode_step``
spans and its ``engine.step_latency_s`` histogram through them, and the
planner's layers their compile, select and replan spans."""

from repro_torch.obs import forensics, metrics, trace

__all__ = ["trace", "metrics", "forensics"]
