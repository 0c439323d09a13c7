"""Observability: the port's own copies of the reference's stdlib-only
``obs/trace.py`` (span flight recorder), ``obs/metrics.py`` (counters,
gauges, histograms) and ``obs/forensics.py`` (the flight recorder and a
metrics snapshot dumped to a ``*.forensics.json`` artifact when an oracle
or analyzer check fails, once armed by ``forensics.enable`` or
``REPRO_FORENSICS``).  The port's tracer also times device spans with CUDA
events, is live whenever a torch profiler records, and marks the captured
decode step; the serving engine, the mixers and the train step record
their spans through it (``serving/engine.py``, ``models/attention.py``,
``models/mamba.py``, ``training/train_step.py``), the engine counts slots,
tokens and prefill positions in the registry, and the planner's layers
record their compile, select and replan spans."""

from repro_torch.obs import forensics, metrics, trace

__all__ = ["trace", "metrics", "forensics"]
