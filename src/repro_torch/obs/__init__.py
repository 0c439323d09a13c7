"""Observability: the port's own copies of the reference's stdlib-only
``obs/trace.py`` (span flight recorder) and ``obs/metrics.py`` (counters,
gauges, histograms).  The serving engine records its ``decode_step`` spans
and its ``engine.step_latency_s`` histogram through them."""

from repro_torch.obs import metrics, trace

__all__ = ["trace", "metrics"]
