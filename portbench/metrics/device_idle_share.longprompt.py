"""The device's idle share while the traced wave is served: one less its
busy time under the profiler (the union of every device record) over the
same wave's wall time served again without the profiler (so the
profiler's own host time stays out)."""

LAYER, UNIT = "device", "%"
MOVES = "ttft_p95_ms"


def read(rec: dict):
    sl, plain = rec.get("slice"), rec.get("plain")
    if sl is None or not plain:
        return None
    wall = plain["end"] - plain["start"]
    return 100.0 * (1.0 - sl.busy_us() / 1e6 / wall)
