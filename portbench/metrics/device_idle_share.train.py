"""The device's idle share over a train step: one less the traced step's
busy time under the profiler (the union of every device record) over the
wall time of the step before it, run without the profiler."""

LAYER, UNIT, MOVES = "device", "%", "train_tokens_per_s"


def read(rec: dict):
    sl = rec.get("slice")
    if sl is None or not rec.get("plain_s"):
        return None
    return 100.0 * (1.0 - sl.busy_us() / 1e6 / rec["plain_s"])
