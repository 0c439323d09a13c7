"""Device time of one decode step (the engine's ``step``: the captured
graph's replay, sampling and the next tokens' copy), averaged over the
traced wave's steps, from the profiler's records."""

LAYER, UNIT, MOVES = "decode step", "ms", "itl_p95_ms"


def read(rec: dict):
    sl, traced = rec.get("slice"), rec.get("traced")
    if sl is None or not traced or not traced["steps"]:
        return None
    recs = sl.within("step")
    if not recs:
        return None
    return sl.busy_us(recs) / traced["steps"] / 1e3
