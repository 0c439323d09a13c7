"""Device time of the traced wave's admission (the prefill over the padded
prompts and the first token's sampling) per padded prompt position."""

LAYER, UNIT, MOVES = "prefill", "us/token", "ttft_p95_ms"


def read(rec: dict):
    sl, traced = rec.get("slice"), rec.get("traced")
    if sl is None or not traced:
        return None
    recs = sl.within("admit")
    if not recs:
        return None
    return sl.busy_us(recs) / (len(traced["prompts"]) * traced["max_len"])
