"""The whole decode step's share of its roofline: over the traced wave's
steps, the card's least time for each step (the larger of its FLOPs over
989 TFLOP/s and its bytes over 3.35 TB/s: weights read once, the KV cache
read up to the step's position, a Mamba layer's state and conv window)
summed, over the device time of those steps."""

from portbench import readers

LAYER, UNIT, MOVES = "decode step", "%", "itl_p95_ms"


def read(rec: dict):
    sl, traced = rec.get("slice"), rec.get("traced")
    if sl is None or not traced or not traced["steps"]:
        return None
    recs = sl.within("step")
    busy = sl.busy_us(recs) / 1e6
    if busy <= 0:
        return None
    batch = len(traced["prompts"])
    least = sum(readers.decode_bound_s(rec, batch, pos) for pos in traced["positions"])
    return 100.0 * least / busy
