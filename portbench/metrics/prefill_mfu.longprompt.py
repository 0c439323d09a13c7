"""Model FLOPs of the window's prefills (every padded position through
every product, the head at the last position, the causal attention pairs)
over their time on the host's clock (each wave's admission, which ends
when its first tokens reach the host), over 989 TFLOP/s."""

from portbench import bounds, readers

LAYER, UNIT, MOVES = "prefill", "%", "ttft_p95_ms"


def read(rec: dict):
    waves = rec.get("window")
    if not waves:
        return None
    flops = sum(readers.prefill_flops(rec, len(w["prompts"]), w["max_len"]) for w in waves)
    secs = sum(w["prefill_end"] - w["start"] for w in waves)
    return 100.0 * flops / secs / bounds.PEAK_BF16_TC_FLOPS
