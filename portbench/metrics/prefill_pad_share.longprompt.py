"""The share of the window's prefill positions that are padding: each wave
is left-padded to its longest prompt."""

LAYER, UNIT, MOVES = "engine", "%", "ttft_p95_ms"


def read(rec: dict):
    waves = rec.get("window")
    if not waves:
        return None
    padded = sum(len(w["prompts"]) * w["max_len"] for w in waves)
    prompt = sum(len(p) for w in waves for p in w["prompts"])
    return 100.0 * (padded - prompt) / padded
