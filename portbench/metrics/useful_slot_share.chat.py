"""The engine's useful share of its decode slots over the window: tokens
that requests received over the tokens the engine computed (every slot at
the prefill and at every decode step of its wave, finished or not)."""

LAYER, UNIT, MOVES = "engine", "%", "gen_tokens_per_s"


def read(rec: dict):
    waves = rec.get("window")
    if not waves:
        return None
    served = sum(len(s) for w in waves for s in w["served"])
    computed = sum(len(w["prompts"]) * (w["steps"] + 1) for w in waves)
    return 100.0 * served / computed
