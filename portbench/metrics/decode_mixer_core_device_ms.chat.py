"""Device time of the mixers' cores in one decode step (attention less its
projections: RoPE, the cache write, the float32 copies and the attend; a
Mamba layer's conv, terms, state update, readout, D skip and gate), averaged
over the traced wave's steps: the busy time inside the program's own
``mixer.core`` spans under ``engine.step`` (the captured graph's markers),
over the number of ``engine.step`` spans."""

from portbench import spans

LAYER, UNIT, MOVES = "decode step", "ms", "itl_p95_ms"


def read(rec: dict):
    v = spans.view(rec.get("slice"))
    if v is None:
        return None
    steps = v.named("engine.step")
    ivs = v.device_intervals(v.under("mixer.core", "engine.step"))
    if not steps or not ivs:
        return None
    return spans.busy_in(rec["slice"], ivs) / len(steps) / 1e3
