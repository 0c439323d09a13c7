"""Device time of the mixers' cores in the traced wave's prefill (each
attention layer less its projections: RoPE, the filled cache, the layout
copies and flash): the busy time inside the program's own ``mixer.core``
spans under ``engine.prefill``, per prefill."""

from portbench import spans

LAYER, UNIT, MOVES = "prefill", "ms", "ttft_p95_ms"


def read(rec: dict):
    v = spans.view(rec.get("slice"))
    if v is None:
        return None
    prefills = v.named("engine.prefill")
    ivs = v.device_intervals(v.under("mixer.core", "engine.prefill"))
    if not prefills or not ivs:
        return None
    return spans.busy_in(rec["slice"], ivs) / len(prefills) / 1e3
