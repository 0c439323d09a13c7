"""Device time of the float32 gradient accumulation in a train step (each
microbatch's gradients added into the accumulators, leaf by leaf): the busy
time inside the program's own ``train.accumulate`` spans, per
``train.step``."""

from portbench import spans

LAYER, UNIT, MOVES = "trainer", "ms", "train_tokens_per_s"


def read(rec: dict):
    v = spans.view(rec.get("slice"))
    if v is None:
        return None
    steps = v.named("train.step")
    ivs = v.device_intervals(v.named("train.accumulate"))
    if not steps or not ivs:
        return None
    return spans.busy_in(rec["slice"], ivs) / len(steps) / 1e3
