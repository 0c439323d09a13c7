"""Device time of the optimizer in a train step (AdamW: the gradients'
global norm, the clip and the update, slice by slice): the busy time
inside the program's own ``train.optimizer`` spans, per ``train.step``."""

from portbench import spans

LAYER, UNIT, MOVES = "trainer", "ms", "train_tokens_per_s"


def read(rec: dict):
    v = spans.view(rec.get("slice"))
    if v is None:
        return None
    steps = v.named("train.step")
    ivs = v.device_intervals(v.named("train.optimizer"))
    if not steps or not ivs:
        return None
    return spans.busy_in(rec["slice"], ivs) / len(steps) / 1e3
