"""Model FLOPs utilisation of the window's steps: the model FLOPs of a step
(6 per token and product weight, ``bounds.train_model_flops``; no
rematerialised work counted) times the steps, over the window's time on
the host's clock, over 989 TFLOP/s."""

from portbench import bounds, readers

LAYER, UNIT, MOVES = "trainer", "%", "train_tokens_per_s"


def read(rec: dict):
    if not rec.get("steps"):
        return None
    flops = readers.train_flops(rec, rec["batch"], rec["seq"]) * rec["steps"]
    return 100.0 * flops / rec["elapsed"] / bounds.PEAK_BF16_TC_FLOPS
