"""The flash forward kernel's share of its roofline in the traced wave's
prefill: the card's least time for each call (``bounds.flash_bounds`` at
the wave's padded length, every query head of every request) over the
kernel's device time."""

from portbench import bounds
from portbench import trace as tr

LAYER, UNIT, MOVES = "kernels", "%", "ttft_p95_ms"


def read(rec: dict):
    sl, traced, cf = rec.get("slice"), rec.get("traced"), rec.get("config", {})
    if sl is None or not traced or "num_attention_heads" not in cf:
        return None
    calls = [r for r in sl.within("admit") if tr.FLASH_FWD.search(r[0])]
    if not calls:
        return None
    H, Hkv = cf["num_attention_heads"], cf["num_key_value_heads"]
    hd = cf.get("head_dim") or cf["hidden_size"] // H
    S = traced["max_len"]
    one = bounds.bound_ms(bounds.flash_bounds(len(traced["prompts"]) * H, H // Hkv, S, S, hd))
    spent_ms = sum(e - s for _, s, e in calls) / 1e3
    return 100.0 * one * len(calls) / spent_ms
