"""The fused selective scan's backward's share of its roofline in the
traced step: each call's least time at the microbatch's shape
(``bounds.scan_fused_bwd_bounds``) over the device time of its kernels
(the backward kernel and its sum kernel)."""

from portbench import bounds
from portbench import trace as tr

LAYER, UNIT, MOVES = "kernels", "%", "train_tokens_per_s"


def read(rec: dict):
    sl, cf = rec.get("slice"), rec.get("config", {})
    if sl is None or "state_size" not in cf:
        return None
    kernels = [r for r in sl.records if tr.SCAN_FUSED_BWD.search(r[0])]
    calls = [r for r in kernels if r[0].find("bwd_kernel") >= 0]
    if not calls:
        return None
    mb = rec["batch"] // rec.get("microbatches", rec["batch"])
    one = bounds.bound_ms(bounds.scan_fused_bwd_bounds(
        mb, rec["seq"], cf["intermediate_size"], cf["state_size"]))
    return 100.0 * one * len(calls) / (sum(e - s for _, s, e in kernels) / 1e3)
