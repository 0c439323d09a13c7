"""The fused selective scan's forward kernel's share of its roofline in
the traced step (forward and rematerialised forward alike): each call's
least time at the microbatch's shape (``bounds.scan_fused_fwd_bounds``:
bytes over 3.35 TB/s or operations over the float32 units' 67 TFLOP/s)
over the kernel's device time."""

from portbench import bounds
from portbench import trace as tr

LAYER, UNIT, MOVES = "kernels", "%", "train_tokens_per_s"


def read(rec: dict):
    sl, cf = rec.get("slice"), rec.get("config", {})
    if sl is None or "state_size" not in cf:
        return None
    calls = [r for r in sl.records if tr.SCAN_FUSED_FWD.search(r[0])]
    if not calls:
        return None
    mb = rec["batch"] // rec.get("microbatches", rec["batch"])
    one = bounds.bound_ms(bounds.scan_fused_fwd_bounds(
        mb, rec["seq"], cf["intermediate_size"], cf["state_size"]))
    return 100.0 * one * len(calls) / (sum(e - s for _, s, e in calls) / 1e3)
