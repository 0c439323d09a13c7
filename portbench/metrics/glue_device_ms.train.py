"""Device time of the traced step in kernels that are neither cuBLAS's
GEMMs nor the port's own (``kernels/csrc``): PyTorch's elementwise,
reduction and copy kernels around them (memcpy and memset records left
out)."""

from portbench import trace as tr

LAYER, UNIT, MOVES = "model", "ms", "train_tokens_per_s"


def read(rec: dict):
    sl = rec.get("slice")
    if sl is None or not rec.get("traced_steps"):
        return None
    glue = [r for r in sl.records if tr.kind(r[0]) == "other"]
    return sl.busy_us(glue) / rec["traced_steps"] / 1e3
