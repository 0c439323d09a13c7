"""Arithmetic that several per-layer readers share: a configuration file's
sizes turned into ``bounds``' arguments.  A record carries the
configuration file (``config``) and the parameter tree's leaf shapes
(``shapes``, ``{path: shape}``)."""

from __future__ import annotations

import math

from portbench import bounds

__all__ = ["decode_bound_s", "prefill_flops", "train_flops"]


def _attn(cf: dict) -> dict:
    if "num_attention_heads" not in cf:
        return {}
    H = cf["num_attention_heads"]
    hd = cf.get("head_dim") or cf["hidden_size"] // H
    return {"attn_layers": cf["num_hidden_layers"], "heads": H, "hd_qk": hd, "hd_v": hd}


def decode_bound_s(rec: dict, batch: int, pos: int) -> float:
    """The card's least time for one decode step of ``batch`` rows at cache
    position ``pos``."""
    cf, shapes = rec["config"], rec["shapes"]
    every = sum(math.prod(s) for s in shapes.values())
    table = math.prod(shapes["embed/embedding"])
    kw = {}
    if "num_attention_heads" in cf:
        a = _attn(cf)
        kw = dict(attn_layers=a["attn_layers"], kv_heads=cf["num_key_value_heads"],
                  heads=a["heads"], head_dim=a["hd_qk"])
    if "state_size" in cf:
        kw.update(mamba_layers=cf["num_hidden_layers"], d_inner=cf["intermediate_size"],
                  d_state=cf["state_size"], d_conv=cf["conv_kernel"])
    b = bounds.decode_step_bound_s(weight_bytes=2 * (every - table), batch=batch,
                                   d_model=cf["hidden_size"],
                                   product_weights=bounds.product_params(shapes), pos=pos, **kw)
    return max(b["bytes_s"], b["ops_s"])


def prefill_flops(rec: dict, batch: int, seq: int) -> float:
    cf, shapes = rec["config"], rec["shapes"]
    return bounds.prefill_model_flops(shapes, batch, seq, **_attn(cf),
                                      vocab_d=math.prod(shapes["head/lm_head"]))


def train_flops(rec: dict, batch: int, seq: int) -> float:
    cf, shapes = rec["config"], rec["shapes"]
    return bounds.train_model_flops(shapes, batch, seq, **_attn(cf))
