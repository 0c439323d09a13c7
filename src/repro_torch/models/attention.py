"""GQA attention (the counterpart of the GQA branch of the reference's
``repro/models/attention.py``).

Two compute paths:

* prefill — attention over the prompt through ``ops.flash_attention``
  (the flash kernel on the card).  The reference's prefill path is
  ``chunked_attention`` with ``q_pos = arange(S)`` and ``k_off = 0``, which
  computes exactly what the flash kernel computes.  Prefill returns the
  filled KV cache: the last ``capacity`` keys and values, zero-padded; under
  a sliding window, a ring in which position p sits in slot p % capacity.
* decode — one new token against the KV cache, in plain PyTorch ops, as in
  the reference (``_decode_attend`` has no TPU kernel).  The new key and
  value are written into the cache in place.

The training path (the reference's custom-VJP flash attention,
``models/flash.py``) and MLA come in later slices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rope
from repro_torch.models.params import ParamMeta

__all__ = ["AttnResult", "attn_meta", "attention", "init_attn_cache"]

_NEG = -1e30


def _check_gqa(cfg: ModelConfig) -> None:
    a = cfg.attn
    if a.kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: MLA comes with its own slice (ROADMAP queue 1 item 9)")
    if a.mrope_sections is not None:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE comes with qwen2-vl (ROADMAP queue 1 item 5)")


def attn_meta(cfg: ModelConfig) -> dict:
    _check_gqa(cfg)
    a, d = cfg.attn, cfg.d_model
    return {
        "wq": ParamMeta((d, a.num_heads * a.head_dim), ("d_model", "heads_flat")),
        "wk": ParamMeta((d, a.num_kv_heads * a.head_dim), ("d_model", "heads_flat")),
        "wv": ParamMeta((d, a.num_kv_heads * a.head_dim), ("d_model", "heads_flat")),
        "wo": ParamMeta((a.num_heads * a.head_dim, d), ("heads_flat", "d_model")),
    }


def init_attn_cache(cfg: ModelConfig, batch: int, capacity: int, *, device,
                    dtype=torch.bfloat16) -> dict:
    """Zero cache for ONE attention layer, bf16 whatever the model dtype.
    ``capacity`` is the ring size for sliding-window attention, else the
    max sequence length."""
    a = cfg.attn
    if a.sliding_window is not None:
        capacity = min(capacity, a.sliding_window)
    shape = (batch, capacity, a.num_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_attend(q, k, v, valid, scale):
    """q [B,1,H,hd]; k/v [B,C,Hkv,hd]; valid [C] bool."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    s = s.masked_fill(~valid, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, 1, H, v.shape[-1])


class AttnResult(NamedTuple):
    out: torch.Tensor
    cache: dict | None


def attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    *,
    cache: dict | None = None,  # decode: this layer's cache, updated in place
    cache_pos: torch.Tensor | None = None,  # decode: tokens already in the cache, 0-d int64
    capacity: int | None = None,  # prefill: size of the filled cache (default S)
) -> AttnResult:
    """Prefill when ``cache`` is None (returns the filled cache), else one
    decode step against ``cache``.

    ``cache_pos`` is a 0-d int64 tensor on the cache's device, which a
    captured decode step reads at every replay.  Nothing is read back to the
    host, so nothing checks it here: ``lm.check_position`` keeps it inside
    a full-attention cache, where the reference's ``dynamic_update_slice``
    would clamp it."""
    _check_gqa(cfg)
    a = cfg.attn
    B, S, _ = x.shape
    H, Hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    q = rope(q, positions, a.rope_theta)
    k = rope(k, positions, a.rope_theta)
    scale = 1.0 / math.sqrt(hd)

    if cache is not None:
        C = cache["k"].shape[1]
        widx = (cache_pos % C if a.sliding_window is not None else cache_pos).reshape(1)
        cache["k"].index_copy_(1, widx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, widx, v.to(cache["v"].dtype))
        idx = torch.arange(C, device=x.device)
        if a.sliding_window is not None:
            # ring buffer: slot s holds position cache_pos - ((cache_pos - s) % C)
            slot_pos = cache_pos - torch.remainder(cache_pos - idx, C)
            valid = (slot_pos >= 0) & (slot_pos >= cache_pos - a.sliding_window + 1)
        else:
            valid = idx <= cache_pos
        o = _decode_attend(q, cache["k"], cache["v"], valid, scale).to(x.dtype)
        new_cache = cache
    else:
        # [B, S, H, hd] -> [B*H, S, hd]: kernel row b*H + h reads kv row
        # (b*H + h) // G = b*Hkv + h // G, the GQA map
        to_rows = lambda t: t.transpose(1, 2).reshape(-1, S, hd)  # noqa: E731
        o = ops.flash_attention(
            to_rows(q), to_rows(k), to_rows(v), group_size=H // Hkv,
            causal=True, window=a.sliding_window, scale=scale,
        ).reshape(B, H, S, hd).transpose(1, 2)
        cap = capacity or S
        if a.sliding_window is not None:
            cap = min(cap, a.sliding_window)
        kc, vc = k[:, -cap:], v[:, -cap:]
        if a.sliding_window is not None and S > cap:
            # the ring's layout: position p in slot p % cap, where decode
            # reads it (the reference leaves the last cap keys unrotated,
            # which is that layout only when S % cap == 0)
            kc, vc = (torch.roll(t, S % cap, dims=1) for t in (kc, vc))
        pad = max(cap - S, 0)
        new_cache = {"k": F.pad(kc, (0, 0, 0, 0, 0, pad)),
                     "v": F.pad(vc, (0, 0, 0, 0, 0, pad))}
    out = o.reshape(B, S, H * hd) @ p["wo"]
    return AttnResult(out, new_cache)
