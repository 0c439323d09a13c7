"""Attention mixers: GQA (optional sliding window, M-RoPE) and MLA
(MiniCPM3's multi-head latent attention), the counterparts of the
reference's ``repro/models/attention.py``.

Two compute paths for each:

* prefill — attention over the prompt through ``ops.flash_attention``
  (the flash kernel on the card).  The reference's prefill path is
  ``chunked_attention`` with ``q_pos = _pos1d(positions)`` and
  ``k_off = 0``, which computes what the flash kernel computes wherever the
  positions' first (t) component is ``arange(S)``: the kernel masks by index
  (ROADMAP, reference caveats).  MLA's prefill is the expanded form: keys
  ``[k_nope ‖ k_rope]`` at q/k head dim ``qk_head_dim``, values at
  ``v_head_dim``.  Prefill returns the filled cache: GQA's last
  ``capacity`` keys and values, zero-padded (under a sliding window, a ring
  in which position p sits in slot p % capacity); MLA's latent ``ckv`` and
  shared rotary key ``krope``.
* decode — one new token against the cache, in plain PyTorch ops, as in
  the reference (neither decode has a TPU kernel); MLA's is the absorbed
  form, whose scores and values are taken against the latent cache.  The
  new entries are written into the cache in place.

The training path (the reference's custom-VJP flash attention,
``models/flash.py``) comes in a later slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm, rope
from repro_torch.models.params import ParamMeta

__all__ = ["AttnResult", "attn_meta", "attention", "init_attn_cache"]

_NEG = -1e30


def attn_meta(cfg: ModelConfig) -> dict:
    a, d = cfg.attn, cfg.d_model
    if a.kind == "mla":
        out = {}
        q_in = d
        if a.q_lora_rank:
            out["wq_a"] = ParamMeta((d, a.q_lora_rank), ("d_model", "lora"))
            out["q_norm"] = ParamMeta((a.q_lora_rank,), ("lora",), init="ones")
            q_in = a.q_lora_rank
        out["wq_b"] = ParamMeta((q_in, a.num_heads * a.qk_head_dim), ("lora", "heads_flat"))
        out["wkv_a"] = ParamMeta((d, a.kv_lora_rank + a.qk_rope_head_dim), ("d_model", "lora"))
        out["kv_norm"] = ParamMeta((a.kv_lora_rank,), ("lora",), init="ones")
        out["wkv_b"] = ParamMeta(
            (a.kv_lora_rank, a.num_heads * (a.qk_nope_head_dim + a.v_head_dim)),
            ("lora", "heads_flat"))
        out["wo"] = ParamMeta((a.num_heads * a.v_head_dim, d), ("heads_flat", "d_model"))
        return out
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
    max sequence length.  MLA caches the latent ``ckv`` [B, C, kv_lora] and
    the shared rotary key ``krope`` [B, C, rope]."""
    a = cfg.attn
    if a.sliding_window is not None:
        capacity = min(capacity, a.sliding_window)
    if a.kind == "mla":
        return {"ckv": torch.zeros(batch, capacity, a.kv_lora_rank, dtype=dtype, device=device),
                "krope": torch.zeros(batch, capacity, a.qk_rope_head_dim, dtype=dtype,
                                     device=device)}
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
    positions: torch.Tensor,  # [B, S], or [B, S, 3] under M-RoPE
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
    if cfg.attn.kind == "mla":
        return _mla_attention(cfg, p, x, positions, cache, cache_pos, capacity)
    a = cfg.attn
    B, S, _ = x.shape
    H, Hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    q = rope(q, positions, a.rope_theta, sections=a.mrope_sections)
    k = rope(k, positions, a.rope_theta, sections=a.mrope_sections)
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
        # kernel row b*H + h reads kv row (b*H + h) // G = b*Hkv + h // G,
        # the GQA map
        o = ops.flash_attention(
            _rows(q), _rows(k), _rows(v), group_size=H // Hkv,
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


def _rows(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, d] -> the flash kernel's [B*H, S, d], contiguous."""
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3]).contiguous()


def _mla_attention(cfg, p, x, positions, cache, cache_pos, capacity):
    """MLA: queries through the ``q_lora_rank`` bottleneck (``q_norm``),
    keys and values from the latent ``ckv`` = ``kv_norm`` of the first
    ``kv_lora_rank`` columns of ``x @ wkv_a``, and one rotary key of
    ``qk_rope_head_dim`` shared by every head.  Scores are scaled by
    1/sqrt(qk_head_dim), not 1/sqrt(head_dim)."""
    a = cfg.attn
    B, S, _ = x.shape
    H, lora = a.num_heads, a.kv_lora_rank
    nope, rdim, vdim = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    scale = 1.0 / math.sqrt(a.qk_head_dim)

    q_in = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) if a.q_lora_rank else x
    qf = (q_in @ p["wq_b"]).reshape(B, S, H, nope + rdim)
    q_nope = qf[..., :nope]
    q_rope = rope(qf[..., nope:], positions, a.rope_theta)
    kv_a = x @ p["wkv_a"]  # [B, S, kv_lora + rope]
    # the RMSNorm kernel reads whole contiguous rows: the latent columns are
    # copied out of kv_a's rows of kv_lora + rope (one copy a layer)
    ckv = rms_norm(kv_a[..., :lora].contiguous(), p["kv_norm"], cfg.norm_eps)
    k_rope = rope(kv_a[..., None, lora:], positions, a.rope_theta)[:, :, 0]  # [B, S, rope]
    wkv_b = p["wkv_b"].reshape(lora, H, nope + vdim)

    if cache is not None:
        # absorbed decode: w_uk folded into the query and w_uv applied after
        # the values, so scores and values are taken against the latent cache
        widx = cache_pos.reshape(1)
        cache["ckv"].index_copy_(1, widx, ckv.to(cache["ckv"].dtype))
        cache["krope"].index_copy_(1, widx, k_rope.to(cache["krope"].dtype))
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        valid = torch.arange(ckv_c.shape[1], device=x.device) <= cache_pos
        q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, wkv_b[..., :nope])
        s = (torch.einsum("bqhl,bkl->bhqk", q_lat.float(), ckv_c.float())
             + torch.einsum("bqhr,bkr->bhqk", q_rope.float(), kr_c.float())) * scale
        pr = torch.softmax(s.masked_fill(~valid, _NEG), dim=-1)
        o_lat = torch.einsum("bhqk,bkl->bqhl", pr.to(ckv_c.dtype), ckv_c)
        o = torch.einsum("bqhl,lhv->bqhv", o_lat.to(wkv_b.dtype), wkv_b[..., nope:])
        new_cache = cache
    else:
        # expanded prefill: per-head keys [k_nope ‖ k_rope] at qk_head_dim and
        # values at v_head_dim, through the flash kernel (MHA: group 1)
        kv = (ckv @ p["wkv_b"]).reshape(B, S, H, nope + vdim)
        kk = torch.cat([kv[..., :nope], k_rope[:, :, None].expand(B, S, H, rdim)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        o = ops.flash_attention(_rows(qq), _rows(kk), _rows(kv[..., nope:]), group_size=1,
                                causal=True, scale=scale).reshape(B, H, S, vdim).transpose(1, 2)
        cap = capacity or S
        pad = max(cap - S, 0)
        new_cache = {"ckv": F.pad(ckv[:, -cap:], (0, 0, 0, pad)),
                     "krope": F.pad(k_rope[:, -cap:], (0, 0, 0, pad))}
    out = o.reshape(B, S, H * vdim) @ p["wo"]
    return AttnResult(out, new_cache)
