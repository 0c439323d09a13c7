"""Attention mixers: GQA (optional sliding window, M-RoPE) and MLA
(MiniCPM3's multi-head latent attention), the counterparts of the
reference's ``repro/models/attention.py``.

Three compute paths (MLA has the last two):

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

* train — attention over the whole sequence with no cache, through
  ``models/flash.flash_attention_train`` (the flash kernel forward with its
  logsumexp, and the flash backward kernel), as the reference's
  ``_gqa_attention`` and ``_mla_attention`` take their custom-VJP flash
  attention when there is no cache and none to fill.  MLA trains in the
  expanded form of its prefill: keys ``[k_nope ‖ k_rope]`` at q/k head dim
  ``qk_head_dim``, values at ``v_head_dim``, G = 1, no window.

On DTensors (sharded serving, ``lm.prefill`` and ``lm.decode_step`` with
parameters placed by ``param_pspecs``) the projections run on DTensor's
sharding propagation, heads over ``model`` and the batch over the
data-parallel dims.  Prefill runs the flash kernel on each rank's batch
rows and kv heads with the query heads that read them (``ops.on_shards``,
as the training attention does) and cuts the filled cache from each
rank's own keys; ``lm`` places it by ``launch/specs.cache_pspecs``.
Decode writes the new entries into each rank's cache shard
(``layers.write_at``), and takes scores and values on DTensors: where the
cache's sequence dim is split over ``model`` (MLA's latent cache, or kv
heads that do not split), the softmax over it is what DTensor's
propagation makes of it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.flash import flash_attention_train, kernel_rows
from repro_torch.models.layers import rms_norm, rope, unflatten, write_at
from repro_torch.models.params import ParamMeta
from repro_torch.obs.trace import TRACER

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


def _merge(o: torch.Tensor) -> torch.Tensor:
    """o [B, S, heads..., hd] -> [B, S, heads * hd]; a DTensor on each rank's
    rows and heads (``ops.on_shards``), so that no view of it, nor of its
    gradient, splits a sharded dim unevenly."""
    B, S = o.shape[:2]
    if not isinstance(o, DTensor):
        return o.reshape(B, S, -1)
    op = ops.rows(o, 0, 2)
    return ops.on_shards(lambda t: t.reshape(t.shape[0], t.shape[1], -1), (o,), (op,), op)


def _scores(qg, k, scale):
    """qg [B,1,Hkv,G,hd], k [B,C,Hkv,hd] -> float32 scores [B,Hkv,G,1,C]."""
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale


def _values(p, v):
    """p [B,Hkv,G,1,C], v [B,C,Hkv,hd] -> [B,1,Hkv,G,hd] in v's dtype."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _decode_attend(q, k, v, valid, scale):
    """q [B,1,H,hd]; k/v [B,C,Hkv,hd]; valid [C] bool."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    qg = unflatten(q, 2, (Hkv, H // Hkv))
    if isinstance(k, DTensor):
        return _sharded_decode_attend(qg, k, v, valid, scale).reshape(B, 1, H, v.shape[-1])
    s = _scores(qg, k, scale)
    s = s.masked_fill(~valid, _NEG)
    p = torch.softmax(s, dim=-1)
    o = _values(p, v)
    return o.reshape(B, 1, H, v.shape[-1])


def _by_cache(cp: tuple, batch: int, seq, other: dict) -> tuple:
    """Placements, one per mesh dim, of a tensor read against a cache placed
    ``cp`` ([B, C, ...]): where the cache shards the batch, ``Shard(batch)``;
    where it shards the sequence, ``seq`` (a placement, or None for
    ``Replicate``); where it shards another dim ``d``, ``Shard(other[d])``
    (``Replicate`` if ``d`` is not in ``other``)."""
    out = []
    for p in cp:
        if not isinstance(p, Shard):
            out.append(Replicate())
        elif p.dim == 0:
            out.append(Shard(batch))
        elif p.dim == 1:
            out.append(seq or Replicate())
        else:
            out.append(Shard(other[p.dim]) if p.dim in other else Replicate())
    return tuple(out)


def _sharded_decode_attend(qg: DTensor, k: DTensor, v: DTensor, valid, scale) -> DTensor:
    """``_decode_attend`` against a cache placed by ``cache_pspecs``: the
    scores and the values on each rank's batch rows and kv heads
    (``ops.on_shards``), the mask and the softmax on DTensors.  Where the
    cache's sequence is split, each rank scores its own keys, the softmax
    gathers them as DTensor's propagation does, and each rank's values
    are a partial sum over its keys."""
    cp = k.placements
    qp = _by_cache(cp, 0, None, {2: 2})
    sp = _by_cache(cp, 0, Shard(4), {2: 1})
    op = _by_cache(cp, 0, Partial(), {2: 2})
    s = ops.on_shards(_scores, (qg, k, scale), (qp, cp, None), sp)
    p = torch.softmax(s.masked_fill(~valid, _NEG), dim=-1)
    return ops.on_shards(_values, (p, v), (sp, cp), op)


def _flash_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                window: int | None) -> torch.Tensor:
    """Prefill attention of one rank's shards through the flash kernel:
    q [B, S, Hkv, G, hd], k [B, S, Hkv, hd], v [B, S, Hkv, hd_v] -> [B, S,
    Hkv, G, hd_v] (kernel row b*Hkv*G + h*G + g reads kv row b*Hkv + h)."""
    B, S, Hkv, G, _ = q.shape
    o = ops.flash_attention(kernel_rows(q), kernel_rows(k), kernel_rows(v), group_size=G,
                            causal=True, window=window, scale=scale)
    return o.reshape(B, Hkv, G, S, -1).movedim(3, 1)


def _sharded_flash(q: DTensor, k: DTensor, v: DTensor, scale: float,
                   window: int | None) -> DTensor:
    """``_flash_rows`` on DTensors, each rank's batch rows and kv heads
    (dims 0 and 2) with the query heads that read them."""
    qp = ops.rows(q, 0, 2)
    return ops.on_shards(_flash_rows, (q, k, v, scale, window), (qp, qp, qp, None, None), qp)


def _fill(t: torch.Tensor, cap: int, window: int | None) -> torch.Tensor:
    """A prefill's cache of ``cap`` entries from t [B, S, ...]: its last
    ``cap`` rows, zero-padded at the end; under a sliding window past it, a
    ring in which position p sits in slot p % cap, where decode reads it
    (the reference leaves the last cap keys unrotated, which is that layout
    only when S % cap == 0)."""
    S = t.shape[1]
    c = t[:, -cap:]
    if window is not None and S > cap:
        c = torch.roll(c, S % cap, dims=1)
    return F.pad(c, (0, 0) * (t.ndim - 2) + (0, max(cap - S, 0)))


def _filled(t: torch.Tensor, cap: int, window: int | None = None) -> torch.Tensor:
    """``_fill``; a DTensor on each rank's rows (and heads), the sequence
    whole."""
    if isinstance(t, DTensor):
        tp = ops.rows(t, *(d for d in range(t.ndim) if d != 1))
        return ops.on_shards(lambda x: _fill(x, cap, window), (t,), (tp,), tp)
    return _fill(t, cap, window)


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
    train: bool = False,  # training: no cache, differentiable flash attention
    layer: int | None = None,  # the layer's index, an attribute of its span
) -> AttnResult:
    """Prefill when ``cache`` is None (returns the filled cache), else one
    decode step against ``cache``; with ``train`` the training forward,
    which returns no cache.

    ``cache_pos`` is a 0-d int64 tensor on the cache's device, which a
    captured decode step reads at every replay.  Nothing is read back to the
    host, so nothing checks it here: ``lm.check_position`` keeps it inside
    a full-attention cache, where the reference's ``dynamic_update_slice``
    would clamp it.

    Between its projections the GQA mixer runs under a device span
    ``mixer.core`` (``obs/trace.py``; attribute ``layer``): a graph marker
    when a decode step is captured.  MLA's absorbed form takes products
    with ``wkv_b`` inside its attend, so it has no such span."""
    if cfg.attn.kind == "mla":
        return _mla_attention(cfg, p, x, positions, cache, cache_pos, capacity, train)
    a = cfg.attn
    H, Hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
    q = unflatten(x @ p["wq"], 2, (H, hd))
    k = unflatten(x @ p["wk"], 2, (Hkv, hd))
    v = unflatten(x @ p["wv"], 2, (Hkv, hd))
    sp = TRACER.start("mixer.core", device=True, layer=layer) if TRACER else None
    try:
        o, new_cache = _gqa_core(cfg, q, k, v, positions, cache, cache_pos, capacity, train)
    finally:
        if sp:
            TRACER.finish(sp)
    return AttnResult(o @ p["wo"], new_cache)


def _gqa_core(cfg: ModelConfig, q, k, v, positions, cache, cache_pos, capacity, train):
    """The GQA mixer between its input and output projections (the
    ``mixer.core`` span): RoPE, the cache write (decode) or the filled cache
    (prefill), the layout copies and the attend.  q [B, S, H, hd], k and v
    [B, S, Hkv, hd] -> (o [B, S, H * hd], the cache or None)."""
    a = cfg.attn
    B, S = q.shape[:2]
    H, Hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
    q = rope(q, positions, a.rope_theta, sections=a.mrope_sections)
    k = rope(k, positions, a.rope_theta, sections=a.mrope_sections)
    scale = 1.0 / math.sqrt(hd)

    if train:
        pl = cfg.parallel
        o = flash_attention_train(unflatten(q, 2, (Hkv, H // Hkv)), k, v, scale,
                                  a.sliding_window, pl.attn_chunk_q, pl.attn_chunk_kv,
                                  pl.causal_skip)
        return _merge(o), None
    if cache is not None:
        C = cache["k"].shape[1]
        widx = cache_pos % C if a.sliding_window is not None else cache_pos
        write_at(cache["k"], widx, k)
        write_at(cache["v"], widx, v)
        idx = torch.arange(C, device=q.device)
        if a.sliding_window is not None:
            # ring buffer: slot s holds position cache_pos - ((cache_pos - s) % C)
            slot_pos = cache_pos - torch.remainder(cache_pos - idx, C)
            valid = (slot_pos >= 0) & (slot_pos >= cache_pos - a.sliding_window + 1)
        else:
            valid = idx <= cache_pos
        o = _decode_attend(q, cache["k"], cache["v"], valid, scale).to(q.dtype)
        new_cache = cache
    else:
        if isinstance(q, DTensor):
            o = _sharded_flash(unflatten(q, 2, (Hkv, H // Hkv)), k, v, scale,
                               a.sliding_window)
        else:
            # kernel row b*H + h reads kv row (b*H + h) // G = b*Hkv + h // G,
            # the GQA map
            o = ops.flash_attention(
                kernel_rows(q), kernel_rows(k), kernel_rows(v), group_size=H // Hkv,
                causal=True, window=a.sliding_window, scale=scale,
            ).reshape(B, H, S, hd).transpose(1, 2)
        cap = capacity or S
        if a.sliding_window is not None:
            cap = min(cap, a.sliding_window)
        new_cache = {"k": _filled(k, cap, a.sliding_window),
                     "v": _filled(v, cap, a.sliding_window)}
    return _merge(o), new_cache


def _mla_attention(cfg, p, x, positions, cache, cache_pos, capacity, train):
    """MLA: queries through the ``q_lora_rank`` bottleneck (``q_norm``),
    keys and values from the latent ``ckv`` = ``kv_norm`` of the first
    ``kv_lora_rank`` columns of ``x @ wkv_a``, and one rotary key of
    ``qk_rope_head_dim`` shared by every head.  Scores are scaled by
    1/sqrt(qk_head_dim), not 1/sqrt(head_dim).  ``train``: the expanded
    form through the training flash attention, no cache."""
    a = cfg.attn
    B, S, _ = x.shape
    H, lora = a.num_heads, a.kv_lora_rank
    nope, rdim, vdim = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    scale = 1.0 / math.sqrt(a.qk_head_dim)

    q_in = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) if a.q_lora_rank else x
    qf = unflatten(q_in @ p["wq_b"], 2, (H, nope + rdim))
    q_nope = qf[..., :nope]
    q_rope = rope(qf[..., nope:], positions, a.rope_theta)
    kv_a = x @ p["wkv_a"]  # [B, S, kv_lora + rope]
    # the RMSNorm kernel reads whole contiguous rows: the latent columns are
    # copied out of kv_a's rows of kv_lora + rope (one copy a layer)
    ckv = rms_norm(kv_a[..., :lora].contiguous(), p["kv_norm"], cfg.norm_eps)
    k_rope = rope(kv_a[..., None, lora:], positions, a.rope_theta)[:, :, 0]  # [B, S, rope]
    wkv_b = unflatten(p["wkv_b"], 1, (H, nope + vdim))

    if cache is not None:
        # absorbed decode: w_uk folded into the query and w_uv applied after
        # the values, so scores and values are taken against the latent cache
        write_at(cache["ckv"], cache_pos, ckv)
        write_at(cache["krope"], cache_pos, k_rope)
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        valid = torch.arange(ckv_c.shape[1], device=x.device) <= cache_pos
        if isinstance(ckv_c, DTensor):
            o = _sharded_mla_decode(q_nope, q_rope, wkv_b, ckv_c, kr_c, valid, scale, nope)
            return AttnResult(_merge(o) @ p["wo"], cache)
        q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, wkv_b[..., :nope])
        s = (torch.einsum("bqhl,bkl->bhqk", q_lat.float(), ckv_c.float())
             + torch.einsum("bqhr,bkr->bhqk", q_rope.float(), kr_c.float())) * scale
        pr = torch.softmax(s.masked_fill(~valid, _NEG), dim=-1)
        o_lat = torch.einsum("bhqk,bkl->bqhl", pr.to(ckv_c.dtype), ckv_c)
        o = torch.einsum("bqhl,lhv->bqhv", o_lat.to(wkv_b.dtype), wkv_b[..., nope:])
        new_cache = cache
    else:
        # expanded form: per-head keys [k_nope ‖ k_rope] at qk_head_dim and
        # values at v_head_dim, through the flash kernels (MHA: group 1)
        kv = unflatten(ckv @ p["wkv_b"], 2, (H, nope + vdim))
        kk = torch.cat([kv[..., :nope], k_rope[:, :, None].expand(B, S, H, rdim)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        if train:
            pl = cfg.parallel
            o = flash_attention_train(qq[:, :, :, None], kk, kv[..., nope:], scale, None,
                                      pl.attn_chunk_q, pl.attn_chunk_kv, pl.causal_skip)
            return AttnResult(_merge(o) @ p["wo"], None)
        if isinstance(qq, DTensor):
            o = _sharded_flash(qq[:, :, :, None], kk, kv[..., nope:], scale, None)
        else:
            o = ops.flash_attention(kernel_rows(qq), kernel_rows(kk),
                                    kernel_rows(kv[..., nope:]), group_size=1, causal=True,
                                    scale=scale).reshape(B, H, S, vdim).transpose(1, 2)
        cap = capacity or S
        new_cache = {"ckv": _filled(ckv, cap), "krope": _filled(k_rope, cap)}
    out = _merge(o) @ p["wo"]
    return AttnResult(out, new_cache)


def _sharded_mla_decode(q_nope: DTensor, q_rope: DTensor, wkv_b: DTensor, ckv: DTensor,
                        krope: DTensor, valid, scale: float, nope: int) -> DTensor:
    """MLA's absorbed decode against a latent cache placed by
    ``cache_pspecs`` (its sequence over ``model``): each product on each
    rank's shards (``ops.on_shards``) and the mask and the softmax on
    DTensors.  The queries' heads stay where the projection split them
    except on a mesh dim that splits the cache's sequence, where each rank
    scores every head against its own keys; the softmax gathers the
    scores as DTensor's propagation does, each rank's latent values are a
    partial sum over its keys, summed into the heads' split before
    ``w_uv``."""
    qp = ops.rows(q_nope, 0, 2)  # batch rows and heads, as projected
    wp = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2 else Replicate() for p in qp)
    heads = {2: 2}
    cp = ckv.placements
    # a mesh dim that shards neither the cache's batch nor its sequence
    # keeps the queries' heads split
    qs = tuple(q if isinstance(c, Replicate) and isinstance(q, Shard) and q.dim == 2 else r
               for q, c, r in zip(qp, cp, _by_cache(cp, 0, None, heads)))
    sp = tuple(Shard(1) if isinstance(q, Shard) and q.dim == 2 else r
               for q, r in zip(qs, _by_cache(cp, 0, Shard(3), {})))
    lp = tuple(Shard(2) if isinstance(q, Shard) and q.dim == 2 else r
               for q, r in zip(qs, _by_cache(cp, 0, Partial(), {})))

    def lat(qn, w):
        return torch.einsum("bqhn,lhn->bqhl", qn, w[..., :nope])

    def scores(ql, qr, c, kr):
        return (torch.einsum("bqhl,bkl->bhqk", ql.float(), c.float())
                + torch.einsum("bqhr,bkr->bhqk", qr.float(), kr.float())) * scale

    def values(pr, c):
        return torch.einsum("bhqk,bkl->bqhl", pr.to(c.dtype), c)

    def out(ol, w):
        return torch.einsum("bqhl,lhv->bqhv", ol.to(w.dtype), w[..., nope:])

    q_lat = ops.on_shards(lat, (q_nope, wkv_b), (qp, wp), qp)
    s = ops.on_shards(scores, (q_lat, q_rope, ckv, krope), (qs, qs, cp, cp), sp)
    pr = torch.softmax(s.masked_fill(~valid, _NEG), dim=-1)
    o_lat = ops.on_shards(values, (pr, ckv), (sp, cp), lp)
    return ops.on_shards(out, (o_lat, wkv_b), (qp, wp), qp)
