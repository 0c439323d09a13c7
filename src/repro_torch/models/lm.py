"""Decoder LM: embedding -> loop over layers -> final norm -> head (the
counterpart of the reference's ``repro/models/lm.py``).

Parameters keep the reference's layout: the repeating ``layer_pattern`` is
stacked on a leading periods axis under ``blocks/slot<i>``, so a weight maps
one to one onto the reference's.  A Python loop over the periods replaces
``lax.scan``.

Entry points:

* ``loss_fn``      — the training forward and its cross-entropy
  (``{"tokens"}`` or ``{"embeds"}`` with ``"labels"``), differentiable in
  the parameters through the flash and RMSNorm backward kernels, each
  period rematerialised in the backward when ``parallel.remat``;
* ``prefill``      — forward over a prompt (``{"tokens"}``, or
  ``{"embeds"}`` for a model that takes embeddings, either with optional
  ``"positions"``); last-position logits and the filled cache;
* ``decode_step``  — one token (or one embedding) against the cache,
  updated in place.

Each slot of the pattern has a mixer (GQA or MLA attention, or Mamba) and, unless
its ``ffn`` is ``"none"`` (Falcon-Mamba), a second norm and a dense MLP or
an MoE FFN (``models/moe.py``); a slot's cache is that of its mixer.  The
first ``first_k_dense`` layers (DeepSeek-V2's one) run before the stacked
periods as an unrolled prelude, ``prelude<j>``, with a dense FFN, their
parameters and caches unstacked, as in the reference; the periods stacked
under ``blocks`` are the ``(num_layers - first_k_dense) // len(pattern)``
that remain.  Every attention config trains (MLA through its expanded form
and the flash kernels at its pair of head dims); Mamba training waits for
the selective scan's backward (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.params import ParamMeta, init_params, map_tree, torch_dtype

__all__ = ["model_meta", "init_model", "init_cache", "loss_fn", "prefill", "decode_step",
           "check_position", "scanned_periods"]


def _slot_meta(cfg: ModelConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    out = {"norm1": L.rms_norm_meta(d),
           "mixer": (attn_mod.attn_meta(cfg) if spec.mixer == "attn"
                     else mamba_mod.mamba_meta(cfg))}
    if spec.ffn != "none":
        out["norm2"] = L.rms_norm_meta(d)
        out["ffn"] = (L.mlp_meta(d, cfg.d_ff, cfg.act) if spec.ffn == "dense"
                      else moe_mod.moe_meta(cfg))
    return out


def _stack_meta(tree, n: int):
    return map_tree(
        lambda _, m: dataclasses.replace(m, shape=(n,) + m.shape,
                                         axes=("layers",) + m.axes),
        tree,
    )


def scanned_periods(cfg: ModelConfig) -> int:
    """The periods stacked under ``blocks``: the layers after the prelude."""
    return (cfg.num_layers - cfg.first_k_dense) // len(cfg.layer_pattern)


def _prelude(cfg: ModelConfig) -> list[tuple[str, LayerSpec]]:
    """``(name, spec)`` of each prelude layer: the pattern's slot with a dense FFN."""
    return [(f"prelude{j}", dataclasses.replace(
        cfg.layer_pattern[j % len(cfg.layer_pattern)], ffn="dense"))
        for j in range(cfg.first_k_dense)]


def model_meta(cfg: ModelConfig) -> dict:
    P = scanned_periods(cfg)
    return {
        "embed": L.embed_meta(cfg),
        "head": L.head_meta(cfg),
        "final_norm": L.rms_norm_meta(cfg.d_model),
        "blocks": {f"slot{i}": _stack_meta(_slot_meta(cfg, spec), P)
                   for i, spec in enumerate(cfg.layer_pattern)},
        **{name: _slot_meta(cfg, spec) for name, spec in _prelude(cfg)},
    }


def init_model(cfg: ModelConfig, generator: torch.Generator, *, device="cuda") -> dict:
    """Random parameters drawn from ``generator``, which lives on ``device``."""
    return init_params(model_meta(cfg), generator, resolve_device(device),
                       dtype=torch_dtype(cfg.dtype))


def _slot_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, capacity: int,
                device, dtype) -> dict:
    if spec.mixer == "attn":
        return attn_mod.init_attn_cache(cfg, batch, capacity, device=device, dtype=dtype)
    return mamba_mod.init_mamba_cache(cfg, batch, device=device, dtype=dtype)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *, device="cuda",
               dtype=torch.bfloat16) -> dict:
    """Zero caches (KV, or MLA's latent ``ckv`` and ``krope``, for
    attention; conv window and state for Mamba), stacked over periods like
    the parameters, and one for each prelude layer.  KV and conv window in
    ``dtype`` (bf16, as the reference's; ``prefill``'s filled cache takes
    the model dtype), the Mamba state in float32."""
    device = resolve_device(device)
    P = scanned_periods(cfg)
    blocks = {}
    for i, spec in enumerate(cfg.layer_pattern):
        one = _slot_cache(cfg, spec, batch, capacity, device, dtype)
        blocks[f"slot{i}"] = {n: t.expand((P,) + t.shape).clone() for n, t in one.items()}
    return {"blocks": blocks,
            **{name: _slot_cache(cfg, spec, batch, capacity, device, dtype)
               for name, spec in _prelude(cfg)}}


def _apply_slot(cfg, spec, p, x, positions, *, cache=None, cache_pos=None,
                capacity=None, train=False):
    """One layer: (x, its filled or updated cache, its MoE aux loss or None)."""
    aux = None
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        res = attn_mod.attention(cfg, p["mixer"], h, positions, cache=cache,
                                 cache_pos=cache_pos, capacity=capacity, train=train)
        mix, new_cache = res.out, res.cache
    else:
        mix, new_cache = mamba_mod.mamba(cfg, p["mixer"], h, cache=cache)
    x = x + mix
    if spec.ffn != "none":
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        if spec.ffn == "dense":
            f = L.mlp(p["ffn"], h2, cfg.act)
        else:
            f, aux = moe_mod.moe(cfg, p["ffn"], h2)
        x = x + f
    return x, new_cache, aux


def _period(tree: dict, i: int) -> dict:
    return map_tree(lambda _, t: t[i], tree)


def _default_positions(cfg: ModelConfig, B: int, S: int, pos: torch.Tensor) -> torch.Tensor:
    """``pos`` ([S] or 0-d) for every row: [B, S], or [B, S, 3] under M-RoPE,
    where t, h and w all equal the position (a text token's)."""
    if cfg.attn is not None and cfg.attn.mrope_sections is not None:
        return pos.reshape(1, -1, 1).expand(B, S, 3)
    return pos.reshape(1, -1).expand(B, S)


def _inputs(cfg: ModelConfig, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The first layer's input [B, S, D] and the positions of a prefill
    batch: ``{"tokens"}`` for a token model, ``{"embeds"}`` (cast to the
    model dtype) for one that takes embeddings, either with ``"positions"``
    ([B, S], or [B, S, 3] under M-RoPE; default ``arange(S)``)."""
    key = "tokens" if cfg.embed_inputs else "embeds"
    if set(batch) - {"positions"} != {key}:
        raise ValueError(f"{cfg.name}: prefill takes {{{key!r}}} with optional "
                         f"'positions', got {sorted(batch)}")
    if cfg.embed_inputs:
        x = L.embed(cfg, params["embed"], batch["tokens"])
    else:
        x = batch["embeds"].to(torch_dtype(cfg.dtype)).contiguous()  # the kernels' rows
    B, S = x.shape[:2]
    default = _default_positions(cfg, B, S, torch.arange(S, device=x.device))
    positions = batch.get("positions", default)
    if positions.shape != default.shape:
        raise ValueError(f"{cfg.name}: positions {tuple(positions.shape)}, want "
                         f"{list(default.shape)}")
    return x, positions.to(x.device)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
    """Cross-entropy training objective of a batch ``{"tokens": [B, S]}``
    (``[B, S, K]`` for K codebooks) or ``{"embeds": [B, S, D]}``, with
    ``"labels"`` of the tokens' shape (integers) and optional
    ``"positions"``.  Returns ``(loss, {"loss", "nll", "aux"})``, float32 0-d
    tensors: the mean over every label of ``logsumexp(logits) -
    logits[label]``, the logsumexp in float32 and the label's logit the
    picked model-dtype element (the reference's one-hot contraction picks
    exactly it); ``aux`` the MoE layers' load-balance losses summed in
    layer order (0 without MoE), and ``loss = nll + aux``.  Each period runs under
    ``torch.utils.checkpoint`` (non-reentrant) when ``parallel.remat``, so
    the backward recomputes its forward, as the reference's
    ``jax.checkpoint`` of the period body does; the prelude layers do not."""
    if any(s.mixer == "mamba" for s in cfg.layer_pattern):
        raise NotImplementedError(
            f"{cfg.name}: Mamba training waits for the selective scan's backward kernel "
            "(ROADMAP queue 1 item 8)")
    x, positions = _inputs(cfg, params, {k: v for k, v in batch.items() if k != "labels"})
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def period(x: torch.Tensor, aux: torch.Tensor, pp: dict):
        for j, spec in enumerate(cfg.layer_pattern):
            x, _, a = _apply_slot(cfg, spec, pp[f"slot{j}"], x, positions, train=True)
            if a is not None:
                aux = aux + a
        return x, aux

    for name, spec in _prelude(cfg):
        x, _, _ = _apply_slot(cfg, spec, params[name], x, positions, train=True)
    for i in range(scanned_periods(cfg)):
        pp = _period(params["blocks"], i)
        if cfg.parallel.remat:
            x, aux = torch.utils.checkpoint.checkpoint(period, x, aux, pp, use_reentrant=False)
        else:
            x, aux = period(x, aux, pp)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    lg = L.logits(cfg, params, x)
    labels = batch["labels"].to(device=lg.device, dtype=torch.int64)
    lse = torch.logsumexp(lg.float(), dim=-1)
    ll = lg.gather(-1, labels[..., None])[..., 0].float()
    nll = (lse - ll).mean()
    loss = nll + aux
    return loss, {"loss": loss, "nll": nll, "aux": aux}


def prefill(cfg: ModelConfig, params: dict, batch: dict, *, capacity: int | None = None):
    """Process a prompt batch ``{"tokens": [B, S]}`` (``[B, S, K]`` for K
    codebooks), or ``{"embeds": [B, S, D]}`` for a model that takes
    embeddings, either with optional ``"positions"``; returns
    (last-position logits [B, V] or [B, K, V], filled cache).  An attention
    slot's cache holds ``capacity`` (default S) entries, a Mamba slot's the
    last conv inputs and the float32 state.  The filled KV cache and conv
    window take the model dtype, as the reference's do.

    The flash kernel masks by index, so attention follows the positions'
    order only where their first (t) component is ``arange(S)``; the
    reference masks by that component (ROADMAP, reference caveats)."""
    x, positions = _inputs(cfg, params, batch)
    cache = {}
    for name, spec in _prelude(cfg):
        x, cache[name], _ = _apply_slot(cfg, spec, params[name], x, positions,
                                        capacity=capacity)
    filled = {}
    for i in range(scanned_periods(cfg)):
        for j, spec in enumerate(cfg.layer_pattern):
            slot = f"slot{j}"
            x, nc, _ = _apply_slot(cfg, spec, _period(params["blocks"][slot], i), x,
                                   positions, capacity=capacity)
            filled.setdefault(slot, []).append(nc)
    cache["blocks"] = {slot: {n: torch.stack([c[n] for c in caches]) for n in caches[0]}
                       for slot, caches in filled.items()}
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    lg = L.logits(cfg, params, x[:, -1:])
    return lg[:, 0], cache


def check_position(cfg: ModelConfig, cache: dict, cache_pos: int) -> None:
    """Raise if a decode step at ``cache_pos`` would write outside ``cache``:
    a full-attention cache (KV, or MLA's latent) holds ``capacity``
    positions; a sliding-window ring and a Mamba state hold any."""
    if cache_pos < 0:
        raise ValueError(f"cache_pos {cache_pos} is negative")
    if cfg.attn is None or cfg.attn.sliding_window is not None:
        return
    for j, spec in enumerate(cfg.layer_pattern):
        if spec.mixer != "attn":
            continue
        slot = cache["blocks"][f"slot{j}"]
        C = slot["ckv" if cfg.attn.kind == "mla" else "k"].shape[2]  # [periods, B, C, ...]
        if cache_pos >= C:
            raise ValueError(f"cache_pos {cache_pos} outside a cache of {C}")


def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor, cache: dict,
                cache_pos: int | torch.Tensor):
    """One decode step.  ``tokens`` [B, 1], or embeddings [B, 1, D] for a
    model that takes embeddings (cast to the model dtype); ``cache_pos`` the
    number of tokens already in the cache, a Python int (checked by
    ``check_position``) or a 0-d int64 tensor on the cache's device (not
    checked: the caller keeps it in range), which is also the new token's
    position (t, h and w alike under M-RoPE).  Returns (logits [B, V],
    cache), the cache updated in place; K codebooks take tokens [B, 1, K]
    and give logits [B, K, V].

    The step reads its inputs, writes the cache in place and reads nothing
    back to the host, so one capture of it with a tensor position serves
    every position (``serving/decode_graph.py``)."""
    x = (L.embed(cfg, params["embed"], tokens) if cfg.embed_inputs
         else tokens.to(torch_dtype(cfg.dtype)).contiguous())
    B = x.shape[0]
    if not isinstance(cache_pos, torch.Tensor):
        check_position(cfg, cache, cache_pos)
        cache_pos = torch.full((), cache_pos, dtype=torch.int64, device=x.device)
    positions = _default_positions(cfg, B, 1, cache_pos)
    for name, spec in _prelude(cfg):
        x, _, _ = _apply_slot(cfg, spec, params[name], x, positions, cache=cache[name],
                              cache_pos=cache_pos)
    for i in range(scanned_periods(cfg)):
        for j, spec in enumerate(cfg.layer_pattern):
            slot = f"slot{j}"
            x, _, _ = _apply_slot(cfg, spec, _period(params["blocks"][slot], i), x,
                                  positions, cache=_period(cache["blocks"][slot], i),
                                  cache_pos=cache_pos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    lg = L.logits(cfg, params, x)
    return lg[:, 0], cache
