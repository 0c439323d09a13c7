"""Decoder LM: embedding -> loop over layers -> final norm -> head (the
counterpart of the reference's ``repro/models/lm.py``).

Parameters keep the reference's layout: the repeating ``layer_pattern`` is
stacked on a leading periods axis under ``blocks/slot<i>``, so a weight maps
one to one onto the reference's.  A Python loop over the periods replaces
``lax.scan``.

Entry points:

* ``loss_fn``      — the training forward and its cross-entropy
  (``{"tokens"}`` or ``{"embeds"}`` with ``"labels"``), differentiable in
  the parameters through the flash, selective-scan and RMSNorm backward
  kernels, each period rematerialised in the backward when
  ``parallel.remat``;
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
that remain.  Every config trains: attention through the flash kernels
(MLA in its expanded form, at its pair of head dims), Mamba through the
selective scan's custom VJP with its terms formed inside the kernels
(``mamba.selective_scan_fused``, the fused backward kernel), the hybrid
(Jamba) through both.

Served sharded (the reference's dry-run cells), ``prefill`` and
``decode_step`` take the parameters as DTensors placed by
``param_pspecs`` (``models/params.shard_params``), the prompt or tokens
placed by ``launch/specs.batch_pspecs`` and, for decode, the cache placed
by ``launch/specs.cache_pspecs`` (``launch/specs.shard_cache``); with
``act_shard`` (``training/train_step.make_act_shard``) the residual
stream's batch is pinned to the data-parallel mesh dims at the backbone's
entry and at every period, as the reference's hook does.  The filled or
updated cache comes back placed by ``cache_pspecs`` (the reference's
``out_shardings``), the last-position logits replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import resolve_device
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.params import (abstract_params, init_params, map_tree, placements,
                                       torch_dtype)

__all__ = ["model_meta", "init_model", "abstract_model", "init_cache", "abstract_cache",
           "loss_fn", "prefill", "decode_step", "check_position", "scanned_periods"]


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


def abstract_model(cfg: ModelConfig) -> dict:
    """The parameters on the meta device: the reference's shapes and dtype,
    no storage."""
    return abstract_params(model_meta(cfg), dtype=torch_dtype(cfg.dtype))


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


def abstract_cache(cfg: ModelConfig, batch: int, capacity: int) -> dict:
    """``init_cache`` on the meta device: every cache's shape and dtype."""
    return init_cache(cfg, batch, capacity, device="meta")


def _apply_slot(cfg, spec, p, x, positions, *, cache=None, cache_pos=None,
                capacity=None, train=False, act_shard=None, layer=None):
    """One layer (``layer``: its index, for the mixer's span): (x, its
    filled or updated cache, its MoE aux loss or None)."""
    aux = None
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        res = attn_mod.attention(cfg, p["mixer"], h, positions, cache=cache,
                                 cache_pos=cache_pos, capacity=capacity, train=train,
                                 layer=layer)
        mix, new_cache = res.out, res.cache
    else:
        mix, new_cache = mamba_mod.mamba(cfg, p["mixer"], h, cache=cache, train=train,
                                         layer=layer)
    x = x + mix
    if spec.ffn != "none":
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        if spec.ffn == "dense":
            f = L.mlp(p["ffn"], h2, cfg.act)
        else:
            f, aux = moe_mod.moe(cfg, p["ffn"], h2, act_shard=act_shard)
        x = x + f
    return x, new_cache, aux


def _layer(cfg: ModelConfig, first: int, i: int, j: int) -> int:
    """The index of period ``i``'s slot ``j`` after ``first`` prelude layers."""
    return first + i * len(cfg.layer_pattern) + j


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


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            act_shard=None) -> tuple[torch.Tensor, dict]:
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
    ``jax.checkpoint`` of the period body does; the prelude layers do not.

    ``act_shard`` (``training/train_step.make_act_shard``; DTensor
    parameters and batch) pins the residual stream's batch dim to the
    data-parallel mesh dims at the backbone's entry and at the start of
    every period, as the reference's hook does."""
    x, positions = _inputs(cfg, params, {k: v for k, v in batch.items() if k != "labels"})
    aux = torch.zeros((), dtype=torch.float32, device=positions.device)
    if act_shard is not None:
        x = act_shard(x)

    first = len(_prelude(cfg))

    def period(x: torch.Tensor, aux: torch.Tensor, pp: dict, i: int):
        if act_shard is not None:
            x = act_shard(x)
        for j, spec in enumerate(cfg.layer_pattern):
            x, _, a = _apply_slot(cfg, spec, pp[f"slot{j}"], x, positions, train=True,
                                  act_shard=act_shard, layer=_layer(cfg, first, i, j))
            if a is not None:
                aux = aux + a
        return x, aux

    for n, (name, spec) in enumerate(_prelude(cfg)):
        x, _, _ = _apply_slot(cfg, spec, params[name], x, positions, train=True,
                              act_shard=act_shard, layer=n)
    for i in range(scanned_periods(cfg)):
        pp = _period(params["blocks"], i)
        if cfg.parallel.remat:
            x, aux = torch.utils.checkpoint.checkpoint(period, x, aux, pp, i,
                                                       use_reentrant=False)
        else:
            x, aux = period(x, aux, pp, i)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    lg = L.logits(cfg, params, x)
    labels = batch["labels"].to(device=lg.device, dtype=torch.int64)
    if isinstance(lg, DTensor):
        nll = _sharded_nll(lg, labels)
    else:
        nll = _token_nll(lg, labels).mean()
    loss = nll + aux
    return loss, {"loss": loss, "nll": nll, "aux": aux}


def _token_nll(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each label's ``logsumexp(logits) - logits[label]``, float32."""
    lse = torch.logsumexp(lg.float(), dim=-1)
    return lse - lg.gather(-1, labels[..., None])[..., 0].float()


def _sharded_nll(lg: DTensor, labels) -> DTensor:
    """The mean of ``_token_nll`` over DTensor logits: each rank's rows,
    with the whole vocabulary gathered, summed on the rank
    (``ops.on_shards``; ``Partial`` over the mesh dims that shard the rows),
    then divided by the number of labels.  ``labels``: a DTensor placed
    like the rows, or each rank's own rows."""
    lp = ops.rows(lg, *range(lg.ndim - 1))
    total = ops.on_shards(lambda lgl, lbl: _token_nll(lgl, lbl).sum(), (lg, labels),
                          (lp, lp if isinstance(labels, DTensor) else None),
                          ops.summed_over(lp, *range(lg.ndim - 1)))
    return total / labels.numel()


def _serving(params: dict):
    """Mixing plain tensors (positions, masks) into DTensor ops, as the
    sharded step does: ``implicit_replication`` where the parameters are
    DTensors."""
    if isinstance(params["final_norm"], DTensor):
        return implicit_replication()
    return contextlib.nullcontext()


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh dim (a tensor as it is)."""
    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)
    return t


def _shifted(pl: tuple, by: int) -> tuple:
    return tuple(Shard(p.dim + by) if isinstance(p, Shard) else p for p in pl)


def _period_cache(tree: dict, i: int) -> dict:
    """Period ``i`` of a stacked cache, a view of its storage (a DTensor's
    of each rank's shard), which a decode step writes in place."""
    def one(_, t):
        if not isinstance(t, DTensor):
            return t[i]
        return DTensor.from_local(t.to_local()[i], t.device_mesh, _shifted(t.placements, -1),
                                  run_check=False, shape=t.shape[1:], stride=t.stride()[1:])
    return map_tree(one, tree)


def _place_filled(cfg: ModelConfig, mesh, prelude: dict, filled: dict) -> dict:
    """A sharded prefill's cache placed by ``cache_pspecs``: each prelude
    layer's, and each slot's periods stacked on each rank."""
    from repro_torch.launch.specs import cache_pspecs  # it imports this module

    def like(shape):  # the shape alone: a view of one element, no cache-sized storage
        return torch.empty((), device="meta").expand(shape)

    stacked = {slot: {n: (len(caches),) + tuple(t.shape) for n, t in caches[0].items()}
               for slot, caches in filled.items()}
    specs = cache_pspecs(cfg, mesh, {
        "blocks": map_tree(lambda _, shape: like(shape), stacked),
        **{name: map_tree(lambda _, t: like(t.shape), c) for name, c in prelude.items()}})
    out = {name: map_tree(lambda _, t, spec: t.redistribute(mesh, placements(spec, mesh)),
                          c, specs[name]) for name, c in prelude.items()}
    blocks = {}
    for slot, caches in filled.items():
        blocks[slot] = {}
        for n, spec in specs["blocks"][slot].items():
            pl = placements(spec, mesh)
            local = torch.stack([c[n].redistribute(mesh, _shifted(pl, -1)).to_local()
                                 for c in caches])
            shape = stacked[slot][n]
            stride = [1] * len(shape)
            for d in range(len(shape) - 2, -1, -1):
                stride[d] = stride[d + 1] * shape[d + 1]
            blocks[slot][n] = DTensor.from_local(local, mesh, pl, run_check=False,
                                                 shape=torch.Size(shape), stride=tuple(stride))
    out["blocks"] = blocks
    return out


def prefill(cfg: ModelConfig, params: dict, batch: dict, *, capacity: int | None = None,
            act_shard=None):
    """Process a prompt batch ``{"tokens": [B, S]}`` (``[B, S, K]`` for K
    codebooks), or ``{"embeds": [B, S, D]}`` for a model that takes
    embeddings, either with optional ``"positions"``; returns
    (last-position logits [B, V] or [B, K, V], filled cache).  An attention
    slot's cache holds ``capacity`` (default S) entries, a Mamba slot's the
    last conv inputs and the float32 state.  The filled KV cache and conv
    window take the model dtype, as the reference's do.

    The flash kernel masks by index, so attention follows the positions'
    order only where their first (t) component is ``arange(S)``; the
    reference masks by that component (ROADMAP, reference caveats).

    On DTensor parameters (the module docstring) the cache comes back
    placed by ``cache_pspecs`` and the logits replicated; ``act_shard``
    pins the batch at the entry and at every period."""
    with _serving(params):
        x, positions = _inputs(cfg, params, batch)
        if act_shard is not None:
            x = act_shard(x)
        cache = {}
        prelude = _prelude(cfg)
        for n, (name, spec) in enumerate(prelude):
            x, cache[name], _ = _apply_slot(cfg, spec, params[name], x, positions,
                                            capacity=capacity, act_shard=act_shard, layer=n)
        filled = {}
        for i in range(scanned_periods(cfg)):
            if act_shard is not None:
                x = act_shard(x)
            for j, spec in enumerate(cfg.layer_pattern):
                slot = f"slot{j}"
                x, nc, _ = _apply_slot(cfg, spec, _period(params["blocks"][slot], i), x,
                                       positions, capacity=capacity, act_shard=act_shard,
                                       layer=_layer(cfg, len(prelude), i, j))
                filled.setdefault(slot, []).append(nc)
        if isinstance(x, DTensor):
            cache = _place_filled(cfg, x.device_mesh, cache, filled)
        else:
            cache["blocks"] = {slot: {n: torch.stack([c[n] for c in caches])
                                      for n in caches[0]}
                               for slot, caches in filled.items()}
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        lg = _replicated(L.logits(cfg, params, x[:, -1:]))
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
                cache_pos: int | torch.Tensor, *, act_shard=None):
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
    every position (``serving/decode_graph.py``).

    On DTensor parameters and a cache placed by ``cache_pspecs`` each rank
    writes its cache shard in place and the logits come back replicated;
    ``act_shard`` pins the batch at the entry and at every period (the
    reference's dry-run passes none where the batch does not split over
    the data-parallel ranks)."""
    with _serving(params):
        x = (L.embed(cfg, params["embed"], tokens) if cfg.embed_inputs
             else tokens.to(torch_dtype(cfg.dtype)).contiguous())
        if act_shard is not None:
            x = act_shard(x)
        B = x.shape[0]
        if not isinstance(cache_pos, torch.Tensor):
            check_position(cfg, cache, cache_pos)
            cache_pos = torch.full((), cache_pos, dtype=torch.int64, device=x.device)
        positions = _default_positions(cfg, B, 1, cache_pos)
        prelude = _prelude(cfg)
        for n, (name, spec) in enumerate(prelude):
            x, _, _ = _apply_slot(cfg, spec, params[name], x, positions, cache=cache[name],
                                  cache_pos=cache_pos, act_shard=act_shard, layer=n)
        for i in range(scanned_periods(cfg)):
            if act_shard is not None:
                x = act_shard(x)
            for j, spec in enumerate(cfg.layer_pattern):
                slot = f"slot{j}"
                x, _, _ = _apply_slot(cfg, spec, _period(params["blocks"][slot], i), x,
                                      positions, cache=_period_cache(cache["blocks"][slot], i),
                                      cache_pos=cache_pos, act_shard=act_shard,
                                      layer=_layer(cfg, len(prelude), i, j))
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        lg = _replicated(L.logits(cfg, params, x))
        return lg[:, 0], cache
