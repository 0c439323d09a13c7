"""Mixture-of-Experts FFN with capacity-based token dispatch (the
counterpart of the reference's ``repro/models/moe.py``).

Routing: the router's logits in the model dtype, cast to float32, softmax,
top-k, the k weights renormalised (``max(sum, 1e-9)``) and cast to the
model dtype.  Tokens go in ``parallel.moe_groups`` groups (one group when
the tokens do not split evenly); within a group each (token, choice)
assignment takes the next slot of its expert in token-major order, and one
past the capacity ``C = max(int(Tg * k / E * capacity_factor), k)`` is
dropped, its weight zeroed (the token keeps its residual stream).  The
capacity is that of the call: a decode step of B tokens has its own.

The experts run at capacity on ``[G, E, C, D]`` buffers, as the reference
does: three batched products over the experts (SwiGLU), then a gather of
each assignment's row, weighted and summed over the k choices; shared
experts (DeepSeek) add a dense SwiGLU on every token.  A Switch load-balance
loss (``E * sum_e f_e P_e * router_aux_weight``) is returned for training.

The reference has no TPU kernel here: its products are XLA's, and so are
the port's (``torch.bmm``).  Nothing is read back to the host (no
``.item()``, no shape that depends on the routing), so a decode step with
MoE layers is captured whole in a CUDA graph (``serving/decode_graph.py``).
Each stage runs under a ``torch.profiler.record_function`` span of its
name in :data:`SPANS` (free when no profiler runs), which
``launch/profile_serve.py`` reads to split the layer's device time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamMeta

__all__ = ["SPANS", "moe_meta", "moe", "dense_ffn_flops", "route", "slots"]

#: the profiler spans of the layer's stages, in their order
SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared")


def moe_meta(cfg: ModelConfig) -> dict:
    e = cfg.moe
    d = cfg.d_model
    f = e.d_ff_expert
    out = {
        "router": ParamMeta((d, e.num_experts), ("d_model", "experts")),
        "w_gate": ParamMeta((e.num_experts, d, f), ("experts", "d_model", "ff")),
        "w_up": ParamMeta((e.num_experts, d, f), ("experts", "d_model", "ff")),
        "w_down": ParamMeta((e.num_experts, f, d), ("experts", "ff", "d_model")),
    }
    if e.num_shared_experts:
        fs = f * e.num_shared_experts
        out["shared_gate"] = ParamMeta((d, fs), ("d_model", "ff"))
        out["shared_up"] = ParamMeta((d, fs), ("d_model", "ff"))
        out["shared_down"] = ParamMeta((fs, d), ("ff", "d_model"))
    return out


def _capacity(tokens: int, e) -> int:
    cap = int(tokens * e.top_k / e.num_experts * e.capacity_factor)
    return max(cap, e.top_k)


def route(cfg: ModelConfig, p: dict, xt: torch.Tensor):
    """xt [G, Tg, D] -> (probs [G, Tg, E] float32, gate weights [G, Tg, k] in
    the model dtype, expert indices [G, Tg, k] int64)."""
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
    gate_w, gate_i = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w.to(xt.dtype), gate_i


def slots(gate_i: torch.Tensor, num_experts: int, capacity: int):
    """Each assignment's slot among its expert's within the group, counted in
    token-major order over the group's ``Tg * k`` assignments, and whether it
    is kept (slot < capacity).  gate_i [G, Tg, k] -> (slot, keep), each
    [G, Tg * k]; a dropped assignment's slot is 0."""
    G = gate_i.shape[0]
    flat_e = gate_i.reshape(G, 1, -1)
    # the count runs along the last dim, [G, E, Tg*k]: a scan over a middle
    # dim of [G, Tg*k, E] leaves only E columns to run in parallel (8192
    # steps of 16 at DBRX's prefill: 1.5 ms a layer on the H100)
    onehot = (flat_e == torch.arange(num_experts, device=flat_e.device)[:, None]).to(
        torch.int32)
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - 1
    slot = pos.gather(1, flat_e)[:, 0]
    keep = slot < capacity
    return torch.where(keep, slot, 0), keep


def moe(cfg: ModelConfig, p: dict, x: torch.Tensor,
        act_shard=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux loss, float32 0-d).
    ``act_shard`` is accepted and not called, as in the reference (whose
    docstring names the ``[G, E, C, D]`` buffers' spec, G over the
    data-parallel axes and E over ``model``, but whose body never applies
    it).

    On DTensors (the sharded train step) the layer runs whole on every
    rank: its input gathered over the data-parallel dims and its weights
    over ``model`` (``ops.on_shards`` with everything replicated), so each
    group's routing sees the group's tokens, as the reference's values
    require, and each rank's gradients are the whole ones."""
    del act_shard
    if isinstance(x, DTensor):
        keys = sorted(p)
        rep = (Replicate(),) * x.device_mesh.ndim
        return ops.on_shards(lambda xl, *w: moe(cfg, dict(zip(keys, w)), xl),
                             (x, *(p[k] for k in keys)), (rep,) * (1 + len(keys)), (rep, rep))
    e = cfg.moe
    B, S, D = x.shape
    T = B * S
    G = max(1, cfg.parallel.moe_groups)
    if T % G:
        G = 1
    Tg = T // G
    E, K = e.num_experts, e.top_k
    C = _capacity(Tg, e)
    xt = x.reshape(G, Tg, D)

    with record_function(SPANS[0]):
        probs, gate_w, gate_i = route(cfg, p, xt)
        # load-balance aux loss (Switch): E * sum_e f_e * P_e
        f_e = (gate_i[..., 0:1] == torch.arange(E, device=x.device)).float().mean((0, 1))
        aux = E * torch.sum(f_e * probs.mean((0, 1))) * e.router_aux_weight

    # ---- dispatch: group-local scatter into [G, E, C, D] ----
    with record_function(SPANS[1]):
        slot, keep = slots(gate_i, E, C)
        w_flat = torch.where(keep, gate_w.reshape(G, Tg * K), 0)
        # each assignment's row of the flattened [G * E * C] buffer; a
        # dropped one goes to one row past the buffer, which is cut off, so
        # a kept assignment's slot receives its token alone
        gidx = torch.arange(G, device=x.device)[:, None]
        row = (gidx * E + gate_i.reshape(G, Tg * K)) * C + slot  # [G, Tg*K]
        dest = torch.where(keep, row, G * E * C).reshape(-1)
        xk = xt.repeat_interleave(K, dim=1).reshape(-1, D)  # [G*Tg*K, D], token-major
        buf = x.new_zeros(G * E * C + 1, D).index_copy_(0, dest, xk)[:-1]

    # ---- expert FFN (SwiGLU), batched over the experts ----
    with record_function(SPANS[2]):
        be = buf.view(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
        h = F.silu(torch.bmm(be, p["w_gate"])) * torch.bmm(be, p["w_up"])
        y = torch.bmm(h, p["w_down"]).view(E, G, C, D).transpose(0, 1).reshape(G * E * C, D)

    # ---- combine: group-local gather and weight ----
    with record_function(SPANS[3]):
        yk = y.index_select(0, row.reshape(-1)).view(G, Tg * K, D)
        yk = yk * w_flat[..., None].to(y.dtype)
        out = yk.view(G, Tg, K, D).sum(dim=2)

    # ---- always-on shared experts (DeepSeek) ----
    if e.num_shared_experts:
        with record_function(SPANS[4]):
            sg = F.silu(xt @ p["shared_gate"]) * (xt @ p["shared_up"])
            out = out + sg @ p["shared_down"]
    return out.reshape(B, S, D), aux


def dense_ffn_flops(cfg: ModelConfig, tokens: int) -> int:
    """Active-parameter matmul FLOPs of one MoE layer (roofline bookkeeping)."""
    e = cfg.moe
    per_tok = (e.top_k + e.num_shared_experts) * 3 * cfg.d_model * e.d_ff_expert
    return 2 * tokens * per_tok
