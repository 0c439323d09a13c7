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

On DTensors (the sharded train steps) the layer is expert-parallel, as the
reference's GSPMD partitions it under ``param_pspecs``: each rank holds
and runs its ``model`` share of the experts (or of every expert's ``ff``
columns, where the experts do not split), and, where the groups split over
the data-parallel ranks, routes only its own tokens; one sum over
``model`` gives the output (``moe``'s docstring has the placements).

The reference has no TPU kernel here: its products are XLA's, and so are
the port's (``torch.bmm``).  Nothing is read back to the host (no
``.item()``, no shape that depends on the routing), so a decode step with
MoE layers is captured whole in a CUDA graph (``serving/decode_graph.py``).
Each stage runs under a tracer span (``obs/trace.py``) of its name in
:data:`SPANS` (one check while the tracer is off and no profiler runs),
which a profiler sees as ``record_function("repro." + name)``:
``launch/profile_serve.py`` reads those ranges to split the layer's device
time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamMeta
from repro_torch.obs.trace import TRACER

__all__ = ["SPANS", "moe_meta", "moe", "dense_ffn_flops", "route", "slots", "expert_ffn"]

#: the tracer spans of the layer's stages, in their order
SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared")
_EXPERTS = ("w_gate", "w_up", "w_down")
_SHARED = ("shared_gate", "shared_up", "shared_down")
#: the mesh dims that split the batch (``training/train_step.dp_axes``)
_DP = ("pod", "data")


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


def _groups(cfg: ModelConfig, tokens: int) -> int:
    """The dispatch groups of ``tokens``: ``parallel.moe_groups``, or one
    where they do not split evenly."""
    g = max(1, cfg.parallel.moe_groups)
    return 1 if tokens % g else g


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


def expert_ffn(be: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU, batched over them: be [E, N, D] (each expert's N
    rows) -> [E, N, D], with w_gate/w_up [E, D, F] and w_down [E, F, D]."""
    h = F.silu(torch.bmm(be, w_gate)) * torch.bmm(be, w_up)
    return torch.bmm(h, w_down)


def _routed(cfg: ModelConfig, p: dict, xt: torch.Tensor, gate_w: torch.Tensor,
            gate_i: torch.Tensor, C: int, e0: int = 0) -> torch.Tensor:
    """The routed experts on the groups xt [G, Tg, D], routed by ``gate_w``
    and ``gate_i`` [G, Tg, k], at capacity ``C``: out [G, Tg, D].  ``p``'s
    experts are the ``E_l`` of its ``w_gate`` from expert ``e0`` on (every
    one, on one device): an assignment to another expert, like a dropped
    one, goes to the dispatch buffer's cut-off row and is gathered back
    from row 0 at weight 0."""
    e = cfg.moe
    G, Tg, D = xt.shape
    E, K = e.num_experts, e.top_k
    El = p["w_gate"].shape[0]

    # ---- dispatch: group-local scatter into [G, E_l, C, D] ----
    with TRACER.span(SPANS[1]):
        slot, keep = slots(gate_i, E, C)
        local = gate_i.reshape(G, Tg * K) - e0
        if El < E:  # this rank's experts only
            keep = keep & (local >= 0) & (local < El)
        w_flat = torch.where(keep, gate_w.reshape(G, Tg * K), 0)
        # each assignment's row of the flattened [G * E_l * C] buffer; a
        # dropped one goes to one row past the buffer, which is cut off, so
        # a kept assignment's slot receives its token alone
        gidx = torch.arange(G, device=xt.device)[:, None]
        row = (gidx * El + local) * C + slot  # [G, Tg*K]
        dest = torch.where(keep, row, G * El * C).reshape(-1)
        if El < E:
            row = torch.where(keep, row, 0)
        xk = xt.repeat_interleave(K, dim=1).reshape(-1, D)  # [G*Tg*K, D], token-major
        buf = xt.new_zeros(G * El * C + 1, D).index_copy_(0, dest, xk)[:-1]

    # ---- expert FFN (SwiGLU), batched over the experts ----
    with TRACER.span(SPANS[2]):
        be = buf.view(G, El, C, D).transpose(0, 1).reshape(El, G * C, D)
        y = expert_ffn(be, p["w_gate"], p["w_up"], p["w_down"])
        y = y.view(El, G, C, D).transpose(0, 1).reshape(G * El * C, D)

    # ---- combine: group-local gather and weight ----
    with TRACER.span(SPANS[3]):
        yk = y.index_select(0, row.reshape(-1)).view(G, Tg * K, D)
        yk = yk * w_flat[..., None].to(y.dtype)
        return yk.view(G, Tg, K, D).sum(dim=2)


def _shared(p: dict, xt: torch.Tensor) -> torch.Tensor:
    """The always-on shared experts (DeepSeek), a dense SwiGLU."""
    with TRACER.span(SPANS[4]):
        sg = F.silu(xt @ p["shared_gate"]) * (xt @ p["shared_up"])
        return sg @ p["shared_down"]


def moe(cfg: ModelConfig, p: dict, x: torch.Tensor,
        act_shard=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux loss, float32 0-d).
    ``act_shard`` is accepted and not called, as in the reference (whose
    docstring names the ``[G, E, C, D]`` buffers' spec, G over the
    data-parallel axes and E over ``model``, but whose body never applies
    it).

    On DTensors (both sharded train steps) the layer reads its
    placements (``_moe_sharded``).  The router is gathered whole, and
    every ``model`` rank routes the same tokens; the experts keep their
    split over ``model`` (``Shard(0)`` of ``w_gate``/``w_up``/``w_down``:
    rank ``m`` runs experts ``[m E/M, (m + 1) E/M)``; or, where ``E % M !=
    0`` and the rules gave ``model`` to ``ff``, every expert on its
    ``F/M`` columns of ``w_gate``/``w_up`` and rows of ``w_down``) and are
    gathered over the data-parallel dims alone (FSDP); DeepSeek's shared
    experts run column- and row-split likewise.  Each rank's output is
    then a partial sum, and one sum over ``model`` gives the layer's.  Two
    cases of tokens, each the reference's value:

    * groups local to the data-parallel ranks, where ``G =
      parallel.moe_groups`` splits the tokens (``T % G == 0``), ``G`` and
      the batch split over the data-parallel world ``ndp``, and ``x`` is
      ``Shard(0)`` over every data-parallel dim: rank ``(p, d)`` holds the
      ``p * data + d``-th share of rows, which is groups ``[i G/ndp, (i +
      1) G/ndp)`` for ``i = p * data + d``, and routes those alone at the
      groups' capacity;
    * otherwise ``x`` is gathered over the data-parallel dims and every
      rank routes every group (its experts' share of them).

    The shard_map step's DTensors are over ``model`` alone: there ``ndp``
    is 1, and each rank routes its own rows, as inside the reference's
    shard_map island.  The aux loss takes ``f_e`` and ``P_e`` as sums over
    each rank's tokens, summed over the data-parallel dims and divided by
    the tokens before the product: the global means.  Gradients: the
    experts' ``Shard`` over ``model`` (``Partial`` over the data-parallel
    dims where the groups are local, left for the step to reduce to their
    placement); the gate weights' ``Partial`` over ``model`` (each
    assignment's on its expert's rank alone), summed before the routing's
    backward, so that the router's is whole on every ``model`` rank."""
    del act_shard
    if isinstance(x, DTensor):
        return _moe_sharded(cfg, p, x)
    e = cfg.moe
    B, S, D = x.shape
    T = B * S
    G = _groups(cfg, T)
    Tg = T // G
    E = e.num_experts
    xt = x.reshape(G, Tg, D)

    with TRACER.span(SPANS[0]):
        probs, gate_w, gate_i = route(cfg, p, xt)
        # load-balance aux loss (Switch): E * sum_e f_e * P_e
        f_e = (gate_i[..., 0:1] == torch.arange(E, device=x.device)).float().mean((0, 1))
        aux = E * torch.sum(f_e * probs.mean((0, 1))) * e.router_aux_weight
    out = _routed(cfg, p, xt, gate_w, gate_i, _capacity(Tg, e))
    if e.num_shared_experts:
        out = out + _shared(p, xt)
    return out.reshape(B, S, D), aux


def _moe_sharded(cfg: ModelConfig, p: dict, x: DTensor) -> tuple[DTensor, DTensor]:
    """``moe`` on DTensors, expert-parallel, in two ``ops.on_shards`` calls:
    the routing (``_route_on_rank``, the same on every ``model`` rank) and
    the experts (``_experts_on_rank``, the rank's partial output), then
    the sum over ``model``."""
    e = cfg.moe
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    B, S, _ = x.shape
    T = B * S
    G = _groups(cfg, T)
    dp = [i for i, n in enumerate(names) if n in _DP]
    md = names.index("model") if "model" in names else None
    ndp = math.prod(mesh.size(i) for i in dp)
    M = mesh.size(md) if md is not None else 1
    local = G % ndp == 0 and B % ndp == 0 and all(x.placements[i].is_shard(0) for i in dp)
    rep = Replicate()
    x_in = tuple(Shard(0) if local and i in dp else rep for i in range(mesh.ndim))
    summed = Partial() if local else rep  # a sum over the rank's tokens, on a dp dim
    # x's rows, summed over model: the partial output and the gate weights' gradient
    partial = tuple(Partial() if i == md and M > 1 else q for i, q in enumerate(x_in))
    sums = tuple(summed if i in dp else rep for i in range(mesh.ndim))
    G_l = G // ndp if local else G
    placed = tuple(rep if q.is_partial() else q for q in x.placements)
    x = x.redistribute(mesh, x_in)

    gate_w, gate_i, f_sum, p_sum = ops.on_shards(
        lambda xl, r: _route_on_rank(cfg, r, xl, G_l), (x, p["router"]),
        (x_in, (rep,) * mesh.ndim), (x_in, x_in, sums, sums), (x_in, sums))

    def model_of(k):
        return p[k].placements[md] if md is not None else rep

    keys = sorted(k for k in p if k != "router")
    if M > 1 and not all(isinstance(model_of(k), Shard) for k in keys):
        raise ValueError(f"moe: model ({M}) splits neither the experts nor their ff: "
                         f"{ {k: model_of(k) for k in keys} }")
    w_in = [tuple(model_of(k) if i == md else rep for i in range(mesh.ndim)) for k in keys]
    w_grad = [tuple(summed if i in dp else q for i, q in enumerate(w)) for w in w_in]
    m = mesh.get_local_rank(md) if md is not None else 0
    e0 = m * (e.num_experts // M) if model_of("w_gate").is_shard(0) else 0

    def experts(xl, gw, gi, *ws):
        return _experts_on_rank(cfg, dict(zip(keys, ws)), xl, gw, gi, G_l, e0)

    out = ops.on_shards(experts, (x, gate_w, gate_i, *(p[k] for k in keys)),
                        (x_in, x_in, x_in, *w_in), partial, (partial, partial, x_in, *w_grad))
    # the one sum over ``model`` (its adjoint in the backward hands every
    # rank the whole cotangent), at x's own placements
    out = out.redistribute(mesh, placed)
    whole = (rep,) * mesh.ndim
    f_e = f_sum.redistribute(mesh, whole) / T
    p_e = p_sum.redistribute(mesh, whole) / T
    aux = e.num_experts * torch.sum(f_e * p_e) * e.router_aux_weight
    return out, aux


def _route_on_rank(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor, G: int):
    """One rank's routing (``_moe_sharded``): x [B_l, S, D] as ``G`` whole
    groups (every group where the tokens are gathered) -> (gate weights,
    expert indices, each [B_l, S, k], and its tokens' sums of ``f_e`` and
    ``P_e``, [E] float32)."""
    B, S, D = x.shape
    E = cfg.moe.num_experts
    with TRACER.span(SPANS[0]):
        probs, gate_w, gate_i = route(cfg, {"router": router}, x.reshape(G, -1, D))
        f_sum = (gate_i[..., 0:1] == torch.arange(E, device=x.device)).float().sum((0, 1))
    return gate_w.reshape(B, S, -1), gate_i.reshape(B, S, -1), f_sum, probs.sum((0, 1))


def _experts_on_rank(cfg: ModelConfig, p: dict, x: torch.Tensor, gate_w: torch.Tensor,
                     gate_i: torch.Tensor, G: int, e0: int) -> torch.Tensor:
    """One rank's experts (``_moe_sharded``) on x [B_l, S, D] as ``G`` whole
    groups routed by ``gate_w``/``gate_i`` [B_l, S, k], with ``p``'s local
    weights, its experts from ``e0`` on -> its partial output [B_l, S, D]."""
    B, S, D = x.shape
    Tg = B * S // G
    xt = x.reshape(G, Tg, D)
    K = gate_w.shape[-1]
    out = _routed(cfg, p, xt, gate_w.reshape(G, Tg, K), gate_i.reshape(G, Tg, K),
                  _capacity(Tg, cfg.moe), e0)
    if cfg.moe.num_shared_experts:
        out = out + _shared(p, xt)
    return out.reshape(B, S, D)


def dense_ffn_flops(cfg: ModelConfig, tokens: int) -> int:
    """Active-parameter matmul FLOPs of one MoE layer (roofline bookkeeping)."""
    e = cfg.moe
    per_tok = (e.top_k + e.num_shared_experts) * 3 * cfg.d_model * e.d_ff_expert
    return 2 * tokens * per_tok
