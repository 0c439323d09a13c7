"""Building blocks: RMSNorm, MLP, token embedding, LM head and rotary
embeddings, M-RoPE's included (the counterpart of the reference's
``repro/models/layers.py``).

Each block has a ``*_meta`` builder (see :mod:`repro_torch.models.params`)
and a forward function on tensors.  ``rms_norm`` runs on the RMSNorm kernel
on the card, and where a gradient is wanted its backward runs on the RMSNorm
backward kernel; the other blocks are differentiated by autograd.  On
DTensors (the sharded train step) every block runs on DTensor's sharding
propagation, and ``rms_norm`` runs shard by shard: each rank's rows of
``x`` through the kernels, ``w`` gathered, and ``w``'s gradient ``Partial``
over the mesh dims that shard the rows (each rank's ``dw`` sums its own
rows only).

``assign`` and ``write_at`` are the caches' in-place writes (a Mamba
state, a decode step's new key at its position), on tensors and on
DTensors placed by ``launch/specs.cache_pspecs``: each rank writes its own
shard, and where the cache's sequence dim is split over a mesh dim only
the rank that holds the position writes (GSPMD's masked
``dynamic_update_slice``); nothing is read back to the host.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamMeta

__all__ = [
    "rms_norm",
    "rms_norm_meta",
    "mlp_meta",
    "mlp",
    "embed_meta",
    "embed",
    "head_meta",
    "logits",
    "rope",
    "mrope_positions",
    "assign",
    "unflatten",
    "write_at",
]


def rms_norm_meta(d: int) -> ParamMeta:
    return ParamMeta((d,), ("d_model",), init="ones")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return ops.rmsnorm(x, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = ops.rmsnorm_bwd(x, w, dy.contiguous(), eps=ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last dim, in float32, cast
    to ``x.dtype``.  Differentiable in x and w (through the backward kernel)
    when autograd records; serving calls the forward kernel alone.  A
    DTensor ``x`` is normalised on each rank's rows (``ops.on_shards``)."""
    if isinstance(x, DTensor):
        xp = ops.rows(x, *range(x.ndim - 1))
        return ops.on_shards(rms_norm, (x, w, eps), (xp, (Replicate(),) * len(xp), None), xp,
                             (xp, ops.summed_over(xp, *range(x.ndim - 1)), None))
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return ops.rmsnorm(x, w, eps=eps)


def mlp_meta(d: int, ff: int, act: str) -> dict:
    if act in ("silu", "geglu"):
        return {
            "w_gate": ParamMeta((d, ff), ("d_model", "ff")),
            "w_up": ParamMeta((d, ff), ("d_model", "ff")),
            "w_down": ParamMeta((ff, d), ("ff", "d_model")),
        }
    return {
        "w_up": ParamMeta((d, ff), ("d_model", "ff")),
        "w_down": ParamMeta((ff, d), ("ff", "d_model")),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act in ("silu", "geglu"):
        g = x @ p["w_gate"]
        g = F.silu(g) if act == "silu" else _gelu(g)
        return (g * (x @ p["w_up"])) @ p["w_down"]
    return _gelu(x @ p["w_up"]) @ p["w_down"]


def embed_meta(cfg: ModelConfig) -> dict:
    """One ``[V, D]`` table, or ``[K, V, D]`` for K codebooks; none for a
    model that takes embeddings (``embed_inputs=False``)."""
    if not cfg.embed_inputs:
        return {}
    v, d, k = cfg.padded_vocab, cfg.d_model, cfg.num_codebooks
    if k > 1:
        return {"embedding": ParamMeta((k, v, d), ("layers", "vocab", "d_model"), scale=0.02)}
    return {"embedding": ParamMeta((v, d), ("vocab", "d_model"), scale=0.02)}


def embed(cfg: ModelConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] integer, or [B, S, K] for K codebooks -> [B, S, D].  A
    gather: the reference's one-hot matmul picks exactly one row, so the
    two agree bit for bit.  K codebooks' embeddings are summed in codebook
    order (MusicGen's parallel pattern), as in the reference.  A DTensor
    table is gathered and each rank picks its own tokens' rows
    (``ops.on_shards``), the table's gradient ``Partial`` over the mesh
    dims that shard the tokens."""
    emb = p["embedding"]
    if isinstance(emb, DTensor):
        rep = (Replicate(),) * emb.device_mesh.ndim
        tp = ops.rows(tokens, *range(tokens.ndim)) if isinstance(tokens, DTensor) else None
        xp = rep if tp is None else ops.moved(tp, {0: 0, 1: 1})
        dw = rep if tp is None else ops.summed_over(tp, 0, 1)
        return ops.on_shards(lambda e, t: embed(cfg, {"embedding": e}, t), (emb, tokens),
                             (rep, tp), xp, (dw, tp))
    if cfg.num_codebooks > 1:
        x = emb[0][tokens[..., 0]]
        for k in range(1, cfg.num_codebooks):
            x = x + emb[k][tokens[..., k]]
    else:
        x = emb[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    return x


def _tied(cfg: ModelConfig) -> bool:
    return cfg.tie_embeddings and cfg.embed_inputs and cfg.num_codebooks == 1


def head_meta(cfg: ModelConfig) -> dict:
    """None when tied to a one-codebook embedding table; else ``[D, V]``, or
    ``[D, K * V]`` for K codebooks."""
    if _tied(cfg):
        return {}
    return {"lm_head": ParamMeta((cfg.d_model, cfg.num_codebooks * cfg.padded_vocab),
                                 ("d_model", "vocab"))}


def logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, V] over the padded vocab, or [B, S, K, V]."""
    if _tied(cfg):
        return x @ params["embed"]["embedding"].T
    out = x @ params["head"]["lm_head"]
    if cfg.num_codebooks > 1:
        out = unflatten(out, out.ndim - 1, (cfg.num_codebooks, cfg.padded_vocab))
    return out


def unflatten(t: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``t.unflatten(dim, sizes)``.  A DTensor whose split of ``dim`` does
    not fall on whole ``sizes[0]`` blocks (Yi's 4 kv heads, MusicGen's 4
    codebooks, over a ``model`` of 16) is gathered on it first."""
    if isinstance(t, DTensor):
        mesh, pl = t.device_mesh, t.placements
        on = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == dim]
        if sizes[0] % math.prod(mesh.size(i) for i in on):
            t = t.redistribute(mesh, tuple(Replicate() if i in on else p
                                           for i, p in enumerate(pl)))
    return t.unflatten(dim, sizes)


def mrope_positions(positions: torch.Tensor, sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: ``positions`` [B, S, 3] (t, h, w) ->
    per-frequency positions [B, S, hd/2], the first ``sections[0]``
    frequencies at t, the next ``sections[1]`` at h, the rest at w."""
    return torch.cat([positions[..., i:i + 1].expand(*positions.shape[:-1], sec)
                      for i, sec in enumerate(sections)], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
         sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """Rotary embedding, llama "rotate-half" layout.  x [B, S, H, hd];
    positions [B, S], or [B, S, 3] with M-RoPE's ``sections``.  cos and sin
    are cast to ``x.dtype`` before the multiply, as in the reference."""
    head_dim = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=x.device) / head_dim))
    if sections is not None:
        pos = mrope_positions(positions, sections).to(torch.float32)  # [B, S, hd/2]
    else:
        pos = positions.to(torch.float32)[..., None]
    angles = pos * freqs  # [B, S, hd/2]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # [B, S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a DTensor ``dst`` takes ``src`` at its own
    placements, each rank copying into its shard."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    dst.to_local().copy_(src.redistribute(dst.device_mesh, dst.placements).to_local())


def write_at(cache: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[:, pos] = new[:, 0]`` in place (``index_copy_`` along dim 1,
    ``new`` cast to the cache's dtype); ``pos`` a 0-d int64 tensor.  On a
    DTensor each rank writes its shard of ``new``; where the cache's dim 1
    is split over a mesh dim, the rank whose slice holds ``pos`` writes it
    and every other rank writes back what it holds."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, pos.reshape(1), new.to(cache.dtype))
        return
    mesh, pl = cache.device_mesh, cache.placements
    seq = [d for d, p in enumerate(pl) if isinstance(p, Shard) and p.dim == 1]
    want = tuple(Replicate() if d in seq else p for d, p in enumerate(pl))
    new = new.redistribute(mesh, want).to_local().to(cache.dtype)
    local = cache.to_local()
    idx = pos.reshape(1)
    if seq:
        coord, size = mesh.get_coordinate(), local.shape[1]
        block = 0
        for d in seq:  # the rank's slice, the mesh dims in order
            block = block * mesh.size(d) + coord[d]
        off = idx - block * size
        inside = ((off >= 0) & (off < size)).reshape(())
        idx = off.clamp(0, size - 1)
        new = torch.where(inside, new, local.index_select(1, idx))
    local.index_copy_(1, idx, new)
