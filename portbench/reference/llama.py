"""Plain float32 reference of a Llama-architecture decoder (Yi-6B): token
embedding, then per layer RMSNorm, grouped-query attention with rotary
embeddings (rotate-half), RMSNorm and a SwiGLU MLP, each added to the
residual stream; a final RMSNorm and an untied head.

It reads its sizes from the benchmark's configuration file and its
weights from the benchmark's draw (``portbench/weights.py``), in the
layout ``blocks/slot0/...`` with the layers stacked in front.  It runs
layer by layer, casting one layer's weights to float32 at a time, and the
attention in blocks of queries, so that it fits beside nothing else on the
card; ``loss`` checkpoints each layer.  Imports plain PyTorch alone.

The family's interface, which the harness finds by a configuration's
``family``: ``WIDTHS`` (each published key and how the port's
``ModelConfig`` states it, checked key by key), ``SET`` (the published keys
the port's config takes from the file) and ``Model`` (``logits_at``,
``loss``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference.common import Matmul, rms_norm

__all__ = ["WIDTHS", "SET", "Model"]

WIDTHS = {
    "hidden_size": lambda c: c.d_model,
    "intermediate_size": lambda c: c.d_ff,
    "vocab_size": lambda c: c.vocab_size,
    "num_hidden_layers": lambda c: c.num_layers,
    "num_attention_heads": lambda c: c.attn.num_heads,
    "num_key_value_heads": lambda c: c.attn.num_kv_heads,
    "head_dim": lambda c: c.attn.head_dim,
    "rope_theta": lambda c: c.attn.rope_theta,
}
SET = {"rms_norm_eps": "norm_eps"}
_NAMES = ("norm1", "norm2", "mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo",
          "ffn/w_gate", "ffn/w_up", "ffn/w_down")

#: queries a block of the reference's attention takes at once
Q_BLOCK = 1024


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd], pos [S]; llama's rotate-half layout, float32."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.float()[:, None] * freqs  # [S, hd/2]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Model:
    def __init__(self, cfg: dict, weights: dict, precision: str = "float32"):
        self.cfg, self.w, self.mm = cfg, weights, Matmul(precision)
        self.L = cfg["num_hidden_layers"]
        self.D = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.Hkv = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or self.D // self.H
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]

    def layer_weights(self, l: int) -> dict:
        return {n: self.w["blocks/slot0/" + n][l].float() for n in _NAMES}

    def _attention(self, h: torch.Tensor, lw: dict) -> torch.Tensor:
        B, S, _ = h.shape
        H, Hkv, hd = self.H, self.Hkv, self.hd
        pos = torch.arange(S, device=h.device)
        q = rope(self.mm(h, lw["mixer/wq"]).view(B, S, H, hd), pos, self.theta)
        k = rope(self.mm(h, lw["mixer/wk"]).view(B, S, Hkv, hd), pos, self.theta)
        v = self.mm(h, lw["mixer/wv"]).view(B, S, Hkv, hd)
        k = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)  # [B, H, S, hd]
        v = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)
        scale = 1.0 / math.sqrt(hd)
        blocks = []
        for s0 in range(0, S, Q_BLOCK):
            s1 = min(S, s0 + Q_BLOCK)
            sc = (q[:, :, s0:s1] @ k[:, :, :s1].transpose(-1, -2)) * scale
            qi = torch.arange(s0, s1, device=h.device)[:, None]
            ki = torch.arange(s1, device=h.device)[None, :]
            sc = sc.masked_fill(ki > qi, float("-inf"))
            blocks.append(torch.softmax(sc, dim=-1) @ v[:, :, :s1])
        out = torch.cat(blocks, dim=2)
        return self.mm(out.transpose(1, 2).reshape(B, S, H * hd), lw["mixer/wo"])

    def block(self, x: torch.Tensor, lw: dict) -> torch.Tensor:
        x = x + self._attention(rms_norm(x, lw["norm1"], self.eps), lw)
        h = rms_norm(x, lw["norm2"], self.eps)
        f = F.silu(self.mm(h, lw["ffn/w_gate"])) * self.mm(h, lw["ffn/w_up"])
        return x + self.mm(f, lw["ffn/w_down"])

    @torch.no_grad()
    def logits_at(self, tokens: torch.Tensor, rows: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """Float32 logits [n, V] at ``(rows[i], positions[i])`` of the
        causal forward over ``tokens`` [B, S]."""
        x = self.w["embed/embedding"][tokens].float()
        for l in range(self.L):
            x = self.block(x, self.layer_weights(l))
        x = rms_norm(x[rows, positions], self.w["final_norm"].float(), self.eps)
        return self.mm(x, self.w["head/lm_head"].float())

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy over every label, differentiable in ``params``
        (``{path: [per-layer float32 leaves] or a leaf}``); each layer
        recomputed in the backward."""
        x = params["embed/embedding"][tokens]
        for l in range(self.L):
            lw = {n: params["blocks/slot0/" + n][l] for n in _NAMES}
            x = torch.utils.checkpoint.checkpoint(self.block, x, lw, use_reentrant=False)
        x = rms_norm(x, params["final_norm"], self.eps)
        lg = self.mm(x, params["head/lm_head"])
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))
