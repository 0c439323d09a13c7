"""Plain float32 reference of a Mamba-1 decoder at Falcon-Mamba-7B's widths:
token embedding, then per layer RMSNorm and the selective-state-space
mixer added to the residual stream; a final RMSNorm and an untied head.

The mixer: ``x z = h W_in``; a causal depthwise conv of ``d_conv`` taps
over x, its bias and SiLU; ``dt = softplus(x W_x[:r] W_dt + b_dt)``, ``B``
and ``C`` the next columns of ``x W_x``; ``A = -exp(a_log)``; the scan
``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``, ``y_t = <h_t, C_t> + D x_t``
from a zero state; out ``(y * silu(z)) W_out``.

The scan runs in chunks of L steps, each in closed form: with
``c_t = sum_{s<=t} dt_s A`` inside the chunk and ``o`` its value at the
chunk's middle, ``h_t = exp(c_t) h_0 + exp(c_t - o) sum_{s<=t} exp(o - c_s)
b_s``, exact algebra, evaluated in float32 where no exponent can overflow:
L is the largest power of two for which ``L * max(-dt A)`` stays under
``_MAX_EXPONENT`` (L = 1 is the plain recurrence).  The states entering the chunks follow from the chunks' ends
by a Hillis-Steele scan.  Differentiable by autograd; ``loss`` checkpoints
each layer.

Reads its sizes from the benchmark's configuration file and its weights
from the benchmark's draw, in the layout ``blocks/slot0/...``.  It has no
norms of dt, B and C inside the mixer (Falcon-Mamba's ``mixer_rms_eps``):
a configuration that states them is refused.  Imports plain PyTorch alone.

The family's interface, as ``llama.py``'s: ``WIDTHS``, ``SET``, ``Model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference.common import Matmul, rms_norm

__all__ = ["WIDTHS", "SET", "Model", "scan"]

WIDTHS = {
    "hidden_size": lambda c: c.d_model,
    "vocab_size": lambda c: c.vocab_size,
    "num_hidden_layers": lambda c: c.num_layers,
    "intermediate_size": lambda c: c.mamba.expand * c.d_model,
    "state_size": lambda c: c.mamba.d_state,
    "conv_kernel": lambda c: c.mamba.d_conv,
    "time_step_rank": lambda c: c.mamba.resolved_dt_rank(c.d_model),
}
SET = {"layer_norm_epsilon": "norm_eps"}

#: largest decay a chunk's closed form spans: its exponents, measured from
#: the chunk's middle, stay within +-80 (exp(80) ~ 5.5e34 in float32)
_MAX_EXPONENT = 160.0
_NAMES = ("norm1", "mixer/in_proj", "mixer/conv_w", "mixer/conv_b", "mixer/x_proj",
          "mixer/dt_w", "mixer/dt_b", "mixer/a_log", "mixer/d_skip", "mixer/out_proj")


def scan(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
         A: torch.Tensor) -> torch.Tensor:
    """y [b, S, di] of the selective scan from a zero state; dt, x [b, S, di],
    B, C [b, S, N], A [di, N], all float32."""
    b, S, di = x.shape
    dA = dt[..., None] * A  # [b, S, di, N], <= 0
    bx = (dt * x)[..., None] * Bm[:, :, None, :]
    worst = float((-dA).amax().detach()) if dA.numel() else 0.0
    L = 1
    while L * 2 <= S and (L * 2) * worst <= _MAX_EXPONENT:
        L *= 2
    pad = (-S) % L
    if pad:
        dA = F.pad(dA, (0, 0, 0, 0, 0, pad))
        bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // L
    dA = dA.view(b, nc, L, di, -1)
    bx = bx.view(b, nc, L, di, -1)
    cum = dA.cumsum(2)
    decay = torch.exp(cum)
    if L == 1:  # the plain recurrence: from a zero start a step's state is its b
        local = bx
    else:  # from a zero start; both exponents measured from the chunk's middle
        mid = cum[:, :, L // 2 - 1:L // 2]
        local = torch.exp(cum - mid) * torch.cumsum(torch.exp(mid - cum) * bx, dim=2)
    # the state at each chunk's end, H_c = a_c H_{c-1} + e_c (a_c the chunk's
    # whole decay, e_c its end from a zero start), by a Hillis-Steele scan
    # over the chunks: log2(nc) rounds, each on every chunk at once
    a, H = decay[:, :, -1], local[:, :, -1]
    k = 1
    while k < nc:
        H = torch.cat([H[:, :k], H[:, k:] + a[:, k:] * H[:, :-k]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    h0 = torch.cat([torch.zeros_like(H[:, :1]), H[:, :-1]], 1)  # entering each chunk
    hall = (local + decay * h0[:, :, None]).view(b, nc * L, di, -1)[:, :S]
    return torch.einsum("bsdn,bsn->bsd", hall, Cm)


class Model:
    def __init__(self, cfg: dict, weights: dict, precision: str = "float32"):
        if cfg.get("mixer_rms_eps") is not None:
            raise ValueError("this reference has no norms of dt, B and C inside the mixer")
        self.cfg, self.w, self.mm = cfg, weights, Matmul(precision)
        self.L = cfg["num_hidden_layers"]
        self.D = cfg["hidden_size"]
        self.di = cfg["intermediate_size"]
        self.N = cfg["state_size"]
        self.r = cfg["time_step_rank"]
        self.k = cfg["conv_kernel"]
        self.eps = cfg["layer_norm_epsilon"]

    def layer_weights(self, l: int) -> dict:
        return {n: self.w["blocks/slot0/" + n][l].float() for n in _NAMES}

    def mixer(self, h: torch.Tensor, lw: dict) -> torch.Tensor:
        b, S, _ = h.shape
        xz = self.mm(h, lw["mixer/in_proj"])
        xin, z = xz[..., :self.di], xz[..., self.di:]
        xp = F.pad(xin, (0, 0, self.k - 1, 0))
        xc = sum(xp[:, w:w + S] * lw["mixer/conv_w"][w] for w in range(self.k))
        xc = F.silu(xc + lw["mixer/conv_b"])
        proj = self.mm(xc, lw["mixer/x_proj"])
        dt = F.softplus(self.mm(proj[..., :self.r], lw["mixer/dt_w"]) + lw["mixer/dt_b"])
        Bm = proj[..., self.r:self.r + self.N]
        Cm = proj[..., self.r + self.N:]
        A = -torch.exp(lw["mixer/a_log"])
        y = scan(dt, xc, Bm, Cm, A) + lw["mixer/d_skip"] * xc
        return self.mm(y * F.silu(z), lw["mixer/out_proj"])

    def block(self, x: torch.Tensor, lw: dict) -> torch.Tensor:
        return x + self.mixer(rms_norm(x, lw["norm1"], self.eps), lw)

    @torch.no_grad()
    def logits_at(self, tokens: torch.Tensor, rows: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """Float32 logits [n, V] at ``(rows[i], positions[i])``."""
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
