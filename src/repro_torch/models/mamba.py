"""Mamba-1 selective-state-space mixer (the counterpart of the reference's
``repro/models/mamba.py``), forward only.

Two compute paths:

* prefill — the causal depthwise conv, written as the reference writes it
  (a sum of shifted float32 scalings), the discretised scan terms
  (``_ssm_terms``), then the selective scan through ``ops.mamba_scan`` (the
  scan kernel on the card) from a zero state.  The reference's prefill runs
  a chunked associative scan, which computes the same recurrence with its
  products in another order.  Prefill returns the filled cache: the last
  ``d_conv - 1`` conv inputs and the last state.
* decode — the O(1) recurrent step over that cache, in plain PyTorch ops,
  as in the reference (it has no TPU kernel).  The cache is updated in
  place.

The reference's ``selective_scan`` custom VJP (the training path, with the
reverse recurrence of ``_scan_bwd``) comes with the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamMeta

__all__ = ["mamba_meta", "mamba", "init_mamba_cache"]


def mamba_meta(cfg: ModelConfig) -> dict:
    m = cfg.mamba
    d = cfg.d_model
    di = m.expand * d
    r = m.resolved_dt_rank(d)
    return {
        "in_proj": ParamMeta((d, 2 * di), ("d_model", "d_inner")),
        "conv_w": ParamMeta((m.d_conv, di), (None, "d_inner")),
        "conv_b": ParamMeta((di,), ("d_inner",), init="zeros"),
        "x_proj": ParamMeta((di, r + 2 * m.d_state), ("d_inner", None)),
        "dt_w": ParamMeta((r, di), (None, "d_inner")),
        "dt_b": ParamMeta((di,), ("d_inner",), init="ones"),
        "a_log": ParamMeta((di, m.d_state), ("d_inner", None), init="a_log"),
        "d_skip": ParamMeta((di,), ("d_inner",), init="ones"),
        "out_proj": ParamMeta((di, d), ("d_inner", "d_model")),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, *, device,
                     dtype=torch.bfloat16) -> dict:
    """Zero cache for ONE Mamba layer: the conv window in ``dtype`` (bf16
    whatever the model dtype, as the reference's), the state in float32."""
    m = cfg.mamba
    di = m.expand * cfg.d_model
    return {
        "conv": torch.zeros(batch, m.d_conv - 1, di, dtype=dtype, device=device),
        "ssm": torch.zeros(batch, di, m.d_state, dtype=torch.float32, device=device),
    }


def _ssm_terms(cfg: ModelConfig, p: dict, xz: torch.Tensor):
    """From the conv+silu branch activation x [B, S, di], the discretised
    scan terms a, b [B, S, di, N] (float32, contiguous) and the per-step
    readout C [B, S, N] (model dtype)."""
    m = cfg.mamba
    r = m.resolved_dt_rank(cfg.d_model)
    proj = xz @ p["x_proj"]  # [B, S, r + 2N]
    dt = F.softplus(proj[..., :r] @ p["dt_w"] + p["dt_b"])  # [B, S, di], model dtype
    B_ssm = proj[..., r:r + m.d_state]
    C_ssm = proj[..., r + m.d_state:]
    A = -torch.exp(p["a_log"].float())  # [di, N]
    dt32 = dt.float()
    a = (dt32[..., None] * A).exp_()  # in place: a is 1.07 GB at the serving shape
    b = (dt32 * xz.float())[..., None] * B_ssm.float()[..., None, :]
    return a, b, C_ssm


def mamba(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # [B, S, D]
    *,
    cache: dict | None = None,  # decode: this layer's cache, updated in place
) -> tuple[torch.Tensor, dict]:
    """Prefill when ``cache`` is None (returns the filled cache), else one
    decode step (S == 1) against ``cache``."""
    m = cfg.mamba
    B, S, D = x.shape
    di = m.expand * D
    xz = x @ p["in_proj"]  # [B, S, 2*di]
    xin, z = xz[..., :di], xz[..., di:]

    if cache is not None:
        # ---------- O(1) decode step ----------
        window = torch.cat([cache["conv"], xin], dim=1)  # [B, d_conv, di]
        xc = torch.einsum("bwd,wd->bd", window.float(), p["conv_w"].float())
        xc = F.silu(xc + p["conv_b"].float())[:, None].to(x.dtype)
        a, b, C_ssm = _ssm_terms(cfg, p, xc)
        h = a[:, 0] * cache["ssm"] + b[:, 0]  # [B, di, N]
        y = torch.einsum("bdn,bn->bd", h, C_ssm[:, 0].float())
        y = y[:, None] + p["d_skip"].float() * xc.float()
        cache["conv"].copy_(window[:, 1:])
        cache["ssm"].copy_(h)
        new_cache = cache
    else:
        # ---------- prefill: causal depthwise conv + selective scan ----------
        pad = torch.zeros(B, m.d_conv - 1, di, dtype=x.dtype, device=x.device)
        xin_p = torch.cat([pad, xin], dim=1)  # [B, S + d_conv - 1, di]
        xc = torch.zeros(B, S, di, dtype=torch.float32, device=x.device)
        for w in range(m.d_conv):
            xc = xc + xin_p[:, w:w + S].float() * p["conv_w"][w].float()
        xc = F.silu(xc + p["conv_b"].float()).to(x.dtype)
        a, b, C_ssm = _ssm_terms(cfg, p, xc)
        y, h_last = ops.mamba_scan(a, b, C_ssm.float().contiguous())
        del a, b
        y = y + p["d_skip"].float() * xc.float()
        new_cache = {"conv": xin_p[:, S:], "ssm": h_last}

    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y, new_cache
