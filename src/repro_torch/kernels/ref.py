"""Plain PyTorch versions of the kernels (the counterparts of the
reference's ``repro/kernels/ref.py``).  The CPU path runs them, and the
chip check holds each CUDA kernel against them on the card."""

from __future__ import annotations

import math

import torch

__all__ = ["a2a_pack_ref", "flash_attention_ref", "mamba_scan_ref", "rmsnorm_ref",
           "scaled_err"]

_NEG = -1e30


#: float32 scores the plain attention holds at once (1 GiB): longer inputs
#: are taken in chunks of query rows, which leaves each row's softmax as it is
_SCORES_AT_ONCE = 2**28


def flash_attention_ref(
    q: torch.Tensor,  # [BH, Sq, hd]
    k: torch.Tensor,  # [BHkv, Skv, hd]
    v: torch.Tensor,  # [BHkv, Skv, hd_v]
    *,
    group_size: int,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Softmax attention of ``q`` over ``k`` (GQA: q row ``bh`` reads kv row
    ``bh // group_size``), causal and/or windowed by index, in float32;
    returns [BH, Sq, hd_v] in ``q``'s dtype."""
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kk = k.float().repeat_interleave(group_size, dim=0)
    vv = v.float().repeat_interleave(group_size, dim=0)
    kp = torch.arange(Skv, device=q.device)[None, :]

    def rows(q0: int, qc: torch.Tensor) -> torch.Tensor:
        s = torch.einsum("bqd,bkd->bqk", qc.float(), kk) * scale
        qp = torch.arange(q0, q0 + qc.shape[1], device=q.device)[:, None]
        mask = kp <= qp if causal else torch.ones_like(kp, dtype=torch.bool)
        if window is not None:
            mask = mask & (kp > qp - window)
        s = torch.where(mask[None], s, torch.full_like(s, _NEG))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bqk,bkd->bqd", p, vv).to(q.dtype)

    n = max(1, _SCORES_AT_ONCE // (BH * Skv))
    if n >= Sq:
        return rows(0, q)
    return torch.cat([rows(i, q[:, i:i + n]) for i in range(0, Sq, n)], dim=1)


def mamba_scan_ref(
    a: torch.Tensor,  # [B, S, di, N] decay
    b: torch.Tensor,  # [B, S, di, N] input
    c: torch.Tensor,  # [B, S, N] readout
    h0: torch.Tensor | None = None,  # [B, di, N] initial state (default 0)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan as a plain sequential recurrence, in float32:
    ``h_t = a_t * h_{t-1} + b_t``, ``y_t = sum_n h_t[:, n] * c_t[n]``.
    Returns (y [B, S, di], h_last [B, di, N])."""
    B, S, di, N = a.shape
    h = (torch.zeros(B, di, N, dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    a, b, c = a.float(), b.float(), c.float()
    ys = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        ys.append((h * c[:, t, None, :]).sum(dim=-1))
    return torch.stack(ys, dim=1), h


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def a2a_pack_ref(x: torch.Tensor) -> torch.Tensor:
    """[No, Ni, blk, d] -> [Ni, No, blk, d], contiguous: the reference's
    ``swapaxes(x, 0, 1)``.  One PyTorch call, so it is also the library
    yardstick of the kernel."""
    return x.transpose(0, 1).contiguous()


def scaled_err(out: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|out - want| / (|want| + rms(want's row))`` over all
    elements, rows along the last dim: the measure each kernel is held to
    against its plain version.  Each element is judged at its own scale and
    its row's, so an error in a row of small values cannot hide behind the
    tensor's largest value."""
    want = want.float()
    rms = want.square().mean(dim=-1, keepdim=True).sqrt().clamp_min(1e-30)
    return ((out.float() - want).abs() / (want.abs() + rms)).max().item()
