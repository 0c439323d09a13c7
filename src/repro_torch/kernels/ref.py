"""Plain PyTorch versions of the kernels (the counterparts of the
reference's ``repro/kernels/ref.py``).  The CPU path runs them, and the
chip check holds each CUDA kernel against them on the card."""

from __future__ import annotations

import math

import torch

__all__ = ["a2a_pack_ref", "dq_scaled_err", "flash_attention_bwd_ref", "flash_attention_ref",
           "mamba_scan_ref", "rmsnorm_bwd_ref", "rmsnorm_ref", "scaled_err"]

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
    return_lse: bool = False,
):
    """Softmax attention of ``q`` over ``k`` (GQA: q row ``bh`` reads kv row
    ``bh // group_size``), causal and/or windowed by index, in float32;
    returns [BH, Sq, hd_v] in ``q``'s dtype, and with ``return_lse`` also
    each row's logsumexp [BH, Sq] float32 (of the scaled scores, masked
    ones at -1e30, as the reference's ``_fwd_impl``)."""
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kk = k.float().repeat_interleave(group_size, dim=0)
    vv = v.float().repeat_interleave(group_size, dim=0)

    def rows(q0: int, qc: torch.Tensor):
        s = _masked_scores(qc, kk, q0, scale, causal, window)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bqk,bkd->bqd", p, vv).to(q.dtype)
        return out, torch.logsumexp(s, dim=-1)

    n = max(1, _SCORES_AT_ONCE // (BH * Skv))
    parts = [rows(i, q[:, i:i + n]) for i in range(0, Sq, n)]
    out = torch.cat([o for o, _ in parts], dim=1)
    return (out, torch.cat([l for _, l in parts], dim=1)) if return_lse else out


def _masked_scores(qc, kk, q0, scale, causal, window):
    """float32 scaled scores of the query rows ``qc`` (from row ``q0``) over
    ``kk``, -1e30 where the causal or window mask removes a key."""
    s = torch.einsum("bqd,bkd->bqk", qc.float(), kk) * scale
    qp = torch.arange(q0, q0 + qc.shape[1], device=qc.device)[:, None]
    kp = torch.arange(kk.shape[1], device=qc.device)[None, :]
    mask = kp <= qp if causal else torch.ones_like(kp, dtype=torch.bool)
    if window is not None:
        mask = mask & (kp > qp - window)
    return torch.where(mask[None], s, torch.full_like(s, _NEG))


def flash_attention_bwd_ref(
    q: torch.Tensor,    # [BH, S, hd]
    k: torch.Tensor,    # [BHkv, S, hd]
    v: torch.Tensor,    # [BHkv, S, hd_v]
    o: torch.Tensor,    # [BH, S, hd_v]
    lse: torch.Tensor,  # [BH, S] float32
    do: torch.Tensor,   # [BH, S, hd_v]
    *,
    group_size: int,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`flash_attention_ref` as the reference's
    ``_bwd`` (``models/flash.py``) forms them, in float32: ``delta =
    rowsum(do * o)``, ``p = exp(s - lse)``, ``dv = p^T do``, ``ds = p (do v^T
    - delta) * scale``, ``dq = ds k``, ``dk = ds^T q``, dk and dv summed over
    the ``group_size`` q heads of each kv head.  Returns (dq, dk, dv) in the
    inputs' dtypes."""
    BH, S, hd = q.shape
    G = group_size
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kk = k.float().repeat_interleave(G, dim=0)
    vv = v.float().repeat_interleave(G, dim=0)
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1)
    dq = torch.empty(BH, S, hd, dtype=torch.float32, device=q.device)
    dk = torch.zeros(BH, k.shape[1], hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros(BH, k.shape[1], v.shape[2], dtype=torch.float32, device=q.device)
    n = max(1, _SCORES_AT_ONCE // (BH * k.shape[1]))
    for i in range(0, S, n):
        qc, doc = q[:, i:i + n].float(), dof[:, i:i + n]
        p = torch.exp(_masked_scores(qc, kk, i, scale, causal, window) - lse[:, i:i + n, None])
        dv += torch.einsum("bqk,bqd->bkd", p, doc)
        ds = p * (torch.einsum("bqd,bkd->bqk", doc, vv) - delta[:, i:i + n, None]) * scale
        dq[:, i:i + n] = torch.einsum("bqk,bkd->bqd", ds, kk)
        dk += torch.einsum("bqk,bqd->bkd", ds, qc)

    def by_kv(t):
        return t.view(BH // G, G, *t.shape[1:]).sum(dim=1)

    return dq.to(q.dtype), by_kv(dk).to(k.dtype), by_kv(dv).to(v.dtype)


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


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`rmsnorm_ref` (``jax.grad`` of the reference's
    ``rms_norm``), in float32: with ``r = rsqrt(mean(x^2) + eps)``, ``dx = r
    (w dy) - x r^3 mean(x w dy)`` and ``dw`` the sum over rows of ``dy (x
    r)``.  Returns (dx, dw) in the dtypes of x and w."""
    xf, wf, gf = x.float(), w.float(), dy.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    dx = r * (wf * gf) - xf * (r * r * r) * (xf * wf * gf).mean(dim=-1, keepdim=True)
    dw = (gf * (xf * r)).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


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


def dq_scaled_err(dq: torch.Tensor, want: torch.Tensor) -> float:
    """The measure a causal attention's dq [BH, S, hd] is held to: its
    :func:`scaled_err` on every row but the first, and on the first row the
    largest ``|dq - want|`` over the rms of ``want``'s head.  The first query
    sees one key, so its dq is 0 in exact arithmetic (``dS = P (dP -
    delta)`` cancels): its plain value is rounding noise, and so is its own
    row's scale."""
    want = want.float()
    head = want.square().mean(dim=(-2, -1)).sqrt().clamp_min(1e-30)
    first = ((dq[:, 0].float() - want[:, 0]).abs().amax(dim=-1) / head).max().item()
    return max(first, scaled_err(dq[:, 1:], want[:, 1:])) if dq.shape[1] > 1 else first
