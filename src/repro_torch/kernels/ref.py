"""Plain PyTorch versions of the kernels (the counterparts of the
reference's ``repro/kernels/ref.py``).  The CPU path runs them, and the
chip check holds each CUDA kernel against them on the card."""

from __future__ import annotations

import math

import torch

__all__ = ["a2a_pack_ref", "dq_scaled_err", "flash_attention_bwd_ref", "flash_attention_ref",
           "fused_grads", "mamba_scan_bwd_ref", "mamba_scan_fused_bwd_ref", "mamba_scan_fused_ref",
           "mamba_scan_ref", "rmsnorm_bwd_ref", "rmsnorm_ref", "scaled_err", "scan_terms_bwd_ref",
           "scan_terms_ref"]

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


def mamba_scan_bwd_ref(
    a: torch.Tensor,  # [B, S, di, N] decay
    b: torch.Tensor,  # [B, S, di, N] input
    c: torch.Tensor,  # [B, S, N] readout
    h0: torch.Tensor | None,  # [B, di, N] initial state (None: zeros)
    gy: torch.Tensor,  # [B, S, di] cotangent of y
    gh_fin: torch.Tensor | None = None,  # [B, di, N] cotangent of h_last (None: zeros)
    gc_sum_dtype: torch.dtype = torch.float32,  # gc's sum over the channels
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`mamba_scan_ref`, step by step as the
    reference's ``_scan_bwd`` defines them, in float32: h recomputed by the
    forward's recurrence, then from the last step to the first ``g_t = gy_t
    c_t + a_{t+1} g_{t+1}``, seeded with ``gh_fin`` at ``t = S - 1``;
    ``ga_t = g_t h_{t-1}``, ``gb_t = g_t``, ``gc_t = sum_d h_t gy_t`` (each
    term in float32, the sum in ``gc_sum_dtype``, rounded once) and ``gh0 =
    a_0 g_0``.  Returns (ga, gb, gc, gh0)."""
    B, S, di, N = a.shape
    a, b, c, gy = a.float(), b.float(), c.float(), gy.float()
    h = (torch.zeros(B, di, N, dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    hs = torch.empty(B, S + 1, di, N, dtype=torch.float32, device=a.device)  # h_{t-1} at t
    hs[:, 0] = h
    gc = torch.empty(B, S, N, dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs[:, t + 1] = h
        gc[:, t] = (h * gy[:, t, :, None]).sum(dim=1, dtype=gc_sum_dtype)
    g = (torch.zeros(B, di, N, dtype=torch.float32, device=a.device) if gh_fin is None
         else gh_fin.float())
    ga, gb = torch.empty_like(a), torch.empty_like(a)
    for t in range(S - 1, -1, -1):
        carry = g if t == S - 1 else a[:, t + 1] * g
        g = gy[:, t, :, None] * c[:, t, None, :] + carry
        ga[:, t] = g * hs[:, t]
        gb[:, t] = g
    return ga, gb, gc, a[:, 0] * g


def scan_terms_ref(
    dt: torch.Tensor,  # [B, S, di] step sizes (through softplus)
    x: torch.Tensor,  # [B, S, di] the conv branch's activation
    B: torch.Tensor,  # [B, S, N] input projection
    A: torch.Tensor,  # [di, N] -exp(a_log), float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The discretised scan terms as the model's ``_ssm_terms`` forms them,
    in float32: ``a = exp(dt A)`` (the product, then exp) and ``b = (dt x)
    B`` (the product dt x, then times B).  Returns (a, b) [B, S, di, N]."""
    dt32 = dt.float()
    a = (dt32[..., None] * A.float()).exp()
    b = (dt32 * x.float())[..., None] * B.float()[..., None, :]
    return a, b


def scan_terms_bwd_ref(dt, x, B, A, a, ga, gb) -> tuple:
    """The chain rule through :func:`scan_terms_ref` from the terms'
    gradients ``ga``, ``gb`` [B, S, di, N]: ``gdt = sum_n ga a A + sum_n gb
    x B``, ``gx = sum_n gb dt B``, ``gB = sum_d gb dt x`` and ``gA =
    sum_{b, t} ga a dt``, each term in float32; the long sums (gB over the
    channels, gA over the batch rows and steps) in float64, rounded once.
    Returns (gdt, gx [B, S, di], gB [B, S, N], gA [di, N]), float32."""
    dt32, x32, B32 = dt.float(), x.float(), B.float()
    gaa = ga * a  # exp's derivative: the gradient of dt A
    gbB = (gb * B32[..., None, :]).sum(dim=-1)  # sum_n gb B, [B, S, di]
    gdt = (gaa * A.float()).sum(dim=-1) + gbB * x32
    gx = gbB * dt32
    gB = (gb * (dt32 * x32)[..., None]).sum(dim=2, dtype=torch.float64).float()
    gA = (gaa * dt32[..., None]).sum(dim=(0, 1), dtype=torch.float64).float()
    return gdt, gx, gB, gA


def mamba_scan_fused_ref(dt, x, B, C, A, h0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan from the layer's own inputs: the terms of
    :func:`scan_terms_ref`, then :func:`mamba_scan_ref` with the readout
    ``C`` [B, S, N].  Returns (y [B, S, di], h_last [B, di, N]), float32."""
    return mamba_scan_ref(*scan_terms_ref(dt, x, B, A), C, h0)


def mamba_scan_fused_bwd_ref(dt, x, B, C, A, h0, gy, gh_fin=None) -> tuple:
    """The gradients of :func:`mamba_scan_fused_ref` for the cotangents
    ``gy`` [B, S, di] of y and ``gh_fin`` [B, di, N] of h_last (None:
    zeros), step by step: :func:`mamba_scan_bwd_ref` on the formed terms
    (gC's sum over the channels in float64, as gB's and gA's long sums in
    :func:`scan_terms_bwd_ref`), then :func:`scan_terms_bwd_ref`.  Returns
    (gdt, gx, gB, gC) in the dtypes of dt, x, B and C (float32 until a
    single cast), gA [di, N] and gh0 [B, di, N] float32."""
    a, b = scan_terms_ref(dt, x, B, A)
    ga, gb, gC, gh0 = mamba_scan_bwd_ref(a, b, C, h0, gy, gh_fin, gc_sum_dtype=torch.float64)
    return fused_grads(dt, x, B, C, scan_terms_bwd_ref(dt, x, B, A, a, ga, gb), gC, gh0)


def fused_grads(dt, x, B, C, chain: tuple, gC, gh0) -> tuple:
    """(gdt, gx, gB, gC, gA, gh0) from the chain rule's (gdt, gx, gB, gA)
    and the scan's gC and gh0, each of the first four cast once to its
    input's dtype."""
    gdt, gx, gB, gA = chain
    return gdt.to(dt.dtype), gx.to(x.dtype), gB.to(B.dtype), gC.to(C.dtype), gA, gh0


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
