"""Mamba-1 selective-state-space mixer (the counterpart of the reference's
``repro/models/mamba.py``).

Two compute paths:

* prefill and train — the causal depthwise conv, written as the reference
  writes it (a sum of shifted float32 scalings), the scan's own inputs
  (``_ssm_inputs``: dt, B, C and A), then ``selective_scan_fused`` from a
  zero state: the counterpart of the reference's ``_ssm_terms`` followed by
  its custom VJP ``selective_scan``.  Its forward is
  ``ops.mamba_scan_fused`` (the fused scan kernel on the card), which forms
  the terms ``a = exp(dt A)`` and ``b = (dt x) B`` in registers, so the
  [B, S, di, N] float32 tensors a and b never exist; it saves only its
  inputs.  Its backward is ``ops.mamba_scan_fused_bwd`` (the fused backward
  kernel), which recomputes the terms and the states, runs the reverse
  recurrence of the reference's ``_scan_bwd`` and the chain rule through
  the terms.  The reference's forward runs a chunked associative scan,
  which computes the same recurrence with its products in another order.
  Prefill returns the filled cache (the last ``d_conv - 1`` conv inputs and
  the last state); ``train=True`` fills none.
* decode — the O(1) recurrent step over that cache, in plain PyTorch ops,
  as in the reference (it has no TPU kernel): the terms of one step
  (``_ssm_terms``), the update and the readout.  The cache is updated in
  place.

``selective_scan(a, b, c, h0)`` stays as the counterpart of the
reference's ``selective_scan`` and of the TPU kernel's interface (formed
terms in, ``ops.mamba_scan`` / ``ops.mamba_scan_bwd``); the layer does not
call it.

On DTensors (the sharded train step, ``d_inner`` over ``model``) the conv,
``_ssm_inputs`` and the scan run on each rank's channels: the two halves of
``in_proj``'s output are pinned to their channel shards (``in_proj`` is
sharded as one ``[D, 2 * di]`` matrix, so a rank's columns hold one half
or the other), and the scan's custom VJP runs shard by shard
(``ops.on_shards``), the gradients of B and C ``Partial`` over ``model``
(each rank sums its channels' share) and A's over the mesh dims that shard
the batch rows.  Served on DTensors (``lm.prefill`` and ``lm.decode_step``
on placed parameters), prefill takes the same path and the decode step's
conv window and state stay on each rank's channels, the cache written in
place shard by shard (``layers.assign``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import assign
from repro_torch.models.params import ParamMeta
from repro_torch.obs.trace import TRACER

__all__ = ["mamba_meta", "mamba", "init_mamba_cache", "selective_scan",
           "selective_scan_fused"]


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


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c, h0):
        ctx.set_materialize_grads(False)  # an unused h_fin sends no zeros back
        y, h_fin = ops.mamba_scan(a, b, c, h0)
        ctx.save_for_backward(a, b, c, h0)
        return y, h_fin

    @staticmethod
    def backward(ctx, gy, gh_fin):
        a, b, c, h0 = ctx.saved_tensors
        gy = a.new_zeros(a.shape[:3]) if gy is None else gy.contiguous()
        ga, gb, gc, gh0 = ops.mamba_scan_bwd(
            a, b, c, h0, gy, gh_fin.contiguous() if gh_fin is not None else None)
        return ga, gb, gc, gh0 if h0 is not None else None


def selective_scan(
    a: torch.Tensor,  # [B, S, di, N] decay, float32
    b: torch.Tensor,  # [B, S, di, N] input, float32
    c: torch.Tensor,  # [B, S, N] readout, float32
    h0: torch.Tensor | None,  # [B, di, N] initial state (None: zeros)
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``y_t = <h_t, c_t>``, ``h_t = a_t h_{t-1} + b_t``: returns (y [B, S,
    di], h_fin [B, di, N]), differentiable in a, b, c and h0 through the
    backward kernel.  The inputs must be contiguous on the card, where the
    kernels take them as they are.  ``chunk`` only shapes the reference's
    XLA loops: it is accepted and changes nothing."""
    del chunk
    if isinstance(a, DTensor):
        ap, cp, hp, gc = ops.scan_placements(a)
        h0p = None if h0 is None else hp
        return ops.on_shards(_SelectiveScan.apply, (a, b, c, h0), (ap, ap, cp, h0p), (ap, hp),
                             (ap, ap, gc, h0p))
    return _SelectiveScan.apply(a, b, c, h0)


class _SelectiveScanFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, x, B, C, A, h0):
        ctx.set_materialize_grads(False)  # an unused h_fin sends no zeros back
        # free where they already are (the layer's own tensors); a shard
        # that local_map redistributed may not be
        dt, x, B, C = (t.contiguous() for t in (dt, x, B, C))
        y, h_fin = ops.mamba_scan_fused(dt, x, B, C, A, h0)
        ctx.save_for_backward(dt, x, B, C, A, h0)
        return y, h_fin

    @staticmethod
    def backward(ctx, gy, gh_fin):
        dt, x, B, C, A, h0 = ctx.saved_tensors
        gy = dt.new_zeros(dt.shape, dtype=torch.float32) if gy is None else gy.contiguous()
        gdt, gx, gB, gC, gA, gh0 = ops.mamba_scan_fused_bwd(
            dt, x, B, C, A, h0, gy, gh_fin.contiguous() if gh_fin is not None else None)
        return gdt, gx, gB, gC, gA, gh0 if h0 is not None else None


def selective_scan_fused(
    dt: torch.Tensor,  # [B, S, di] step sizes (through softplus), model dtype
    x: torch.Tensor,  # [B, S, di] the conv branch's activation, model dtype
    B: torch.Tensor,  # [B, S, N] input projection, model dtype
    C: torch.Tensor,  # [B, S, N] readout, model dtype
    A: torch.Tensor,  # [di, N] -exp(a_log), float32
    h0: torch.Tensor | None,  # [B, di, N] initial state (None: zeros)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``selective_scan`` on the terms ``a = exp(dt A)``, ``b = (dt x) B``
    that the reference's ``_ssm_terms`` forms, without forming them: returns
    (y [B, S, di], h_fin [B, di, N]) float32, differentiable in dt, x, B,
    C, A and h0 through the fused backward kernel."""
    if isinstance(dt, DTensor):
        xp, cp, hp, gc = ops.scan_placements(dt)
        Ap, gA = ops.fused_placements(dt)
        h0p = None if h0 is None else hp
        return ops.on_shards(_SelectiveScanFused.apply, (dt, x, B, C, A, h0),
                             (xp, xp, cp, cp, Ap, h0p), (xp, hp), (xp, xp, gc, gc, gA, h0p))
    return _SelectiveScanFused.apply(dt, x, B, C, A, h0)


def _channels(t: DTensor, x: DTensor, like: DTensor) -> DTensor:
    """``t`` [B, S, di] with its batch rows placed as ``x``'s [B, S, D] are
    (the data-parallel shards the activation hook pinned) and its channels
    as ``like`` [di] places them (``d_inner`` over ``model`` where it
    divides)."""
    pl = tuple(Shard(2) if isinstance(w, Shard) else
               (Shard(0) if isinstance(b, Shard) and b.dim == 0 else Replicate())
               for b, w in zip(x.placements, like.placements))
    return t.redistribute(t.device_mesh, pl)


def _ssm_inputs(cfg: ModelConfig, p: dict, xz: torch.Tensor):
    """From the conv+silu branch activation x [B, S, di], the selective
    scan's own inputs: the step sizes dt [B, S, di] (through softplus), the
    per-step input projection B and readout C [B, S, N] (model dtype, views
    of one projection) and A = -exp(a_log) [di, N] (float32)."""
    m = cfg.mamba
    r = m.resolved_dt_rank(cfg.d_model)
    proj = xz @ p["x_proj"]  # [B, S, r + 2N]
    if isinstance(proj, DTensor):  # summed over the channels' shards, once, here
        proj = proj.redistribute(proj.device_mesh, ops.rows(proj, 0, 1))
    dt = F.softplus(proj[..., :r] @ p["dt_w"] + p["dt_b"])  # [B, S, di], model dtype
    B_ssm = proj[..., r:r + m.d_state]
    C_ssm = proj[..., r + m.d_state:]
    A = -torch.exp(p["a_log"].float())  # [di, N]
    return dt, B_ssm, C_ssm, A


def _ssm_terms(cfg: ModelConfig, p: dict, xz: torch.Tensor):
    """From the conv+silu branch activation x [B, S, di], the discretised
    scan terms a, b [B, S, di, N] (float32, contiguous) and the per-step
    readout C [B, S, N] (model dtype): the decode step's (one step)."""
    dt, B_ssm, C_ssm, A = _ssm_inputs(cfg, p, xz)
    dt32 = dt.float()
    a = (dt32[..., None] * A).exp_()
    b = (dt32 * xz.float())[..., None] * B_ssm.float()[..., None, :]
    return a, b, C_ssm


def mamba(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # [B, S, D]
    *,
    cache: dict | None = None,  # decode: this layer's cache, updated in place
    train: bool = False,
    layer: int | None = None,  # the layer's index, an attribute of its span
) -> tuple[torch.Tensor, dict | None]:
    """Prefill when ``cache`` is None (returns the filled cache), else one
    decode step (S == 1) against ``cache``.  ``train``: the prefill branch
    through ``selective_scan_fused``, differentiable, and no cache (None).
    Between ``in_proj`` and ``out_proj`` the mixer runs under a device span
    ``mixer.core`` (``obs/trace.py``; attribute ``layer``): a graph marker
    when a decode step is captured."""
    di = cfg.mamba.expand * x.shape[-1]
    xz = x @ p["in_proj"]  # [B, S, 2*di]
    xin, z = xz[..., :di], xz[..., di:]
    if isinstance(xz, DTensor):
        xin, z = (_channels(t, x, p["conv_b"]) for t in (xin, z))
    sp = TRACER.start("mixer.core", device=True, layer=layer) if TRACER else None
    try:
        y, new_cache = _mixer_core(cfg, p, xin, z, cache, train)
    finally:
        if sp:
            TRACER.finish(sp)
    return y @ p["out_proj"], new_cache


def _mixer_core(cfg: ModelConfig, p: dict, xin: torch.Tensor, z: torch.Tensor,
                cache: dict | None, train: bool) -> tuple[torch.Tensor, dict | None]:
    """The mixer between its projections: the conv, the scan's inputs
    (``_ssm_inputs``; one step's terms, ``_ssm_terms``, in decode), the scan
    or the state update and readout, the D skip and the gate.  xin and z
    [B, S, di] (the halves of ``in_proj``'s output) -> (y [B, S, di] in
    their dtype, the cache or None)."""
    m = cfg.mamba
    B, S, di = xin.shape
    dtype = xin.dtype
    if cache is not None:
        # ---------- O(1) decode step ----------
        window = torch.cat([cache["conv"], xin], dim=1)  # [B, d_conv, di]
        if isinstance(window, DTensor):  # products and sums, which DTensor propagates fast
            xc = (window.float() * p["conv_w"].float()).sum(1)
        else:
            xc = torch.einsum("bwd,wd->bd", window.float(), p["conv_w"].float())
        xc = F.silu(xc + p["conv_b"].float())[:, None].to(dtype)
        a, b, C_ssm = _ssm_terms(cfg, p, xc)
        h = a[:, 0] * cache["ssm"] + b[:, 0]  # [B, di, N]
        if isinstance(h, DTensor):
            y = (h * C_ssm[:, 0].float()[:, None]).sum(-1)
        else:
            y = torch.einsum("bdn,bn->bd", h, C_ssm[:, 0].float())
        y = y[:, None] + p["d_skip"].float() * xc.float()
        assign(cache["conv"], window[:, 1:])
        assign(cache["ssm"], h)
        new_cache = cache
    else:
        # ---------- prefill: causal depthwise conv + selective scan ----------
        pad = torch.zeros(B, m.d_conv - 1, di, dtype=dtype, device=xin.device)
        xin_p = torch.cat([pad, xin], dim=1)  # [B, S + d_conv - 1, di]
        xc = torch.zeros(B, S, di, dtype=torch.float32, device=xin.device)
        for w in range(m.d_conv):
            xc = xc + xin_p[:, w:w + S].float() * p["conv_w"][w].float()
        xc = F.silu(xc + p["conv_b"].float()).to(dtype)
        dt, B_ssm, C_ssm, A = _ssm_inputs(cfg, p, xc)
        y, h_last = selective_scan_fused(dt, xc, B_ssm.contiguous(), C_ssm.contiguous(), A,
                                         None)
        new_cache = None if train else {"conv": xin_p[:, S:], "ssm": h_last}
        y = y + p["d_skip"].float() * xc.float()
    return y.to(dtype) * F.silu(z), new_cache
