"""Dispatch between each CUDA kernel and its plain version, by device.

A tensor on a CUDA device goes to the kernel, or the wrapper raises; a
tensor on the CPU goes to the plain PyTorch version in ``ref.py`` (the
reference's CPU tests run its Pallas kernels in interpret mode; the port's
run the plain versions).  Nothing falls back from the card to the CPU.

Each dispatcher counts the kernel launches it makes in its ``launches``
attribute, so a run can show that its main path went through the kernels;
CPU calls are not counted.  A call made while a CUDA graph is captured
launches nothing: the graph's owner takes those counts back and adds them
again at every replay (``add_launches``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.a2a_pack import a2a_pack_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.mamba_scan import mamba_scan_cuda
from repro_torch.kernels.ref import (
    a2a_pack_ref,
    flash_attention_bwd_ref,
    flash_attention_ref,
    mamba_scan_ref,
    rmsnorm_bwd_ref,
    rmsnorm_ref,
)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.kernels.rmsnorm_bwd import rmsnorm_bwd_cuda

__all__ = ["a2a_pack", "flash_attention", "flash_attention_bwd", "mamba_scan", "rmsnorm",
           "rmsnorm_bwd", "add_launches", "launch_counts", "reset_launches"]


def _no_path(name: str, t: torch.Tensor):
    return ValueError(f"{name}: no implementation for device {t.device}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (any leading shape)."""
    if x.is_cuda:
        shape = x.shape
        out = rmsnorm_cuda(x.reshape(-1, shape[-1]), w, eps)
        rmsnorm.launches += 1
        return out.reshape(shape)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    raise _no_path("rmsnorm", x)


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx like ``x``, dw like ``w``) of :func:`rmsnorm` for the
    output's cotangent ``dy``."""
    if x.is_cuda:
        shape = x.shape
        dx, dw = rmsnorm_bwd_cuda(x.reshape(-1, shape[-1]), w, dy.reshape(-1, shape[-1]), eps)
        rmsnorm_bwd.launches += 1
        return dx.reshape(shape), dw
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, w, dy, eps=eps)
    raise _no_path("rmsnorm_bwd", x)


def flash_attention(q, k, v, *, group_size=1, causal=True, window=None, scale=None,
                    return_lse=False):
    """q [BH, Sq, hd]; k [BH // group_size, Skv, hd]; v [BH // group_size,
    Skv, hd_v]; returns [BH, Sq, hd_v], and with ``return_lse`` also each
    row's logsumexp [BH, Sq] float32 (the training forward)."""
    kw = dict(group_size=group_size, causal=causal, window=window, scale=scale,
              return_lse=return_lse)
    if q.is_cuda:
        out = flash_attention_cuda(q, k, v, **kw)
        flash_attention.launches += 1
        return out
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    raise _no_path("flash_attention", q)


def flash_attention_bwd(q, k, v, o, lse, do, *, group_size=1, causal=True, window=None,
                        scale=None):
    """The gradients (dq, dk, dv) of :func:`flash_attention` at queries and
    keys of one length, from its output ``o``, its ``lse`` and the output's
    cotangent ``do``."""
    kw = dict(group_size=group_size, causal=causal, window=window, scale=scale)
    if q.is_cuda:
        dq, dk, dv, _ = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        flash_attention_bwd.launches += 1
        return dq, dk, dv
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    raise _no_path("flash_attention_bwd", q)


def mamba_scan(a, b, c, h0=None):
    """a/b [B, S, di, N], c [B, S, N], h0 [B, di, N] or None (zeros), all
    float32; returns (y [B, S, di], h_last [B, di, N])."""
    if a.is_cuda:
        out = mamba_scan_cuda(a, b, c, h0)
        mamba_scan.launches += 1
        return out
    if a.device.type == "cpu":
        return mamba_scan_ref(a, b, c, h0)
    raise _no_path("mamba_scan", a)


def a2a_pack(x: torch.Tensor) -> torch.Tensor:
    """[No, Ni, blk, d] -> [Ni, No, blk, d] (the leading two dims swapped),
    any dtype; contiguous output."""
    if x.is_cuda:
        out = a2a_pack_cuda(x)
        a2a_pack.launches += 1
        return out
    if x.device.type == "cpu":
        return a2a_pack_ref(x)
    raise _no_path("a2a_pack", x)


_DISPATCHERS = (rmsnorm, flash_attention, mamba_scan, a2a_pack, flash_attention_bwd,
                rmsnorm_bwd)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _DISPATCHERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Every kernel's launch count, by dispatcher name."""
    return {fn.__name__: fn.launches for fn in _DISPATCHERS}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (by dispatcher name, as ``launch_counts`` gives them)
    to the kernels' launch counts."""
    for fn in _DISPATCHERS:
        fn.launches += counts.get(fn.__name__, 0)


reset_launches()
