"""Flash-attention backward: the wrapper of the CUDA kernel
``csrc/flash_attention_bwd.cu``.

Computes ``_bwd`` of the reference's custom VJP (``repro/models/flash.py``,
whose chunked loops XLA compiles: the reference has no Pallas kernel for
the backward): from q, k, v, the forward's output and per-row logsumexp
and the output's cotangent, the three gradients, dK and dV summed over the
``group_size`` q heads of each kv head, at every (q/k, v) head-dim pair of
``flash_attention.HEAD_DIMS`` (v, the output and its cotangent at a v head
dim of their own, as MLA has them).  On the H100 it is bound by the
tensor cores, and its products run on ``wgmma``.  The kernel is a
``delta = rowsum(dO * O)`` pre-pass; one CTA per (kv row, 64-key tile,
slice of the group's q heads) with dK and dV in registers, whose fp32
partials a second launch sums in slice order into bf16; and
one CTA per (q row, 64-row q tile) for dQ; above 128 columns each of a
CTA's two warpgroups accumulates one column half of its gradients (see the
source).  No atomics, so the result is the same from run to run.

The wrapper checks shapes, dtypes, device, contiguity and alignment, and
raises on anything the kernel does not take; it allocates the outputs and
delta and the workspace of the partials (the size the library states) and
launches on PyTorch's current stream.  Its plain
version is ``ref.flash_attention_bwd_ref``; ``ops.flash_attention_bwd``
chooses between them by device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS

__all__ = ["flash_attention_bwd_cuda"]

_MAX_BH = 65535  # the C interface's limit
_SIGNATURES = {
    "flash_attention_bwd_launch": (ctypes.c_int, [
        *[ctypes.c_void_p] * 11,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]),
    "flash_attention_bwd_workspace_bytes": (ctypes.c_longlong, [ctypes.c_int] * 5),
    "flash_attention_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def flash_attention_bwd_cuda(
    q: torch.Tensor,    # [BH, S, hd]
    k: torch.Tensor,    # [BH // group_size, S, hd]
    v: torch.Tensor,    # [BH // group_size, S, hd_v]
    o: torch.Tensor,    # [BH, S, hd_v], the forward's output
    lse: torch.Tensor,  # [BH, S] float32, the forward's logsumexp (natural log)
    do: torch.Tensor,   # [BH, S, hd_v], the output's cotangent
    *,
    group_size: int,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """bfloat16 ``q``/``k``/``v``/``o``/``do`` and float32 ``lse``, contiguous
    on one CUDA device, head dims ``(hd, hd_v)`` in ``HEAD_DIMS``, queries and
    keys of one length (the training layout).  Returns ``(dq, dk, dv,
    delta)``: the gradients in bfloat16 and ``delta = rowsum(do * o)`` [BH, S]
    float32."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or v.shape[:2] != k.shape[:2] \
            or o.shape != (*q.shape[:2], v.shape[2]) or do.shape != o.shape:
        raise ValueError(f"flash_attention_bwd: want q [BH, S, hd], k [BHkv, S, hd], v "
                         f"[BHkv, S, hd_v] and o, do [BH, S, hd_v], got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, o {tuple(o.shape)}, "
                         f"do {tuple(do.shape)}")
    BH, S, hd = q.shape
    hdv = v.shape[2]
    if group_size < 1 or BH != k.shape[0] * group_size or k.shape[1:] != (S, hd):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"do not match group_size={group_size} (queries and keys of one "
                         f"length)")
    if lse.shape != (BH, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: want lse [BH, S] float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if (hd, hdv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dims ({hd}, {hdv}) not in {HEAD_DIMS}")
    if S == 0 or BH == 0 or BH > _MAX_BH:
        raise ValueError(f"flash_attention_bwd: want 0 < BH <= {_MAX_BH} and S > 0, "
                         f"got BH={BH}, S={S}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd: window must be >= 1, got {window}")
    bf = (q, k, v, o, do)
    if any(t.dtype != torch.bfloat16 for t in bf):
        raise TypeError(f"flash_attention_bwd: q/k/v/o/do must be bfloat16, got "
                        f"{[str(t.dtype) for t in bf]}")
    if not q.is_cuda or any(t.device != q.device for t in (*bf, lse)):
        raise ValueError("flash_attention_bwd: every input must be on one CUDA device")
    if not all(t.is_contiguous() for t in (*bf, lse)):
        raise ValueError("flash_attention_bwd: every input must be contiguous")
    if any(t.data_ptr() % 16 for t in bf) or lse.data_ptr() % 4:
        raise ValueError("flash_attention_bwd: q/k/v/o/do must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    lib = build.library("flash_attention_bwd", _SIGNATURES)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(BH, S, dtype=torch.float32, device=q.device)
    work = torch.empty(lib.flash_attention_bwd_workspace_bytes(BH, S, hd, hdv, group_size) // 4,
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd_launch(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv, delta, work)),
            BH, S, hd, hdv, group_size, int(causal), 0 if window is None else int(window),
            float(scale), torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed: CUDA error {code} "
            f"({lib.flash_attention_bwd_error_string(code).decode()})")
    return dq, dk, dv, delta
