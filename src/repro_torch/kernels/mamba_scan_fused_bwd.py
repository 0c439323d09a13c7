"""Backward of the selective scan from the layer's own inputs: the wrapper
of the CUDA kernel ``csrc/mamba_scan_fused_bwd.cu``.

The redesign of ``mamba_scan_bwd`` (``csrc/mamba_scan_bwd.cu``, which
replaces ``_scan_bwd``, the backward of the reference's custom VJP
``selective_scan`` in ``repro/models/mamba.py``) together with the chain
rule through the terms ``a = exp(dt A)`` and ``b = (dt x) B``: from the
layer's inputs ``dt``, ``x`` [B, S, di], ``B``, ``C`` [B, S, N], ``A`` [di,
N], ``h0`` and the cotangents ``gy`` [B, S, di] of y and ``gh_fin`` [B, di,
N] of h_last, it returns the gradients of dt, x, B and C in their dtypes
(summed in float32, cast once), of A [di, N] and of h0 [B, di, N], float32.
The terms and their gradients stay in registers: nothing of size [B, S,
di, N] is read or written.  No atomics: every sum runs in a fixed order, so
two calls give the same bits.

The wrapper checks shapes, dtypes, device and contiguity, and raises on
anything the kernel does not take.  It allocates the outputs and the
workspace (:func:`mamba_scan_fused_bwd_workspace_bytes`) and launches on
PyTorch's current stream.  Its plain version is
``ref.mamba_scan_fused_bwd_ref``; ``ops.mamba_scan_fused_bwd`` chooses
between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan_fused import DTYPES, check_fused_inputs

__all__ = ["mamba_scan_fused_bwd_cuda", "mamba_scan_fused_bwd_workspace_bytes"]

_SIGNATURES = {
    "mamba_scan_fused_bwd_launch": (ctypes.c_int, [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                                    + [ctypes.c_void_p]),
    "mamba_scan_fused_bwd_workspace_bytes": (ctypes.c_longlong, [ctypes.c_int] * 4),
    "mamba_scan_fused_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib():
    return build.library("mamba_scan_fused_bwd", _SIGNATURES)


def mamba_scan_fused_bwd_workspace_bytes(B: int, S: int, di: int, N: int) -> int:
    """Bytes of device memory one call at these sizes takes besides its
    outputs: the batch rows' partials of gA and the CTAs' partials of gB
    and gC (float64), and the states entering every chunk of steps
    (float32; see the source)."""
    return int(_lib().mamba_scan_fused_bwd_workspace_bytes(B, S, di, N))


def mamba_scan_fused_bwd_cuda(
    dt: torch.Tensor,  # [B, S, di] step sizes (through softplus)
    x: torch.Tensor,  # [B, S, di] the conv branch's activation
    B: torch.Tensor,  # [B, S, N] input projection
    C: torch.Tensor,  # [B, S, N] readout
    A: torch.Tensor,  # [di, N] -exp(a_log), float32
    h0: torch.Tensor | None,  # [B, di, N] initial state, float32 (None: zeros)
    gy: torch.Tensor,  # [B, S, di] cotangent of y, float32
    gh_fin: torch.Tensor | None = None,  # [B, di, N] cotangent of h_last (None: zeros)
) -> tuple[torch.Tensor, ...]:
    """``N`` in ``STATE_SIZES``.  Returns (gdt, gx [B, S, di], gB, gC [B, S,
    N], gA [di, N], gh0 [B, di, N]); the first four in the inputs' dtype,
    summed in float32 and cast once: for bf16 inputs they are the float32
    outputs of a call on the same values in float32, cast."""
    Bz, S, di, N = check_fused_inputs(
        "mamba_scan_fused_bwd", dt, x, B, C, A, h0, gy=(gy, tuple(dt.shape), "[B, S, di]"),
        gh_fin=(gh_fin, (dt.shape[0], dt.shape[2], A.shape[-1]), "[B, di, N]"))
    lib = _lib()
    dev = dt.device
    gdt, gx = (torch.empty(Bz, S, di, dtype=dt.dtype, device=dev) for _ in range(2))
    gB, gC = (torch.empty(Bz, S, N, dtype=dt.dtype, device=dev) for _ in range(2))
    gA = torch.empty(di, N, dtype=torch.float32, device=dev)
    gh0 = torch.empty(Bz, di, N, dtype=torch.float32, device=dev)
    work = torch.empty(lib.mamba_scan_fused_bwd_workspace_bytes(Bz, S, di, N) // 4,
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.mamba_scan_fused_bwd_launch(
            dt.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
            h0.data_ptr() if h0 is not None else None, gy.data_ptr(),
            gh_fin.data_ptr() if gh_fin is not None else None,
            gdt.data_ptr(), gx.data_ptr(), gB.data_ptr(), gC.data_ptr(), gA.data_ptr(),
            gh0.data_ptr(), work.data_ptr(), Bz, S, di, N, DTYPES[dt.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if code:
        raise RuntimeError(f"mamba_scan_fused_bwd kernel launch failed: CUDA error {code} "
                           f"({lib.mamba_scan_fused_bwd_error_string(code).decode()})")
    return gdt, gx, gB, gC, gA, gh0
