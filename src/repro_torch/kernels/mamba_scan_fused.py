"""Selective scan from the layer's own inputs: the wrapper of the CUDA
kernel ``csrc/mamba_scan_fused.cu``.

The redesign of ``mamba_scan`` (``csrc/mamba_scan.cu``, which replaces the
TPU kernel ``mamba_scan_kernel`` / ``mamba_scan_pallas`` of the reference,
``repro/kernels/mamba_scan.py``) for the card: it takes what the Mamba
layer has, ``dt`` and ``x`` [B, S, di], ``B`` and ``C`` [B, S, N] in the
model dtype and ``A`` [di, N] float32, and forms the terms ``a_t = exp(dt_t
A)`` and ``b_t = (dt_t x_t) B_t`` in registers, so that the [B, S, di, N]
float32 tensors a and b of the TPU kernel's interface (1.07 GB each at
Falcon-Mamba-7B's prefill of 4 x 512) never exist.  It computes exactly
``ref.scan_terms_ref`` followed by ``ref.mamba_scan_ref``.

The wrapper checks shapes, dtypes, device and contiguity, and raises on
anything the kernel does not take.  It allocates the outputs and launches
on PyTorch's current stream.  Its plain version is
``ref.mamba_scan_fused_ref``; ``ops.mamba_scan_fused`` chooses between them
by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import STATE_SIZES

__all__ = ["DTYPES", "check_fused_inputs", "mamba_scan_fused_cuda"]

#: the dtypes dt, x, B and C may have (all four the same), by the code the
#: C interface takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "mamba_scan_fused_launch": (ctypes.c_int, [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                + [ctypes.c_void_p]),
    "mamba_scan_fused_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def check_fused_inputs(name: str, dt, x, B, C, A, h0, **float32) -> tuple[int, int, int, int]:
    """Raise unless the fused scan's kernels take these inputs: ``dt``, ``x``
    [B, S, di] and ``B``, ``C`` [B, S, N] of one dtype of :data:`DTYPES`,
    ``A`` [di, N], ``h0`` [B, di, N] or None, and every tensor of
    ``float32`` (name: tensor or None, with its shape) float32, all
    contiguous on one CUDA device.  Returns (B, S, di, N)."""
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"{name}: want dt and x [B, S, di], got {tuple(dt.shape)} and "
                         f"{tuple(x.shape)}")
    Bz, S, di = dt.shape
    N = A.shape[-1] if A.dim() == 2 else -1
    want = {"B": (B, (Bz, S, N), "[B, S, N]"), "C": (C, (Bz, S, N), "[B, S, N]"),
            "A": (A, (di, N), "[di, N]"), "h0": (h0, (Bz, di, N), "[B, di, N]"),
            **{k: (t, shape, dims) for k, (t, shape, dims) in float32.items()}}
    for k, (t, shape, dims) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {k} {dims} = {shape}, got {tuple(t.shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"{name}: state size N={N} must divide 32 (one of {STATE_SIZES})")
    if Bz == 0 or S == 0 or di == 0:
        raise ValueError(f"{name}: want nonempty inputs, got B={Bz}, S={S}, di={di}")
    if dt.dtype not in DTYPES or any(t.dtype != dt.dtype for t in (x, B, C)):
        raise TypeError(f"{name}: dt, x, B and C must share one dtype of "
                        f"{list(DTYPES)}, got {[t.dtype for t in (dt, x, B, C)]}")
    f32 = [A, h0] + [t for t, _, _ in float32.values()]
    if any(t is not None and t.dtype != torch.float32 for t in f32):
        raise TypeError(f"{name}: {', '.join(['A', 'h0', *float32])} must be float32, got "
                        f"{[t.dtype for t in f32 if t is not None]}")
    tensors = [t for t in (dt, x, B, C, *f32) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous (the wrapper does not copy them)")
    if not dt.is_cuda or any(t.device != dt.device for t in tensors):
        raise ValueError(f"{name}: inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    return Bz, S, di, N


def mamba_scan_fused_cuda(
    dt: torch.Tensor,  # [B, S, di] step sizes (through softplus)
    x: torch.Tensor,  # [B, S, di] the conv branch's activation
    B: torch.Tensor,  # [B, S, N] input projection
    C: torch.Tensor,  # [B, S, N] readout
    A: torch.Tensor,  # [di, N] -exp(a_log), float32
    h0: torch.Tensor | None = None,  # [B, di, N] initial state, float32 (default 0)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``N`` in ``STATE_SIZES``.  Returns (y [B, S, di], h_last [B, di,
    N]), float32."""
    Bz, S, di, N = check_fused_inputs("mamba_scan_fused", dt, x, B, C, A, h0)
    lib = build.library("mamba_scan_fused", _SIGNATURES)
    y = torch.empty(Bz, S, di, dtype=torch.float32, device=dt.device)
    h_last = torch.empty(Bz, di, N, dtype=torch.float32, device=dt.device)
    with torch.cuda.device(dt.device):
        code = lib.mamba_scan_fused_launch(
            dt.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
            h0.data_ptr() if h0 is not None else None, y.data_ptr(), h_last.data_ptr(),
            Bz, S, di, N, DTYPES[dt.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if code:
        raise RuntimeError(f"mamba_scan_fused kernel launch failed: CUDA error {code} "
                           f"({lib.mamba_scan_fused_error_string(code).decode()})")
    return y, h_last
