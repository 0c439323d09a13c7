"""Selective scan: the wrapper of the CUDA kernel ``csrc/mamba_scan.cu``.

Replaces the TPU kernel ``mamba_scan_kernel`` / ``mamba_scan_pallas`` of
the reference (``repro/kernels/mamba_scan.py``): the Mamba-1 recurrence
``h_t = a_t * h_{t-1} + b_t`` over ``[B, S, di, N]`` with the readout
``y_t = sum_n h_t[:, n] * c_t[n]``, returning ``y`` and the last state.  On
the H100 it is bound by bytes (a and b are read once, for ~0.5 flop per
byte); the kernel gives each thread one state element, keeps it in a
register through a loop over t, and sums the readout over the N lanes of a
channel with warp shuffles (see the source).  Unlike the Pallas kernel it
takes any S and an initial state ``h0``.

The wrapper checks shapes, dtypes, device and contiguity, and raises on
anything the kernel does not take.  It never copies its inputs: at the
serving shape a and b are 1.07 GB each.  It allocates the outputs and
launches on PyTorch's current stream.  Its plain version is
``ref.mamba_scan_ref``; ``ops.mamba_scan`` chooses between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["STATE_SIZES", "mamba_scan_cuda"]

#: state sizes N the kernel is instantiated for: the divisors of a warp's 32
#: lanes, so that the N lanes of one channel share a warp
STATE_SIZES = (1, 2, 4, 8, 16, 32)
_SIGNATURES = {
    "mamba_scan_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]),
    "mamba_scan_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def mamba_scan_cuda(
    a: torch.Tensor,  # [B, S, di, N] decay
    b: torch.Tensor,  # [B, S, di, N] input
    c: torch.Tensor,  # [B, S, N] readout
    h0: torch.Tensor | None = None,  # [B, di, N] initial state (default 0)
) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 tensors, contiguous on one CUDA device, ``N`` in
    :data:`STATE_SIZES`.  Returns (y [B, S, di], h_last [B, di, N]),
    float32."""
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"mamba_scan: want a and b [B, S, di, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, S, di, N = a.shape
    if c.shape != (B, S, N):
        raise ValueError(f"mamba_scan: want c [B, S, N] = {(B, S, N)}, got {tuple(c.shape)}")
    if h0 is not None and h0.shape != (B, di, N):
        raise ValueError(f"mamba_scan: want h0 [B, di, N] = {(B, di, N)}, got "
                         f"{tuple(h0.shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan: state size N={N} must divide 32 "
                         f"(one of {STATE_SIZES})")
    if B == 0 or S == 0 or di == 0:
        raise ValueError(f"mamba_scan: want nonempty inputs, got B={B}, S={S}, di={di}")
    tensors = (a, b, c) + ((h0,) if h0 is not None else ())
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"mamba_scan: a, b, c and h0 must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mamba_scan: inputs must be contiguous (the wrapper does "
                         "not copy them)")
    if not a.is_cuda or any(t.device != a.device for t in tensors):
        raise ValueError(f"mamba_scan: inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    lib = build.library("mamba_scan", _SIGNATURES)
    y = torch.empty(B, S, di, dtype=torch.float32, device=a.device)
    h_last = torch.empty(B, di, N, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        code = lib.mamba_scan_launch(
            a.data_ptr(), b.data_ptr(), c.data_ptr(),
            h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), h_last.data_ptr(), B, S, di, N,
            torch.cuda.current_stream().cuda_stream,
        )
    if code:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {code} "
                           f"({lib.mamba_scan_error_string(code).decode()})")
    return y, h_last
