"""Fused RMSNorm: the wrapper of the CUDA kernel ``csrc/rmsnorm.cu``.

Replaces the TPU kernel ``rmsnorm_kernel`` / ``rmsnorm_pallas`` of the
reference (``repro/kernels/rmsnorm.py``).  On the H100 it is bound by bytes:
``2*T*d*sizeof(x) + d*sizeof(w)`` moved for ~4 flops per value.  The kernel
reads each row of x once into registers and w once per CTA as 16-byte
vectors; with many rows a persistent grid walks them with the next row's
copy in flight, with few rows each row gets a CTA of its own (see the
source).

The wrapper checks shapes, dtypes, device, contiguity and the 16-byte
alignment of x and w (both are read in 16-byte vectors), and raises on
anything the kernel does not take; it allocates the output and launches
on PyTorch's current stream.  Its plain version is
``ref.rmsnorm_ref``; ``ops.rmsnorm`` chooses between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["rmsnorm_cuda"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "rmsnorm_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]),
    "rmsnorm_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x`` [T, d] and ``w`` [d] of one dtype, float32 or bfloat16, both
    contiguous and 16-byte aligned on one CUDA device; ``d`` a multiple of
    8.  Returns ``x * rsqrt(mean(x^2) + eps) * w`` in ``x.dtype``."""
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm: want x [T, d] and w [d], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    T, d = x.shape
    if T == 0 or d % 8:
        raise ValueError(f"rmsnorm: want T > 0 and d a multiple of 8, got T={T}, d={d}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm: x and w must be both float32 or both bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"rmsnorm: x and w must be on one CUDA device, got "
                         f"{x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rmsnorm: x and w must be 16-byte aligned")
    lib = build.library("rmsnorm", _SIGNATURES)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.rmsnorm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), T, d, float(eps),
            _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if code:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {code} "
                           f"({lib.rmsnorm_error_string(code).decode()})")
    return out
