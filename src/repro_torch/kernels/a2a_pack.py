"""Block regroup of the full-lane alltoall: the wrapper of the CUDA kernel
``csrc/a2a_pack.cu``.

Replaces the TPU kernel ``a2a_pack_kernel`` / ``a2a_pack_pallas`` of the
reference (``repro/kernels/a2a_pack.py``): ``[No, Ni, blk, d] -> [Ni, No,
blk, d]``, the leading two (destination-group) dims swapped, one ``(blk,
d)`` tile at a time.  The reference's ``fulllane_all_to_all`` needs no such
copy, because ``jax.lax.all_to_all`` splits any axis; ``all_to_all_single``
splits only dim 0, so the port's ``core.collectives.fulllane_all_to_all``
runs this kernel before each of its two exchanges.  On the H100 it is bound
by bytes (a copy); the kernel moves 16-byte vectors where the tiles allow
and bytes where they do not, so it takes any dtype (see the source).

The wrapper takes a contiguous 4-D tensor on a CUDA device and raises on
anything else; it allocates the output and launches on PyTorch's current
stream.  Its plain version is ``ref.a2a_pack_ref``; ``ops.a2a_pack``
chooses between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["a2a_pack_cuda"]

_SIGNATURES = {
    "a2a_pack_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p,
    ]),
    "a2a_pack_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def a2a_pack_cuda(x: torch.Tensor) -> torch.Tensor:
    """``x`` [No, Ni, blk, d] of any dtype, contiguous on a CUDA device.
    Returns ``x`` with its leading two dims swapped, [Ni, No, blk, d],
    contiguous."""
    if x.dim() != 4:
        raise ValueError(f"a2a_pack: want x [No, Ni, blk, d], got {tuple(x.shape)}")
    No, Ni, blk, d = x.shape
    if x.numel() == 0:
        raise ValueError(f"a2a_pack: want a nonempty x, got {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"a2a_pack: x must be on a CUDA device, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("a2a_pack: x must be contiguous (the wrapper does not copy it)")
    lib = build.library("a2a_pack", _SIGNATURES)
    out = torch.empty(Ni, No, blk, d, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.a2a_pack_launch(
            x.data_ptr(), out.data_ptr(), No, Ni, blk * d * x.element_size(),
            torch.cuda.current_stream().cuda_stream,
        )
    if code:
        raise RuntimeError(f"a2a_pack kernel launch failed: CUDA error {code} "
                           f"({lib.a2a_pack_error_string(code).decode()})")
    return out
