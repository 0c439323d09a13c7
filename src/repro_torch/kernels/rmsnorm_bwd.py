"""RMSNorm backward: the wrapper of the CUDA kernel ``csrc/rmsnorm_bwd.cu``.

Computes what ``jax.grad`` of the reference's ``rms_norm``
(``repro/models/layers.py``) gives, the backward of the TPU kernel
``rmsnorm_pallas``'s function: with ``r = rsqrt(mean(x^2) + eps)``, ``dx =
r * (w * dy) - x * r^3 * mean(x * w * dy)`` and ``dw = sum over rows of dy *
(x * r)``.  On the H100 it is bound by bytes (x and dy read, dx written,
each once).  It is one launch: teams of lanes walk the rows on a persistent
grid with a ring of rows in flight (narrow rows several a warp), each CTA
writes its fp32 share of dw to a workspace row, and after a grid-wide
barrier the CTAs sum the workspace's column stripes in a fixed order (see
the source).

The wrapper checks shapes, dtypes, device, contiguity and alignment, and
raises on anything the kernel does not take; it asks the library for the
grid (every CTA resident at once, from the device's occupancy), allocates
the outputs and the workspace, and launches on PyTorch's current stream.
The barrier's counter is a pair of words per stream in a buffer kept per
device, zeroed once and set back to 0 by each launch's last arriving CTA;
it is made at the first call on a device, which therefore must not be
inside a CUDA graph's capture.  Its plain version is
``ref.rmsnorm_bwd_ref``; ``ops.rmsnorm_bwd`` chooses between them by
device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["rmsnorm_bwd_cuda"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VECS = 8 * 32 * 4  # 8 warps x 4 vectors a lane
#: streams a device's barrier buffer has room for, one counter pair each
_BARRIER_SLOTS = 64
_SIGNATURES = {
    "rmsnorm_bwd_plan": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
    "rmsnorm_bwd_launch": (ctypes.c_int, [
        *[ctypes.c_void_p] * 7, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p,
    ]),
    "rmsnorm_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
#: by device index: (uint32 counter pairs [_BARRIER_SLOTS, 2], {stream: slot})
_BARRIERS: dict[int, tuple[torch.Tensor, dict[int, int]]] = {}


def _barrier(device: torch.device, stream: int) -> int:
    """The address of the barrier's counter pair of ``stream`` on ``device``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _BARRIERS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("rmsnorm_bwd: call it once on this device before capturing a "
                               "CUDA graph (its barrier counters are made at the first call)")
        _BARRIERS[index] = (torch.zeros(_BARRIER_SLOTS, 2, dtype=torch.int32, device=device), {})
    buf, slots = _BARRIERS[index]
    slot = slots.setdefault(stream, len(slots))
    if slot >= _BARRIER_SLOTS:
        raise RuntimeError(f"rmsnorm_bwd: more than {_BARRIER_SLOTS} streams on one device")
    return buf.data_ptr() + slot * 8


def _check(lib, code: int) -> None:
    if code:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: CUDA error {code} "
                           f"({lib.rmsnorm_bwd_error_string(code).decode()})")


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``x``, ``dy`` [T, d] and ``w`` [d] of one dtype, float32 or bfloat16,
    contiguous and 16-byte aligned on one CUDA device; ``d`` a multiple of 8
    (at most 8192 in bfloat16, 4096 in float32).  Returns ``(dx, dw)`` in
    the inputs' dtype."""
    if x.dim() != 2 or dy.shape != x.shape or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm_bwd: want x, dy [T, d] and w [d], got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)} and {tuple(w.shape)}")
    T, d = x.shape
    if T == 0 or d % 8:
        raise ValueError(f"rmsnorm_bwd: want T > 0 and d a multiple of 8, got T={T}, d={d}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd: x, w and dy must be all float32 or all bfloat16, "
                        f"got {x.dtype}, {w.dtype} and {dy.dtype}")
    if d * x.element_size() // 16 > _MAX_VECS:
        raise ValueError(f"rmsnorm_bwd: d={d} is wider than the kernel takes")
    if not x.is_cuda or w.device != x.device or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: x, w and dy must be on one CUDA device, got "
                         f"{x.device}, {w.device} and {dy.device}")
    if not (x.is_contiguous() and w.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd: x, w and dy must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("rmsnorm_bwd: x, w and dy must be 16-byte aligned")
    lib = build.library("rmsnorm_bwd", _SIGNATURES)
    code = _DTYPE_CODE[x.dtype]
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    with torch.cuda.device(x.device):
        plan = (ctypes.c_int * 4)()  # blocks (= workspace rows), threads, lanes, smem
        _check(lib, lib.rmsnorm_bwd_plan(T, d, code, plan))
        stream = torch.cuda.current_stream().cuda_stream
        ws = torch.empty(plan[0], d, dtype=torch.float32, device=x.device)
        _check(lib, lib.rmsnorm_bwd_launch(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            ws.data_ptr(), _barrier(x.device, stream), plan[0], T, d, float(eps), code, stream))
    return dx, dw
