"""Backward of the selective scan: the wrapper of the CUDA kernel
``csrc/mamba_scan_bwd.cu``.

Replaces ``_scan_bwd``, the backward of the reference's custom VJP
``selective_scan`` (``repro/models/mamba.py``), plain XLA there: from the
forward's inputs a, b [B, S, di, N], c [B, S, N], h0 and the cotangents gy
[B, S, di] of y and gh_fin [B, di, N] of the last state, it recomputes the
states and runs the reverse recurrence ``g_t = gy_t c_t + a_{t+1} g_{t+1}``,
returning ``ga = g_t h_{t-1}``, ``gb = g_t``, ``gc = sum_d h_t gy_t`` and
``gh0 = a_0 g_0``.  On the H100 it is bound by bytes; the kernel gives each
thread one state element, stores the state entering every 8-step chunk in
a first pass and walks the chunks backward in a second, and sums gc over
the channels in a fixed order, in the CTAs and then by a second launch
(see the source).

The wrapper checks shapes, dtypes, device and contiguity, and raises on
anything the kernel does not take.  It never copies its inputs: at
Falcon-Mamba's training microbatch a and b are 1.07 GB each.  It allocates
the outputs and the workspace (the size the library states,
:func:`mamba_scan_bwd_workspace_bytes`) and launches on PyTorch's current
stream.  Its plain version is ``ref.mamba_scan_bwd_ref``;
``ops.mamba_scan_bwd`` chooses between them by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import STATE_SIZES

__all__ = ["mamba_scan_bwd_cuda", "mamba_scan_bwd_workspace_bytes"]

_SIGNATURES = {
    "mamba_scan_bwd_launch": (ctypes.c_int, [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                              + [ctypes.c_void_p]),
    "mamba_scan_bwd_workspace_bytes": (ctypes.c_longlong, [ctypes.c_int] * 4),
    "mamba_scan_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib():
    return build.library("mamba_scan_bwd", _SIGNATURES)


def mamba_scan_bwd_workspace_bytes(B: int, S: int, di: int, N: int) -> int:
    """Bytes of device memory one call at these sizes takes besides its
    outputs: the gc partials of every CTA [B, ceil(di * N / 256), S, N] and
    the states entering every 8-step chunk [B, ceil(S / 8), di, N], float32
    (67 MB and 134 MB at Falcon-Mamba's [1, 2048, 8192, 16])."""
    return int(_lib().mamba_scan_bwd_workspace_bytes(B, S, di, N))


def mamba_scan_bwd_cuda(
    a: torch.Tensor,  # [B, S, di, N] decay
    b: torch.Tensor,  # [B, S, di, N] input
    c: torch.Tensor,  # [B, S, N] readout
    h0: torch.Tensor | None,  # [B, di, N] initial state (None: zeros)
    gy: torch.Tensor,  # [B, S, di] cotangent of y
    gh_fin: torch.Tensor | None = None,  # [B, di, N] cotangent of h_last (None: zeros)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 tensors, contiguous on one CUDA device, ``N`` in
    ``STATE_SIZES``.  Returns (ga, gb [B, S, di, N], gc [B, S, N], gh0 [B,
    di, N]), float32."""
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"mamba_scan_bwd: want a and b [B, S, di, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, S, di, N = a.shape
    want = {"c": (c, (B, S, N), "[B, S, N]"), "gy": (gy, (B, S, di), "[B, S, di]"),
            "h0": (h0, (B, di, N), "[B, di, N]"), "gh_fin": (gh_fin, (B, di, N), "[B, di, N]")}
    for name, (t, shape, dims) in want.items():
        if t is not None and t.shape != shape:
            raise ValueError(f"mamba_scan_bwd: want {name} {dims} = {shape}, got "
                             f"{tuple(t.shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan_bwd: state size N={N} must divide 32 "
                         f"(one of {STATE_SIZES})")
    if B == 0 or S == 0 or di == 0:
        raise ValueError(f"mamba_scan_bwd: want nonempty inputs, got B={B}, S={S}, di={di}")
    tensors = [t for t in (a, b, c, h0, gy, gh_fin) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"mamba_scan_bwd: a, b, c, h0, gy and gh_fin must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mamba_scan_bwd: inputs must be contiguous (the wrapper does not "
                         "copy them)")
    if not a.is_cuda or any(t.device != a.device for t in tensors):
        raise ValueError(f"mamba_scan_bwd: inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    lib = _lib()
    ga, gb = torch.empty_like(a), torch.empty_like(a)
    gc = torch.empty(B, S, N, dtype=torch.float32, device=a.device)
    gh0 = torch.empty(B, di, N, dtype=torch.float32, device=a.device)
    work = torch.empty(lib.mamba_scan_bwd_workspace_bytes(B, S, di, N) // 4,
                       dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        code = lib.mamba_scan_bwd_launch(
            a.data_ptr(), b.data_ptr(), c.data_ptr(),
            h0.data_ptr() if h0 is not None else None, gy.data_ptr(),
            gh_fin.data_ptr() if gh_fin is not None else None,
            ga.data_ptr(), gb.data_ptr(), gc.data_ptr(), gh0.data_ptr(), work.data_ptr(),
            B, S, di, N, torch.cuda.current_stream().cuda_stream,
        )
    if code:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed: CUDA error {code} "
                           f"({lib.mamba_scan_bwd_error_string(code).decode()})")
    return ga, gb, gc, gh0
