"""Flash-attention forward: the wrapper of the CUDA kernel
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_kernel`` /
``flash_attention_pallas`` of the reference
(``repro/kernels/flash_attention.py``): online-softmax attention with GQA
(q row ``bh`` reads kv row ``bh // group_size``), causal and/or sliding
window masks, fp32 m/l/acc, and KV tiles past the causal frontier or before
the window skipped.  On the H100 a causal pass at head_dim 128 does ~S/2
flops per byte moved, so the Yi prefill (S = 512) is bound by bytes, barely,
and longer prompts by the tensor cores.  The kernel is FlashAttention-2's
design on ``mma.sync``: each warp holds 16 q rows, scores, probabilities and
the output accumulator stay in registers (bf16 operands, fp32
accumulation), and K/V tiles of 64 rows (32 at head_dim 256, where Q is
re-read from shared memory at every k-step rather than held in registers)
arrive by ``cp.async`` into a two-stage ring in shared memory while the
previous tile is computed (DeepSeek-V2's MLA pair, q/k 192 and v 128,
takes hd 256's path too).  A head dim that is no multiple of 16 is padded
inside the kernel, in its shared-memory tiles (no copy here).  The value
head dim may differ from the query/key one (MLA's 64 beside 96, 128 beside
192): the kernel takes both as template parameters, so V and the output
move only their own columns.  Unlike the Pallas kernel it masks the ragged edge, so Sq and Skv
need not be multiples of its tiles.  For training (``models/flash.py``) it
also returns each row's logsumexp (``return_lse=True``, at the head dims
:data:`LSE_HEAD_DIMS` that the backward kernel takes), from an instance of
its own: the serving instance and its C entry point are unchanged.

The wrapper checks shapes, dtypes, device, contiguity and alignment, and
raises on anything the kernel does not take; it allocates the output and
launches on PyTorch's current stream.  Its plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` chooses between them by
device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

__all__ = ["HEAD_DIMS", "LSE_HEAD_DIMS", "flash_attention_cuda"]

#: (q/k head dim, v head dim) pairs the kernel is instantiated for: the smoke
#: configs' (16, 16) and MiniCPM3 smoke's (24, 16), and the published
#: configs' 64 (MusicGen), 120 (H2O-Danube3, run padded to 128 inside the
#: kernel), 128 (Yi, Qwen2-VL, DBRX), 256 (Gemma) and the MLA pairs of
#: MiniCPM3 (96, 64) and DeepSeek-V2 (192, 128); 24 runs padded to 32
HEAD_DIMS = ((16, 16), (64, 64), (120, 120), (128, 128), (256, 256), (24, 16), (96, 64),
             (192, 128))
#: head dims the lse instance (and the backward kernel) is built for: Yi's
#: 128 and the smoke configs' 16; the others wait for ROADMAP queue 2 item 9
LSE_HEAD_DIMS = (16, 128)
_MAX_BH = 65535  # the C interface's limit
_SIGNATURES = {
    "flash_attention_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]),
    "flash_attention_lse_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]),
    "flash_attention_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def flash_attention_cuda(
    q: torch.Tensor,  # [BH, Sq, hd]
    k: torch.Tensor,  # [BH // group_size, Skv, hd]
    v: torch.Tensor,  # [BH // group_size, Skv, hd_v]
    *,
    group_size: int,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    return_lse: bool = False,
):
    """bfloat16 ``q``/``k``/``v``, contiguous on one CUDA device, head dims
    ``(hd, hd_v)`` in :data:`HEAD_DIMS`.  Returns ``softmax(q k^T * scale +
    mask) v`` as ``[BH, Sq, hd_v]`` bfloat16; ``scale`` defaults to
    1/sqrt(hd).  ``return_lse``: returns ``(out, lse)``, lse [BH, Sq] float32
    the natural-log logsumexp of each row's scaled, masked scores (hd in
    :data:`LSE_HEAD_DIMS`, hd_v = hd)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"flash_attention: want q [BH, Sq, hd], k [BHkv, Skv, hd] "
                         f"and v [BHkv, Skv, hd_v], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, hd = q.shape
    BHkv, Skv, hdk = k.shape
    hdv = v.shape[2]
    if group_size < 1 or BH != BHkv * group_size or hdk != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match group_size={group_size}")
    if (hd, hdv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims ({hd}, {hdv}) not in {HEAD_DIMS}")
    if return_lse and (hd not in LSE_HEAD_DIMS or hdv != hd):
        raise ValueError(f"flash_attention: lse at head dims ({hd}, {hdv}) is not built: "
                         f"the training path takes {LSE_HEAD_DIMS} (other head dims: "
                         f"ROADMAP queue 2 item 9)")
    if Sq == 0 or Skv == 0 or BH == 0 or BH > _MAX_BH:
        raise ValueError(f"flash_attention: want 0 < BH <= {_MAX_BH} and "
                         f"nonempty sequences, got BH={BH}, Sq={Sq}, Skv={Skv}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention: q/k/v must be bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q/k/v must be on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q/k/v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q/k/v must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    lib = build.library("flash_attention", _SIGNATURES)
    out = q.new_empty(BH, Sq, hdv)
    common = (BH, Sq, Skv)
    tail = (group_size, int(causal), 0 if window is None else int(window), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if return_lse:
            lse = torch.empty(BH, Sq, dtype=torch.float32, device=q.device)
            code = lib.flash_attention_lse_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                *common, hd, *tail, stream)
        else:
            code = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *common, hd, hdv, *tail, stream)
    if code:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {code} "
            f"({lib.flash_attention_error_string(code).decode()})")
    return (out, lse) if return_lse else out
