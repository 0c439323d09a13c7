"""Training attention: flash attention with a backward kernel (the
counterpart of the reference's custom-VJP ``repro/models/flash.py``).

``flash_attention_train`` keeps the reference's layout (q [B, S, Hkv, G,
hd], k [B, S, Hkv, hd], v [B, S, Hkv, hd_v]: v's head dim may differ from
q's and k's, as MLA's does) and its memory-lean factorisation: the forward
saves only q, k, v, the output and each row's logsumexp (``lse``), and the
backward recomputes the scores from them.  Both directions go through the
kernels on the card (``ops.flash_attention(return_lse=True)`` and
``ops.flash_attention_bwd``), their plain versions on the CPU.  The
reference's chunk sizes and causal skip only shape its XLA loops: they are
accepted here and do not change the result (the kernels tile by 64 and
skip what the mask removes).

On DTensors (the sharded train step) the whole custom VJP runs on each
rank's shards (``ops.on_shards``): its batch rows and its kv heads, with
the groups of query heads that read them.  The flatten to the kernels'
``[B * H, S, hd]`` rows merges a dim sharded over the data-parallel mesh
dims with one sharded over ``model``, which a DTensor can only express by
gathering, so it happens inside, on local tensors.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops

__all__ = ["flash_attention_train", "kernel_rows"]


def kernel_rows(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H..., d] -> the flash kernels' [B * H..., S, d], contiguous."""
    return t.movedim(1, -2).reshape(-1, t.shape[1], t.shape[-1]).contiguous()


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, window):
        B, S, Hkv, G, hd = q.shape
        qr, kr, vr = kernel_rows(q), kernel_rows(k), kernel_rows(v)
        # kernel row b*Hkv*G + h*G + g reads kv row b*Hkv + h: the GQA map
        o, lse = ops.flash_attention(qr, kr, vr, group_size=G, causal=True, window=window,
                                     scale=scale, return_lse=True)
        ctx.save_for_backward(qr, kr, vr, o, lse)
        ctx.meta = (B, S, Hkv, G, scale, window)
        return o.reshape(B, Hkv, G, S, -1).movedim(3, 1)

    @staticmethod
    def backward(ctx, dout):
        qr, kr, vr, o, lse = ctx.saved_tensors
        B, S, Hkv, G, scale, window = ctx.meta
        dq, dk, dv = ops.flash_attention_bwd(qr, kr, vr, o, lse, kernel_rows(dout), group_size=G,
                                             causal=True, window=window, scale=scale)
        return (dq.reshape(B, Hkv, G, S, -1).movedim(3, 1),
                dk.reshape(B, Hkv, S, -1).movedim(2, 1),
                dv.reshape(B, Hkv, S, -1).movedim(2, 1), None, None)


def flash_attention_train(
    q: torch.Tensor,  # [B, Sq, Hkv, G, hd]
    k: torch.Tensor,  # [B, Skv, Hkv, hd]
    v: torch.Tensor,  # [B, Skv, Hkv, hd_v]
    scale: float,
    window: int | None,
    chunk_q: int,
    chunk_kv: int,
    causal_skip: bool,
) -> torch.Tensor:
    """Causal (and optionally windowed) attention of the aligned training
    layout (``q_pos == arange(Sq)``, Skv == Sq); returns [B, Sq, Hkv, G,
    hd_v] in q's dtype, differentiable in q, k and v.  (hd, hd_v) is a pair
    of ``flash_attention.HEAD_DIMS`` on the card.  ``chunk_q``, ``chunk_kv``
    and ``causal_skip`` are the reference's and leave the result as it is."""
    del chunk_q, chunk_kv, causal_skip
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash_attention_train: the training layout has Skv == Sq, got "
                         f"{k.shape[1]} and {q.shape[1]}")
    if isinstance(q, DTensor):  # batch rows and kv heads (dims 0 and 2 of all three)
        qp = ops.rows(q, 0, 2)
        return ops.on_shards(_FlashTrain.apply, (q, k, v, scale, window),
                             (qp, qp, qp, None, None), qp)
    return _FlashTrain.apply(q, k, v, scale, window)
