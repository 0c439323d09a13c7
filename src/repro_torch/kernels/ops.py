"""Dispatch between each CUDA kernel and its plain version, by device.

A tensor on a CUDA device goes to the kernel, or the wrapper raises; a
tensor on the CPU goes to the plain PyTorch version in ``ref.py`` (the
reference's CPU tests run its Pallas kernels in interpret mode; the port's
run the plain versions).  Nothing falls back from the card to the CPU.

Each dispatcher counts the kernel launches it makes in its ``launches``
attribute, so a run can show that its main path went through the kernels;
CPU calls are not counted.  A call made while a CUDA graph is captured
launches nothing: the graph's owner takes those counts back and adds them
again at every replay (``add_launches``).

A tensor on the meta device (the dry-run's shape pass, ``launch/dryrun.py``)
gets outputs of the right shape and dtype on the meta device and computes
nothing: no kernel, no plain version (the plain scan's Python loop over S
alone would take minutes at the dry-run's sizes).  Each such call adds the
FLOPs of the matrix products its kernel does to every counter that
``count_meta_flops`` has open, in the reference's dot-only measure
(``repro/launch/hloanalysis.py``): attention counts its score and value
products over the 64 x 64 (query, key) tiles inside the causal or window
frontier, as the reference's chunked attention skips the chunks outside it;
the scan counts its readout ``y_t = sum_n h_t c_t`` (an einsum in the
reference) and its backward the readout's contraction for ``gc``, under
the names ``mamba_scan`` and ``mamba_scan_bwd`` whether the terms are
formed outside (``mamba_scan``) or inside the kernel
(``mamba_scan_fused``); RMSNorm and ``a2a_pack`` count none.

A ``DTensor`` (a tensor sharded over a ``DeviceMesh``, the sharded train
step's) goes to the same dispatcher shard by shard: ``on_shards`` runs the
call through ``local_map`` on each rank's local tensors, which stay on
their device, and wraps the outputs with the placements the kernel gives
them.  Each operand is first redistributed to the placements its kernel
can take on local rows: the dims the kernel treats as independent rows or
channels keep their shards (``rows``), every other dim, and any pending
sum (``Partial``), is gathered.  A gradient that each rank computes over
its own rows only (RMSNorm's ``dw``, the scan's ``gc`` over a rank's
channels, the fused scan's ``gA`` over its batch rows) comes back
``Partial`` over those mesh dims, never as if it were the whole sum.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.a2a_pack import a2a_pack_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.mamba_scan import mamba_scan_cuda
from repro_torch.kernels.mamba_scan_bwd import mamba_scan_bwd_cuda
from repro_torch.kernels.mamba_scan_fused import mamba_scan_fused_cuda
from repro_torch.kernels.mamba_scan_fused_bwd import mamba_scan_fused_bwd_cuda
from repro_torch.kernels.ref import (
    a2a_pack_ref,
    flash_attention_bwd_ref,
    flash_attention_ref,
    fused_grads,
    mamba_scan_bwd_ref,
    mamba_scan_ref,
    rmsnorm_bwd_ref,
    rmsnorm_ref,
    scan_terms_bwd_ref,
    scan_terms_ref,
)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.kernels.rmsnorm_bwd import rmsnorm_bwd_cuda

__all__ = ["a2a_pack", "flash_attention", "flash_attention_bwd", "mamba_scan", "mamba_scan_bwd",
           "mamba_scan_fused", "mamba_scan_fused_bwd", "rmsnorm", "rmsnorm_bwd", "add_launches",
           "launch_counts", "reset_launches", "count_meta_flops", "attention_tile_pairs",
           "on_shards", "rows", "moved", "summed_over", "scan_placements", "fused_placements"]

#: the (query, key) tile of the meta FLOP count
META_TILE = 64
_meta_counters: list[dict[str, float]] = []


def _no_path(name: str, t: torch.Tensor):
    return ValueError(f"{name}: no implementation for device {t.device}")


@contextlib.contextmanager
def count_meta_flops():
    """Inside the block, every dispatcher call on meta tensors adds its
    kernel's matrix-product FLOPs to the dict yielded, by dispatcher name."""
    counts = {fn.__name__: 0.0 for fn in _DISPATCHERS}
    _meta_counters.append(counts)
    try:
        yield counts
    finally:  # by identity: two open counters may hold equal counts
        _meta_counters[:] = [c for c in _meta_counters if c is not counts]


def rows(t: DTensor, *dims: int) -> tuple:
    """``t``'s placements with the shards of ``dims`` kept (negative dims
    count from the end) and every other shard, and every ``Partial``, as
    ``Replicate``: what a kernel that treats ``dims`` as independent rows
    can take shard by shard."""
    keep = {d % t.ndim for d in dims}
    return tuple(p if isinstance(p, Shard) and p.dim % t.ndim in keep else Replicate()
                 for p in t.placements)


def moved(placements: tuple, where: dict) -> tuple:
    """``placements`` with each ``Shard(d)`` moved to ``Shard(where[d])``
    (a dim not in ``where`` is dropped: ``Replicate``)."""
    return tuple(Shard(where[p.dim]) if isinstance(p, Shard) and p.dim in where else Replicate()
                 for p in placements)


def scan_placements(a: DTensor) -> tuple:
    """The selective scan's placements from ``a`` [B, S, di, N] (or the
    fused scan's ``dt`` [B, S, di]): (a's and b's and y's and gy's, each
    rank's batch rows and channels; c's [B, S, N], the rows; h's [B, di,
    N], the rows and channels; c's gradient, ``Partial`` over the mesh dims
    that shard the channels, since each rank sums ``gc`` over its own)."""
    ap = rows(a, 0, 2)
    cp = moved(ap, {0: 0})
    gc = tuple(Partial() if isinstance(p, Shard) and p.dim == 2 else q for p, q in zip(ap, cp))
    return ap, cp, moved(ap, {0: 0, 2: 1}), gc


def fused_placements(dt: DTensor) -> tuple:
    """The fused scan's placements of ``A`` [di, N] from ``dt`` [B, S, di]:
    (A's, the rank's channels; A's gradient, ``Partial`` over the mesh dims
    that shard the batch rows, since each rank sums ``gA`` over its own)."""
    ap = rows(dt, 0, 2)
    Ap = moved(ap, {2: 0})
    return Ap, tuple(Partial() if isinstance(p, Shard) and p.dim == 0 else q
                     for p, q in zip(ap, Ap))


def summed_over(placements: tuple, *dims: int) -> tuple:
    """``Partial`` on every mesh dim that shards one of ``dims``, else
    ``Replicate``: the placements of a value each rank sums over its own
    rows (or channels) of those dims."""
    return tuple(Partial() if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in placements)


def on_shards(fn, args: tuple, in_placements: tuple, out_placements, grad_placements=None):
    """``fn(*local args)`` on each rank's shards (``local_map``): the
    DTensor arguments redistributed to ``in_placements`` (None for a
    non-tensor argument), the outputs wrapped with ``out_placements`` and,
    under autograd, each input's gradient with ``grad_placements`` (default:
    its ``in_placements``)."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    if all(isinstance(p, Placement) for p in out_placements):  # one output: a list
        out_placements = list(out_placements)
    else:
        out_placements = tuple(list(p) for p in out_placements)
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _meta(name: str, flops: float) -> None:
    for counts in _meta_counters:
        counts[name] += flops


def attention_tile_pairs(Sq: int, Skv: int, causal: bool, window: int | None,
                         tile: int = META_TILE) -> int:
    """The (query, key) pairs of one head in the ``tile`` x ``tile`` tiles
    that are not wholly masked (query ``i`` sees key ``j <= i`` when causal,
    ``j > i - window`` under a window)."""
    n = 0
    for q0 in range(0, Sq, tile):
        q1 = min(q0 + tile, Sq)
        hi = min(Skv, q1) if causal else Skv  # keys below the tile's last row + 1
        lo = max(0, q0 - window + 1) if window is not None else 0
        lo, hi = lo // tile * tile, min(Skv, -(-hi // tile) * tile)
        n += (q1 - q0) * max(0, hi - lo)
    return n


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (any leading shape)."""
    if isinstance(x, DTensor):
        xp = rows(x, *range(x.ndim - 1))
        return on_shards(lambda xl, wl: rmsnorm(xl, wl, eps=eps), (x, w),
                         (xp, (Replicate(),) * len(xp)), xp)
    if x.is_cuda:
        shape = x.shape
        out = rmsnorm_cuda(x.reshape(-1, shape[-1]), w, eps)
        rmsnorm.launches += 1
        return out.reshape(shape)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    if x.is_meta:
        return torch.empty_like(x)
    raise _no_path("rmsnorm", x)


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx like ``x``, dw like ``w``) of :func:`rmsnorm` for the
    output's cotangent ``dy``."""
    if isinstance(x, DTensor):
        xp = rows(x, *range(x.ndim - 1))
        return on_shards(lambda xl, wl, dl: rmsnorm_bwd(xl, wl, dl, eps=eps), (x, w, dy),
                         (xp, (Replicate(),) * len(xp), xp),
                         (xp, summed_over(xp, *range(x.ndim - 1))))
    if x.is_cuda:
        shape = x.shape
        dx, dw = rmsnorm_bwd_cuda(x.reshape(-1, shape[-1]), w, dy.reshape(-1, shape[-1]), eps)
        rmsnorm_bwd.launches += 1
        return dx.reshape(shape), dw
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, w, dy, eps=eps)
    if x.is_meta:
        return torch.empty_like(x), torch.empty_like(w)
    raise _no_path("rmsnorm_bwd", x)


def flash_attention(q, k, v, *, group_size=1, causal=True, window=None, scale=None,
                    return_lse=False):
    """q [BH, Sq, hd]; k [BH // group_size, Skv, hd]; v [BH // group_size,
    Skv, hd_v]; returns [BH, Sq, hd_v], and with ``return_lse`` also each
    row's logsumexp [BH, Sq] float32 (the training forward)."""
    kw = dict(group_size=group_size, causal=causal, window=window, scale=scale,
              return_lse=return_lse)
    if isinstance(q, DTensor):  # rows of heads: kv row = q row // group_size on each shard
        qp = rows(q, 0)
        return on_shards(lambda *t: flash_attention(*t, **kw), (q, k, v), (qp,) * 3,
                         (qp, qp) if return_lse else qp)
    if q.is_cuda:
        out = flash_attention_cuda(q, k, v, **kw)
        flash_attention.launches += 1
        return out
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    if q.is_meta:
        BH, Sq, hd = q.shape
        hdv = v.shape[-1]
        _meta("flash_attention", 2 * (hd + hdv) * BH * attention_tile_pairs(
            Sq, k.shape[1], causal, window))
        out = q.new_empty((BH, Sq, hdv))
        return (out, q.new_empty((BH, Sq), dtype=torch.float32)) if return_lse else out
    raise _no_path("flash_attention", q)


def flash_attention_bwd(q, k, v, o, lse, do, *, group_size=1, causal=True, window=None,
                        scale=None):
    """The gradients (dq, dk, dv) of :func:`flash_attention` at queries and
    keys of one length, from its output ``o``, its ``lse`` and the output's
    cotangent ``do``."""
    kw = dict(group_size=group_size, causal=causal, window=window, scale=scale)
    if isinstance(q, DTensor):
        qp = rows(q, 0)
        return on_shards(lambda *t: flash_attention_bwd(*t, **kw), (q, k, v, o, lse, do),
                         (qp,) * 6, (qp,) * 3)
    if q.is_cuda:
        dq, dk, dv, _ = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        flash_attention_bwd.launches += 1
        return dq, dk, dv
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    if q.is_meta:
        BH, Sq, hd = q.shape
        hdv = v.shape[-1]
        # the scores again, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q,
        # and delta = rowsum(dO * O)
        _meta("flash_attention_bwd", 2 * (3 * hd + 2 * hdv) * BH * attention_tile_pairs(
            Sq, k.shape[1], causal, window) + 2 * BH * Sq * hdv)
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    raise _no_path("flash_attention_bwd", q)


def mamba_scan(a, b, c, h0=None):
    """a/b [B, S, di, N], c [B, S, N], h0 [B, di, N] or None (zeros), all
    float32; returns (y [B, S, di], h_last [B, di, N])."""
    if isinstance(a, DTensor):
        ap, cp, hp, _ = scan_placements(a)
        return on_shards(mamba_scan, (a, b, c, h0), (ap, ap, cp, None if h0 is None else hp),
                         (ap, hp))
    if a.is_cuda:
        out = mamba_scan_cuda(a, b, c, h0)
        mamba_scan.launches += 1
        return out
    if a.device.type == "cpu":
        return mamba_scan_ref(a, b, c, h0)
    if a.is_meta:
        B, S, di, N = a.shape
        _meta("mamba_scan", 2 * B * S * di * N)
        return (a.new_empty((B, S, di), dtype=torch.float32),
                a.new_empty((B, di, N), dtype=torch.float32))
    raise _no_path("mamba_scan", a)


def mamba_scan_bwd(a, b, c, h0, gy, gh_fin=None):
    """The gradients (ga, gb [B, S, di, N], gc [B, S, N], gh0 [B, di, N]) of
    :func:`mamba_scan` for the cotangents ``gy`` [B, S, di] of y and
    ``gh_fin`` [B, di, N] of h_last (None: zeros), from its inputs; h0 None
    is zeros, all float32."""
    if isinstance(a, DTensor):
        ap, cp, hp, gc = scan_placements(a)
        return on_shards(mamba_scan_bwd, (a, b, c, h0, gy, gh_fin),
                         (ap, ap, cp, None if h0 is None else hp, ap,
                          None if gh_fin is None else hp), (ap, ap, gc, hp))
    if a.is_cuda:
        out = mamba_scan_bwd_cuda(a, b, c, h0, gy, gh_fin)
        mamba_scan_bwd.launches += 1
        return out
    if a.device.type == "cpu":
        return mamba_scan_bwd_ref(a, b, c, h0, gy, gh_fin)
    if a.is_meta:
        B, S, di, N = a.shape
        # gc_t = sum_d h_t gy_t (the readout's cotangent into the state,
        # gy_t c_t, is an outer product, no contraction)
        _meta("mamba_scan_bwd", 2 * B * S * di * N)
        return (torch.empty_like(a), torch.empty_like(b), torch.empty_like(c),
                a.new_empty((B, di, N)))
    raise _no_path("mamba_scan_bwd", a)


def mamba_scan_fused(dt, x, B, C, A, h0=None):
    """The selective scan from the layer's own inputs, the terms ``a =
    exp(dt A)`` and ``b = (dt x) B`` formed inside the kernel: dt, x [B, S,
    di] and B, C [B, S, N] in one dtype (the model's), A [di, N] and h0 [B,
    di, N] or None (zeros) float32; returns (y [B, S, di], h_last [B, di,
    N]) float32.  On the CPU the plain version, ``ref.mamba_scan_fused_ref``
    (the terms, then the unfused plain scan)."""
    if isinstance(dt, DTensor):
        xp, cp, hp, _ = scan_placements(dt)
        Ap, _ = fused_placements(dt)
        return on_shards(mamba_scan_fused, (dt, x, B, C, A, h0),
                         (xp, xp, cp, cp, Ap, None if h0 is None else hp), (xp, hp))
    if dt.is_cuda:
        out = mamba_scan_fused_cuda(dt, x, B, C, A, h0)
        mamba_scan_fused.launches += 1
        return out
    if dt.device.type == "cpu":
        return mamba_scan_ref(*scan_terms_ref(dt, x, B, A), C, h0)
    if dt.is_meta:
        Bz, S, di = dt.shape
        N = A.shape[-1]
        _meta("mamba_scan", 2 * Bz * S * di * N)  # the readout, as the unfused scan's
        return (dt.new_empty((Bz, S, di), dtype=torch.float32),
                dt.new_empty((Bz, di, N), dtype=torch.float32))
    raise _no_path("mamba_scan_fused", dt)


def mamba_scan_fused_bwd(dt, x, B, C, A, h0, gy, gh_fin=None):
    """The gradients (gdt, gx [B, S, di], gB, gC [B, S, N] in their inputs'
    dtype, gA [di, N], gh0 [B, di, N] float32) of :func:`mamba_scan_fused`
    for the cotangents ``gy`` [B, S, di] of y and ``gh_fin`` [B, di, N] of
    h_last (None: zeros), float32.  On the CPU the plain version,
    ``ref.mamba_scan_fused_bwd_ref``: the unfused plain backward on the
    formed terms, then the chain rule through them."""
    if isinstance(dt, DTensor):
        xp, cp, hp, gc = scan_placements(dt)
        Ap, gA = fused_placements(dt)
        return on_shards(mamba_scan_fused_bwd, (dt, x, B, C, A, h0, gy, gh_fin),
                         (xp, xp, cp, cp, Ap, None if h0 is None else hp, xp,
                          None if gh_fin is None else hp), (xp, xp, gc, gc, gA, hp))
    if dt.is_cuda:
        out = mamba_scan_fused_bwd_cuda(dt, x, B, C, A, h0, gy, gh_fin)
        mamba_scan_fused_bwd.launches += 1
        return out
    if dt.device.type == "cpu":  # ref.mamba_scan_fused_bwd_ref, its steps named here
        a, b = scan_terms_ref(dt, x, B, A)
        ga, gb, gC, gh0 = mamba_scan_bwd_ref(a, b, C, h0, gy, gh_fin,
                                             gc_sum_dtype=torch.float64)
        return fused_grads(dt, x, B, C, scan_terms_bwd_ref(dt, x, B, A, a, ga, gb), gC, gh0)
    if dt.is_meta:
        Bz, S, di = dt.shape
        N = A.shape[-1]
        _meta("mamba_scan_bwd", 2 * Bz * S * di * N)  # gc's contraction, as the unfused
        return (torch.empty_like(dt), torch.empty_like(x), torch.empty_like(B),
                torch.empty_like(C), torch.empty_like(A), dt.new_empty((Bz, di, N),
                                                                      dtype=torch.float32))
    raise _no_path("mamba_scan_fused_bwd", dt)


def a2a_pack(x: torch.Tensor) -> torch.Tensor:
    """[No, Ni, blk, d] -> [Ni, No, blk, d] (the leading two dims swapped),
    any dtype; contiguous output."""
    if isinstance(x, DTensor):
        xp = rows(x, *range(x.ndim))
        return on_shards(a2a_pack, (x,), (xp,), moved(xp, {0: 1, 1: 0, **{
            d: d for d in range(2, x.ndim)}}))
    if x.is_cuda:
        out = a2a_pack_cuda(x)
        a2a_pack.launches += 1
        return out
    if x.device.type == "cpu":
        return a2a_pack_ref(x)
    if x.is_meta:
        return x.new_empty((x.shape[1], x.shape[0]) + tuple(x.shape[2:]))
    raise _no_path("a2a_pack", x)


_DISPATCHERS = (rmsnorm, flash_attention, mamba_scan, a2a_pack, flash_attention_bwd,
                rmsnorm_bwd, mamba_scan_bwd, mamba_scan_fused, mamba_scan_fused_bwd)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _DISPATCHERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Every kernel's launch count, by dispatcher name."""
    return {fn.__name__: fn.launches for fn in _DISPATCHERS}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (by dispatcher name, as ``launch_counts`` gives them)
    to the kernels' launch counts."""
    for fn in _DISPATCHERS:
        fn.launches += counts.get(fn.__name__, 0)


reset_launches()
