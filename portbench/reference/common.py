"""What the plain references share: float32 with TF32 off, RMSNorm, the
product in float32 or in emulated fp8 (the control), and the AdamW update.

This package imports plain PyTorch alone: nothing of the program under
test, nothing of JAX.
"""

from __future__ import annotations

import torch

__all__ = ["float32_only", "rms_norm", "Matmul", "E4M3_MAX", "E5M2_MAX", "quantize",
           "AdamW"]

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def float32_only() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def quantize(t: torch.Tensor, dim: int | None, fmt: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the fp8 format ``fmt`` with one absmax scale per
    slice along ``dim`` (None: one scale for the tensor), back in float32."""
    top = E4M3_MAX if fmt == torch.float8_e4m3fn else E5M2_MAX
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = top / amax.clamp(min=1e-12)
    return (t * scale).to(fmt).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """x @ w with both operands in e4m3 (x per row, w per output column);
    the backward's incoming gradient in e5m2 (per tensor), as fp8 training
    recipes take them."""

    @staticmethod
    def forward(ctx, x, w):
        xq = quantize(x, -1, torch.float8_e4m3fn)
        wq = quantize(w, -2, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = quantize(g, None, torch.float8_e5m2)
        gx = gq @ wq.transpose(-1, -2)
        gw = (xq.reshape(-1, xq.shape[-1]).transpose(0, 1) @ gq.reshape(-1, gq.shape[-1]))
        return gx, gw


class Matmul:
    """The reference's products: ``"float32"``, or ``"fp8"`` for the control
    (every weight product in emulated fp8; everything else in float32)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8Matmul.apply(x, w)
        return x @ w


class AdamW:
    """The configuration's AdamW on float32 leaves, as the configuration
    states it: global-norm clip, linear warm-up, bias correction, decoupled
    weight decay, all in float32; the parameters are then stored in
    ``store_dtype`` (bf16: the configuration's parameters are bf16, so an
    update under half a bf16 step is lost, as it is in any bf16 model)."""

    def __init__(self, leaves: list, *, lr: float, beta1: float, beta2: float, eps: float,
                 weight_decay: float, grad_clip: float, warmup_steps: int,
                 store_dtype: torch.dtype = torch.bfloat16, moments_on=None):
        """``moments_on``: the device that keeps the second moments between
        steps (the host, where the card has no room for both beside the next
        step's backward); None keeps them beside the parameters."""
        self.leaves = leaves
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.wd, self.clip, self.warmup = weight_decay, grad_clip, warmup_steps
        self.store = store_dtype
        self.home = moments_on
        self.m = [None] * len(leaves)  # zero until the first step
        self.v = [None] * len(leaves)
        self.step_count = 0

    def step(self) -> float:
        """One update from the leaves' ``.grad``; returns the global norm."""
        gnorm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in self.leaves])))
        clip = min(self.clip / max(gnorm, 1e-9), 1.0)
        lr = self.lr * min((self.step_count + 1) / max(self.warmup, 1), 1.0)
        self.step_count += 1
        bc1 = 1.0 - self.b1 ** self.step_count
        bc2 = 1.0 - self.b2 ** self.step_count
        with torch.no_grad():
            for i, p in enumerate(self.leaves):
                m = torch.zeros_like(p) if self.m[i] is None else self.m[i].to(p.device)
                v = torch.zeros_like(p) if self.v[i] is None else self.v[i].to(p.device)
                g = p.grad * clip
                m.mul_(self.b1).add_(g, alpha=1 - self.b1)
                v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                delta = (m / bc1) / ((v / bc2).sqrt() + self.eps) + self.wd * p
                p.sub_(lr * delta)
                p.copy_(p.to(self.store).float())
                self.m[i] = m
                self.v[i] = v if self.home is None else v.to(self.home)
        return gnorm
