"""The port's training attention and RMSNorm gradients against the
reference's.

``repro_torch.models.flash.flash_attention_train`` (on the CPU: the plain
versions of the flash forward with its lse and of the flash backward)
against the reference's custom-VJP ``flash_attention_train`` and
``jax.grad``, at the five cases of ``tests/test_vjps.py``
(``test_flash_train_grads``) on the same numpy inputs: float32, the
reference test's tolerances (forward rtol 1e-5, gradients 1e-4 absolute on
``sum * 0.01``), and one bfloat16 case at 2e-2 in ``ref.scaled_err`` (dq in
``ref.dq_scaled_err``: a causal first row's dq is 0 in exact arithmetic).
The same at a v head dim unlike q's and k's (MLA's layout: MiniCPM3
smoke's (24, 16), and (12, 8)), with and without a window, through
``jax.vjp`` of the reference against the port's autograd.
Then ``layers.rms_norm``'s gradients (the RMSNorm backward's plain version)
against ``jax.grad`` of the reference's ``layers.rms_norm``: 1e-5 of the
scale in float32, 2e-2 in bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models.flash import flash_attention_train as jflash
from repro_torch.kernels import ref
from repro_torch.models import layers
from repro_torch.models.flash import flash_attention_train

RNG = np.random.RandomState(0)


def _grads(fn, *xs):
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = fn(*ts)
    out.backward()
    return out.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("B,S,Hkv,G,hd,win,skip", [
    (2, 128, 2, 2, 16, None, True),
    (2, 128, 2, 2, 16, None, False),
    (1, 96, 1, 4, 32, None, True),
    (2, 128, 2, 1, 16, 48, True),
    (2, 64, 3, 2, 8, 24, False),
])
def test_flash_train_grads_match_the_reference(B, S, Hkv, G, hd, win, skip):
    q = RNG.randn(B, S, Hkv, G, hd).astype(np.float32)
    k = RNG.randn(B, S, Hkv, hd).astype(np.float32)
    v = RNG.randn(B, S, Hkv, hd).astype(np.float32)
    scale = 1 / np.sqrt(hd)
    f = lambda *a: jflash(*a, scale, win, 32, 32, skip).sum() * 0.01  # noqa: E731
    want, want_g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    got, got_g = _grads(
        lambda *a: flash_attention_train(*a, scale, win, 32, 32, skip).sum() * 0.01, q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for a, b in zip(got_g, want_g):
        assert a.shape == b.shape
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < 1e-4


@pytest.mark.parametrize("B,S,Hkv,G,hd,hdv,win", [
    (2, 64, 2, 1, 24, 16, None),   # MiniCPM3 smoke's MLA pair, MHA
    (2, 64, 2, 1, 24, 16, 24),     # ... windowed
    (1, 96, 2, 2, 12, 8, None),    # a GQA group of 2
    (2, 96, 1, 3, 12, 8, 20),      # ... windowed, the window's edge inside a chunk
])
def test_flash_train_grads_at_unequal_head_dims_match_the_reference(B, S, Hkv, G, hd, hdv,
                                                                      win):
    """v (and the output) at head dim ``hdv`` beside q/k at ``hd``: the
    output and the three gradients of a random cotangent, float32, at the
    tolerances above."""
    q = RNG.randn(B, S, Hkv, G, hd).astype(np.float32)
    k = RNG.randn(B, S, Hkv, hd).astype(np.float32)
    v = RNG.randn(B, S, Hkv, hdv).astype(np.float32)
    do = (RNG.randn(B, S, Hkv, G, hdv) * 0.01).astype(np.float32)
    scale = 1 / np.sqrt(hd)
    out, vjp = jax.vjp(lambda *a: jflash(*a, scale, win, 32, 32, True),
                       *map(jnp.asarray, (q, k, v)))
    want_g = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = flash_attention_train(*ts, scale, win, 32, 32, True)
    got.backward(torch.from_numpy(do))
    assert tuple(got.shape) == (B, S, Hkv, G, hdv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-6)
    for t, w in zip(ts, want_g):
        assert t.grad.shape == w.shape
        assert float(np.abs(t.grad.numpy() - np.asarray(w)).max()) < 1e-4


def test_flash_train_bf16_matches_the_reference():
    """bfloat16, Yi's GQA group of 8 with a window: output and the three
    gradients of a random cotangent."""
    B, S, Hkv, G, hd, win = 2, 128, 2, 8, 16, 40
    q = RNG.randn(B, S, Hkv, G, hd).astype(np.float32)
    k, v = (RNG.randn(B, S, Hkv, hd).astype(np.float32) for _ in range(2))
    do = RNG.randn(B, S, Hkv, G, hd).astype(np.float32)
    scale = 1 / np.sqrt(hd)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    out, want_g = jax.jit(lambda *a: (lambda o, vjp: (o, vjp(jb(do))))(
        *jax.vjp(lambda *x: jflash(*x, scale, win, 64, 64, True), *a)))(jb(q), jb(k), jb(v))
    ts = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    got = flash_attention_train(*ts, scale, win, 64, 64, True)
    got.backward(torch.from_numpy(do).bfloat16())

    def heads(t):  # [B, S, Hkv, (G,) hd] -> [B * Hkv * G, S, hd]
        t = torch.from_numpy(np.asarray(t, np.float32)) if not isinstance(t, torch.Tensor) else t
        return t.float().movedim(1, -2).reshape(-1, S, hd)

    assert got.dtype == torch.bfloat16
    assert ref.scaled_err(heads(got.detach()), heads(out)) <= 2e-2
    assert ref.dq_scaled_err(heads(ts[0].grad), heads(want_g[0])) <= 2e-2
    for t, w in zip(ts[1:], want_g[1:]):
        assert ref.scaled_err(heads(t.grad), heads(w)) <= 2e-2


@pytest.mark.parametrize("dt,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_rms_norm_grads_match_jax_grad(dt, tol):
    x = RNG.randn(3, 10, 64).astype(np.float32)
    w = (RNG.rand(64) + 0.5).astype(np.float32)
    dy = RNG.randn(3, 10, 64).astype(np.float32)
    jd = getattr(jnp, dt)
    _, vjp = jax.vjp(lambda x, w: jlayers.rms_norm(x, w, 1e-6), jnp.asarray(x, jd),
                     jnp.asarray(w, jd))
    want_dx, want_dw = (np.array(g, np.float32) for g in vjp(jnp.asarray(dy, jd)))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dt)).requires_grad_() for a in (x, w))
    layers.rms_norm(tx, tw, 1e-6).backward(torch.from_numpy(dy).to(getattr(torch, dt)))
    assert tx.grad.dtype == tw.grad.dtype == getattr(torch, dt)
    assert ref.scaled_err(tx.grad, torch.from_numpy(want_dx)) <= tol
    assert ref.scaled_err(tw.grad, torch.from_numpy(want_dw)) <= tol


def test_rms_norm_without_grad_is_the_forward_kernels_call():
    """Serving's call: no autograd node, the same values as ``ops.rmsnorm``."""
    from repro_torch.kernels import ops

    x, w = torch.randn(4, 64), torch.rand(64)
    y = layers.rms_norm(x, w)
    assert y.grad_fn is None and torch.equal(y, ops.rmsnorm(x, w))
