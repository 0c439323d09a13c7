"""Mamba training in the port against the JAX package's: the selective
scan's custom VJP (``repro_torch.models.mamba.selective_scan`` over
``ops.mamba_scan`` and ``ops.mamba_scan_bwd``, their plain versions on the
CPU) and the mixer's training path (``mamba(..., train=True)``).

Inputs are made with numpy from a seed; the parameters are the reference's
``lm.init_model`` carried across by ``convert.params_from_numpy``.
Tolerances:

* ``selective_scan`` against the reference's ``selective_scan`` under
  ``jax.grad``, at ``tests/test_vjps.py``'s shapes and loss, ``(y*y).sum()
  + 0.5*(h*h).sum()`` (so h_fin's cotangent is nonzero), plus a ragged S
  and a loss that leaves h_fin unused: y, h_fin and every gradient within
  ``1e-6 * max(max|want|, 1)``.  The reference's own bound for its VJP is
  ``1e-3 * max(max|want|, 1)``; the reference scans associatively, so its
  products and sums run in another order than the port's sequential
  recurrence.  The largest difference measured at these cases on the CPU
  was 2.0e-7 of that scale.
* The plain backward (``ref.mamba_scan_bwd_ref``) against
  ``torch.autograd`` through the plain forward: 1e-5 of
  ``max(max|want|, 1)`` (both float32 and the same recurrence; on the CPU
  they agreed bit for bit).
* The mixer's parameter and input gradients against ``jax.grad`` of the
  reference's ``mamba`` on the float32 smoke config: 1e-5 of each leaf's
  largest gradient (float32 products of the projections, rounded at other
  places in the two frameworks; 3.5e-7 measured, at ``x_proj``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as JLM
from repro.models import mamba as JM
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba as TM

ARCH = "falcon_mamba_7b"
VJP_TOL = 1e-6
PLAIN_TOL = 1e-5
MIXER_TOL = 1e-5


def _inputs(rng, B, S, di, N):
    """As ``tests/test_vjps.py::test_selective_scan_grads`` makes them."""
    return [(rng.rand(B, S, di, N) * 0.9 + 0.05).astype(np.float32),
            (rng.randn(B, S, di, N) * 0.1).astype(np.float32),
            rng.randn(B, S, N).astype(np.float32),
            (rng.randn(B, di, N) * 0.1).astype(np.float32)]


def _loss(y, h, use_h):
    return (y * y).sum() + (0.5 * (h * h).sum() if use_h else 0.0)


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), (err, np.abs(want).max())


@pytest.mark.parametrize("B,S,di,N,chunk,use_h", [
    (2, 64, 8, 4, 16, True),    # tests/test_vjps.py's shapes
    (1, 96, 16, 8, 32, True),
    (2, 37, 16, 16, 16, True),  # a length no chunk divides
    (2, 64, 8, 4, 16, False),   # h_fin unused: its cotangent arrives as None
])
def test_selective_scan_matches_reference_grads(B, S, di, N, chunk, use_h):
    arrs = _inputs(np.random.RandomState(0), B, S, di, N)
    jx = [jnp.asarray(x) for x in arrs]

    def jloss(a, b, c, h0):
        return _loss(*JM.selective_scan(a, b, c, h0, chunk), use_h)

    want_y, want_h = JM.selective_scan(*jx, chunk)
    want_g = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jx)

    tx = [torch.from_numpy(x).requires_grad_() for x in arrs]
    y, h = TM.selective_scan(*tx, chunk)
    got_g = torch.autograd.grad(_loss(y, h, use_h), tx)
    _close(y, want_y, VJP_TOL)
    _close(h, want_h, VJP_TOL)
    for name, g, w in zip(("ga", "gb", "gc", "gh0"), got_g, want_g):
        assert g.dtype == torch.float32, name
        _close(g, w, VJP_TOL)


@pytest.mark.parametrize("uses", ["y", "h_fin"])
def test_an_unused_output_sends_no_cotangent(monkeypatch, uses):
    """The training loss never reads h_fin: the backward gets None for it,
    not a materialised tensor of zeros ([B, di, N] at every layer).  A loss
    of h_fin alone gets its gradients too (y's cotangent taken as zeros);
    both against autograd through the plain forward."""
    seen = []
    real = ops.mamba_scan_bwd

    def spy(a, b, c, h0, gy, gh_fin=None):
        seen.append(gh_fin)
        return real(a, b, c, h0, gy, gh_fin)

    monkeypatch.setattr(ops, "mamba_scan_bwd", spy)
    arrs = _inputs(np.random.RandomState(1), 1, 9, 4, 4)
    xs = [torch.from_numpy(x).requires_grad_() for x in arrs]
    y, h = TM.selective_scan(*xs)
    got = torch.autograd.grad((y if uses == "y" else h).sum(), xs)
    assert len(seen) == 1 and (seen[0] is None) == (uses == "y")
    xs = [torch.from_numpy(x).requires_grad_() for x in arrs]
    y, h = ref.mamba_scan_ref(*xs)
    want = torch.autograd.grad((y if uses == "y" else h).sum(), xs, materialize_grads=True)
    for g, w in zip(got, want):
        _close(g, w.numpy(), PLAIN_TOL)


@pytest.mark.parametrize("B,S,di,N,with_h0,with_gh", [
    (2, 16, 8, 4, True, True), (1, 33, 16, 8, False, False), (3, 7, 5, 2, True, False),
    (2, 9, 4, 16, False, True),
])
def test_plain_backward_matches_autograd(B, S, di, N, with_h0, with_gh):
    """``mamba_scan_bwd_ref`` against ``torch.autograd`` through
    ``mamba_scan_ref``, with and without h0 and gh_fin."""
    rng = np.random.RandomState(2)
    a, b, c, h0 = (torch.from_numpy(x) for x in _inputs(rng, B, S, di, N))
    h0 = h0 if with_h0 else None
    gy = torch.from_numpy(rng.randn(B, S, di).astype(np.float32))
    gh = torch.from_numpy(rng.randn(B, di, N).astype(np.float32)) if with_gh else None
    xs = [t.clone().requires_grad_() for t in (a, b, c, h0 if with_h0 else torch.zeros(B, di, N))]
    y, h = ref.mamba_scan_ref(*xs)
    loss = (y * gy).sum() + ((h * gh).sum() if with_gh else 0.0)
    want = torch.autograd.grad(loss, xs)
    got = ops.mamba_scan_bwd(a, b, c, h0, gy, gh)  # the CPU path: the plain version
    for g, w in zip(got, want):
        _close(g, w.numpy(), PLAIN_TOL)


def _configs():
    return [dataclasses.replace(cfg, dtype="float32")
            for cfg in (jax_smoke_config(ARCH), get_smoke_config(ARCH))]


def test_mixer_train_gradients_match_reference():
    """One Mamba layer's training forward (``train=True``: no cache) and the
    gradients of a seeded projection of its output in every parameter and
    its input, against ``jax.grad`` of the reference's ``mamba``.  The
    gradients reach ``a_log`` and ``dt_w`` through ``_ssm_terms``' in-place
    ``exp_``."""
    jcfg, tcfg = _configs()
    jp = JLM.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jpl = jax.tree.map(lambda t: t[0], jp["blocks"]["slot0"]["mixer"])
    tpl = {k: v[0].clone().requires_grad_() for k, v in tp["blocks"]["slot0"]["mixer"].items()}
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, tcfg.d_model).astype(np.float32)
    w = rng.randn(2, 24, tcfg.d_model).astype(np.float32)

    def jloss(p, x):
        y, cache = JM.mamba(jcfg, p, x)
        assert cache is None
        return (y * w).sum()

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jpl, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y, cache = TM.mamba(tcfg, tpl, tx, train=True)
    assert cache is None
    served, _ = TM.mamba(tcfg, {k: v.detach() for k, v in tpl.items()}, tx.detach())
    torch.testing.assert_close(y.detach(), served, rtol=0, atol=0)
    names = sorted(tpl)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [tpl[k] for k in names] + [tx])
    for name, g in zip(names + ["x"], got):
        want = np.asarray(want_x if name == "x" else want_p[name], np.float32)
        assert np.abs(want).max() > 0, name
        err = np.abs(g.numpy() - want).max()
        assert err <= MIXER_TOL * np.abs(want).max(), (name, err, np.abs(want).max())


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device with no implementation (this build of
    PyTorch has no third device to put one on)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_dispatcher_raises_for_another_device():
    """CUDA goes to the kernel, the CPU to the plain version, meta tensors
    to the shape pass (``tests/test_torch_dryrun.py``), and any other
    device raises: nothing falls back."""
    a = torch.Tensor._make_subclass(_Elsewhere, torch.empty(1, 4, 2, 4))
    c, gy = torch.empty(1, 4, 4), torch.empty(1, 4, 2)
    with pytest.raises(ValueError, match="no implementation for device xpu"):
        ops.mamba_scan_bwd(a, a, c, None, gy)
