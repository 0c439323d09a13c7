"""The fused selective scan (``ops.mamba_scan_fused`` and
``ops.mamba_scan_fused_bwd``, their plain versions on the CPU;
``models.mamba.selective_scan_fused``) against the JAX package's
``_ssm_terms`` followed by ``selective_scan``.

Inputs are made with numpy from a seed, at smoke sizes (B 2, S up to 40
with a ragged S, d_inner 16 to 64, d_state 4 and 8), float32.  Tolerances,
each of ``max(max|want|, 1)``:

* the port's ``_ssm_inputs`` and fused scan against the reference's
  ``_ssm_terms`` and ``selective_scan`` (y and h_last), and their
  gradients under ``jax.grad`` in the layer's input, ``x_proj``, ``dt_w``,
  ``dt_b``, ``a_log`` and h0: 1e-5, as the mixer's (float32 projections
  rounded at other places in the two frameworks, and the reference's
  associative scan multiplies in another order);
* the fused backward on given dt, x, B, C, A and h0 against ``jax.grad``
  of the reference's formation (``_ssm_terms``' lines) and
  ``selective_scan``: 1e-5 (the associative scan's order; no projection);
* the plain backward (``ref.mamba_scan_fused_bwd_ref``) against
  ``torch.autograd`` through the plain forward: 1e-5 (both float32, the
  same recurrence; its sums in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import mamba as JM
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba as TM

ARCH = "falcon_mamba_7b"
TOL = 1e-5
CHUNK = 8  # the reference's associative-scan chunk (any S: it shrinks to a divisor)
CASES = [  # B, S, d_inner, N, with h0
    (2, 16, 16, 4, False),
    (2, 37, 32, 8, True),  # ragged S (prime)
    (2, 40, 64, 8, False),
    (2, 24, 48, 4, True),
]
IDS = [f"B{b}-S{s}-di{d}-N{n}{'-h0' if h else ''}" for b, s, d, n, h in CASES]


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _configs(di: int, N: int):
    """The float32 smoke config with d_inner ``di`` and d_state ``N``, for
    the reference and the port."""
    out = []
    for cfg in (jax_smoke_config(ARCH), get_smoke_config(ARCH)):
        m = dataclasses.replace(cfg.mamba, d_state=N)
        out.append(dataclasses.replace(cfg, dtype="float32", d_model=di // m.expand, mamba=m))
    return out


def _layer(seed, B, S, di, N, with_h0):
    """The scan's part of a layer's parameters, its input x [B, S, di], h0
    and the loss's weights on y and h_last, float32 numpy."""
    rng = np.random.RandomState(seed)
    _, tcfg = _configs(di, N)
    r = tcfg.mamba.resolved_dt_rank(tcfg.d_model)
    p = {"x_proj": rng.randn(di, r + 2 * N) / np.sqrt(di),
         "dt_w": rng.randn(r, di) / np.sqrt(r),
         "dt_b": rng.randn(di) * 0.5,
         "a_log": np.log(np.arange(1, N + 1))[None, :] + 0.1 * rng.randn(di, N)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(B, S, di).astype(np.float32)
    h0 = (rng.randn(B, di, N) * 0.1).astype(np.float32) if with_h0 else None
    return p, x, h0, rng.randn(B, S, di).astype(np.float32), rng.randn(B, di, N).astype(np.float32)


def _jax_scan(jcfg, p, x, h0, B, di, N):
    """The reference's ``_ssm_terms`` and ``selective_scan`` (h0 None: zeros)."""
    a, b, C = JM._ssm_terms(jcfg, p, x)
    h0 = jnp.zeros((B, di, N), jnp.float32) if h0 is None else h0
    return JM.selective_scan(a, b, C.astype(jnp.float32), h0, CHUNK)


def _port_scan(tcfg, p, x, h0):
    dt, Bm, Cm, A = TM._ssm_inputs(tcfg, p, x)
    return TM.selective_scan_fused(dt, x, Bm.contiguous(), Cm.contiguous(), A, h0)


@pytest.mark.parametrize("B,S,di,N,with_h0", CASES, ids=IDS)
def test_fused_forward_matches_ssm_terms_and_selective_scan(B, S, di, N, with_h0):
    jcfg, tcfg = _configs(di, N)
    p, x, h0, _, _ = _layer(0, B, S, di, N, with_h0)
    want_y, want_h = jax.jit(lambda p, x, h0: _jax_scan(jcfg, p, x, h0, B, di, N))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        None if h0 is None else jnp.asarray(h0))
    y, h = _port_scan(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, di) and tuple(h.shape) == (B, di, N)
    _close(y, want_y, "y")
    _close(h, want_h, "h_last")


@pytest.mark.parametrize("B,S,di,N,with_h0", CASES, ids=IDS)
def test_fused_gradients_match_jax_grad_through_ssm_terms(B, S, di, N, with_h0):
    """``jax.grad`` of ``sum(y wy) + sum(h_last wh)`` through the reference's
    ``_ssm_terms`` and ``selective_scan`` against autograd through the
    port's ``_ssm_inputs`` and ``selective_scan_fused`` (its backward the
    fused plain backward): the layer's input, the projections, ``dt_b``,
    ``a_log`` and h0."""
    jcfg, tcfg = _configs(di, N)
    p, x, h0, wy, wh = _layer(1, B, S, di, N, with_h0)
    h0 = h0 if with_h0 else np.zeros((B, di, N), np.float32)

    def jloss(p, x, h0):
        y, h = _jax_scan(jcfg, p, x, h0, B, di, N)
        return (y * wy).sum() + (h * wh).sum()

    want_p, want_x, want_h0 = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(h0))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx, th0 = (torch.from_numpy(v).requires_grad_() for v in (x, h0))
    y, h = _port_scan(tcfg, tp, tx, th0)
    loss = (y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()
    names = sorted(tp)
    got = torch.autograd.grad(loss, [tp[k] for k in names] + [tx, th0])
    for name, g, w in zip(names + ["x", "h0"], got,
                          [want_p[k] for k in names] + [want_x, want_h0]):
        assert np.abs(np.asarray(w)).max() > 0, name
        _close(g, w, name)


def _direct_inputs(seed, B, S, di, N, with_h0):
    """dt (through softplus), x, B, C, a_log, h0 and the loss's weights,
    float32 numpy."""
    rng = np.random.RandomState(seed)
    dt = np.log1p(np.exp(rng.randn(B, S, di) - 0.5))
    x, Bm, Cm = rng.randn(B, S, di), rng.randn(B, S, N), rng.randn(B, S, N)
    a_log = np.log(np.arange(1, N + 1))[None, :] + 0.1 * rng.randn(di, N)
    h0 = rng.randn(B, di, N) * 0.1 if with_h0 else np.zeros((B, di, N))
    wy, wh = rng.randn(B, S, di), rng.randn(B, di, N)
    return [t.astype(np.float32) for t in (dt, x, Bm, Cm, a_log, h0, wy, wh)]


@pytest.mark.parametrize("B,S,di,N,with_h0", CASES, ids=IDS)
def test_fused_backward_matches_jax_grad(B, S, di, N, with_h0):
    """``ops.mamba_scan_fused_bwd`` (the plain version here) on given dt, x,
    B, C, A = -exp(a_log) and h0, for the cotangents wy of y and wh of
    h_last, against ``jax.grad`` of the reference's formation and
    ``selective_scan``; a_log's gradient is gA A."""
    dt, x, Bm, Cm, a_log, h0, wy, wh = _direct_inputs(2, B, S, di, N, with_h0)

    def jloss(dt, x, Bm, Cm, a_log, h0):
        # the reference's _ssm_terms from dt on (repro/models/mamba.py)
        A = -jnp.exp(a_log.astype(jnp.float32))
        dt32 = dt.astype(jnp.float32)
        a = jnp.exp(dt32[..., None] * A)
        b = (dt32 * x.astype(jnp.float32))[..., None] * Bm.astype(jnp.float32)[..., None, :]
        y, h = JM.selective_scan(a, b, Cm, h0, CHUNK)
        return (y * wy).sum() + (h * wh).sum()

    want = jax.jit(jax.grad(jloss, argnums=range(6)))(*(jnp.asarray(t) for t in
                                               (dt, x, Bm, Cm, a_log, h0)))
    t = [torch.from_numpy(v) for v in (dt, x, Bm, Cm)]
    A = -torch.exp(torch.from_numpy(a_log))
    gdt, gx, gB, gC, gA, gh0 = ops.mamba_scan_fused_bwd(
        *t, A, torch.from_numpy(h0) if with_h0 else None, torch.from_numpy(wy),
        torch.from_numpy(wh))
    got = [gdt, gx, gB, gC, gA * A]
    for name, g, w in zip(("dt", "x", "B", "C", "a_log"), got, want):
        _close(g, w, name)
    if with_h0:
        _close(gh0, want[5], "h0")


@pytest.mark.parametrize("B,S,di,N,with_h0", CASES, ids=IDS)
@pytest.mark.parametrize("with_gh", [True, False], ids=["gh_fin", "no-gh_fin"])
def test_plain_backward_matches_autograd_through_the_plain_forward(B, S, di, N, with_h0,
                                                                   with_gh):
    dt, x, Bm, Cm, a_log, h0, wy, wh = _direct_inputs(3, B, S, di, N, with_h0)
    ins = [torch.from_numpy(v).requires_grad_() for v in (dt, x, Bm, Cm)]
    A = (-torch.exp(torch.from_numpy(a_log))).requires_grad_()
    th0 = torch.from_numpy(h0).requires_grad_() if with_h0 else None
    y, h = ref.mamba_scan_fused_ref(*ins, A, th0)
    loss = (y * torch.from_numpy(wy)).sum() + (
        (h * torch.from_numpy(wh)).sum() if with_gh else 0)
    wrt = ins + [A] + ([th0] if with_h0 else [])
    want = torch.autograd.grad(loss, wrt)
    got = ref.mamba_scan_fused_bwd_ref(*(t.detach() for t in ins), A.detach(), h0=(
        th0.detach() if with_h0 else None), gy=torch.from_numpy(wy),
        gh_fin=torch.from_numpy(wh) if with_gh else None)
    for name, g, w in zip(("dt", "x", "B", "C", "A", "h0"), got, want):
        _close(g, w.numpy(), name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_run_the_plain_versions_uncounted(dtype):
    """On the CPU the dispatchers return ``ref.mamba_scan_fused_ref`` and
    ``ref.mamba_scan_fused_bwd_ref`` exactly, gradients in the inputs'
    dtype (gA and gh0 float32), and count no launch."""
    dt, x, Bm, Cm, a_log, h0, wy, wh = _direct_inputs(4, 2, 9, 8, 4, True)
    t = [torch.from_numpy(v).to(dtype) for v in (dt, x, Bm, Cm)]
    A, th0, gy, gh = (torch.from_numpy(v) for v in (-np.exp(a_log), h0, wy, wh))
    before = ops.launch_counts()
    for h, g in ((None, None), (th0, gh)):
        for a, b in zip(ops.mamba_scan_fused(*t, A, h), ref.mamba_scan_fused_ref(*t, A, h)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        got = ops.mamba_scan_fused_bwd(*t, A, h, gy, g)
        assert [u.dtype for u in got] == [dtype] * 4 + [torch.float32] * 2
        for a, b in zip(got, ref.mamba_scan_fused_bwd_ref(*t, A, h, gy, g)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ops.launch_counts() == before


def test_meta_calls_count_as_the_unfused_scan():
    """On the meta device the fused calls compute nothing, count no launch,
    and add the unfused scan's FLOPs under its names (``mamba_scan``,
    ``mamba_scan_bwd``), so the dry-run's counts do not move."""
    B, S, di, N = 2, 5, 16, 4
    dt, x = (torch.empty(B, S, di, dtype=torch.bfloat16, device="meta") for _ in range(2))
    Bm, Cm = (torch.empty(B, S, N, dtype=torch.bfloat16, device="meta") for _ in range(2))
    A = torch.empty(di, N, device="meta")
    gy = torch.empty(B, S, di, device="meta")
    ops.reset_launches()
    with ops.count_meta_flops() as counts:
        y, h = ops.mamba_scan_fused(dt, x, Bm, Cm, A)
        grads = ops.mamba_scan_fused_bwd(dt, x, Bm, Cm, A, None, gy)
    assert y.is_meta and y.shape == (B, S, di) and y.dtype == torch.float32
    assert h.shape == (B, di, N) and h.dtype == torch.float32
    assert [tuple(g.shape) for g in grads] == [(B, S, di)] * 2 + [(B, S, N)] * 2 + [
        (di, N), (B, di, N)]
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4 + [torch.float32] * 2
    assert counts["mamba_scan"] == counts["mamba_scan_bwd"] == 2 * B * S * di * N
    assert counts["mamba_scan_fused"] == counts["mamba_scan_fused_bwd"] == 0
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


def test_the_layer_forms_no_scan_terms(monkeypatch):
    """The mixer's prefill and training path goes through the fused scan:
    ``_ssm_terms`` (the decode step's) and the unfused ``mamba_scan`` are
    not called, and the fused forward is, once a layer."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    from repro_torch.models import lm as TLM

    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    p = {k: v[0] for k, v in params["blocks"]["slot0"]["mixer"].items()}
    calls = []
    real = ops.mamba_scan_fused

    def fused(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    def refused(*a, **k):
        raise AssertionError("the layer formed the scan's terms")

    monkeypatch.setattr(ops, "mamba_scan_fused", fused)
    monkeypatch.setattr(ops, "mamba_scan", refused)
    monkeypatch.setattr(TM, "_ssm_terms", refused)
    x = torch.randn(2, 7, cfg.d_model, generator=torch.Generator().manual_seed(1))
    for train in (False, True):
        y, _ = TM.mamba(cfg, p, x, train=train)
        assert y.shape == x.shape
    assert calls == [(2, 7, cfg.mamba.expand * cfg.d_model)] * 2
