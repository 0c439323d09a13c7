"""The port's Mamba path against the JAX package's: the selective scan
(``repro_torch.kernels.ops.mamba_scan``, its plain version on the CPU), the
Mamba mixer (``repro_torch.models.mamba``) and the decoder LM on the
``falcon_mamba_7b`` smoke config, with the reference's own parameters
(``lm.init_model``) carried across by ``convert.params_from_numpy``.

Inputs are made with numpy from a seed.  The scan is held at
``tests/test_kernels.py``'s shapes and tolerances (rtol 1e-4, atol 1e-5)
against the reference's Pallas kernel in interpret mode, and with an initial
state against the reference's ``selective_scan``.  The mixer and the LM run
on a float32 copy of the config, where the point is the algorithm:
tolerance 1e-5 of the largest value.  The reference's prefill runs a chunked
associative scan, which multiplies the decays in another order than the
port's sequential recurrence; in float32 that moves the results by a few
ulps, well inside 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.models import lm as JLM
from repro.models import mamba as JM
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import lm as TLM
from repro_torch.models import mamba as TM

ARCH = "falcon_mamba_7b"
TOL_F32 = 1e-5
B, S, STEPS = 2, 16, 4


def _scan_inputs(rng, B, S, di, N, h0=False):
    """As ``tests/test_kernels.py::test_mamba_scan`` makes them."""
    a = (rng.rand(B, S, di, N) * 0.9).astype(np.float32)
    b = (rng.randn(B, S, di, N) * 0.1).astype(np.float32)
    c = rng.randn(B, S, N).astype(np.float32)
    out = [a, b, c]
    if h0:
        out.append((rng.randn(B, di, N) * 0.1).astype(np.float32))
    return out


@pytest.mark.parametrize("B,S,di,N,chunk,bd", [
    (2, 64, 32, 8, 16, 16),
    (1, 128, 64, 16, 32, 32),
    (3, 96, 16, 4, 16, 16),
])
def test_mamba_scan_matches_pallas(B, S, di, N, chunk, bd):
    arrs = _scan_inputs(np.random.RandomState(0), B, S, di, N)
    want_y, want_h = jops.mamba_scan(*(jnp.asarray(x) for x in arrs), chunk=chunk,
                                     block_d=bd)
    y, h = ops.mamba_scan(*(torch.from_numpy(x) for x in arrs))
    assert y.shape == (B, S, di) and h.shape == (B, di, N) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,S,di,N,chunk", [(2, 64, 8, 4, 16), (1, 96, 16, 8, 32),
                                            (2, 37, 16, 16, 16)])
def test_mamba_scan_with_h0_matches_selective_scan(B, S, di, N, chunk):
    """A nonzero initial state, against the model's ``selective_scan``
    (``tests/test_vjps.py``'s shapes, plus a length that no chunk divides)."""
    arrs = _scan_inputs(np.random.RandomState(1), B, S, di, N, h0=True)
    want_y, want_h = JM.selective_scan(*(jnp.asarray(x) for x in arrs), chunk)
    y, h = ops.mamba_scan(*(torch.from_numpy(x) for x in arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-4, atol=1e-5)


def _configs(dtype="float32"):
    return [dataclasses.replace(cfg, dtype=dtype)
            for cfg in (jax_smoke_config(ARCH), get_smoke_config(ARCH))]


def _params(jcfg, tcfg, seed=0):
    jp = JLM.init_model(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.float().numpy() - want).max() / max(np.abs(want).max(), 1e-6))


def _layer(tree, i=0):
    return jax.tree.map(lambda t: t[i], tree)


def test_mixer_prefill_cache_and_decode_match_reference():
    """One Mamba layer: prefill output and filled cache (conv window and
    state), then a decode step from that cache."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    jpl = _layer(jp["blocks"]["slot0"]["mixer"])
    tpl = {k: v[0] for k, v in tp["blocks"]["slot0"]["mixer"].items()}
    rng = np.random.RandomState(2)
    x = rng.randn(B, S + 1, tcfg.d_model).astype(np.float32)

    jcache = JM.init_mamba_cache(jcfg, B)
    jy, jc = JM.mamba(jcfg, jpl, jnp.asarray(x[:, :S]), cache=jcache, fill_cache=True)
    ty, tc = TM.mamba(tcfg, tpl, torch.from_numpy(x[:, :S]))
    assert _rel(ty, jy) < TOL_F32
    for n in ("conv", "ssm"):
        assert _rel(tc[n], jc[n]) < TOL_F32, n
    assert tc["ssm"].dtype == torch.float32

    jy, jc = JM.mamba(jcfg, jpl, jnp.asarray(x[:, S:]), cache=jc)
    ty, tc2 = TM.mamba(tcfg, tpl, torch.from_numpy(x[:, S:]), cache=tc)
    assert tc2 is tc  # updated in place
    assert _rel(ty, jy) < TOL_F32
    for n in ("conv", "ssm"):
        assert _rel(tc[n], jc[n]) < TOL_F32, n


@pytest.mark.parametrize("position", ["int", "tensor"])
def test_prefill_and_decode_match_reference(position):
    """Logits and caches after prefill and after each of 4 decode steps, the
    position given as an int or as the 0-d tensor that the captured decode
    step reads."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.RandomState(3).randint(0, tcfg.vocab_size, (B, S + STEPS))

    jl, jc = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)})
    tl, tc = TLM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S])})
    assert tl.shape == (B, tcfg.padded_vocab) and tl.dtype == torch.float32
    assert _rel(tl, jl) < TOL_F32
    for n in ("conv", "ssm"):
        assert _rel(tc["blocks"]["slot0"][n], jc["blocks"]["slot0"][n]) < TOL_F32, n

    for t in range(STEPS):
        step = toks[:, S + t:S + t + 1]
        jl, jc = JLM.decode_step(jcfg, jp, jnp.asarray(step, jnp.int32), jc,
                                 jnp.int32(S + t))
        pos = S + t if position == "int" else torch.tensor(S + t)
        tl, tc = TLM.decode_step(tcfg, tp, torch.from_numpy(step), tc, pos)
        assert _rel(tl, jl) < TOL_F32, f"step {t}"
        for n in ("conv", "ssm"):
            assert _rel(tc["blocks"]["slot0"][n], jc["blocks"]["slot0"][n]) < TOL_F32, \
                (t, n)


def test_bf16_prefill_matches_reference():
    """The served dtype: bf16 rounds at other places in the two frameworks,
    so 2e-2 of the logits' scale, as for Yi."""
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.RandomState(4).randint(0, tcfg.vocab_size, (B, S))
    jl, _ = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _ = TLM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    assert _rel(tl, jl) < 2e-2


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_F32), ("bfloat16", 0.05)])
def test_decode_matches_full_forward(dtype, tol):
    """The port's own consistency: decoding token 33 from the cache of the
    first 32 gives the full forward's last logits (0.05 for bf16, as the
    reference's ``test_models.py::test_decode_matches_full_forward``)."""
    _, cfg = _configs(dtype)
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 33)))
    full, _ = TLM.prefill(cfg, params, {"tokens": toks})
    _, cache = TLM.prefill(cfg, params, {"tokens": toks[:, :32]})
    lg, _ = TLM.decode_step(cfg, params, toks[:, 32:], cache, 32)
    err = (lg.float() - full.float()).abs().max() / full.float().abs().max()
    assert err < tol


def test_param_meta_and_a_log_match_reference():
    """Same keys, shapes, logical axes and inits as the reference's
    metadata, and the port's own ``a_log`` init equals the reference's."""
    jcfg, tcfg = _configs("bfloat16")
    jmeta = jax.tree.map(lambda m: (m.shape, m.axes, m.init), JLM.model_meta(jcfg),
                         is_leaf=lambda m: isinstance(m, JM.ParamMeta))
    tmeta = jax.tree.map(lambda m: (m.shape, m.axes, m.init), TLM.model_meta(tcfg),
                         is_leaf=lambda m: hasattr(m, "init"))
    assert tmeta == jmeta
    assert "norm2" not in tmeta["blocks"]["slot0"] and "ffn" not in tmeta["blocks"]["slot0"]
    want = np.asarray(JLM.init_model(jcfg, jax.random.PRNGKey(0))
                      ["blocks"]["slot0"]["mixer"]["a_log"], np.float32)
    got = TLM.init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = got["blocks"]["slot0"]["mixer"]["a_log"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_init_cache_matches_reference():
    """Conv window bf16 and state float32, stacked over the layers."""
    jcfg, tcfg = _configs()
    want = JLM.init_cache(jcfg, 3, 10)["blocks"]["slot0"]
    got = TLM.init_cache(tcfg, 3, 10, device="cpu")["blocks"]["slot0"]
    assert set(got) == set(want) == {"conv", "ssm"}
    for n in got:
        assert tuple(got[n].shape) == want[n].shape and not got[n].any()
    assert got["conv"].dtype == torch.bfloat16 and got["ssm"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_terms_are_contiguous_float32(dtype):
    """The scan kernel takes its 1 GB operands as they are and refuses a
    non-contiguous one, so the model must hand it contiguous float32."""
    _, cfg = _configs(dtype)
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    p = {k: v[0] for k, v in params["blocks"]["slot0"]["mixer"].items()}
    di = cfg.mamba.expand * cfg.d_model
    xc = torch.randn(2, 5, di).to(params["embed"]["embedding"].dtype)
    a, b, c = TM._ssm_terms(cfg, p, xc)
    for t in (a, b):
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert tuple(t.shape) == (2, 5, di, cfg.mamba.d_state)
    assert ((a > 0) & (a < 1)).all()
