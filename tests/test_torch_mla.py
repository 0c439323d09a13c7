"""MiniCPM3's multi-head latent attention in the port
(``repro_torch.models.attention``, MLA branch) against the JAX package's:
the flash path at unequal q/k and v head dims, the layer's expanded prefill
and filled latent cache, its absorbed decode, and the whole model's prefill
and decode, and the layer's training gradients, with the reference's own
parameters (``lm.init_model``) carried across by ``convert.params_from_numpy``.

Float32 copies of the smoke config (q/k head dim 16 + 8 = 24, v head dim
16), where the point is the algorithm: tolerance 1e-5 of the output's
scale.  bf16 at 0.05, the served dtype's tolerance of
``tests/test_torch_lm.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import lm as JLM
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import lm as TLM

TOL_F32 = 1e-5
TOL_BF16 = 0.05
ARCH = "minicpm3_4b"
B, S, STEPS = 2, 16, 4


def _configs(dtype="float32"):
    return (dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


def _params(jcfg, tcfg, seed=0):
    jp = JLM.init_model(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.float().numpy() - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("H,Hkv,Sq,hd,hdv,window", [
    (4, 4, 40, 24, 16, None),   # the smoke config's MLA pair, MHA
    (4, 2, 64, 24, 16, 16),     # ... GQA, windowed
    (3, 3, 48, 96, 64, None),   # MiniCPM3's pair
    (2, 2, 100, 96, 64, 30),    # ... windowed, a length off the chunk sizes
    (4, 1, 33, 96, 64, None),   # ... GQA group 4
])
def test_flash_attention_ref_unequal_head_dims_matches_chunked_attention(
        H, Hkv, Sq, hd, hdv, window):
    """The port's flash path (the plain version on the CPU) at v head dim !=
    q/k head dim, against the reference's ``chunked_attention`` with
    ``q_pos = arange(S)``, ``k_off = 0`` (the Pallas kernel assumes equal
    dims, so it is not the oracle here)."""
    rng = np.random.RandomState(hd + Sq)
    q = rng.randn(1, Sq, H, hd).astype(np.float32)
    k = rng.randn(1, Sq, Hkv, hd).astype(np.float32)
    v = rng.randn(1, Sq, Hkv, hdv).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.arange(Sq, dtype=jnp.int32), 0, window=window,
                                chunk_q=16, chunk_kv=16, scale=scale)
    rows = lambda a: torch.from_numpy(a).transpose(1, 2).reshape(-1, Sq, a.shape[-1])  # noqa: E731
    out = ops.flash_attention(rows(q), rows(k), rows(v), group_size=H // Hkv, causal=True,
                              window=window, scale=scale)
    assert tuple(out.shape) == (H, Sq, hdv)
    assert _rel(out.reshape(1, H, Sq, hdv).transpose(1, 2), want) < TOL_F32


def _layer(jp, tp, i=0):
    """The attention parameters of period ``i`` of both trees."""
    return (jax.tree.map(lambda a: a[i], jp["blocks"]["slot0"]["mixer"]),
            {n: t[i] for n, t in tp["blocks"]["slot0"]["mixer"].items()})


def test_mla_layer_prefill_and_absorbed_decode_match_reference():
    """The layer alone: the expanded prefill's output and filled latent
    cache (``ckv`` [B, C, kv_lora], ``krope`` [B, C, rope], zero past the
    prompt), then the absorbed decode's output and cache over 4 steps."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    jl, tl = _layer(jp, tp, 1)
    rng = np.random.RandomState(3)
    x = rng.randn(B, S + STEPS, tcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S + STEPS), (B, S + STEPS))
    C = S + STEPS

    jcache = JA.init_attn_cache(jcfg, B, C, dtype=jnp.float32)
    jout, jcache = JA.attention(jcfg, jl, jnp.asarray(x[:, :S]), jnp.asarray(pos[:, :S]),
                                cache=jcache, fill_cache=True)
    tout, tcache = TA.attention(tcfg, tl, torch.from_numpy(x[:, :S]),
                                torch.from_numpy(pos[:, :S].copy()), capacity=C)
    assert _rel(tout, jout) < TOL_F32
    assert set(tcache) == {"ckv", "krope"}
    for n in tcache:
        assert _rel(tcache[n], jcache[n]) < TOL_F32
        assert not tcache[n][:, S:].any()

    for t in range(STEPS):
        n = S + t
        jout, jcache = JA.attention(jcfg, jl, jnp.asarray(x[:, n:n + 1]),
                                    jnp.asarray(pos[:, n:n + 1]), cache=jcache,
                                    cache_pos=jnp.int32(n))
        tout, tcache = TA.attention(tcfg, tl, torch.from_numpy(x[:, n:n + 1]),
                                    torch.from_numpy(pos[:, n:n + 1].copy()), cache=tcache,
                                    cache_pos=torch.tensor(n))
        assert _rel(tout, jout) < TOL_F32, f"step {t}"
        for name in tcache:
            assert _rel(tcache[name], jcache[name]) < TOL_F32, f"step {t} {name}"


def test_mla_layer_training_gradients_match_reference():
    """The layer's training form (the expanded keys through the training
    flash attention, no cache): its output and the gradients of ``sum(out
    * w)`` in x and in every parameter of the layer, against
    ``jax.value_and_grad`` of the reference's, float32."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    jl, tl = _layer(jp, tp, 1)
    rng = np.random.RandomState(5)
    x = rng.randn(B, S, tcfg.d_model).astype(np.float32)
    w = rng.randn(B, S, tcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()

    def jloss(params, x):
        out, _ = JA.attention(jcfg, params, x, jnp.asarray(pos))
        return (out * w).sum(), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jl, jnp.asarray(x))
    tl = {n: t.detach().clone().requires_grad_() for n, t in tl.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tout, cache = TA.attention(tcfg, tl, tx, torch.from_numpy(pos), train=True)
    (tout * torch.from_numpy(w)).sum().backward()
    assert cache is None
    assert _rel(tout.detach(), jout) < TOL_F32
    assert _rel(tx.grad, jgx) < TOL_F32
    assert set(tl) == set(jgp)
    for n, t in tl.items():
        assert _rel(t.grad, jgp[n]) < TOL_F32, n


@pytest.mark.parametrize("position", ["int", "tensor"])
def test_minicpm3_prefill_and_decode_match_reference(position):
    """The whole model: logits and latent caches after prefill and after
    each of 4 decode steps, the position given as an int or as the 0-d
    tensor the captured step reads."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.RandomState(0).randint(0, tcfg.vocab_size, (B, S + STEPS))
    jl, jc = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                         capacity=S + STEPS)
    tl, tc = TLM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S])},
                         capacity=S + STEPS)
    assert tl.shape == (B, tcfg.padded_vocab)
    assert _rel(tl, jl) < TOL_F32
    for n in ("ckv", "krope"):
        assert _rel(tc["blocks"]["slot0"][n], jc["blocks"]["slot0"][n]) < TOL_F32
    for t in range(STEPS):
        step = toks[:, S + t:S + t + 1]
        jl, jc = JLM.decode_step(jcfg, jp, jnp.asarray(step, jnp.int32), jc,
                                 jnp.int32(S + t))
        pos = S + t if position == "int" else torch.tensor(S + t)
        tl, tc = TLM.decode_step(tcfg, tp, torch.from_numpy(step), tc, pos)
        assert _rel(tl, jl) < TOL_F32, f"step {t}"
        for n in ("ckv", "krope"):
            assert _rel(tc["blocks"]["slot0"][n], jc["blocks"]["slot0"][n]) < TOL_F32


def test_minicpm3_bf16_prefill_matches_reference():
    """The served dtype: bf16 rounds at other places in the two frameworks."""
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.RandomState(2).randint(0, tcfg.vocab_size, (B, S))
    jl, _ = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _ = TLM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    assert _rel(tl, jl) < TOL_BF16


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_F32), ("bfloat16", TOL_BF16)])
def test_mla_decode_matches_full_forward(dtype, tol):
    """The port's absorbed decode equals its own expanded prefill over the
    same tokens, step by step."""
    _, cfg = _configs(dtype)
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 24)))
    _, cache = TLM.prefill(cfg, params, {"tokens": toks[:, :20]}, capacity=24)
    for n in range(20, 24):
        lg, cache = TLM.decode_step(cfg, params, toks[:, n:n + 1], cache, n)
        full, _ = TLM.prefill(cfg, params, {"tokens": toks[:, :n + 1]})
        err = (lg.float() - full.float()).abs().max() / full.float().abs().max()
        assert err < tol, f"position {n}: {err}"


def test_mla_init_cache_is_a_bf16_latent_cache():
    _, cfg = _configs()
    cache = TLM.init_cache(cfg, 3, 10, device="cpu")["blocks"]["slot0"]
    a = cfg.attn
    assert set(cache) == {"ckv", "krope"}
    assert tuple(cache["ckv"].shape) == (cfg.num_periods, 3, 10, a.kv_lora_rank)
    assert tuple(cache["krope"].shape) == (cfg.num_periods, 3, 10, a.qk_rope_head_dim)
    assert all(t.dtype == torch.bfloat16 and not t.any() for t in cache.values())


def test_check_position_on_an_mla_cache():
    """The capacity of an MLA cache is read from its latent ``ckv``: a decode
    step at the last slot runs, one past it raises, as does a negative one."""
    _, cfg = _configs()
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = TLM.init_cache(cfg, B, 12, device="cpu")
    TLM.check_position(cfg, cache, 11)
    tok = torch.zeros(B, 1, dtype=torch.int64)
    TLM.decode_step(cfg, params, tok, cache, 11)
    assert cache["blocks"]["slot0"]["ckv"][:, :, 11].any()
    with pytest.raises(ValueError, match="outside a cache of 12"):
        TLM.decode_step(cfg, params, tok, cache, 12)
    with pytest.raises(ValueError, match="is negative"):
        TLM.check_position(cfg, cache, -1)


def test_mla_params_carry_the_reference_tree():
    """The MLA block's parameters have the reference's names and shapes."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    want = jax.tree.map(lambda a: a.shape, jp["blocks"]["slot0"]["mixer"])
    got = {n: tuple(t.shape) for n, t in tp["blocks"]["slot0"]["mixer"].items()}
    assert got == want
    assert set(got) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
