"""The port's layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the same numpy inputs.

Tolerances: float32 1e-5 of the output's scale (the two frameworks sum in
other orders); bfloat16 2e-2 of each element's own scale, ``ref.scaled_err``
(bf16 keeps 8 bits); embedding lookups are exact (a gather and a one-hot
matmul pick the same row).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ref import scaled_err
from repro_torch.models import layers as TL

RNG = np.random.RandomState(1)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _both(a, dt):
    return jnp.asarray(a, getattr(jnp, dt)), torch.from_numpy(np.asarray(a)).to(getattr(torch, dt))


def _close(port: torch.Tensor, want, dt, exact=False):
    got = port.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    if exact:
        assert err == 0.0, err
    elif dt == "bfloat16":
        assert scaled_err(port, torch.from_numpy(want)) <= TOL[dt]
    else:
        assert err <= TOL[dt] * max(np.abs(want).max(), 1.0), err


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rms_norm(dt):
    (jx, tx), (jw, tw) = _both(RNG.randn(2, 8, 64), dt), _both(RNG.rand(64) + 0.5, dt)
    _close(TL.rms_norm(tx, tw, 1e-6), JL.rms_norm(jx, jw, 1e-6), dt)


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mlp(act, dt):
    d, ff = 64, 160
    names = ["w_gate", "w_up", "w_down"] if act != "gelu" else ["w_up", "w_down"]
    shapes = {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    pairs = {n: _both(RNG.randn(*shapes[n]) / np.sqrt(shapes[n][0]), dt) for n in names}
    jx, tx = _both(RNG.randn(2, 8, d), dt)
    want = JL.mlp({n: p[0] for n, p in pairs.items()}, jx, act)
    _close(TL.mlp({n: p[1] for n, p in pairs.items()}, tx, act), want, dt)


def _codebook_cases(name: str):
    """A flag's two values on the yi smoke config (one codebook; the ids
    are the flag's alone) and on musicgen's (2 codebooks)."""
    return pytest.mark.parametrize(
        f"{name},arch", [(f, a) for a in ("yi_6b", "musicgen_large") for f in (False, True)],
        ids=["False", "True", "musicgen-False", "musicgen-True"])


@_codebook_cases("embed_scale")
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_embed(embed_scale, arch, dt):
    """One table [V, D] for tokens [B, S], or K tables [K, V, D] summed in
    codebook order for tokens [B, S, K]."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), embed_scale=embed_scale)
    tcfg = dataclasses.replace(get_smoke_config(arch), embed_scale=embed_scale)
    k = tcfg.num_codebooks
    table = (k, tcfg.padded_vocab, tcfg.d_model) if k > 1 else (tcfg.padded_vocab, tcfg.d_model)
    assert TL.embed_meta(tcfg)["embedding"].shape == table
    jt, tt = _both(RNG.randn(*table), dt)
    toks = RNG.randint(0, tcfg.vocab_size, (2, 8, k) if k > 1 else (2, 8))
    want = JL.embed(jcfg, {"embedding": jt}, jnp.asarray(toks, jnp.int32))
    _close(TL.embed(tcfg, {"embedding": tt}, torch.from_numpy(toks)), want, dt, exact=True)


@_codebook_cases("tie")
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_logits(tie, arch, dt):
    """A tied or untied head [D, V], or for K codebooks an untied head
    [D, K * V] (tying is ignored, as in the reference) giving [B, S, K, V]."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), tie_embeddings=tie)
    tcfg = dataclasses.replace(get_smoke_config(arch), tie_embeddings=tie)
    v, d, k = tcfg.padded_vocab, tcfg.d_model, tcfg.num_codebooks
    (je, te), (jh, th) = _both(RNG.randn(v, d) * 0.02, dt), _both(RNG.randn(d, k * v) / 8, dt)
    jx, tx = _both(RNG.randn(2, 3, d), dt)
    want = JL.logits(jcfg, {"embed": {"embedding": je}, "head": {"lm_head": jh}}, jx)
    tied = tie and k == 1
    tp = {"embed": {"embedding": te}, "head": {} if tied else {"lm_head": th}}
    assert TL.head_meta(tcfg) == ({} if tied else {"lm_head": TL.head_meta(tcfg)["lm_head"]})
    assert tied or TL.head_meta(tcfg)["lm_head"].shape == (d, k * v)
    _close(TL.logits(tcfg, tp, tx), want, dt)


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rope(theta, dt):
    jx, tx = _both(RNG.randn(2, 8, 4, 16), dt)
    pos = RNG.randint(0, 1000, (2, 8))
    want = JL.rope(jx, jnp.asarray(pos, jnp.int32), theta)
    _close(TL.rope(tx, torch.from_numpy(pos), theta), want, dt)


def test_param_metadata_matches_the_reference():
    """Same keys, shapes and inits as the reference's metadata, so the
    reference's parameters carry across one to one."""
    _param_metadata_matches("yi_6b")


@pytest.mark.parametrize("arch", ["gemma_7b", "h2o_danube_3_4b", "musicgen_large",
                                  "falcon_mamba_7b"])
def test_config_param_metadata_matches_the_reference(arch):
    """The same on every other served config: a tied head (gemma), a window
    (h2o-danube), [K, V, D] codebook tables and a [D, K * V] head
    (musicgen), the Mamba mixer (falcon-mamba)."""
    _param_metadata_matches(arch)


def _param_metadata_matches(arch):
    from repro.models import lm as JLM
    from repro_torch.models import lm as TLM

    want = jax.tree.leaves_with_path(JLM.model_meta(jax_smoke_config(arch)),
                                     is_leaf=lambda m: hasattr(m, "axes"))
    got = {}

    def walk(tree, path):
        for k, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, path + (k,))
            else:
                got[path + (k,)] = sub

    walk(TLM.model_meta(get_smoke_config(arch)), ())
    assert {tuple(p.key for p in path): (m.shape, m.axes, m.init, m.scale)
            for path, m in want} == \
        {path: (m.shape, m.axes, m.init, m.scale) for path, m in got.items()}
