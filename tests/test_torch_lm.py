"""The port's decoder LM (``repro_torch.models.lm``) against the JAX
package's (``repro.models.lm``): prefill logits and filled cache, then four
decode steps, on the yi, gemma, h2o-danube and musicgen smoke configs with
the reference's own parameters (``lm.init_model``) carried across by
``convert.params_from_numpy``.

The parity runs on a float32 copy of the config, where the point is the
algorithm: tolerance 1e-5 of the logits' scale (sums in other orders, and
the reference's chunked online softmax against the port's plain one).  As
in the reference, the filled cache takes the model dtype.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as JLM
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm as TLM
from repro_torch.models.params import map_tree

TOL_F32 = 1e-5
B, S, CAP, STEPS = 2, 16, 24, 4


def _configs(dtype="float32", window=None, arch="yi_6b"):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    out = []
    for cfg in (jcfg, tcfg):
        cfg = dataclasses.replace(cfg, dtype=dtype)
        if window is not None:
            cfg = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                                    sliding_window=window))
        out.append(cfg)
    return out


def _params(jcfg, tcfg, seed=0):
    jp = JLM.init_model(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("position", ["int", "tensor"])
@pytest.mark.parametrize("window", [None, 8])
def test_prefill_and_decode_match_reference(window, position):
    """Logits and caches after prefill and after each of 4 decode steps;
    ``window=8`` runs the sliding-window ring cache (8 slots for 16 + 4
    positions).  The position is given as an int or as the 0-d tensor that
    the captured decode step reads at every replay."""
    jcfg, tcfg = _configs(window=window)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, tcfg.vocab_size, (B, S + STEPS))

    jl, jc = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                         capacity=CAP)
    tl, tc = TLM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S])},
                         capacity=CAP)
    assert tl.shape == (B, tcfg.padded_vocab) and tl.dtype == torch.float32
    assert _rel(tl, jl) < TOL_F32
    for n in ("k", "v"):
        want = jc["blocks"]["slot0"][n]
        assert tuple(tc["blocks"]["slot0"][n].shape) == want.shape
        assert _rel(tc["blocks"]["slot0"][n], want) < TOL_F32

    for t in range(STEPS):
        step = toks[:, S + t:S + t + 1]
        jl, jc = JLM.decode_step(jcfg, jp, jnp.asarray(step, jnp.int32), jc,
                                 jnp.int32(S + t))
        pos = S + t if position == "int" else torch.tensor(S + t)
        tl, tc = TLM.decode_step(tcfg, tp, torch.from_numpy(step), tc, pos)
        assert _rel(tl, jl) < TOL_F32, f"step {t}"
        for n in ("k", "v"):
            assert _rel(tc["blocks"]["slot0"][n], jc["blocks"]["slot0"][n]) < TOL_F32


#: the three configs of the dense serving slice, each with a prompt length:
#: h2o-danube's smoke window is 64, and its prompt runs past it (S % 64 == 0,
#: where the reference's ring is right; ``test_ring_*`` below take the rest)
CONFIG_PROMPTS = {"gemma_7b": 16, "h2o_danube_3_4b": 128, "musicgen_large": 16}


def _tokens(cfg, rng, shape):
    """Token ids of ``shape``, with a trailing codebook axis for K > 1."""
    k = cfg.num_codebooks
    return rng.randint(0, cfg.vocab_size, shape + ((k,) if k > 1 else ()))


@pytest.mark.parametrize("arch", sorted(CONFIG_PROMPTS))
def test_config_prefill_and_decode_match_reference(arch):
    """Logits and caches after prefill and after each of 4 decode steps on
    each config's smoke version: gemma (GeGLU, a tied head, the scaled
    embedding), h2o-danube (a sliding window, its ring wrapped by the
    prompt), musicgen (2 codebooks: tokens [B, S, K], logits [B, K, V])."""
    jcfg, tcfg = _configs(arch=arch)
    jp, tp = _params(jcfg, tcfg)
    S = CONFIG_PROMPTS[arch]
    toks = _tokens(tcfg, np.random.RandomState(0), (B, S + STEPS))

    jl, jc = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                         capacity=S + STEPS)
    tl, tc = TLM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S])},
                         capacity=S + STEPS)
    assert tuple(tl.shape) == jl.shape and tl.shape[-1] == tcfg.padded_vocab
    assert _rel(tl, jl) < TOL_F32
    for n in ("k", "v"):
        want = jc["blocks"]["slot0"][n]
        assert tuple(tc["blocks"]["slot0"][n].shape) == want.shape
        assert _rel(tc["blocks"]["slot0"][n], want) < TOL_F32
    for t in range(STEPS):
        step = toks[:, S + t:S + t + 1]
        jl, jc = JLM.decode_step(jcfg, jp, jnp.asarray(step, jnp.int32), jc,
                                 jnp.int32(S + t))
        tl, tc = TLM.decode_step(tcfg, tp, torch.from_numpy(step), tc, S + t)
        assert _rel(tl, jl) < TOL_F32, f"step {t}"
        for n in ("k", "v"):
            assert _rel(tc["blocks"]["slot0"][n], jc["blocks"]["slot0"][n]) < TOL_F32


# The sliding-window ring with a prompt past the window and S % window != 0:
# decode writes position p to slot p % C and reads slot s as the position
# congruent to s, so the filled cache must hold position p in slot p % C.
RING_S, RING_WINDOW = 20, 8


def _ring_setup():
    jcfg, tcfg = _configs(window=RING_WINDOW)
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.RandomState(5).randint(0, tcfg.vocab_size, (B, RING_S + STEPS))
    return jcfg, tcfg, jp, tp, toks


def test_ring_decode_matches_full_forward():
    """The port's decode after a 20-token prompt into an 8-slot ring equals
    its own full forward over the prompt and the decoded tokens, step by
    step, to float32 rounding."""
    _, cfg, _, params, toks = _ring_setup()
    _, cache = TLM.prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :RING_S])},
                           capacity=CAP)
    assert cache["blocks"]["slot0"]["k"].shape[2] == RING_WINDOW
    for t in range(STEPS):
        n = RING_S + t
        lg, cache = TLM.decode_step(cfg, params, torch.from_numpy(toks[:, n:n + 1]), cache, n)
        full, _ = TLM.prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :n + 1])})
        err = (lg - full).abs().max() / full.abs().max()
        assert err < TOL_F32, f"step {t}: {err}"


def test_ring_cache_is_the_reference_cache_rotated():
    """The port's filled ring is the reference's rolled by S % C slots:
    the same keys, each in the slot decode reads it from."""
    jcfg, tcfg, jp, tp, toks = _ring_setup()
    _, jc = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :RING_S], jnp.int32)},
                        capacity=CAP)
    _, tc = TLM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :RING_S])},
                        capacity=CAP)
    for n in ("k", "v"):
        want = np.roll(np.asarray(jc["blocks"]["slot0"][n], np.float32),
                       RING_S % RING_WINDOW, axis=2)  # [periods, B, C, Hkv, hd]
        assert _rel(tc["blocks"]["slot0"][n], want) < TOL_F32


def test_reference_ring_caveat_decode_misses_its_full_forward():
    """Reference caveat (ROADMAP): the reference stores the last C keys of
    a prompt unrotated, so past the window with S % C != 0 its first decode
    step overwrites a key inside the window and keeps one outside it.  Its
    decode then differs from its own full forward far beyond rounding."""
    jcfg, _, jp, _, toks = _ring_setup()
    _, jc = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :RING_S], jnp.int32)},
                        capacity=CAP)
    lg, _ = JLM.decode_step(jcfg, jp, jnp.asarray(toks[:, RING_S:RING_S + 1], jnp.int32),
                            jc, jnp.int32(RING_S))
    full, _ = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :RING_S + 1], jnp.int32)})
    lg, full = np.asarray(lg, np.float32), np.asarray(full, np.float32)
    assert np.abs(lg - full).max() / np.abs(full).max() > 1000 * TOL_F32


def test_bf16_prefill_matches_reference():
    """The served dtype: bf16 rounds at other places in the two frameworks,
    and the error grows through the layers, so 2e-2 of the logits' scale."""
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.RandomState(2).randint(0, tcfg.vocab_size, (B, S))
    jl, _ = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _ = TLM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    assert _rel(tl, jl) < 2e-2


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_F32), ("bfloat16", 0.05)])
def test_decode_matches_full_forward(dtype, tol):
    """The port's own consistency, as the reference's
    ``test_models.py::test_decode_matches_full_forward`` (0.05 for bf16)."""
    _, cfg = _configs(dtype)
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 33)))
    full, _ = TLM.prefill(cfg, params, {"tokens": toks}, capacity=33)
    _, cache = TLM.prefill(cfg, params, {"tokens": toks[:, :32]}, capacity=33)
    lg, _ = TLM.decode_step(cfg, params, toks[:, 32:], cache, 32)
    err = (lg.float() - full.float()).abs().max() / full.float().abs().max()
    assert err < tol


def test_decode_position_outside_a_full_cache_raises():
    """An int position is checked against the cache before it becomes the
    0-d tensor the step reads; a sliding-window ring takes any position."""
    for window in (None, 8):
        _, cfg = _configs(window=window)
        params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
        cache = TLM.init_cache(cfg, B, CAP, device="cpu")
        tok = torch.zeros(B, 1, dtype=torch.int64)
        with pytest.raises(ValueError, match="is negative"):
            TLM.decode_step(cfg, params, tok, cache, -1)
        if window is None:
            with pytest.raises(ValueError, match=f"outside a cache of {CAP}"):
                TLM.decode_step(cfg, params, tok, cache, CAP)
        else:
            TLM.decode_step(cfg, params, tok, cache, CAP)


def test_init_cache_is_bf16_and_stacked():
    _, cfg = _configs("float32")
    cache = TLM.init_cache(cfg, 3, 10, device="cpu")
    k = cache["blocks"]["slot0"]["k"]
    assert k.dtype == torch.bfloat16 and tuple(k.shape) == (3, 3, 10, 2, 16)
    assert not k.any()


def test_convert_refuses_a_mismatched_tree():
    jcfg, tcfg = _configs()
    tree = jax.tree.map(np.asarray, JLM.init_model(jcfg, jax.random.PRNGKey(0)))
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(tcfg, tree, device="cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="tree mismatch"):
        params_from_numpy(tcfg, tree, device="cpu")


def test_bf16_params_carry_across_exactly():
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    want = np.asarray(jp["blocks"]["slot0"]["mixer"]["wq"], np.float32)
    got = tp["blocks"]["slot0"]["mixer"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("arch", ["dbrx_132b", "jamba_1_5_large_398b", "deepseek_v2_236b"])
def test_registry_names_what_is_not_ported(arch):
    """The MoE configs were the last the registry named as not ported: it
    now returns them, and knows no architecture it refuses."""
    from repro_torch import configs
    from repro_torch.configs import get_config

    assert not hasattr(configs, "_NOT_PORTED")
    assert get_config(arch).family in ("moe", "hybrid")
    assert get_config(arch).moe is not None and get_smoke_config(arch).moe is not None
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(arch + "_x")


PORTED = ["yi_6b", "falcon_mamba_7b", "h2o_danube_3_4b", "gemma_7b", "musicgen_large",
          "qwen2_vl_7b", "minicpm3_4b", "dbrx_132b", "deepseek_v2_236b",
          "jamba_1_5_large_398b"]


@pytest.mark.parametrize("arch", PORTED)
def test_registry_loads_the_ported_configs_as_the_reference_has_them(arch):
    """Each ported config, published and smoke, is the reference's field for
    field, and its parameter count is the reference's."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", PORTED)
def test_chip_smoke_float32_reads_give_the_float32_prefill(arch, monkeypatch):
    """``chip_smoke.py``'s float32 reference prefill casts each weight where
    it is read (``float32_reads``, so a full-width MoE model's float32 copy
    fits the card): its logits and caches equal those of the whole tree cast
    at once, bit for bit, for every config, whether it has a tied table, an
    untied one or none (embeds)."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = get_smoke_config(arch)
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    k = cfg.num_codebooks
    batch = ({"tokens": torch.randint(0, cfg.vocab_size, (2, 8, k) if k > 1 else (2, 8),
                                      generator=gen)} if cfg.embed_inputs
             else {"embeds": torch.randn(2, 8, cfg.d_model, generator=gen)})
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    want, want_cache = TLM.prefill(cfg32, map_tree(lambda _, t: t.float(), params), batch)
    got, got_cache = TLM.prefill(cfg32, chip_smoke.float32_reads(params), batch)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    map_tree(lambda path, a, b: None if torch.equal(a, b) else pytest.fail(path),
             got_cache, want_cache)


@pytest.mark.parametrize("arch", PORTED)
def test_chip_smoke_float32_reads_from_the_host_give_the_float32_prefill(arch, monkeypatch):
    """``float32_reads(params, on_host=True)``, for a layer whose float32
    copy does not fit the card beside the bf16 model: the stacked leaves
    move to the host in ``params`` itself, and each read copies its period
    back to the device of the rest of the model before the cast.  The same
    logits and caches as the whole tree cast at once, bit for bit."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = get_smoke_config(arch)
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    k = cfg.num_codebooks
    batch = ({"tokens": torch.randint(0, cfg.vocab_size, (2, 8, k) if k > 1 else (2, 8),
                                      generator=gen)} if cfg.embed_inputs
             else {"embeds": torch.randn(2, 8, cfg.d_model, generator=gen)})
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    want, want_cache = TLM.prefill(cfg32, map_tree(lambda _, t: t.float(), params), batch)
    reads = chip_smoke.float32_reads(params, on_host=True)
    map_tree(lambda path, t: None if t.device.type == "cpu" else pytest.fail(path),
             params["blocks"])
    got, got_cache = TLM.prefill(cfg32, reads, batch)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    map_tree(lambda path, a, b: None if torch.equal(a, b) else pytest.fail(path),
             got_cache, want_cache)
