"""Cutting a config to its first layers (``repro_torch.configs.first_layers``,
the CLIs' ``--layers``) and Jamba-1.5-Large, the hybrid, cut below its
pattern's period of 8, against the JAX package's configs and model.

The cut keeps whole periods where ``n`` is a multiple of the period, and
below one period the pattern's first ``n`` slots: Jamba's first 4 layers
hold each kind it has (attention + MoE, Mamba + dense, Mamba + MoE, Mamba +
dense), which is how it is served on one card.  The reference's
``ModelConfig`` takes the same cut, so the parity below builds it on both
sides; float32 smoke configs, 1e-5 of the logits' scale.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as JLM
from repro_torch.configs import first_layers, get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm as TLM

TOL = 1e-5
JAMBA = "jamba_1_5_large_398b"
#: the parameters of Jamba's first 4 layers at their published widths
#: (``ModelConfig.param_count`` of either package)
JAMBA_4_LAYERS = 22_996_213_760


def _pattern(cfg) -> tuple:
    return tuple((s.mixer, s.ffn) for s in cfg.layer_pattern)


def _widths(cfg) -> dict:
    """Every field but the depth and the pattern."""
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("num_layers", "layer_pattern")}


def test_jambas_first_four_layers_keep_its_published_widths():
    full, ref = get_config(JAMBA), jax_config(JAMBA)
    cut, ref_cut = first_layers(full, 4), first_layers(ref, 4)
    assert type(ref_cut) is type(ref)  # the reference's own ModelConfig
    assert cut.num_layers == ref_cut.num_layers == 4 and cut.num_periods == 1
    assert _widths(cut) == _widths(full) == _widths(ref_cut)
    assert _pattern(cut) == _pattern(ref_cut) == _pattern(ref)[:4] == (
        ("attn", "moe"), ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"))
    assert cut.param_count() == ref_cut.param_count() == JAMBA_4_LAYERS
    assert cut.param_count() == sum(t.numel() for t in _leaves(TLM.abstract_model(cut)))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("arch,n", [("dbrx_132b", 8), ("deepseek_v2_236b", 8),
                                    (JAMBA, 8), (JAMBA, 16), ("yi_6b", 16)])
def test_a_cut_of_whole_periods_only_sets_the_depth(arch, n):
    """As ``dataclasses.replace(cfg, num_layers=n)`` did before the cut had
    a helper (DBRX-132B and DeepSeek-V2-236B are served at 8 layers), on
    both packages' configs."""
    for cfg in (get_config(arch), jax_config(arch)):
        assert first_layers(cfg, n) == dataclasses.replace(cfg, num_layers=n)
    assert first_layers(get_config(arch), n).param_count() == \
        first_layers(jax_config(arch), n).param_count()


@pytest.mark.parametrize("n", [9, 12, 0, 73])
def test_a_cut_that_is_neither_raises(n):
    """Over the period and not a multiple of it, or outside 1 to 72 layers
    (below the period, 5 would keep the pattern's first 5 slots)."""
    match = "period 8" if 0 < n <= 72 else "cannot keep"
    for cfg in (get_config(JAMBA), jax_config(JAMBA)):
        with pytest.raises(ValueError, match=match):
            first_layers(cfg, n)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_jamba_smoke_cut_below_its_period_matches_reference(n):
    """Prefill and two decode steps of the first ``n`` layers of Jamba's
    smoke config (period 4), the cut built on both sides: logits at 1e-5
    of their scale, and every cache leaf (KV, conv window, state)."""
    jcfg = first_layers(dataclasses.replace(jax_smoke_config(JAMBA), dtype="float32"), n)
    tcfg = first_layers(dataclasses.replace(get_smoke_config(JAMBA), dtype="float32"), n)
    jp = JLM.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(0).randint(0, tcfg.vocab_size, (2, 12))

    def rel(got, want):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        return float(np.abs(got.float().numpy() - want).max() / max(np.abs(want).max(), 1e-6))

    def caches_agree(tc, jc):
        for slot, leaves in jc["blocks"].items():
            for name, want in leaves.items():
                got = tc["blocks"][slot][name]
                assert tuple(got.shape) == want.shape, (slot, name)
                assert rel(got, want) < TOL, (slot, name)

    jl, jc = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :10], jnp.int32)},
                         capacity=12)
    tl, tc = TLM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :10])}, capacity=12)
    assert sorted(tc["blocks"]) == [f"slot{i}" for i in range(n)]
    assert rel(tl, jl) < TOL
    caches_agree(tc, jc)
    for t in (10, 11):
        step = toks[:, t:t + 1]
        jl, jc = JLM.decode_step(jcfg, jp, jnp.asarray(step, jnp.int32), jc, jnp.int32(t))
        tl, tc = TLM.decode_step(tcfg, tp, torch.from_numpy(step), tc, t)
        assert rel(tl, jl) < TOL, t
        caches_agree(tc, jc)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_holds_every_served_config_to_its_published_widths(chip_smoke):
    """``SERVED``'s widths are each config's; a hybrid's hold its Mamba,
    attention and MoE widths and its pattern, so that a change to any of
    them fails the card's run before it serves."""
    for arch, want in chip_smoke.SERVED.items():
        assert chip_smoke._widths(get_config(arch)) == want["widths"], arch
    jamba = get_config(JAMBA)
    for changed in (dataclasses.replace(jamba, attn=dataclasses.replace(jamba.attn,
                                                                        num_kv_heads=16)),
                    dataclasses.replace(jamba, moe=dataclasses.replace(jamba.moe, top_k=4)),
                    dataclasses.replace(jamba, mamba=dataclasses.replace(jamba.mamba,
                                                                         d_state=8)),
                    dataclasses.replace(jamba, d_ff=14336),
                    dataclasses.replace(jamba, layer_pattern=jamba.layer_pattern[::-1])):
        assert chip_smoke._widths(changed) != chip_smoke.SERVED[JAMBA]["widths"]


def test_chip_smoke_serves_jamba_at_its_first_four_layers(chip_smoke):
    """The served cut: 4 layers, 22,996,213,760 parameters, and the
    launches a prefill must make (one attention layer, three Mamba layers;
    two norms a layer and the final one)."""
    want = chip_smoke.SERVED[JAMBA]
    cut = first_layers(get_config(JAMBA), want["depth"])
    assert want["params"] == cut.param_count() == JAMBA_4_LAYERS
    kinds = [s.mixer for s in cut.layer_pattern] * cut.num_periods
    assert want["prefill"] == {"flash_attention": kinds.count("attn"),
                               "mamba_scan_fused": kinds.count("mamba")}
    assert want["norms_per_layer"] * cut.num_layers + 1 == 9
