"""Qwen2-VL in the port: a model that takes embeddings (no embedding
table, an untied head) and M-RoPE positions [B, S, 3] (t, h, w), against
the JAX package's, with the reference's own parameters carried across by
``convert.params_from_numpy``.

Inputs are seeded numpy embeddings and positions whose t component is
``arange(S)`` and whose h and w components walk a 2-D grid over an image
span, so every rotary section sees positions of its own.  The flash kernel
masks by index, and the reference masks by t: the two agree only where t is
``arange(S)``, and ``test_reference_masks_by_t`` names that caveat.

Float32 copies of the smoke config at 1e-5 of the output's scale; bf16 at
0.05, the served dtype's tolerance of ``tests/test_torch_lm.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

TOL_F32 = 1e-5
TOL_BF16 = 0.05
ARCH = "qwen2_vl_7b"
B, S, STEPS = 2, 24, 4


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


def grid_positions(n: int, start: int = 4, side: int = 4) -> np.ndarray:
    """[n, 3] positions: t = arange(n); text before and after an image span
    of side x side patches from ``start``, over which h and w walk the grid
    (offset by the span's start), while a text token's h and w equal its t."""
    pos = np.repeat(np.arange(n)[:, None], 3, axis=1)
    span = np.arange(side * side)
    end = min(start + side * side, n)
    pos[start:end, 1] = start + span[:end - start] // side
    pos[start:end, 2] = start + span[:end - start] % side
    return pos


def _inputs(tcfg, n, seed=0):
    rng = np.random.RandomState(seed)
    emb = rng.randn(B, n, tcfg.d_model).astype(np.float32)
    return emb, np.broadcast_to(grid_positions(n), (B, n, 3)).copy()


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
@pytest.mark.parametrize("dt,tol", [("float32", TOL_F32), ("bfloat16", 2e-2)])
def test_rope_with_sections_matches_reference(sections, hd, dt, tol):
    """M-RoPE on random positions (each component its own), in both dtypes:
    cos and sin are cast to the input's dtype before the multiply, as in the
    reference (bf16 at 2e-2 of the output's scale)."""
    rng = np.random.RandomState(hd)
    x = rng.randn(2, 7, 3, hd).astype(np.float32)
    pos = rng.randint(0, 5000, (2, 7, 3))
    want = JL.rope(jnp.asarray(x, getattr(jnp, dt)), jnp.asarray(pos, jnp.int32), 1e6,
                   sections=sections)
    got = TL.rope(torch.from_numpy(x).to(getattr(torch, dt)), torch.from_numpy(pos), 1e6,
                  sections=sections)
    assert got.dtype == getattr(torch, dt)
    assert _rel(got, want) < tol


def test_mrope_positions_match_reference():
    pos = np.random.RandomState(0).randint(0, 100, (2, 5, 3))
    want = JL.mrope_positions(jnp.asarray(pos), (2, 3, 3))
    got = TL.mrope_positions(torch.from_numpy(pos), (2, 3, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("position", ["int", "tensor"])
def test_qwen2_vl_prefill_and_decode_match_reference(position):
    """Logits and caches after a prefill over embeddings with grid positions,
    then after each of 4 decode steps on new embeddings (t, h and w all the
    cache position, as in the reference), the position given as an int or
    as the 0-d tensor the captured step reads."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    emb, pos = _inputs(tcfg, S + STEPS)
    jl, jc = JLM.prefill(jcfg, jp, {"embeds": jnp.asarray(emb[:, :S]),
                                    "positions": jnp.asarray(pos[:, :S], jnp.int32)},
                         capacity=S + STEPS)
    tl, tc = TLM.prefill(tcfg, tp, {"embeds": torch.from_numpy(emb[:, :S]),
                                    "positions": torch.from_numpy(pos[:, :S])},
                         capacity=S + STEPS)
    assert tl.shape == (B, tcfg.padded_vocab)
    assert _rel(tl, jl) < TOL_F32
    for n in ("k", "v"):
        assert _rel(tc["blocks"]["slot0"][n], jc["blocks"]["slot0"][n]) < TOL_F32
    for t in range(STEPS):
        step = emb[:, S + t:S + t + 1]
        jl, jc = JLM.decode_step(jcfg, jp, jnp.asarray(step), jc, jnp.int32(S + t))
        p = S + t if position == "int" else torch.tensor(S + t)
        tl, tc = TLM.decode_step(tcfg, tp, torch.from_numpy(step), tc, p)
        assert _rel(tl, jl) < TOL_F32, f"step {t}"
        for n in ("k", "v"):
            assert _rel(tc["blocks"]["slot0"][n], jc["blocks"]["slot0"][n]) < TOL_F32


def test_qwen2_vl_default_positions_match_reference():
    """Without ``positions``, t, h and w all equal the index (text)."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    emb, _ = _inputs(tcfg, S)
    jl, _ = JLM.prefill(jcfg, jp, {"embeds": jnp.asarray(emb)})
    tl, _ = TLM.prefill(tcfg, tp, {"embeds": torch.from_numpy(emb)})
    assert _rel(tl, jl) < TOL_F32


def test_qwen2_vl_bf16_prefill_matches_reference():
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    emb, pos = _inputs(tcfg, S, seed=2)
    jl, _ = JLM.prefill(jcfg, jp, {"embeds": jnp.asarray(emb),
                                   "positions": jnp.asarray(pos, jnp.int32)})
    tl, _ = TLM.prefill(tcfg, tp, {"embeds": torch.from_numpy(emb),
                                   "positions": torch.from_numpy(pos)})
    assert tl.dtype == torch.bfloat16
    assert _rel(tl, jl) < TOL_BF16


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_F32), ("bfloat16", TOL_BF16)])
def test_qwen2_vl_decode_matches_full_forward(dtype, tol):
    """The port's decode after a grid-position prompt equals its own prefill
    over the prompt and the decoded embeddings, with the decoded positions
    t = h = w = the index."""
    _, cfg = _configs(dtype)
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    emb, pos = _inputs(cfg, S + STEPS, seed=1)
    pos[:, S:] = np.arange(S, S + STEPS)[None, :, None]
    emb, pos = torch.from_numpy(emb), torch.from_numpy(pos)
    _, cache = TLM.prefill(cfg, params, {"embeds": emb[:, :S], "positions": pos[:, :S]},
                           capacity=S + STEPS)
    for n in range(S, S + STEPS):
        lg, cache = TLM.decode_step(cfg, params, emb[:, n:n + 1], cache, n)
        full, _ = TLM.prefill(cfg, params, {"embeds": emb[:, :n + 1],
                                            "positions": pos[:, :n + 1]})
        err = (lg.float() - full.float()).abs().max() / full.float().abs().max()
        assert err < tol, f"position {n}: {err}"


def test_mrope_positions_affect_output():
    """The port's counterpart of the reference's test: other spatial
    coordinates give other logits."""
    _, cfg = _configs()
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    emb = torch.from_numpy(np.random.RandomState(0).randn(1, 32, cfg.d_model).astype(np.float32))
    p1 = torch.arange(32)[None, :, None].expand(1, 32, 3)
    p2 = p1.clone()
    p2[..., 1] *= 2
    lg1, _ = TLM.prefill(cfg, params, {"embeds": emb, "positions": p1}, capacity=32)
    lg2, _ = TLM.prefill(cfg, params, {"embeds": emb, "positions": p2}, capacity=32)
    assert (lg1 - lg2).abs().max() > 1e-4


def test_reference_masks_by_t(monkeypatch):
    """Reference caveat (ROADMAP): the reference's prefill masks attention by
    the positions' t component (``_pos1d``), the port's flash kernel by
    index.  Where t != arange(S), as for an image span sharing one t, the
    reference hides keys that a causal model sees: its logits then differ
    from its own prefill masked by index, which the port matches."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    emb, pos = _inputs(tcfg, S)
    pos[:, 4:20, 0] = 4  # a 4 x 4 image span at one t, then text from t = 5
    pos[:, 20:, 0] = 5 + np.arange(S - 20)
    batch = {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos, jnp.int32)}
    by_t, _ = JLM.prefill(jcfg, jp, batch)
    monkeypatch.setattr(JA, "_pos1d", lambda a, positions: jnp.arange(positions.shape[1]))
    by_index, _ = JLM.prefill(jcfg, jp, batch)
    port, _ = TLM.prefill(tcfg, tp, {"embeds": torch.from_numpy(emb),
                                     "positions": torch.from_numpy(pos)})
    assert _rel(port, by_index) < TOL_F32
    assert _rel(torch.from_numpy(np.array(by_t)), by_index) > 1000 * TOL_F32


@pytest.mark.parametrize("arch,batch,err", [
    ("qwen2_vl_7b", lambda c: {"tokens": torch.zeros(1, 4, dtype=torch.int64)}, "'embeds'"),
    ("yi_6b", lambda c: {"embeds": torch.zeros(1, 4, c.d_model)}, "'tokens'"),
    ("qwen2_vl_7b", lambda c: {"embeds": torch.zeros(1, 4, c.d_model),
                               "positions": torch.zeros(1, 4, dtype=torch.int64)},
     r"want \[1, 4, 3\]"),
    ("yi_6b", lambda c: {"tokens": torch.zeros(1, 4, dtype=torch.int64),
                         "positions": torch.zeros(1, 4, 3, dtype=torch.int64)}, r"want \[1, 4\]"),
])
def test_prefill_refuses_a_batch_of_the_wrong_kind(arch, batch, err):
    cfg = get_smoke_config(arch)
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match=err):
        TLM.prefill(cfg, params, batch(cfg))


def test_qwen2_vl_has_no_embedding_table_and_an_untied_head():
    cfg = get_smoke_config(ARCH)
    meta = TLM.model_meta(cfg)
    assert meta["embed"] == {}
    assert meta["head"]["lm_head"].shape == (cfg.d_model, cfg.padded_vocab)
