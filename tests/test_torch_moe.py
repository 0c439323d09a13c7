"""The port's MoE FFN (``repro_torch.models.moe``) and the LMs that use it
against the JAX package's (``repro.models.moe``, ``repro.models.lm``), with
the reference's own parameters (``lm.init_model``) carried across by
``convert.params_from_numpy`` and numpy inputs from a seed.

* The layer on the dbrx, deepseek-v2 (shared experts) and jamba smoke
  configs: the output, the aux loss and the routing, at the configs'
  capacity factor (with drops), at a factor that drops most assignments,
  dropless (factor = number of experts) and in two dispatch groups.
  Float32 at 1e-5 of the output's scale, the expert indices equal.  bf16
  at 2e-2 in ``ref.scaled_err``: the router's logits round to bf16 in
  both frameworks, so where a token's k-th and (k+1)-th logits lie within
  bf16 rounding its choice may flip, and a flip moves the slots (and the
  drops) of later tokens; those rows are left out and counted.
* The LM: prefill logits and every leaf of the filled cache (DeepSeek's
  unstacked ``prelude0`` included), then one decode step, float32; the
  port's decode against its own full forward, dropless; the periods
  stacked under ``blocks``; DBRX's and DeepSeek-V2's loss, nll, aux and
  every gradient against ``jax.value_and_grad`` of the reference's
  ``loss_fn``; Jamba's training refused (its Mamba layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as JLM
from repro.models import moe as JM
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ref import scaled_err
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TM
from repro_torch.models.params import map_tree

TOL_F32 = 1e-5
TOL_BF16 = 2e-2
ARCHS = ["dbrx_132b", "deepseek_v2_236b", "jamba_1_5_large_398b"]
B, S = 2, 16
#: capacity cases: the config's factor (1.25: some drops), a factor that
#: drops most assignments, dropless, and the config's factor in 2 groups
CASES = {"default": {}, "overflow": {"capacity_factor": 0.5},
         "dropless": {"capacity_factor": None}, "two_groups": {"moe_groups": 2}}


def _configs(arch, dtype="float32", capacity_factor=0.0, moe_groups=1):
    """(reference, port) smoke configs in ``dtype``; ``capacity_factor``
    None is dropless (the number of experts), 0.0 the config's own."""
    out = []
    for cfg in (jax_smoke_config(arch), get_smoke_config(arch)):
        e = cfg.moe
        cf = (float(e.num_experts) if capacity_factor is None
              else capacity_factor or e.capacity_factor)
        out.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(e, capacity_factor=cf),
            parallel=dataclasses.replace(cfg.parallel, moe_groups=moe_groups)))
    return out


def _params(jcfg, tcfg, seed=0):
    jp = JLM.init_model(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.float().numpy() - want).max() / max(np.abs(want).max(), 1e-6))


def _moe_layer(arch, dtype, case, seed=0):
    """The first MoE slot's period-0 parameters of each side, and x [B, S, D]."""
    jcfg, tcfg = _configs(arch, dtype, **CASES[case])
    jp, tp = _params(jcfg, tcfg, seed)
    slot = next(f"slot{i}" for i, s in enumerate(tcfg.layer_pattern) if s.ffn == "moe")
    jl = jax.tree.map(lambda a: a[0], jp["blocks"][slot]["ffn"])
    tl = {n: t[0] for n, t in tp["blocks"][slot]["ffn"].items()}
    x = np.random.RandomState(seed + 1).randn(B, S, tcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jl, tl, x


def _ref_routing(jcfg, jl, xt):
    """The reference's logits [G, Tg, E] and top-k indices, as ``moe`` makes them."""
    logits = (xt @ jl["router"]).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.moe.top_k)
    return np.array(logits), np.array(idx)


def _groups(cfg) -> int:
    G = max(1, cfg.parallel.moe_groups)
    return 1 if (B * S) % G else G


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(arch, case):
    jcfg, tcfg, jl, tl, x = _moe_layer(arch, "float32", case)
    jout, jaux = JM.moe(jcfg, jl, jnp.asarray(x))
    tout, taux = TM.moe(tcfg, tl, torch.from_numpy(x))
    assert tout.dtype == torch.float32 and taux.dtype == torch.float32
    assert _rel(tout, jout) < TOL_F32
    assert abs(float(taux) - float(jaux)) <= TOL_F32 * abs(float(jaux))

    G = _groups(tcfg)
    xt = x.reshape(G, -1, tcfg.d_model)
    _, want_idx = _ref_routing(jcfg, jl, jnp.asarray(xt))
    _, _, got_idx = TM.route(tcfg, tl, torch.from_numpy(xt))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    # the case does what it is named for
    C = TM._capacity(xt.shape[1], tcfg.moe)
    _, keep = TM.slots(got_idx, tcfg.moe.num_experts, C)
    drops = int((~keep).sum())
    if case == "dropless":
        assert drops == 0
    if case == "overflow":
        assert drops >= keep.numel() // 4, drops
    if case == "two_groups":
        assert G == 2


@pytest.mark.parametrize("case", ["default", "overflow", "dropless"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_bf16_matches_reference(arch, case):
    """bf16 at 2e-2 in ``ref.scaled_err`` on every row but those whose
    routing is inside bf16 rounding: a token whose k-th and (k+1)-th
    logits lie within 4 bf16 ulps of the row's largest logit, and each
    token whose kept/dropped status then differs between the two routings.
    Every other token must have the reference's expert indices."""
    jcfg, tcfg, jl, tl, x = _moe_layer(arch, "bfloat16", case, seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    jout, jaux = JM.moe(jcfg, jl, xb)
    xt_t = torch.from_numpy(x).to(torch.bfloat16)
    tout, taux = TM.moe(tcfg, tl, xt_t)
    assert tout.dtype == torch.bfloat16

    K, E = tcfg.moe.top_k, tcfg.moe.num_experts
    logits, want_idx = _ref_routing(jcfg, jl, xb.reshape(1, B * S, -1))
    _, _, got_idx = TM.route(tcfg, tl, xt_t.reshape(1, B * S, -1))
    top = -np.sort(-logits[0], axis=-1)
    near = (top[:, K - 1] - top[:, K]) <= 4 * 2.0**-8 * np.abs(top).max(-1)
    flipped = (got_idx[0].numpy() != want_idx[0]).any(-1)
    assert not (flipped & ~near).any(), np.nonzero(flipped & ~near)
    C = TM._capacity(B * S, tcfg.moe)
    keep_got = TM.slots(got_idx, E, C)[1].reshape(B * S, K)
    keep_want = TM.slots(torch.from_numpy(want_idx).long(), E, C)[1].reshape(B * S, K)
    moved = (keep_got != keep_want).any(-1).numpy()
    excluded = near | moved
    print(f"{arch} {case}: {int(excluded.sum())} of {B * S} rows left out "
          f"({int(near.sum())} near a tie, {int(flipped.sum())} flipped, "
          f"{int(moved.sum())} kept/dropped otherwise)")
    assert excluded.sum() <= B * S // 4
    rows = ~excluded
    got = tout.reshape(B * S, -1)[torch.from_numpy(rows)]
    want = torch.from_numpy(np.asarray(jout, np.float32).reshape(B * S, -1)[rows])
    assert scaled_err(got, want) < TOL_BF16
    assert abs(float(taux) - float(jaux)) <= TOL_BF16 * abs(float(jaux))


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _leaves(v, f"{prefix}/{k}") if isinstance(v, dict) else [(f"{prefix}/{k}", v)]
    return out


def _assert_caches_match(tc, jc):
    got, want = _leaves(tc), _leaves(jax.tree.map(np.asarray, jc))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert _rel(g, w) < TOL_F32, path


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_reference(arch):
    """Logits and every cache leaf after prefill (the config's capacity
    factor: prefill and decode each have their own capacity) and after one
    decode step."""
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.RandomState(0).randint(0, tcfg.vocab_size, (B, S + 1))
    jl, jc = JLM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                         capacity=S + 4)
    tl, tc = TLM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S])}, capacity=S + 4)
    assert _rel(tl, jl) < TOL_F32
    assert ("prelude0" in tc) == bool(tcfg.first_k_dense)
    _assert_caches_match(tc, jc)
    step = toks[:, S:]
    jl, jc = JLM.decode_step(jcfg, jp, jnp.asarray(step, jnp.int32), jc, jnp.int32(S))
    tl, tc = TLM.decode_step(tcfg, tp, torch.from_numpy(step), tc, S)
    assert _rel(tl, jl) < TOL_F32
    _assert_caches_match(tc, jc)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_F32), ("bfloat16", 0.05)])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_matches_full_forward(arch, dtype, tol):
    """The port's own consistency, dropless, as the reference's
    ``test_models.py::test_decode_matches_full_forward`` (0.05 for bf16)."""
    _, cfg = _configs(arch, dtype, capacity_factor=None)
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 33)))
    full, _ = TLM.prefill(cfg, params, {"tokens": toks}, capacity=33)
    _, cache = TLM.prefill(cfg, params, {"tokens": toks[:, :32]}, capacity=33)
    lg, _ = TLM.decode_step(cfg, params, toks[:, 32:], cache, 32)
    err = (lg.float() - full.float()).abs().max() / full.float().abs().max()
    assert err < tol


def test_deepseek_stacks_the_periods_after_its_prelude():
    """DeepSeek-V2 smoke: 3 layers, the first dense and unrolled, so
    ``blocks`` holds 2 periods, as the reference's tree and cache do."""
    jcfg, tcfg = _configs("deepseek_v2_236b")
    P = tcfg.num_layers - tcfg.first_k_dense
    assert TLM.scanned_periods(tcfg) == P == 2
    meta = TLM.model_meta(tcfg)
    assert meta["blocks"]["slot0"]["norm1"].shape == (P, tcfg.d_model)
    assert "w_gate" in meta["prelude0"]["ffn"] and "router" not in meta["prelude0"]["ffn"]
    assert meta["prelude0"]["ffn"]["w_gate"].shape == (tcfg.d_model, tcfg.d_ff)
    cache = TLM.init_cache(tcfg, 3, 10, device="cpu")
    assert cache["blocks"]["slot0"]["ckv"].shape[0] == P
    assert tuple(cache["prelude0"]["ckv"].shape) == (3, 10, tcfg.attn.kv_lora_rank)
    want = jax.tree.map(lambda a: a.shape, JLM.abstract_cache(jcfg, 3, 10))
    got = map_tree(lambda _, t: tuple(t.shape), cache)
    assert got == want


def _loss_and_gradients(arch, remat):
    """Loss, nll, aux and the gradient of every parameter of ``arch``'s
    float32 smoke config, the port's against ``jax.value_and_grad`` of the
    reference's ``loss_fn``, each gradient at 1e-5 of its largest value
    (1e-4 with remat, whose backward recomputes each period's forward)."""
    jcfg, tcfg = _configs(arch)
    jcfg, tcfg = (dataclasses.replace(c, parallel=dataclasses.replace(c.parallel, remat=remat))
                  for c in (jcfg, tcfg))
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, tcfg.vocab_size, (B, S))
    labels = rng.randint(0, tcfg.vocab_size, (B, S))
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JLM.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks, jnp.int32),
                                        "labels": jnp.asarray(labels, jnp.int32)}),
        has_aux=True)(jp)
    tp = map_tree(lambda _, t: t.requires_grad_(), tp)
    tloss, tm = TLM.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                       "labels": torch.from_numpy(labels)})
    tloss.backward()
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=TOL_F32)
    assert float(tm["aux"].detach()) > 0
    tol = 1e-4 if remat else TOL_F32
    got = _leaves(map_tree(lambda _, t: t.grad, tp))
    want = _leaves(jax.tree.map(np.asarray, jg))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert _rel(g, w) < tol, path


@pytest.mark.parametrize("remat", [False, True])
def test_dbrx_loss_and_gradients_match_reference(remat):
    _loss_and_gradients("dbrx_132b", remat)


def test_deepseek_loss_and_gradients_match_reference():
    """DeepSeek-V2 trains through MLA (the expanded keys through the
    training flash attention at q/k 24 and v 16), its dense prelude and the
    MoE FFN with shared experts."""
    _loss_and_gradients("deepseek_v2_236b", False)


def test_moe_training_of_a_mamba_config_raises():
    """Jamba trains through Mamba, whose selective scan has no backward
    kernel: its ``loss_fn`` raises naming its ROADMAP item."""
    _, cfg = _configs("jamba_1_5_large_398b")
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        TLM.loss_fn(cfg, params, {"tokens": toks, "labels": toks})


def test_moe_dispatch_keeps_slot_zero_from_dropped_tokens():
    """Every assignment past the capacity is dropped: its weight is zero and
    its token lands in no slot, so slot 0 of each expert holds the first
    token routed there, alone."""
    _, tcfg, _, tl, x = _moe_layer("dbrx_132b", "float32", "overflow")
    xt = torch.from_numpy(x).reshape(1, B * S, -1)
    _, gate_w, gate_i = TM.route(tcfg, tl, xt)
    C = TM._capacity(B * S, tcfg.moe)
    slot, keep = TM.slots(gate_i, tcfg.moe.num_experts, C)
    flat = gate_i.reshape(-1)
    for e in range(tcfg.moe.num_experts):
        mine = (flat == e).nonzero()[:, 0]
        assert keep[0, mine].sum() == min(len(mine), C)
        assert (slot[0, mine[:C]] == torch.arange(min(len(mine), C))).all()
        assert not keep[0, mine[C:]].any() and (slot[0, mine[C:]] == 0).all()
