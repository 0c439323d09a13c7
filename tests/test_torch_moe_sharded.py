"""The expert-parallel MoE layer (``models/moe.moe`` on DTensors) on a
(pod 2, data 2, model 2) ``DeviceMesh`` of 8 gloo ranks on the CPU, against
the one-rank layer on the same inputs, and the one-rank layer against the
reference's ``moe()`` as GSPMD partitions it on the same mesh of this
process's 8 virtual CPU devices (``tests/conftest.py``), its parameters
placed by the reference's FSDP rules.

One 8-rank job, ``torch_rank_jobs.moe_ranks``, runs every case
(``MOE_CASES``: DBRX's and DeepSeek-V2's float32 smoke layers, DeepSeek's
shared experts among them, at ``moe_groups`` 1, 2 and 4; 4 is the
data-parallel world, where each rank routes its own group; DBRX with 3
experts, which do not split over ``model``, so that the rules give it
``ff``) and the planted faults; the tests read its result.  The loss is
``sum(c * out) + aux`` for a seeded cotangent ``c``.  Tolerance: 1e-5 of
each tensor's largest value (float32; a gradient summed over ranks takes
another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P

import torch_rank_jobs as J
from repro.configs import get_smoke_config as jsmoke
from repro.models import moe as JM
from repro.models.params import partition_specs as jspecs
from repro_torch.launch import ranks
from repro_torch.models import moe as TM

TOL = 1e-5
MESH = {"pod": 2, "data": 2, "model": 2}
NDP = MESH["pod"] * MESH["data"]


@pytest.fixture(scope="module")
def run():
    return ranks.run("torch_rank_jobs:moe_ranks", 8, timeout_s=600)


def _one_rank(name: str) -> dict:
    """The one-rank layer on the case's inputs: output, aux loss and the
    gradients of ``sum(c * out) + aux``, by name."""
    cfg = J.moe_config(*J.MOE_CASES[name])
    inputs = J.moe_inputs(cfg)
    keys = [k for k in inputs if k not in ("x", "c")]
    p = {k: torch.from_numpy(inputs[k]).requires_grad_() for k in keys}
    x = torch.from_numpy(inputs["x"]).requires_grad_()
    out, aux = TM.moe(cfg, p, x)
    grads = torch.autograd.grad((out * torch.from_numpy(inputs["c"])).sum() + aux, [x, *p.values()])
    return {"out": out.detach(), "aux": aux.detach(), **dict(zip(["x", *keys], grads))}


def _errs(got: dict, want: dict) -> dict:
    """Each tensor's largest difference over its largest value."""
    mine = {"out": got["out"], "aux": got["aux"], **got["grads"]}
    assert set(mine) == set(want)
    return {k: float((mine[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30))
            for k in want}


@pytest.mark.parametrize("name", list(J.MOE_CASES))
def test_layer_matches_the_one_rank_layer(run, name):
    errs = _errs(run[0]["cases"][name], _one_rank(name))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("name", list(J.MOE_CASES))
def test_one_rank_layer_matches_the_reference_partitioned_by_gspmd(name):
    """The reference's ``moe()`` jitted on the (2, 2, 2) mesh, its weights
    placed by ``partition_specs`` (FSDP) and ``x`` over the data-parallel
    axes: the one-rank port's output, aux loss and gradients."""
    arch, groups, experts = J.MOE_CASES[name]
    cfg = jsmoke(arch)
    e = cfg.moe if experts is None else dataclasses.replace(cfg.moe, num_experts=experts)
    jcfg = dataclasses.replace(cfg, dtype="float32", moe=e, parallel=dataclasses.replace(
        cfg.parallel, moe_groups=groups))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), tuple(MESH),
                axis_types=(AxisType.Auto,) * 3)
    inputs = J.moe_inputs(J.moe_config(*J.MOE_CASES[name]))
    keys = [k for k in inputs if k not in ("x", "c")]
    specs = jspecs(JM.moe_meta(jcfg), MESH, fsdp=True)
    dp = NamedSharding(mesh, P(("pod", "data")))

    def loss(p, x, c):
        out, aux = JM.moe(jcfg, p, x)
        return jnp.sum(out * c) + aux, (out, aux)

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True), in_shardings=(
        {k: NamedSharding(mesh, specs[k]) for k in keys}, dp, dp))
    (_, (out, aux)), (gp, gx) = fn({k: jnp.asarray(inputs[k]) for k in keys},
                                   jnp.asarray(inputs["x"]), jnp.asarray(inputs["c"]))
    want = {"out": out, "aux": aux, "x": gx, **gp}
    got = _one_rank(name)
    for k, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[k].numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= TOL, (k, err)


@pytest.mark.parametrize("name", list(J.MOE_CASES))
def test_each_rank_runs_its_model_share_of_the_experts(run, name):
    """Every ``expert_ffn`` call on every rank saw ``[E/M, D, F]`` weights,
    or ``[E, D, F/M]`` where the experts do not split over ``model``."""
    cfg = J.moe_config(*J.MOE_CASES[name])
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    M = MESH["model"]
    want = ([[E // M, D, F], [E // M, D, F], [E // M, F, D]] if E % M == 0 else
            [[E, D, F // M], [E, D, F // M], [E, F // M, D]])
    for r in run:
        assert r["cases"][name]["expert_ffn"] == [want], r["cases"][name]["expert_ffn"]


@pytest.mark.parametrize("name", list(J.MOE_CASES))
def test_no_expert_weight_is_gathered_over_model(run, name):
    """Over ``model``, the forward gathers the router alone (2-D) and sums
    the output once; the backward gathers nothing over ``model``.  The
    experts' and shared experts' weights are gathered over ``data`` alone
    (FSDP)."""
    cfg = J.moe_config(*J.MOE_CASES[name])
    for r in run:
        case = r["cases"][name]
        fwd = [(op, shape) for op, dim, shape in case["fwd"] if dim == "model"]
        assert [op for op, _ in fwd].count("all_reduce") == 1, case["fwd"]
        assert ("all_reduce", [J.MOE_B // NDP, J.MOE_S, cfg.d_model]) in fwd
        gathered = [shape for op, shape in fwd if op == "all_gather_into_tensor"]
        assert all(len(s) == 2 and s[-1] == cfg.moe.num_experts // MESH["model"]
                   for s in gathered), case["fwd"]
        assert not [c for c in case["bwd"] if c[1] == "model" and c[0].startswith("all_gather")]


@pytest.mark.parametrize("name", list(J.MOE_CASES))
def test_expert_flops_are_the_ranks_share(run, name):
    """Each rank's forward bmm FLOPs (``FlopCounterMode``): 1/(ndp M) of the
    one-rank layer's where the groups are local to the data-parallel ranks
    (``moe_groups`` a multiple of ndp), 1/M where the tokens are gathered."""
    groups = J.MOE_CASES[name][1]
    share = NDP * MESH["model"] if groups % NDP == 0 else MESH["model"]
    for r in run:
        case = r["cases"][name]
        assert case["flops"] * share == case["one_rank_flops"] > 0, (case["flops"], share)


@pytest.mark.parametrize("name", list(J.MOE_CASES))
def test_aux_loss_and_router_gradient_are_the_one_rank_values(run, name):
    errs = _errs(run[0]["cases"][name], _one_rank(name))
    assert errs["aux"] <= TOL and errs["router"] <= TOL, errs


@pytest.mark.parametrize("name", list(J.MOE_CASES))
def test_gradients_come_back_placed_like_the_parameters(run, name):
    """Each weight's gradient arrives at its parameter's placements (the
    data-parallel partial sums reduced by the placement's own
    collectives)."""
    for r in run:
        case = r["cases"][name]
        mesh = tuple(MESH)
        for k, spec in case["specs"].items():
            want = ["Replicate()"] * 3
            for dim, axis in enumerate(spec):
                if axis is not None:
                    want[mesh.index(axis)] = f"Shard(dim={dim})"
            assert case["grad_placements"][k] == f"({', '.join(want)})", (k, spec)


@pytest.mark.parametrize("fault", list(J.MOE_FAULTS))
def test_planted_faults_fail_the_check(run, fault):
    """A rank that leaves its partial out of the sum over ``model``, and a
    rank that routes the rows at another rank's group offset, each fail
    ``test_layer_matches_the_one_rank_layer``'s check by far."""
    errs = _errs(run[0]["faults"][fault], _one_rank(J.MOE_FAULTS[fault][0]))
    assert errs["out"] > 100 * TOL and max(errs.values()) > 1e4 * TOL, errs


def test_chip_smoke_moe_layer_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 10 (d) of ``chip_smoke.py`` at the smoke widths on the CPU: the
    one-rank layers with their two readings, which its limit parts, and the
    8 ranks of its (1, 2, 4) mesh, each quantity of each rank within it."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS

    kw = dict(ref_dir=str(tmp_path), cases=CS.MOE_LAYER_CASES, smoke=True, batch=8, seq=16,
              device="cpu")
    (one,) = ranks.run("chip_smoke:moe_layer_reference", 1, timeout_s=300, kwargs=kw)
    got = ranks.run("chip_smoke:moe_layer_job", 8, timeout_s=300, kwargs=kw)
    for label, _, _ in CS.MOE_LAYER_CASES:
        order, fault = max(one[label]["order"].values()), max(one[label]["fault"].values())
        assert order <= CS.MOE_LAYER_TOL / 2 and fault >= 2 * CS.MOE_LAYER_TOL, (order, fault)
        for r in got:
            assert max(r[label]["errs"].values()) <= CS.MOE_LAYER_TOL, r[label]["errs"]
