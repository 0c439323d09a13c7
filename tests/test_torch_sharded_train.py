"""The sharded train step (``training/train_step.make_train_step_sharded``,
DTensor over a ``(pod 2, data 2, model 2)`` ``DeviceMesh`` of 8 gloo ranks
on the CPU) and the shard_map step with TP (``make_train_step(mesh=)``)
against the reference's ``make_train_step_pjit`` and
``make_train_step_shardmap`` on the same mesh of this process's 8 virtual
CPU devices (``tests/conftest.py``).

One 8-rank job, ``torch_rank_jobs.sharded_ranks``, runs every case; the
tests read its result.  Inputs: the reference's parameters
(``lm.init_model``, saved per config and loaded by key) and
``make_batch(seed=0, step=0)`` of 8 x 32, in float32 smoke configs.  The
cases (``torch_rank_jobs.SHARDED_CASES``): yi_6b, gemma_7b and
musicgen_large at 2 microbatches (the reference's
``test_microbatch_equivalence`` cases; the reference drops its activation
hook for musicgen with microbatches, the port applies it always),
deepseek_v2_236b (MLA, MoE), falcon_mamba_7b (the scan),
jamba_1_5_large_398b (all three) and dbrx_132b (MoE), each at
``moe_groups`` 1, and dbrx_132b and deepseek_v2_236b at ``moe_groups`` 4,
the data-parallel world, where each rank routes its own group (against
the reference's step at the same ``moe_groups``); every MoE layer runs
expert-parallel, its experts split over ``model``.  The shard_map step
with TP (``TP_CASES``): yi_6b for both backends, and deepseek_v2_236b,
whose MoE layers route each rank's rows.

Tolerances, those of the one-card step's parity
(``test_torch_train_step.py``): loss and nll rtol 1e-5, ``grad_norm`` rtol
1e-4, ``lr`` and the step exactly; each first moment (``(1 - b1) c g``)
within 1e-4 of its leaf's rms, each second moment (``(1 - b2) (c g)^2``)
within 1e-3 of its leaf's rms; each updated parameter within what the two
first moments imply for a first AdamW step (``lr`` times the difference of
the shares ``c g / (|c g| + eps)``, plus 1e-6; and, for the shard_map step,
plus the 1e-5 of the reference's own backend check).

Also: every parameter's local shard before the step is the reference's
device shard (``NamedSharding(mesh, spec).devices_indices_map``) bit for
bit; every parameter's and moment's local shape, for every config at
fsdp True and False, is ``NamedSharding(mesh, spec).shard_shape``; the
kernels' plain versions saw local shapes (attention rows ``B/(pod data) *
H/model``, RMSNorm the rank's rows, the scan ``d_inner/model`` channels);
RMSNorm's ``dw`` over batch shards equals the one-card ``dw`` (rtol
1e-6) and comes back Partial; every kernel dispatcher takes DTensors; the host-staged process group that the
card's mesh runs on under gloo (``core/groups.StagedGroup``) gives
DTensor's collectives and the paper's sums the bits plain gloo gives, on
the CPU.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P

import torch_rank_jobs as J
from repro.configs import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro.training import optimizer as jopt
from repro.training.data import make_batch as jmake_batch
from repro.training.train_step import (make_train_step_pjit, make_train_step_shardmap,
                                       opt_pspecs, param_pspecs)
from repro_torch.launch import ranks

B, S = 8, 32
OPT = dict(learning_rate=1e-3, warmup_steps=2)


def _jcfg(arch, microbatches=1, fsdp=True, moe_groups=1):
    cfg = jsmoke(arch)
    return dataclasses.replace(cfg, dtype="float32", parallel=dataclasses.replace(
        cfg.parallel, microbatches=microbatches, fsdp=fsdp, moe_groups=moe_groups))


def _jflat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


@pytest.fixture(scope="module")
def mesh():
    devices = np.array(jax.devices()[:8]).reshape(2, 2, 2)
    return Mesh(devices, ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)


@pytest.fixture(scope="module")
def run(tmp_path_factory, mesh):
    """The ranks' job and the reference's steps, once for the module; the
    job runs in its processes while this one compiles the reference."""
    d = tmp_path_factory.mktemp("sharded")
    want = {"init": {}, "sharded": {}, "tp": {}}
    inits = {}
    for arch, micro, _ in J.SHARDED_CASES.values():
        if arch not in inits:
            inits[arch] = jlm.init_model(_jcfg(arch, micro), jax.random.PRNGKey(0))
            want["init"][arch] = {k: np.asarray(v) for k, v in _jflat(inits[arch]).items()}
            np.savez(d / f"{arch}.npz", **want["init"][arch])
    got = []
    job = threading.Thread(target=lambda: got.append(_ranks(d)), daemon=True)
    job.start()
    ocfg = jopt.OptConfig(**OPT)
    for name, (arch, micro, groups) in J.SHARDED_CASES.items():
        jcfg, params = _jcfg(arch, micro, moe_groups=groups), inits[arch]
        batch = jax.tree.map(jnp.asarray, jmake_batch(jcfg, B, S, seed=0, step=0))
        fn = make_train_step_pjit(jcfg, mesh, ocfg)[0](batch)
        new, opt, m = fn(jax.tree.map(jnp.copy, params), jopt.init_opt_state(params, ocfg),
                         batch)
        want["sharded"][name] = {"params": _jflat(new), "m": _jflat(opt["m"]),
                                 "v": _jflat(opt["v"]), "metrics": m, "step": opt["step"]}
    for name, (arch, backend) in J.TP_CASES.items():
        jcfg, params = _jcfg(arch, fsdp=False), inits[arch]
        batch = jax.tree.map(jnp.asarray, jmake_batch(jcfg, B, S, seed=0, step=0))
        fn = make_train_step_shardmap(jcfg, mesh, ocfg, backend=backend)[0](batch)
        new, opt, m = fn(jax.tree.map(jnp.copy, params), jopt.init_opt_state(params, ocfg),
                         batch)
        want["tp"][name] = {"params": _jflat(new), "m": _jflat(opt["m"]), "metrics": m}
    job.join(timeout=660)
    assert not job.is_alive() and len(got) == 1, "the ranks' job did not finish"
    if isinstance(got[0], BaseException):
        raise got[0]
    return want, got[0]


def _ranks(d):
    """The ranks' job, its result or the exception it raised."""
    try:
        return ranks.run("torch_rank_jobs:sharded_ranks", 8, timeout_s=600, kwargs=dict(
            npz_dir=str(d), batch=B, seq=S, lr=OPT["learning_rate"],
            warmup=OPT["warmup_steps"]))
    except Exception as e:  # re-raised by the fixture, in the test's thread
        return e


def _share(m):
    """A first AdamW step's share ``c g / (|c g| + eps)`` from its first
    moment ``m = (1 - b1) c g``."""
    cg = np.asarray(m, np.float64) / 0.1
    return cg / (np.abs(cg) + 1e-8)


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2))) + 1e-30


def _check_step(port: dict, want: dict, slack: float = 0.0) -> None:
    for k in ("loss", "nll"):
        np.testing.assert_allclose(port["metrics"][k], float(want["metrics"][k]), rtol=1e-5)
    np.testing.assert_allclose(port["metrics"]["grad_norm"], float(want["metrics"]["grad_norm"]),
                               rtol=1e-4)
    assert port["metrics"]["lr"] == float(want["metrics"]["lr"])
    for k, m in port["m"].items():
        assert np.abs(m.numpy() - want["m"][k]).max() <= 1e-4 * _rms(want["m"][k]), k
    for k, v in port.get("v", {}).items():
        assert np.abs(v.numpy() - want["v"][k]).max() <= 1e-3 * _rms(want["v"][k]), k
    for k, p in port["params"].items():
        bound = OPT["learning_rate"] * np.abs(_share(port["m"][k].numpy())
                                              - _share(want["m"][k])) + 1e-6 + slack
        assert np.all(np.abs(p.numpy() - np.asarray(want["params"][k])) <= bound), k


@pytest.mark.parametrize("name", list(J.SHARDED_CASES))
def test_sharded_step_matches_the_reference_pjit_step(run, name):
    want, got = run
    for r in got[1:]:  # the metrics are the same floats on every rank
        assert r["sharded"][name]["metrics"] == got[0]["sharded"][name]["metrics"]
    port = got[0]["sharded"][name]
    assert port["step"] == int(want["sharded"][name]["step"]) == 1
    _check_step(port, want["sharded"][name])


@pytest.mark.parametrize("backend", ["xla", "fulllane"])
def test_tp_shardmap_step_matches_the_reference_shardmap_step(run, backend):
    want, got = run
    for r in got[1:]:
        assert r["tp"][backend]["metrics"] == got[0]["tp"][backend]["metrics"]
    _check_step(got[0]["tp"][backend], want["tp"][backend], slack=1e-5)
    other = got[0]["tp"]["fulllane" if backend == "xla" else "xla"]
    np.testing.assert_allclose(got[0]["tp"][backend]["metrics"]["loss"],
                               other["metrics"]["loss"], rtol=1e-6)


def test_tp_shardmap_moe_step_matches_the_reference_shardmap_step(run):
    """DeepSeek-V2 (MLA, MoE with shared experts) through the shard_map step:
    each rank routes its own rows, its experts split over ``model``."""
    want, got = run
    for r in got[1:]:
        assert r["tp"]["deepseek_v2_236b"]["metrics"] == got[0]["tp"]["deepseek_v2_236b"]["metrics"]
    _check_step(got[0]["tp"]["deepseek_v2_236b"], want["tp"]["deepseek_v2_236b"], slack=1e-5)


@pytest.mark.parametrize("step,name", [("sharded", n) for n, c in J.SHARDED_CASES.items()
                                       if J.sharded_config(c[0]).moe is not None]
                         + [("tp", "deepseek_v2_236b")])
def test_no_expert_weight_is_gathered_over_model(run, step, name):
    """Each MoE case, in either step: inside the MoE layer, every all-gather
    over ``model`` is of a 2-D input (the router's; no expert weight), and
    the layer sums its output over ``model``."""
    _, got = run
    for r in got:
        calls = r[step][name]["moe_collectives"]
        assert [c for c in calls if c[1] == "model" and c[0] == "all_reduce"], calls
        assert not [c for c in calls if c[1] == "model" and c[0].startswith("all_gather")
                    and len(c[2]) != 2], calls


@pytest.mark.parametrize("name", list(J.SHARDED_CASES))
def test_local_shards_are_the_reference_device_shards(run, mesh, name):
    want, got = run
    arch = J.SHARDED_CASES[name][0]
    specs = _jflat(param_pspecs(_jcfg(arch), mesh))
    for r, res in enumerate(got):
        device = mesh.devices[np.unravel_index(r, (2, 2, 2))]
        for k, local in res["sharded"][name]["local_before"].items():
            full = want["init"][arch][k]
            idx = NamedSharding(mesh, specs[k]).devices_indices_map(full.shape)[device]
            assert np.array_equal(local.numpy(), full[idx]), f"rank {r} {k}"


@pytest.mark.parametrize("arch", J.PLACED_ARCHS)
def test_every_shard_shape_is_the_reference_shard_shape(run, mesh, arch):
    _, got = run
    for fsdp in (True, False):
        jcfg = _jcfg(arch, fsdp=fsdp)
        shapes = {k: m.shape for k, m in _jflat(jlm.model_meta(jcfg)).items()}
        pspec = _jflat(param_pspecs(jcfg, mesh))
        mspec = _jflat(opt_pspecs(jcfg, mesh)["m"])
        for r, res in enumerate(got):
            placed = res["placed"][f"{arch} fsdp={fsdp}"]
            for k, shape in shapes.items():
                assert placed["params"][k] == list(
                    NamedSharding(mesh, pspec[k]).shard_shape(shape)), (r, fsdp, k)
                for mom in ("m", "v"):
                    assert placed[mom][k] == list(
                        NamedSharding(mesh, mspec[k]).shard_shape(shape)), (r, fsdp, mom, k)


@pytest.mark.parametrize("name,micro", [pytest.param(n, c[1], id=f"{n}-{c[1]}")
                                        for n, c in J.SHARDED_CASES.items()])
def test_kernels_saw_local_shapes(run, name, micro):
    """Each rank's rows are B / (pod * data) / microbatches; attention's
    kernel rows are those rows times the rank's H / model heads, the scan's
    channels d_inner / model."""
    _, got = run
    cfg = J.sharded_config(J.SHARDED_CASES[name][0], micro)
    rows = B // 4 // micro
    calls = got[0]["sharded"][name]["kernel_shapes"]
    seen = {fn for fn, _ in calls}
    want = {"rmsnorm_ref", "rmsnorm_bwd_ref"}
    if cfg.attn is not None:
        want |= {"flash_attention_ref", "flash_attention_bwd_ref"}
    if cfg.mamba is not None:
        want |= {"mamba_scan_ref", "mamba_scan_bwd_ref"}
    assert seen == want
    for r in got:
        for fn, shape in r["sharded"][name]["kernel_shapes"]:
            if fn.startswith("flash"):
                assert shape == [rows * cfg.attn.num_heads // 2, S, shape[2]], (fn, shape)
            elif fn.startswith("mamba"):
                di = cfg.mamba.expand * cfg.d_model
                assert shape == [rows, S, di // 2, cfg.mamba.d_state], (fn, shape)
            else:
                assert shape[:2] == [rows, S], (fn, shape)


def test_rmsnorm_dw_over_batch_shards_is_the_one_card_dw(run):
    _, got = run
    for r in got:
        dw = r["dw"]
        np.testing.assert_allclose(dw["sharded"].numpy(), dw["one_card"].numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert dw["placements"] == "(Partial(sum), Partial(sum), Replicate())"


def test_the_staged_group_runs_dtensor_and_the_sums_as_gloo_does(run):
    _, got = run
    for r in got:
        st = r["staged"]
        assert st["backend"] == "gloo_staged" and st["transport"] == "gloo_staged"
        assert st["full"] and st["reshard"] and st["psum"]


def test_every_dispatcher_takes_dtensors(run):
    """Each ``kernels/ops`` dispatcher on DTensors (rows, heads or channels
    sharded) gives the call on the whole tensors: bit for bit where each
    shard's rows are computed alone, within 1e-6 of max(|output|, 1) where
    a gradient sums over the shards (RMSNorm's ``dw``, the scan's ``gc``)."""
    _, got = run
    for r in got:
        assert set(r["dispatch"]) == {"rmsnorm", "rmsnorm_bwd", "flash_attention",
                                      "flash_attention_bwd", "mamba_scan", "mamba_scan_bwd",
                                      "a2a_pack"}
        for name, err in r["dispatch"].items():
            assert err <= (1e-6 if name in ("rmsnorm_bwd", "mamba_scan_bwd") else 0.0), (name,
                                                                                          err)
