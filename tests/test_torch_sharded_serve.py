"""Sharded serving (``lm.prefill`` and ``lm.decode_step`` on DTensors, with
``make_act_shard``'s hook) in 8 gloo ranks on the CPU, against the
reference's jitted prefill and decode step with ``in_shardings`` and
``out_shardings`` as its dry-run builds them (``repro/launch/dryrun.py``:
parameters under ``param_pspecs``, the prompt and tokens under
``batch_pspecs``, the cache under ``cache_pspecs``, the logits replicated)
on a (pod 2, data 2, model 2) mesh of this process's 8 virtual CPU
devices.

One 8-rank job, ``torch_rank_jobs.sharded_serve_ranks``, serves every case
of ``torch_rank_jobs.SERVE_CASES`` (float32 smoke configs at the FSDP
default: Yi; Danube, whose 8-slot ring wraps in decode; Falcon-Mamba;
DeepSeek-V2, MLA with a latent cache split over ``model`` on its sequence
and expert-parallel MoE; DBRX at ``moe_groups`` 1 and 4; Jamba; MusicGen's
codebooks; Qwen2-VL's embeddings and M-RoPE grid positions) from the same
numpy inputs and the reference's parameters: a prefill of 8 x 16 into the
case's capacity, then 4 decode steps.  Yi is also served at B = 1 with no
hook, the reference's ``dec_act`` rule, its decode batch not splitting
over the data-parallel ranks.

What must hold: every rank's logits after the prefill and after each step
within ``TOL_F32`` (1e-5, ``tests/test_torch_lm.py``'s) of the
reference's, relative to their largest magnitude; every rank's shard of
every cache leaf after the prefill and after the last step within
``TOL_F32`` of the reference's shard on the device at the rank's mesh
coordinate (relative to the leaf's largest magnitude), and of the shape
``NamedSharding(mesh, spec).shard_shape`` gives.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType, Mesh, NamedSharding

import torch_rank_jobs as J
from repro.configs import get_smoke_config as jsmoke
from repro.launch import specs as RSP
from repro.models import lm as jlm
from repro.training.train_step import make_act_shard, param_pspecs
from repro_torch.launch import ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

TOL_F32 = 1e-5
B, S, STEPS = J.SERVE_B, J.SERVE_S, J.SERVE_STEPS
NAMES = list(J.SERVE_CASES) + [J.SERVE_B1 + "-b1"]


def _jcfg(arch, groups):
    cfg = jsmoke(arch)
    return dataclasses.replace(cfg, dtype="float32", parallel=dataclasses.replace(
        cfg.parallel, moe_groups=groups))


def _jflat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grid_positions(n: int, start: int = 4, side: int = 3) -> np.ndarray:
    """[n, 3] M-RoPE positions: t = arange(n), h and w walking a side x side
    image grid from ``start`` (a text token's h and w equal its t)."""
    pos = np.repeat(np.arange(n)[:, None], 3, axis=1)
    span = np.arange(side * side)
    pos[start:start + side * side, 1] = start + span // side
    pos[start:start + side * side, 2] = start + span % side
    return pos


def _inputs(cfg, seed: int) -> dict:
    """The prompt, its positions (M-RoPE) and the decode steps' inputs."""
    r = np.random.RandomState(seed)
    if not cfg.embed_inputs:
        return {"x/prompt": r.randn(B, S, cfg.d_model).astype(np.float32),
                "x/positions": np.broadcast_to(_grid_positions(S), (B, S, 3)).astype(np.int64),
                "x/steps": r.randn(STEPS, B, 1, cfg.d_model).astype(np.float32)}
    k = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    return {"x/prompt": r.randint(0, cfg.vocab_size, (B, S) + k).astype(np.int64),
            "x/steps": r.randint(0, cfg.vocab_size, (STEPS, B, 1) + k).astype(np.int64)}


def _reference(name: str, jcfg, params, x: dict, mesh, rows: slice) -> dict:
    """The reference's sharded prefill and decode steps, jitted as its
    dry-run builds them; the hook where the batch splits over the
    data-parallel ranks (4), else none."""
    prompt = x["x/prompt"][rows]
    n = prompt.shape[0]
    cap = J.serve_capacity(name.removesuffix("-b1"))
    act = make_act_shard(jcfg, mesh) if n % 4 == 0 else None
    ns = RSP.named(mesh, param_pspecs(jcfg, mesh))
    if jcfg.embed_inputs:
        batch = {"tokens": jnp.asarray(prompt, jnp.int32)}
    else:
        batch = {"embeds": jnp.asarray(prompt),
                 "positions": jnp.asarray(x["x/positions"][rows], jnp.int32)}
    cpspec = RSP.cache_pspecs(jcfg, mesh, jlm.abstract_cache(jcfg, n, cap))
    cspec = RSP.named(mesh, cpspec)
    pre = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b, capacity=cap, act_shard=act),
                  in_shardings=(ns, RSP.named(mesh, RSP.batch_pspecs(mesh, batch))),
                  out_shardings=(None, cspec))
    lg, cache = pre(params, batch)
    out = {"logits": [np.asarray(lg)], "prefill_cache": _jflat(cache),
           "specs": _jflat(cpspec)}

    def tok(step):
        t = step[rows]
        return jnp.asarray(t, jnp.int32) if jcfg.embed_inputs else jnp.asarray(t)

    tspec = RSP.named(mesh, RSP.batch_pspecs(mesh, tok(x["x/steps"][0])))
    dec = jax.jit(lambda p, t, c, i: jlm.decode_step(jcfg, p, t, c, i, act_shard=act),
                  in_shardings=(ns, tspec, cspec, None), out_shardings=(None, cspec))
    for t, step in enumerate(x["x/steps"]):
        lg, cache = dec(params, tok(step), cache, jnp.int32(S + t))
        out["logits"].append(np.asarray(lg))
    out["cache"] = _jflat(cache)
    return out


@pytest.fixture(scope="module")
def mesh():
    devices = np.array(jax.devices()[:8]).reshape(2, 2, 2)
    return Mesh(devices, ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)


@pytest.fixture(scope="module")
def run(tmp_path_factory, mesh):
    """The ranks' job and the reference's programs, once for the module;
    the job runs in its processes while this one compiles the reference."""
    d = tmp_path_factory.mktemp("serve")
    cases = {}
    for i, (name, (arch, groups)) in enumerate(J.SERVE_CASES.items()):
        jcfg = _jcfg(arch, groups)
        params = jlm.init_model(jcfg, jax.random.PRNGKey(i))
        x = _inputs(jcfg, 100 + i)
        np.savez(d / f"{name}.npz", **x,
                 **{f"p/{k}": np.asarray(v) for k, v in _jflat(params).items()})
        cases[name] = (jcfg, params, x)
    got = []
    job = threading.Thread(target=lambda: got.append(_ranks(d)), daemon=True)
    job.start()
    want = {}
    for name, (jcfg, params, x) in cases.items():
        want[name] = _reference(name, jcfg, params, x, mesh, slice(None))
    jcfg, params, x = cases[J.SERVE_B1]
    want[J.SERVE_B1 + "-b1"] = _reference(J.SERVE_B1 + "-b1", jcfg, params, x, mesh,
                                          slice(0, 1))
    job.join(timeout=330)
    assert not job.is_alive() and len(got) == 1, "the ranks' job did not finish"
    if isinstance(got[0], BaseException):
        raise got[0]
    return want, got[0]


def _ranks(d):
    """The ranks' job, its result or the exception it raised."""
    try:
        return ranks.run("torch_rank_jobs:sharded_serve_ranks", 8, timeout_s=300,
                         kwargs=dict(npz_dir=str(d)))
    except Exception as e:  # re-raised by the fixture, in the test's thread
        return e


def _rel(got, want, scale=None) -> float:
    got = np.asarray(got.float().numpy() if hasattr(got, "numpy") else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    return float(np.abs(got - want).max() / max(scale, 1e-6))


@pytest.mark.parametrize("name", NAMES)
def test_logits_on_every_rank_match_the_reference(run, name):
    """Every rank's replicated logits after the prefill and after each of
    the 4 decode steps."""
    want, got = run
    for r, res in enumerate(got):
        for t, (g, w) in enumerate(zip(res[name]["logits"], want[name]["logits"], strict=True)):
            assert _rel(g, w) < TOL_F32, f"rank {r}, {'prefill' if t == 0 else f'step {t}'}"


@pytest.mark.parametrize("name", NAMES)
def test_cache_shards_are_the_reference_device_shards(run, mesh, name):
    """Every rank's shard of every cache leaf, after the prefill and after
    the last step: the reference's shard on the device at the rank's mesh
    coordinate, of ``NamedSharding(mesh, spec).shard_shape``."""
    want, got = run
    devices = mesh.devices.reshape(-1)
    for when in ("prefill_cache", "cache"):
        ref = want[name][when]
        for r, res in enumerate(got):
            mine = res[name][when]
            assert set(mine) == set(ref), when
            for path, (local, placements) in mine.items():
                arr = ref[path]
                spec = want[name]["specs"][path]
                shape = NamedSharding(mesh, spec).shard_shape(arr.shape)
                assert tuple(local.shape) == tuple(shape), (path, placements)
                shard = next(s.data for s in arr.addressable_shards if s.device == devices[r])
                err = _rel(local, shard, np.abs(np.asarray(arr, np.float64)).max())
                assert err < TOL_F32, f"{when} {path} rank {r}: {err}"


def test_sharded_caches_split_as_the_specs_say(run):
    """The rules reach every case: the latent cache splits its sequence over
    ``model``, the kv heads split over ``model``, the Mamba state its
    channels, and the B = 1 cache replicates the batch."""
    _, got = run
    pl = {name: {p: v[1] for p, v in got[0][name]["cache"].items()} for name in NAMES}
    assert "Shard(dim=2)" in pl["deepseek_v2_236b"]["blocks/slot0/ckv"]  # [P, B, C, r]
    assert pl["yi_6b"]["blocks/slot0/k"].endswith("Shard(dim=3))")  # heads
    assert pl["falcon_mamba_7b"]["blocks/slot0/ssm"].endswith("Shard(dim=2))")
    assert "Shard(dim=1)" not in pl["yi_6b-b1"]["blocks/slot0/k"]

