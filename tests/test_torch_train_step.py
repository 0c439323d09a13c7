"""The port's train step (``repro_torch.training.train_step``) against the
reference's.

One step from identical parameters (the reference's ``lm.init_model``
through ``convert.params_from_numpy``) and a ``make_batch`` batch (the
port's copy of ``training/data.py`` gives the same bits), against the
reference's ``_grad_and_metrics`` (jitted) and ``adamw_update``.  The
parity runs on float32 copies of the smoke configs, where the point is the
algorithm: loss and nll at rtol 1e-5, ``grad_norm`` at rtol 1e-4, ``lr``
exactly, every gradient within 1e-4 of its leaf's rms, and every updated
parameter within what the two gradients imply: a first AdamW step moves a
parameter by ``lr * c g / (|c g| + eps)`` (c the clip factor) plus weight
decay, so where a gradient is within a few ``eps`` of zero, a float32
difference in it moves the step by a share of ``lr``; the bound is ``lr``
times that share's difference between the port's and the reference's
gradients, plus 1e-6.  Cases: yi_6b at 1 and 2 microbatches with remat on and
off; gemma_7b (tied head, GeGLU), h2o_danube_3_4b (a window of 64 inside
128 tokens), musicgen_large (two codebooks), qwen2_vl_7b (embeds and
M-RoPE; 1 microbatch, and 2 with remat), dbrx_132b (MoE), minicpm3_4b (MLA: flash at q/k 24 and v 16),
deepseek_v2_236b (MLA, MoE with shared experts, the dense prelude),
falcon_mamba_7b (the selective scan's custom VJP; 1 microbatch, and 2 with
remat) and jamba_1_5_large_398b (Mamba, attention and MoE layers together).

Then the data-parallel step in 4 gloo ranks (2 pods x 2 lanes,
``launch/ranks.py``, the job ``torch_rank_jobs.train_step_ranks``): its
``"xla"`` (flat all-reduce) and ``"fulllane"`` (hierarchical) backends
agree with each other as ``test_train.py::test_backends_agree`` asks (loss
rtol 1e-6, parameters 1e-5 absolute), and with the reference's
``make_train_step_shardmap`` on a (pod 2, data 2, model 1) mesh of this
process's CPU devices: the ranks' synced gradients within 1e-4 of each
leaf's rms of the reference's whole-batch gradients (the mean of the
ranks' means), the parameters within the bound above plus the 1e-5 of the
reference's own backend check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro.training import optimizer as jopt
from repro.training.data import make_batch as jmake_batch
from repro.training.train_step import _grad_and_metrics, make_train_step_shardmap
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import ranks
from repro_torch.models.params import map_tree
from repro_torch.training import optimizer as opt
from repro_torch.training.data import make_batch
from repro_torch.training.train_step import grad_and_metrics, make_train_step

B, S = 4, 128
OPT = dict(learning_rate=1e-3, warmup_steps=2)


def _configs(arch, **parallel):
    out = []
    for cfg in (jsmoke(arch), get_smoke_config(arch)):
        out.append(dataclasses.replace(cfg, dtype="float32", parallel=dataclasses.replace(
            cfg.parallel, **parallel)))
    return out


def _flat(tree) -> dict:
    out = {}
    map_tree(lambda path, t: out.__setitem__(path, t), tree)
    return out


def _jflat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _step_bound(g_port, g_ref, norms, lr) -> np.ndarray:
    """Per element: ``lr`` times the difference of a first AdamW step's
    share ``c g / (|c g| + eps)`` between the two gradients (each clipped
    by its own global norm), plus 1e-6."""
    def share(g, norm):
        cg = np.asarray(g, np.float64) * min(1.0, 1.0 / max(norm, 1e-9))
        return cg / (np.abs(cg) + 1e-8)
    return lr * np.abs(share(g_port, norms[0]) - share(g_ref, norms[1])) + 1e-6


def _reference_step(jcfg, params, batch):
    grads, metrics = jax.jit(lambda p, b: _grad_and_metrics(jcfg, p, b))(params, batch)
    ocfg = jopt.OptConfig(**OPT)
    new, _, info = jopt.adamw_update(grads, jopt.init_opt_state(params, ocfg), params, ocfg)
    return grads, new, {**metrics, **info}


@pytest.mark.parametrize("arch,micro,remat", [
    ("yi_6b", 1, False), ("yi_6b", 2, False), ("yi_6b", 1, True), ("yi_6b", 2, True),
    ("gemma_7b", 1, False), ("h2o_danube_3_4b", 1, False), ("musicgen_large", 2, False),
    ("qwen2_vl_7b", 1, False), ("qwen2_vl_7b", 2, True), ("dbrx_132b", 2, False),
    ("minicpm3_4b", 1, False),
    ("deepseek_v2_236b", 2, False), ("falcon_mamba_7b", 1, False), ("falcon_mamba_7b", 2, True),
    ("jamba_1_5_large_398b", 2, False),
])
def test_train_step_matches_the_reference(arch, micro, remat):
    jcfg, tcfg = _configs(arch, microbatches=micro, remat=remat)
    params = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    batch = make_batch(tcfg, B, S, seed=0, step=0)
    want_batch = jmake_batch(jcfg, B, S, seed=0, step=0)
    assert all(np.array_equal(batch[k], want_batch[k]) for k in want_batch)
    jgrads, jnew, jm = _reference_step(jcfg, params, jax.tree.map(jnp.asarray, batch))

    np_params = jax.tree.map(np.asarray, params)
    tgrads, tm = grad_and_metrics(tcfg, params_from_numpy(tcfg, np_params, device="cpu"),
                                  {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
                                   else torch.from_numpy(v) for k, v in batch.items()})
    tparams = params_from_numpy(tcfg, np_params, device="cpu")
    step = make_train_step(tcfg, opt.OptConfig(**OPT))
    tnew, tstate, tm2 = step(tparams, opt.init_opt_state(tparams, opt.OptConfig(**OPT)), batch)

    for k in ("loss", "nll"):
        np.testing.assert_allclose(float(tm2[k]), float(jm[k]), rtol=1e-5)
        assert float(tm[k]) == float(tm2[k])
    np.testing.assert_allclose(float(tm2["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(tm2["lr"]) == float(jm["lr"]) and int(tstate["step"]) == 1
    want_g, want_p = _jflat(jgrads), _jflat(jnew)
    for key, g in _flat(tgrads).items():
        rms = np.sqrt(np.mean(want_g[key].astype(np.float64) ** 2)) + 1e-30
        assert np.abs(g.numpy() - want_g[key]).max() <= 1e-4 * rms, key
    norms = (float(tm2["grad_norm"]), float(jm["grad_norm"]))
    tg = _flat(tgrads)
    for key, p in _flat(tnew).items():
        bound = _step_bound(tg[key].numpy(), want_g[key], norms, OPT["learning_rate"])
        assert np.all(np.abs(p.numpy() - want_p[key]) <= bound), key


def test_data_parallel_backends_agree_with_each_other_and_the_reference(tmp_path):
    from jax.sharding import AxisType, Mesh

    jcfg, _ = _configs("yi_6b", fsdp=False)
    params = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    path = str(tmp_path / "params.npz")
    np.savez(path, **_jflat(params))
    got = ranks.run("torch_rank_jobs:train_step_ranks", 4, timeout_s=240, kwargs=dict(
        pods=2, lanes=2, arch="yi_6b", params_npz=path, batch=8, seq=S, lr=OPT["learning_rate"],
        warmup=OPT["warmup_steps"]))
    for r in got[1:]:  # every rank holds the same result
        for backend in ("xla", "fulllane"):
            assert r[backend]["metrics"] == got[0][backend]["metrics"]
            assert all(torch.equal(a, got[0][backend]["params"][k])
                       for k, a in r[backend]["params"].items())
    xla, full = got[0]["xla"], got[0]["fulllane"]
    np.testing.assert_allclose(xla["metrics"]["loss"], full["metrics"]["loss"], rtol=1e-6)
    for k, a in xla["params"].items():
        np.testing.assert_allclose(a.numpy(), full["params"][k].numpy(), rtol=0, atol=1e-5)

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1), ("pod", "data", "model"),
                axis_types=(AxisType.Auto,) * 3)
    batch = jax.tree.map(jnp.asarray, make_batch(jcfg, 8, S, seed=0, step=0))
    ocfg = jopt.OptConfig(**OPT)
    want_g = _jflat(jax.jit(lambda p, b: _grad_and_metrics(jcfg, p, b)[0])(params, batch))
    for backend in ("xla", "fulllane"):
        fn = make_train_step_shardmap(jcfg, mesh, ocfg, backend=backend)[0](batch)
        new, _, m = fn(jax.tree.map(jnp.copy, params), jopt.init_opt_state(params, ocfg), batch)
        port = got[0][backend]
        np.testing.assert_allclose(port["metrics"]["loss"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(port["metrics"]["grad_norm"], float(m["grad_norm"]),
                                   rtol=1e-4)
        norms = (port["metrics"]["grad_norm"], float(m["grad_norm"]))
        for k, want in _jflat(new).items():
            g = port["grads"][k].numpy()
            rms = np.sqrt(np.mean(want_g[k].astype(np.float64) ** 2)) + 1e-30
            assert np.abs(g - want_g[k]).max() <= 1e-4 * rms, f"{backend} {k}"
            bound = _step_bound(g, want_g[k], norms, OPT["learning_rate"]) + 1e-5
            assert np.all(np.abs(port["params"][k].numpy() - want) <= bound), f"{backend} {k}"
