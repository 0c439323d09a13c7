"""The port's checkpoints (``repro_torch.training.checkpoint``): the cases
of ``tests/test_checkpoint.py`` on the port's tensors, and both directions
across frameworks, bit for bit: a checkpoint the reference's ``ckpt.save``
writes restores into the port, and one the port writes restores in the
reference's ``ckpt.restore``.  The reference's ``restore_with_shardings``
places shards on a JAX mesh and has no one-GPU counterpart.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro.training import checkpoint as JC
from repro.training import optimizer as jopt
from repro_torch.configs import get_smoke_config
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models import lm
from repro_torch.models.params import map_tree
from repro_torch.training import checkpoint as C
from repro_torch.training import optimizer as opt


@pytest.fixture
def params():
    cfg = get_smoke_config("yi_6b")
    return lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")


def _trees_equal(a, b):
    flat = []
    map_tree(lambda _, x, y: flat.append((x, y)), a, b)
    for x, y in flat:
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


def test_roundtrip(tmp_path, params):
    d = str(tmp_path)
    C.save(d, 7, params, extra={"note": "x"})
    got, extra = C.restore(d, 7, params)
    _trees_equal(params, got)
    assert extra == {"note": "x"}


def test_latest_ignores_uncommitted(tmp_path, params):
    d = str(tmp_path)
    C.save(d, 1, params)
    os.makedirs(os.path.join(d, "step_000000009", "arrays"))  # a torn write: no COMMIT
    assert C.latest_step(d) == 1


def test_gc_keeps_last(tmp_path, params):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        C.save(d, s, params, keep_last=2)
    assert C.committed_steps(d) == [3, 4]


def test_async_checkpointer(tmp_path, params):
    d = str(tmp_path)
    ac = C.AsyncCheckpointer(d, keep_last=3)
    for s in (10, 20):
        ac.save(s, params)
    ac.wait()
    assert C.committed_steps(d) == [10, 20]
    got, _ = C.restore(d, 20, params)
    _trees_equal(params, got)


def test_async_checkpointer_copies_before_returning(tmp_path, params):
    """The tensors may change the moment ``save`` returns (the optimizer
    updates them in place): the checkpoint holds what they were."""
    d = str(tmp_path)
    want = map_tree(lambda _, t: t.clone(), params)
    ac = C.AsyncCheckpointer(d)
    ac.save(1, params)
    map_tree(lambda _, t: t.add_(1), params)
    ac.wait()
    _trees_equal(want, C.restore(d, 1, params)[0])


def test_async_checkpointer_double_failure_surfaces_both(tmp_path, params, monkeypatch):
    """Step N's failed write is raised by save(N+1), whose write is already
    in flight, and its own failure surfaces on the next wait()."""
    d = str(tmp_path)
    fails = []

    def bad_save(ckpt_dir, step, tree, **kw):
        fails.append(step)
        raise OSError(f"disk full at step {step}")

    monkeypatch.setattr(C, "save", bad_save)
    ac = C.AsyncCheckpointer(d)
    ac.save(1, params)
    ac._join()
    with pytest.raises(OSError, match="step 1"):
        ac.save(2, params)
    ac._join()
    assert fails == [1, 2]
    with pytest.raises(OSError, match="step 2"):
        ac.wait()
    ac.wait()


def test_shape_mismatch_raises(tmp_path, params):
    d = str(tmp_path)
    C.save(d, 1, params)
    bad = map_tree(lambda _, t: torch.empty((t.shape[0] + 1,) + t.shape[1:], dtype=t.dtype),
                   params)
    with pytest.raises(ValueError):
        C.restore(d, 1, bad)


def _reference_state():
    """The reference's yi smoke params (bf16) and an AdamW state after one
    update (float32 moments, step 1), as JAX arrays."""
    cfg = jsmoke("yi_6b")
    p = jlm.init_model(cfg, jax.random.PRNGKey(0))
    ocfg = jopt.OptConfig()

    def update(p):
        g = jax.tree.map(lambda x: jnp.full(x.shape, 0.01, jnp.float32), p)
        return jopt.adamw_update(g, jopt.init_opt_state(p, ocfg), p, ocfg)[:2]

    p, o = jax.jit(update)(p)
    return cfg, {"params": p, "opt": o}


def _np(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jcfg, tree = _reference_state()
    JC.save(str(tmp_path), 5, tree, extra={"arch": "yi_6b"})
    cfg = get_smoke_config("yi_6b")
    like_p = lm.init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    like = {"params": like_p, "opt": opt.init_opt_state(like_p, opt.OptConfig())}
    assert C.latest_step(str(tmp_path)) == 5
    got, extra = C.restore(str(tmp_path), 5, like)
    assert extra == {"arch": "yi_6b"}
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat = {}
    map_tree(lambda path, t: flat.__setitem__(path, t), got)
    assert len(flat) == len(want)
    for path, leaf in want:
        key = "/".join(str(k.key) for k in path)
        t = flat[key]
        assert str(t.dtype).split(".")[1] == str(leaf.dtype)
        bits = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
            else t.numpy()
        np.testing.assert_array_equal(bits, _np(leaf))
    # and the converters agree with the checkpoint
    np_tree = jax.tree.map(np.asarray, tree)
    _trees_equal(got["params"], params_from_numpy(cfg, np_tree["params"], device="cpu"))
    _trees_equal(got["opt"], opt_state_from_numpy(cfg, np_tree["opt"], device="cpu"))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jcfg, tree = _reference_state()
    cfg = get_smoke_config("yi_6b")
    np_tree = jax.tree.map(np.asarray, tree)
    port = {"params": params_from_numpy(cfg, np_tree["params"], device="cpu"),
            "opt": opt_state_from_numpy(cfg, np_tree["opt"], device="cpu")}
    C.save(str(tmp_path), 3, port, extra={"from": "port"})
    assert JC.latest_step(str(tmp_path)) == 3
    got, extra = JC.restore(str(tmp_path), 3, jax.eval_shape(lambda: tree))
    assert extra == {"from": "port"}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_np(a), _np(b))
