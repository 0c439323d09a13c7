"""The port's AdamW (``repro_torch.training.optimizer``) against the
reference's, step for step.

Three updates of the same parameters with the same numpy gradients (a
float32 and a bfloat16 leaf, and a stacked [2, 8, 16] leaf), moments in
float32 and in bfloat16, the global-norm clip on (gradients of norm ~50
against ``grad_clip`` 1) and off (``grad_clip`` 1e9), warmup over 2 steps.
Compared after every step: ``grad_norm`` and ``lr`` (rtol 1e-6), and every
parameter and moment: float32 at rtol 1e-5 (XLA may fuse a multiply and an
add that PyTorch rounds apart), bfloat16 within one unit in the last place
(such a difference can move a rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jopt
from repro_torch.training import optimizer as opt

RNG = np.random.RandomState(0)
SHAPES = {"a": ((4, 8), "float32"), "b": {"c": ((16,), "bfloat16"),
                                          "d": ((2, 8, 16), "bfloat16")}}


def _tree(fn, shapes=SHAPES, path=""):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v, f"{path}/{k}") for k, v in shapes.items()}
    return fn(*shapes)


def _close(got: torch.Tensor, want, dt: str):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    if dt == "bfloat16":  # one bf16 ulp: 2^-7 of the value's binade
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_adamw_matches_the_reference(moment_dtype, clip):
    cfg = dict(learning_rate=1e-2, warmup_steps=2, grad_clip=clip, moment_dtype=moment_dtype)
    p0 = _tree(lambda shape, dt: (RNG.randn(*shape).astype(np.float32), dt))
    grads = [_tree(lambda shape, dt: (RNG.randn(*shape) * 5).astype(np.float32))
             for _ in range(3)]
    jp = jax.tree.map(lambda pair: jnp.asarray(pair[0], getattr(jnp, pair[1])), p0,
                      is_leaf=lambda x: isinstance(x, tuple))
    tp = jax.tree.map(lambda pair: torch.from_numpy(pair[0]).to(getattr(torch, pair[1])), p0,
                      is_leaf=lambda x: isinstance(x, tuple))
    dts = jax.tree.map(lambda pair: pair[1], p0, is_leaf=lambda x: isinstance(x, tuple))
    jcfg, tcfg = jopt.OptConfig(**cfg), opt.OptConfig(**cfg)
    jstate, tstate = jopt.init_opt_state(jp, jcfg), opt.init_opt_state(tp, tcfg)
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        tg = jax.tree.map(torch.from_numpy, g)
        jp, jstate, jinfo = jopt.adamw_update(jg, jstate, jp, jcfg)
        tp, tstate, tinfo = opt.adamw_update(tg, tstate, tp, tcfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"])
        for t, j, dt in zip(opt.leaves(tp), jax.tree.leaves(jp), jax.tree.leaves(dts)):
            assert t.dtype == getattr(torch, dt)
            _close(t, j, dt)
        for key in ("m", "v"):
            for t, j in zip(opt.leaves(tstate[key]), jax.tree.leaves(jstate[key])):
                assert t.dtype == getattr(torch, moment_dtype)
                _close(t, j, moment_dtype)
    if clip == 1.0:
        assert float(tinfo["grad_norm"]) > 10  # the clip was on


def _whole_and_sliced(monkeypatch, shape, dtype, seed, device, slice_elems):
    """One AdamW update of a [shape] leaf taken whole and taken in slices of
    ``slice_elems`` elements, from the same seeded parameters and gradient."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = opt.OptConfig(learning_rate=1e-2, warmup_steps=1)
    p = {"w": torch.randn(shape, generator=gen, device=device).to(dtype)}
    g = {"w": torch.randn(shape, generator=gen, device=device).to(dtype)}
    monkeypatch.setattr(opt, "_SLICE", p["w"].numel())  # the leaf in one slice
    whole = opt.adamw_update(g, opt.init_opt_state(p, cfg), {"w": p["w"].clone()}, cfg)
    monkeypatch.setattr(opt, "_SLICE", slice_elems)
    sliced = opt.adamw_update(g, opt.init_opt_state(p, cfg), {"w": p["w"].clone()}, cfg)
    return whole, sliced


def _assert_same_update(whole, sliced):
    assert torch.equal(whole[2]["grad_norm"], sliced[2]["grad_norm"])
    assert torch.equal(whole[0]["w"], sliced[0]["w"])
    assert torch.equal(whole[1]["m"]["w"], sliced[1]["m"]["w"])
    assert torch.equal(whole[1]["v"]["w"], sliced[1]["v"]["w"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_updates_in_slices_match_one_update(monkeypatch, seed):
    """Slicing a leaf along its leading dim (as a full-width leaf is)
    changes no value: the update is elementwise, and the global norm (and
    with it the clip) sums rows before it sums slices."""
    _assert_same_update(*_whole_and_sliced(monkeypatch, (6, 5, 7), torch.float32, seed, "cpu",
                                           35))  # one [5, 7] slice at a time


@pytest.mark.parametrize("shape, slice_elems", [
    ((3, 5000), 5000),          # one row a slice
    ((4, 3, 4096), 2 * 4096),   # two rows of a 3-d leaf a slice
    ((2, 2, 3), 3),             # short rows
    ((9000,), 1000),            # a 1-d leaf: each element a row
])
def test_norm_in_slices_matches_one_norm(monkeypatch, shape, slice_elems):
    """The global norm of a leaf taken whole and in slices has the same
    bits, for leaves of 1 to 3 dims, and agrees with float64's to 1e-6."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)) * 3
    monkeypatch.setattr(opt, "_SLICE", x.numel())
    whole = opt.global_norm({"w": x})
    monkeypatch.setattr(opt, "_SLICE", slice_elems)
    assert len(list(opt._slices(x))) > 1
    assert torch.equal(opt.global_norm({"w": x}), whole)
    np.testing.assert_allclose(float(whole), np.linalg.norm(x.double().numpy()), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype, slice_elems", [
    ((64000, 4096), torch.bfloat16, opt._SLICE),  # Yi's embedding, at the module's slice size
    ((4, 4096, 11008), torch.float32, 4096 * 11008),  # a stacked MLP leaf, one row a slice
])
def test_updates_in_slices_match_one_update_on_card(monkeypatch, shape, dtype, slice_elems):
    """The same on the card, at Yi's embedding and at a stacked MLP leaf of
    Yi's widths cut into one 45M-element row a slice (as ``_SLICE`` cuts
    Yi's [L, 4096, 11008] leaves): there a library's reduction of a long
    row may split it across CTAs by the number of rows in the call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    _assert_same_update(*_whole_and_sliced(monkeypatch, shape, dtype, 0, "cuda", slice_elems))
