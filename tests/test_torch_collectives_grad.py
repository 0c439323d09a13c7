"""The gradients of the port's collectives (``repro_torch.core.collectives``)
against ``jax.grad`` of the reference's.

The port's side runs 8 gloo ranks on the CPU once for every case
(``torch_rank_jobs.run_grad_cases``, a module-scoped fixture): each rank
differentiates its loss ``sum(c * f(x))``, ``c`` a seeded cotangent, so its
gradient is f's adjoint applied to ``c``, at the cotangent's scale.
The reference's side differentiates the same loss under ``shard_map(...,
check_vma=False)`` on the 8 virtual CPU devices of this process, on the same
numpy inputs; that is the port's convention, the gradient of the sum of
every rank's loss.  The reference's output is converted whole
(``np.asarray``) before it is indexed (ROADMAP, reference caveats).

Tolerances: float32 within rtol 1e-5 (the permutations' gradients are
exact in both, the sums' round in another order); bfloat16 within 2e-2 in
``ref.scaled_err``, as the forward's bf16 sums are held
(``tests/test_torch_collectives.py``).  ``test_check_vma_caveat`` pins the
reference's default convention, under which the two equal sums have
gradients a factor of the lane count apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_rank_jobs as jobs
from repro.core import collectives as C
from repro_torch.kernels.ref import scaled_err
from repro_torch.launch import ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

RTOL_F32 = 1e-5
TOL_BF16 = 2e-2
SPEC = P(("pod", "lane"))


@pytest.fixture(scope="module")
def port():
    """Every case's port gradient, [8, ...] float32 by rank, with its dtype,
    the output's shape and whether every rank's input was left unchanged."""
    results = ranks.run("torch_rank_jobs:run_grad_cases", jobs.WORLD, timeout_s=240)
    return {name: {"grad": np.concatenate([r[name]["grad"].numpy() for r in results]),
                   "dtypes": {r[name]["dtype"] for r in results},
                   "out_shape": tuple(results[0][name]["out_shape"]),
                   "input_unchanged": all(r[name]["input_unchanged"] for r in results)}
            for name in jobs.GRAD_CASES}


def _collective(fn: str, kw: dict):
    """The reference's collective ``fn`` on one device's block."""
    f = getattr(C, fn)
    if fn.startswith("kported"):
        return lambda v: f(v, ("pod", "lane"), **kw)
    return lambda v: f(v, "pod", "lane", **kw)


def _reference_grad(name: str, out_shape: tuple, *, check_vma: bool = False) -> np.ndarray:
    """``jax.grad`` of every device's ``sum(c * f(x))`` for case ``name``,
    [8, ...] float32, whole."""
    (pods, lanes), make, dtype, fn, kw = jobs.GRAD_CASES[name]
    mesh = jax.make_mesh((pods, lanes), ("pod", "lane"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    f = _collective(fn, kw)

    def per_device(v, c):
        return jax.grad(lambda v: (c[0] * f(v[0])).sum())(v)

    x = jnp.asarray(make(), getattr(jnp, dtype))
    c = jnp.asarray(jobs.grad_cotangent(name, out_shape), getattr(jnp, dtype))
    g = jax.jit(jax.shard_map(per_device, mesh=mesh, in_specs=(SPEC, SPEC), out_specs=SPEC,
                              check_vma=check_vma))(x, c)
    return np.asarray(np.asarray(g), np.float32)


@pytest.mark.parametrize("name", list(jobs.GRAD_CASES))
def test_gradient_matches_jax_grad(port, name):
    dtype = jobs.GRAD_CASES[name][2]
    got = port[name]
    assert got["input_unchanged"]
    assert got["dtypes"] == {dtype}  # the cotangent keeps the input's dtype
    want = _reference_grad(name, got["out_shape"])
    assert got["grad"].shape == want.shape
    if dtype == "bfloat16":
        assert scaled_err(torch.from_numpy(got["grad"]), torch.from_numpy(want)) <= TOL_BF16
    else:
        np.testing.assert_allclose(got["grad"], want, rtol=RTOL_F32, atol=RTOL_F32 * np.abs(
            want).max())


@pytest.mark.parametrize("name", ["kported_broadcast_k2", "kported_scatter_root5",
                                  "fulllane_broadcast_root1_float32"])
def test_only_the_root_gets_a_gradient(port, name):
    """A broadcast's or scatter's non-root inputs are overwritten: their
    gradient is zero, and the root's carries every rank's cotangent."""
    (pods, lanes), _, _, fn, kw = jobs.GRAD_CASES[name]
    g = port[name]["grad"]
    if fn == "fulllane_broadcast":
        roots = [kw["root"] * lanes + j for j in range(lanes)]
    else:
        roots = [kw["root"]]
    for r in range(jobs.WORLD):
        assert np.any(g[r] != 0) if r in roots else not np.any(g[r]), r


def test_check_vma_caveat():
    """The reference's default, ``check_vma=True``, transposes its
    collectives otherwise: ``hierarchical_psum``'s gradient is ``lanes``
    times ``flat_psum``'s, though the two sums are equal.  Under
    ``check_vma=False`` (the port's convention) they agree."""
    lanes = 4
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    mesh = jax.make_mesh((2, lanes), ("pod", "lane"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def grad_of(f, check_vma):
        loss = lambda v: (f(v * v, "pod", "lane") ** 2).sum()  # noqa: E731
        return np.asarray(np.asarray(jax.jit(jax.shard_map(
            jax.grad(loss), mesh=mesh, in_specs=SPEC, out_specs=SPEC,
            check_vma=check_vma))(x)))

    hier, flat = grad_of(C.hierarchical_psum, True), grad_of(C.flat_psum, True)
    np.testing.assert_allclose(hier, lanes * flat, rtol=1e-5)
    np.testing.assert_allclose(grad_of(C.hierarchical_psum, False),
                               grad_of(C.flat_psum, False), rtol=1e-5)
