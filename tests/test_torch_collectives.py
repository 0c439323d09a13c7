"""The port's collectives (``repro_torch.core.collectives``) against the
reference's, case for case with ``tests/test_collectives.py`` and
``tests/test_collectives_meshes.py``.

The port's side runs 8 gloo ranks on the CPU (``repro_torch.launch.ranks``),
once for every case of every mesh (``torch_rank_jobs.run_cases``, a
module-scoped fixture); the reference's side runs under ``shard_map`` on the
8 virtual CPU devices of this process, on the same numpy inputs.  The
reference's output is converted whole (``np.asarray``) before it is indexed:
under jax 0.9.0 indexing a sharded output raises (see ROADMAP queue 3).
Tolerances are the reference tests': exact for the all-to-alls, the
broadcasts and the scatter; rtol 1e-5 for float32 sums and 2e-2 for
bfloat16 (in the scaled measure, see ``_check_sum``).
``test_hierarchical_psum_grad`` has no counterpart yet: the port's
collectives are not differentiable until the training slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from jax import shard_map
except ImportError:  # pinned 0.4.x spells it jax.experimental.shard_map
    from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import torch_rank_jobs as jobs
from repro.core import collectives as C
from repro_torch.kernels.ref import scaled_err
from repro_torch.launch import ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

RTOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def port():
    """Every case's port result, [8, ...] float32 by rank, and rank 0's
    traffic counts."""
    results = ranks.run("torch_rank_jobs:run_cases", jobs.WORLD, timeout_s=240)
    out = {}
    for name in jobs.CASES:
        got = {k: np.concatenate([r[name][k].numpy() for r in results])
               for k in ("port", "flat") if k in results[0][name]}
        got["traffic"] = results[0][name]["traffic"]
        got["input_unchanged"] = all(r[name]["input_unchanged"] for r in results)
        out[name] = got
    return out


def _reference(name):
    """The reference's result for case ``name`` on the 8 devices, whole."""
    (pods, lanes), make, dtype, kind, kw = jobs.CASES[name]
    mesh = jax.make_mesh((pods, lanes), ("pod", "lane"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    f = {
        "psum": lambda v: C.hierarchical_psum(v, "pod", "lane"),
        "a2a": lambda v: C.fulllane_all_to_all(v[0], "pod", "lane")[None],
        "fulllane_bcast": lambda v: C.fulllane_broadcast(v[0], "pod", "lane", **kw)[None],
        "kported_bcast":
            lambda v: C.kported_broadcast_ppermute(v[0], ("pod", "lane"), **kw)[None],
        "kported_scatter":
            lambda v: C.kported_scatter_ppermute(v[0], ("pod", "lane"), **kw)[None],
    }[kind]
    x = jnp.asarray(make(), getattr(jnp, dtype))
    out = jax.jit(shard_map(f, mesh=mesh, in_specs=P(("pod", "lane")),
                            out_specs=P(("pod", "lane"))))(x)
    return np.asarray(np.asarray(out), np.float32)


def _check_sum(port, name):
    """float32: rtol 1e-5 element by element, as the reference's tests.
    bfloat16: two sums of 8 values rounded in different orders (gloo adds
    in bf16 rank by rank, XLA in its own order) differ by an ulp of the
    partial sums, which is at the scale of the row, not of the element (a
    sum that cancels to ~0.5 differs by 0.0156 = an ulp at 4); so bf16 is
    held to 2e-2 in the port's scaled measure, ``ref.scaled_err``
    (``|got - want| <= 2e-2 * (|want| + rms of want's row)``)."""
    dtype = jobs.CASES[name][2]
    got = port[name]
    assert got["input_unchanged"]
    for want in (_reference(name), got["flat"]):
        if dtype == "bfloat16":
            assert scaled_err(torch.from_numpy(got["port"]), torch.from_numpy(want)) \
                <= RTOL[dtype]
        else:
            np.testing.assert_allclose(got["port"], want, rtol=RTOL[dtype])


def _check_exact(port, name, want=None):
    got = port[name]
    assert got["input_unchanged"]
    np.testing.assert_array_equal(got["port"], _reference(name))
    if "flat" in got:
        np.testing.assert_array_equal(got["port"], got["flat"])
    if want is not None:
        np.testing.assert_array_equal(got["port"], want)


# --- tests/test_collectives.py ---------------------------------------------


def test_hierarchical_psum(port):
    _check_sum(port, "hierarchical_psum")


def test_fulllane_all_to_all(port):
    _check_exact(port, "fulllane_all_to_all")


def test_fulllane_broadcast(port):
    _check_exact(port, "fulllane_broadcast",
                 np.broadcast_to(np.arange(24, dtype=np.float32), (8, 24)))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_kported_broadcast_ppermute(port, k):
    _check_exact(port, f"kported_broadcast_k{k}",
                 np.broadcast_to(np.arange(5, dtype=np.float32) + 1, (8, 5)))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_kported_scatter_ppermute(port, k):
    _check_exact(port, f"kported_scatter_k{k}", jobs._scatter_input(0)[0])


def test_hierarchical_psum_nondivisible_pad(port):
    _check_sum(port, "psum_pad")


# --- tests/test_collectives_meshes.py --------------------------------------


@pytest.mark.parametrize("shape", ["2x4", "4x2", "8x1", "1x8"])
def test_hierarchical_psum_all_factorizations(port, shape):
    _check_sum(port, f"psum_mesh_{shape}")


@pytest.mark.parametrize("shape", ["2x4", "4x2", "8x1", "1x8"])
def test_fulllane_a2a_all_factorizations(port, shape):
    _check_exact(port, f"a2a_mesh_{shape}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hierarchical_psum_dtypes(port, dtype):
    _check_sum(port, f"psum_{dtype}")


def test_kported_broadcast_nonzero_root(port):
    _check_exact(port, "kported_broadcast_root5",
                 np.broadcast_to(np.arange(4, dtype=np.float32) + 1, (8, 4)))


# --- beyond the reference's tests --------------------------------------------


def test_fulllane_broadcast_root_on_second_pod(port):
    _check_exact(port, "fulllane_broadcast_root1",
                 np.broadcast_to(np.arange(24, dtype=np.float32), (8, 24)))


def test_kported_scatter_nonzero_root(port):
    _check_exact(port, "kported_scatter_root5", jobs._scatter_input(5)[5])


def test_traffic_counts_follow_the_paper(port):
    """Per rank on 2 pods x 4 lanes (P = 8, No = 2, Ni = 4), under the direct
    algorithm of each op.  Alltoall of 8 blocks of 12 bytes: the flat one
    sends P - 1 = 7 messages, P - Ni = 4 of them across pods (48 bytes); the
    full-lane one sends Ni - 1 = 3 on the pod and No - 1 = 1 combined
    message across pods, with the same 48 bytes.  Sum of 13 float32 (padded
    to 16 on the lane axis): the flat all-reduce sends 2 x 4 messages of 6
    bytes across pods (48 bytes), the hierarchical one 2 x 1 of 8 (16
    bytes)."""
    a2a = port["fulllane_all_to_all"]["traffic"]
    zero = {"staged_bytes": 0}
    assert a2a["all_to_all/world"] == {"calls": 1, "messages": 7, "bytes": 84,
                                       "cross_pod_messages": 4, "cross_pod_bytes": 48, **zero}
    assert a2a["all_to_all/lane"] == {"calls": 1, "messages": 3, "bytes": 72,
                                      "cross_pod_messages": 0, "cross_pod_bytes": 0, **zero}
    assert a2a["all_to_all/pod"] == {"calls": 1, "messages": 1, "bytes": 48,
                                     "cross_pod_messages": 1, "cross_pod_bytes": 48, **zero}
    psum = port["psum_mesh_2x4"]["traffic"]
    assert psum["all_reduce/world"]["cross_pod_messages"] == 8
    assert psum["all_reduce/world"]["cross_pod_bytes"] == 8 * (52 // 8)
    assert psum["all_reduce/pod"]["cross_pod_messages"] == 2
    assert psum["all_reduce/pod"]["cross_pod_bytes"] == 2 * 16 // 2
    assert psum["reduce_scatter/lane"]["cross_pod_bytes"] == 0
    assert psum["all_gather/lane"]["cross_pod_bytes"] == 0
