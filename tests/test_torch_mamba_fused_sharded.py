"""The fused selective scan on DTensors: ``ops.mamba_scan_fused`` /
``ops.mamba_scan_fused_bwd`` and the custom VJP
``models.mamba.selective_scan_fused`` shard by shard (``ops.on_shards``)
over a (pod 2, data 2, model 2) mesh of 8 gloo ranks on the CPU
(``torch_rank_jobs.fused_scan_ranks``), against the same calls on whole
tensors.  A shard's rows and channels are computed alone, so y, h_last,
gdt, gx and gh0 agree bit for bit; gB and gC are sums over the channels
and gA over the batch rows, each rank's share ``Partial`` over the mesh
dims that shard them, summed by DTensor: within 1e-6 of max(|want|, 1)
(float32, another order)."""

import pytest

import torch_rank_jobs as jobs
from repro_torch.launch import ranks

SUM_TOL = 1e-6
GRADS = ("dt", "x", "B", "C", "A", "h0")


@pytest.fixture(scope="module")
def run():
    return ranks.run("torch_rank_jobs:fused_scan_ranks", jobs.WORLD, timeout_s=240)


def test_forward_on_shards_is_the_whole_call(run):
    for r in run:
        assert r["forward"] == [0.0, 0.0]


@pytest.mark.parametrize("i,name", list(enumerate(GRADS)))
def test_backward_on_shards_is_the_whole_call(run, i, name):
    """Each gradient of the dispatcher on shards; the sums over shards
    (gB, gC, gA) within ``SUM_TOL``."""
    for r in run:
        assert r["backward"][i] <= (SUM_TOL if name in ("B", "C", "A") else 0.0), (name, r)


@pytest.mark.parametrize("i,name", list(enumerate(GRADS)))
def test_custom_vjp_on_shards_gives_the_one_tensor_gradients(run, i, name):
    for r in run:
        assert r["vjp"][i] <= (SUM_TOL if name in ("B", "C", "A") else 0.0), (name, r)


def test_gradient_placements(run):
    """gB and gC come back ``Partial`` over ``model`` (each rank sums its
    channels) and their rows' shards elsewhere; gA ``Partial`` over the
    data-parallel dims and its channels' shard over ``model``."""
    want = ["(Shard(dim=0), Shard(dim=0), Shard(dim=2))"] * 2 + [
        "(Shard(dim=0), Shard(dim=0), Partial(sum))"] * 2 + [
        "(Partial(sum), Partial(sum), Shard(dim=0))", "(Shard(dim=0), Shard(dim=0), Shard(dim=1))"]
    for r in run:
        assert r["backward_placements"] == want
