"""The rank launcher (``repro_torch.launch.ranks``) and the EP-dispatch entry
point (``repro_torch.launch.ep_dispatch``) on the CPU, over gloo.

A rank that fails or hangs must never hang the caller: the launcher kills
the others and raises with the failing rank's output.  The dispatch, the
counterpart of ``examples/moe_ep_demo.py``, must route the same rows with
the flat and the full-lane alltoall, equal to its numpy oracle, with the
messages the paper counts.
"""

import time
from pathlib import Path

import pytest

from repro_torch.kernels import ops
from repro_torch.launch import ep_dispatch, ranks


def test_a_failing_rank_stops_the_run_with_its_error():
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailed, match="planted failure on rank 1"):
        ranks.run("torch_rank_jobs:fail_on_rank", 3, kwargs={"rank": 1}, timeout_s=120)
    assert time.monotonic() - t0 < 100  # the others, waiting in a barrier, were killed


@pytest.mark.parametrize("how,attempt", [("raise", a) for a in range(10)]
                         + [("kill", a) for a in range(3)])
def test_the_failing_rank_is_named_first(how, attempt):
    """The bystanders, waiting in a barrier, fail as soon as the failing
    rank tears its connections down, and often exit before it: the error
    must still name the rank that failed, first, every time.  A rank killed
    by a signal writes no record of its own; its bystanders do, and it must
    still come first."""
    with pytest.raises(ranks.RankFailed) as exc:
        ranks.run("torch_rank_jobs:fail_on_rank", 3, kwargs={"rank": 1, "how": how},
                  timeout_s=120)
    msg = str(exc.value)
    want = {"raise": "rank 1 of 3 exited 1: RuntimeError: planted failure on rank 1",
            "kill": "rank 1 of 3 killed by SIGKILL\n"}[how]
    assert msg.startswith(want), msg[:3000]
    assert "--- bystanders, after the rank above ---" in msg


def test_ranks_past_the_deadline_are_killed():
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailed, match="still running at the deadline"):
        ranks.run("torch_rank_jobs:sleep", 2, kwargs={"seconds": 600}, timeout_s=10)
    assert time.monotonic() - t0 < 40


@pytest.mark.parametrize("pods,lanes,dtype", [(2, 4, "bfloat16"), (4, 2, "float32")])
def test_ep_dispatch_flat_equals_fulllane_and_the_oracle(capsys, pods, lanes, dtype):
    results = ep_dispatch.main(["--device", "cpu", "--pods", str(pods), "--lanes",
                                str(lanes), "--tokens", "32", "--top-k", "2", "--d-model",
                                "24", "--dtype", dtype])
    P = pods * lanes
    assert [r["rank"] for r in results] == list(range(P))
    size = 2 if dtype == "bfloat16" else 4
    for r in results:
        assert r["flat_equals_fulllane"] and r["flat_equals_oracle"]
        assert r["fulllane_equals_oracle"]
        assert all(r[k] for k in ep_dispatch.CHECKS) and r["grad_dtype"] == dtype
        # the backward of a full-lane alltoall is a second one
        assert r["traffic"]["fulllane with backward"]["all_to_all/pod"]["calls"] == 2
        assert r["rows_per_destination"] == 32 * 2 // P
        block = r["rows_per_destination"] * 24 * size
        flat = r["traffic"]["flat"]["all_to_all/world"]
        full = r["traffic"]["fulllane"]
        assert (flat["messages"], flat["cross_pod_messages"]) == (P - 1, P - lanes)
        assert full["all_to_all/lane"]["cross_pod_messages"] == 0
        assert full["all_to_all/pod"]["cross_pod_messages"] == pods - 1
        # the same cross-pod bytes, in No - 1 combined messages
        assert full["all_to_all/pod"]["cross_pod_bytes"] == flat["cross_pod_bytes"] \
            == (P - lanes) * block
    out = capsys.readouterr().out
    assert f"{pods} pods x {lanes} lanes" in out
    assert "transport gloo, tensors on cpu" in out


def test_chip_smoke_collectives_job_on_cpu(monkeypatch):
    """Phase 7 of ``chip_smoke.py``, its checks included, in 8 gloo ranks at
    a small size on the CPU (where no kernel launches: CPU calls run the
    plain versions)."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    results = ranks.run("chip_smoke:collectives_job", 8, timeout_s=120, kwargs=dict(
        pods=2, lanes=4, tokens=32, top_k=2, d_model=16, bucket=4096, device="cpu"))
    for r in results:
        assert r["launches"] == dict.fromkeys(ops.launch_counts(), 0)  # every kernel: none
        assert r["dispatch"]["flat_equals_fulllane"]
        assert sorted(r["seconds"]) == sorted(
            ["hierarchical_psum 4096", "flat_psum 4096", "hierarchical_psum 4097",
             "flat_psum 4097", "fulllane_broadcast", "kported_broadcast k=1",
             "kported_broadcast k=2", "kported_broadcast k=3", "kported_scatter k=2",
             *(f"{name} backward" for name in (
                 "hierarchical_psum 4096", "flat_psum 4096", "hierarchical_psum 4097",
                 "flat_psum 4097", "fulllane_broadcast root=1", "kported_broadcast k=1",
                 "kported_broadcast k=2", "kported_broadcast k=3",
                 "kported_scatter k=2 root=5"))])
        assert sorted(r["backward"]) == sorted(
            n.removesuffix(" backward") for n in r["seconds"] if n.endswith(" backward"))
