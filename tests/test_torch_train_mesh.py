"""The training CLI over a mesh: ``repro_torch.launch.train --smoke --mesh
2,2,2 --device cpu`` (8 gloo ranks) for both backends.

``--backend xla`` runs the sharded step (FSDP and TP parameters, ZeRO-1
moments), ``fulllane`` the shard_map step with TP and the hierarchical
gradient sum.  Each gives the one-card CLI's losses for the same seed
(rtol 2e-3 over 6 steps at learning rate 3e-2: the smoke config is
bfloat16, and the steps' sums run in other orders).  A meshed run stopped
at its checkpoint and resumed gives
the losses of one that never stopped, bit for bit, for each backend; a
one-card checkpoint resumes under the mesh and a meshed one on one card,
each continuing as the run it resumes into would (rtol 2e-3); a 2-D
``--mesh 4,2`` (data, model; no pod axis) gives the one-card losses too.
The resumed, crossed and 2-D runs share one 8-rank job
(``torch_rank_jobs.cli_runs``).
"""

import numpy as np
import pytest

from repro_torch.launch import ranks, train
from repro_torch.training import checkpoint as C

ARGS = ["--arch", "yi_6b", "--smoke", "--device", "cpu", "--corpus-size", "1", "--lr", "3e-2",
        "--log-every", "100"]
MESH = ["--mesh", "2,2,2"]


def _losses(out) -> list:
    return [h["loss"] for h in out["history"]]


@pytest.mark.parametrize("backend", ["xla", "fulllane"])
def test_meshed_cli_gives_the_one_card_losses(backend):
    one = train.main([*ARGS, "--backend", backend, "--steps", "6"])
    meshed = train.main([*ARGS, *MESH, "--backend", backend, "--steps", "6"])
    assert "state" not in meshed and meshed["steps"] == 6
    np.testing.assert_allclose(_losses(meshed), _losses(one), rtol=2e-3)
    assert _losses(meshed)[-1] < _losses(meshed)[0]


def test_meshed_checkpoints_resume_and_cross_to_one_card(tmp_path):
    one_card_ck = str(tmp_path / "one")
    first = train.main([*ARGS, "--steps", "5", "--ckpt-dir", one_card_ck, "--ckpt-every", "2"])
    assert C.committed_steps(one_card_ck) == [2, 4]
    runs = []
    for backend in ("xla", "fulllane"):
        d = str(tmp_path / backend)
        runs += [[*ARGS, *MESH, "--backend", backend, "--steps", "8"],
                 [*ARGS, *MESH, "--backend", backend, "--steps", "5", "--ckpt-dir", d,
                  "--ckpt-every", "2"],
                 [*ARGS, *MESH, "--backend", backend, "--steps", "8", "--ckpt-dir", d,
                  "--ckpt-every", "2"]]
    runs.append([*ARGS, *MESH, "--steps", "8", "--ckpt-dir", one_card_ck, "--ckpt-every", "2"])
    meshed_ck = str(tmp_path / "meshed")
    runs.append([*ARGS, *MESH, "--steps", "5", "--ckpt-dir", meshed_ck, "--ckpt-every", "2"])
    runs += [[*ARGS, "--mesh", "4,2", "--backend", b, "--steps", "3"] for b in ("xla", "fulllane")]
    got = ranks.run("torch_rank_jobs:cli_runs", 8, kwargs={"runs": runs}, timeout_s=400)[0]
    for i, backend in enumerate(("xla", "fulllane")):
        whole, head, rest = got[3 * i:3 * i + 3]
        assert [h["step"] for h in rest["history"]] == [5, 6, 7], backend
        assert _losses(head) + _losses(rest) == _losses(whole), backend
        assert C.committed_steps(str(tmp_path / backend)) == [2, 4, 6], backend
    # the one-card checkpoint (step 4) resumed under the mesh
    xla_whole, crossed = got[0], got[6]
    assert [h["step"] for h in crossed["history"]] == [5, 6, 7]
    np.testing.assert_allclose(_losses(crossed), _losses(xla_whole)[5:], rtol=2e-3)
    # the meshed checkpoint (step 4) resumed on one card
    assert C.committed_steps(meshed_ck) == [2, 4]
    back = train.main([*ARGS, "--steps", "8", "--ckpt-dir", meshed_ck])
    one_whole = train.main([*ARGS, "--steps", "8"])
    assert [h["step"] for h in back["history"]] == [5, 6, 7]
    np.testing.assert_allclose(_losses(back), _losses(one_whole)[5:], rtol=2e-3)
    assert _losses(first) == _losses(one_whole)[:5]
    # a 2-D mesh, (data 4, model 2): no pod axis
    for backend, two_d in zip(("xla", "fulllane"), got[8:10]):
        np.testing.assert_allclose(_losses(two_d), _losses(one_whole)[:3], rtol=2e-3,
                                   err_msg=backend)
