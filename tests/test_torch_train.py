"""The port's training CLI, ``repro_torch.launch.train``, on the CPU.

``--arch yi_6b --smoke --device cpu --corpus-size 1`` (and ``--arch
falcon_mamba_7b``, the Mamba path): the loss falls by 0.3 within 12 steps,
as ``test_train.py::test_loss_decreases`` asks of the reference (there at
learning rate 1e-3 with 2 warmup steps; the CLI keeps the reference's 100
warmup steps, so it is given 3e-2, whose first 12 steps average 2e-3).  A run stopped at a checkpoint and resumed gives the
losses of the run that never stopped, bit for bit: the port resumes after
the checkpoint's step (the reference's loop applies that step's batch a
second time; ROADMAP, reference caveats).
"""

import pytest
import torch

from repro_torch.launch import train


def _run(*args):
    return train.main(["--arch", "yi_6b", "--smoke", "--device", "cpu", "--corpus-size", "1",
                       "--lr", "3e-2", "--log-every", "100", *args])


def test_loss_falls_by_0_3_within_12_steps():
    out = _run("--steps", "12")
    losses = [h["loss"] for h in out["history"]]
    assert out["steps"] == 12 and losses[-1] < losses[0] - 0.3, losses


def test_falcon_mamba_loss_falls_by_0_3_within_12_steps():
    """The Mamba path: every layer's selective scan differentiated through
    its custom VJP (``ops.mamba_scan_bwd``, the plain version here)."""
    out = train.main(["--arch", "falcon_mamba_7b", "--smoke", "--device", "cpu",
                      "--corpus-size", "1", "--lr", "3e-2", "--log-every", "100",
                      "--steps", "12"])
    losses = [h["loss"] for h in out["history"]]
    assert out["steps"] == 12 and losses[-1] < losses[0] - 0.3, losses


def test_layers_keeps_the_first_layers():
    out = train.main(["--arch", "falcon_mamba_7b", "--smoke", "--device", "cpu",
                      "--layers", "2", "--steps", "1", "--log-every", "100"])
    blocks = out["state"]["params"]["blocks"]["slot0"]["mixer"]["in_proj"]
    assert out["steps"] == 1 and blocks.shape[0] == 2


def test_a_resumed_run_gives_the_uninterrupted_losses(tmp_path):
    full = [h["loss"] for h in _run("--steps", "8")["history"]]
    d = str(tmp_path / "ck")
    first = _run("--steps", "5", "--ckpt-dir", d, "--ckpt-every", "2")
    assert [h["step"] for h in first["history"]] == list(range(5))
    from repro_torch.training import checkpoint as C

    assert C.committed_steps(d) == [2, 4]
    rest = _run("--steps", "8", "--ckpt-dir", d, "--ckpt-every", "2")
    assert [h["step"] for h in rest["history"]] == [5, 6, 7]
    assert [h["loss"] for h in first["history"]] + [h["loss"] for h in rest["history"]] == full


def test_the_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "yi_6b", "--smoke", "--steps", "1"])
