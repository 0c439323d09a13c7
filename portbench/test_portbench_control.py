"""The control: the plain reference put in the program's place, computed
in fp8 (every weight product in e4m3, a backward's incoming gradient in
e5m2), the step below the bf16 that the configurations state.

On the card, at each cell's own size and on three seeds, a run with the
control judged in the program's place must come out not correct (for
training, one of the three numbers over its limit is enough), and so must
a training run with half of each batch left out of the program's step.
Those tests decide inside themselves whether there is a card and skip
without one.

On the CPU, at the port's smoke sizes (3 or 4 layers of width 64, a few
dozen tokens checked), the limits set at the cells' size do not transfer
(the control's widest gap there reads 0.05 to 0.3), so the CPU test holds
the control's reading to at least three times the program's on the same
seeds: the control path itself runs and parts from the program.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CARD_SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
SERVING = ["yi-6b.chat", "yi-6b.longprompt", "mamba1-falcon-widths.chat"]
TRAINING = ["mamba1-falcon-widths.pretrain"]
NUMBERS = ("loss_gap", "first_grad_gap", "change_gap")


@pytest.fixture(autouse=True)
def _src_on_path(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "src"))


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


@pytest.mark.parametrize("workload", SERVING)
def test_the_control_is_not_correct_at_the_cells_size(workload):
    _card()
    from portbench import harness
    from portbench.run import run_cell

    limit = harness.checks_file(workload)["served_logit_gap"]["limit"]
    for seed in CARD_SEEDS:
        _, outcome, line = run_cell(workload, seed, 1.0, False, control="fp8")
        print(json.dumps({"cell": workload, "seed": seed, "control": "fp8", **line["checks"],
                          "program_gap": outcome.readings["gap"]}), flush=True)
        assert not line["correct"], (seed, limit, outcome.readings)


@pytest.mark.parametrize("planted", ["fp8 control", "half batch"])
@pytest.mark.parametrize("workload", TRAINING)
def test_the_training_control_and_half_batch_are_not_correct_at_the_cells_size(workload, planted,
                                                                              monkeypatch):
    _card()
    from portbench.run import run_cell
    from portbench.test_portbench_faults import _half_batch

    if planted == "half batch":
        _half_batch(monkeypatch)
    for seed in CARD_SEEDS:
        _, outcome, line = run_cell(workload, seed, 1.0, False,
                                    control="fp8" if planted == "fp8 control" else None)
        print(json.dumps({"cell": workload, "seed": seed, "control": planted, **line["checks"],
                          "program": {n: outcome.readings[n] for n in NUMBERS}}), flush=True)
        assert not line["correct"], seed


@pytest.mark.parametrize("workload", ["yi-6b.chat", "mamba1-falcon-widths.chat"])
def test_the_control_parts_from_the_program_at_smoke_size(workload):
    from portbench.run import run_cell

    for seed in (11, 2**31 + 3):
        _, outcome, _ = run_cell(workload, seed, 0.0, False, device="cpu", smoke=True,
                                 control="fp8")
        r = outcome.readings
        assert r["control_gap"] > 3 * r["gap"] and r["control_gap"] > 0.03, r


def test_the_training_control_parts_from_the_program_at_smoke_size():
    from portbench.run import run_cell

    _, outcome, line = run_cell("mamba1-falcon-widths.pretrain", 2**31 + 77, 0.0, False,
                                device="cpu", smoke=True, control="fp8")
    r = outcome.readings
    assert max(r["control"][n] / max(r[n], 1e-12) for n in NUMBERS) > 3, r
    assert line["checks"] and all(c["value"] == r["control"][n]
                                  for n, c in line["checks"].items())
