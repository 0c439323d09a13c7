"""A run of each cell with the timed path broken underneath must come out
not correct.  The runs skip the harness's look for a card and drive the
rest of a run (``run.run_cell``) on the CPU at the port's smoke sizes,
where every kernel runs its plain version; each fault is planted in the
program with ``monkeypatch``:

* serving: a token altered where the engine samples it; the cache left
  unwritten by the decode step (a step that leaves its state unchanged);
* training: an update that returns the parameters unchanged; half of each
  batch left out, the mean taken over the rest.

One sound run of each driver must come out correct, so that the faults'
failures are theirs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 1234


@pytest.fixture(autouse=True)
def _src_on_path(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "src"))


def _run(workload: str, seed: int = SEED):
    from portbench.run import run_cell

    _, outcome, line = run_cell(workload, seed, 0.0, False, device="cpu", smoke=True)
    return outcome, line


def _alter_a_token(monkeypatch):
    from repro_torch.serving import engine

    calls = {"n": 0}
    real = engine.ServeEngine._sample

    def altered(self, logits):
        out = real(self, logits)
        calls["n"] += 1
        if calls["n"] % 5 == 0:  # every request's token, at every fifth sampling
            out = (np.array(out) + 1) % self.cfg.vocab_size
        return out

    monkeypatch.setattr(engine.ServeEngine, "_sample", altered)


def _cache_unwritten(monkeypatch):
    from repro_torch.models import attention, mamba

    monkeypatch.setattr(attention, "write_at", lambda cache, pos, new: None)
    monkeypatch.setattr(mamba, "assign", lambda dst, src: None)


SERVE_FAULTS = {"token altered": _alter_a_token, "cache unwritten": _cache_unwritten}


@pytest.mark.parametrize("workload", ["yi-6b.chat", "mamba1-falcon-widths.chat"])
def test_a_sound_serving_run_is_correct(workload):
    outcome, line = _run(workload)
    assert line["correct"], line["checks"]
    assert outcome.attempted > 0 and outcome.failed == 0


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
@pytest.mark.parametrize("workload", ["yi-6b.chat", "mamba1-falcon-widths.chat"])
def test_a_broken_serving_path_is_not_correct(workload, fault, monkeypatch):
    SERVE_FAULTS[fault](monkeypatch)
    _, line = _run(workload)
    assert not line["correct"], line["checks"]


def _state_unchanged(monkeypatch):
    from repro_torch.training import optimizer, train_step

    def unchanged(grads, state, params, cfg):
        return params, {"m": state["m"], "v": state["v"], "step": state["step"] + 1}, {
            "grad_norm": optimizer.global_norm(grads), "lr": cfg.learning_rate}

    monkeypatch.setattr(train_step, "adamw_update", unchanged)


def _half_batch(monkeypatch):
    """The step's batch with its second half left out and the first half in
    its place, so the mean is taken over the first half alone (before the
    microbatches are cut: at the cell's size each of them is one row)."""
    import torch

    from repro_torch.training import train_step

    real = train_step.grad_and_metrics

    def half(cfg, params, batch, act_shard=None):
        n = next(iter(batch.values())).shape[0] // 2
        kept = {k: torch.cat([v[:n], v[:n]]) for k, v in batch.items()}
        return real(cfg, params, kept, act_shard)

    monkeypatch.setattr(train_step, "grad_and_metrics", half)


TRAIN_FAULTS = {"state unchanged": _state_unchanged, "half batch": _half_batch}


def test_a_sound_training_run_is_correct():
    outcome, line = _run("mamba1-falcon-widths.pretrain")
    assert line["correct"], line["checks"]
    assert outcome.attempted > 0 and outcome.failed == 0


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_a_broken_training_step_is_not_correct(fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    _, line = _run("mamba1-falcon-widths.pretrain")
    assert not line["correct"], line["checks"]
