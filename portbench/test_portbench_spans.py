"""CPU tests of the readers of the program's own spans (``portbench/spans.py``
and the four metrics that read them): each returns None on a CPU smoke
record, where the spans have no device time, and the right value on a
hand-built slice with hand-built tracer records."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, spans, traffic
from portbench import trace as tr

ROOT = Path(__file__).resolve().parents[1]
READERS = {"decode_mixer_core_device_ms.chat": "yi-6b.chat",
           "prefill_mixer_core_device_ms.longprompt": "yi-6b.longprompt",
           "grad_accumulate_device_ms.train": "mamba1-falcon-widths.pretrain",
           "optimizer_device_ms.train": "mamba1-falcon-widths.pretrain"}


@pytest.fixture(autouse=True)
def _src_on_path(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    from repro_torch.obs.trace import TRACER

    TRACER.disable()
    TRACER.clear()
    yield
    TRACER.clear()


def test_the_new_metrics_are_declared_for_their_cells():
    spec = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name, cell in READERS.items():
        assert cell in spec[name]["workloads"] and spec[name]["source"] == "device_trace"
        assert name in {m["name"] for m in harness.layer_metrics(cell)}


def _profiled_on_the_cpu(fn, monkeypatch):
    """``trace.profiled`` on the CPU (no device to wait for): a slice with
    host operators and the tracer's ranges, and no device records."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return tr.profiled(fn)


def test_readers_return_none_on_a_cpu_smoke_serving_record(monkeypatch):
    from portbench.drivers import serve_waves
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine

    cfg = get_smoke_config("yi_6b")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tf = json.loads((ROOT / "portbench" / "traffic" / "chat.json").read_text())
    tf.update(tf["smoke"])
    eng = ServeEngine(cfg, params, num_slots=tf["slots"], capacity=tf["capacity"],
                      device="cpu")
    wave = next(traffic.waves(tf, cfg.vocab_size, 2**31 + 5))
    traced, sl = _profiled_on_the_cpu(lambda: serve_waves.serve_wave(eng, wave, tf["capacity"]),
                                      monkeypatch)
    rec = {"slice": sl, "traced": traced, "window": [traced]}
    v = spans.view(sl)  # the clocks meet through engine.step on the CPU too
    assert v is not None and len(v.named("engine.step")) == traced["steps"]
    assert len(v.under("mixer.core", "engine.step")) == traced["steps"] * cfg.num_layers
    assert v.device_intervals(v.named("mixer.core")) is None  # no device time here
    for name in READERS:
        assert harness.reader(name).read(rec) is None


def test_readers_return_none_on_a_cpu_smoke_training_record(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    cfg = get_smoke_config("falcon_mamba_7b")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    oc = OptConfig()
    step = make_train_step(cfg, oc)
    toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, sl = _profiled_on_the_cpu(lambda: step(params, init_opt_state(params, oc), batch),
                                 monkeypatch)
    v = spans.view(sl)
    assert v is not None and len(v.named("train.step")) == 1
    assert len(v.named("train.accumulate")) == cfg.parallel.microbatches
    rec = {"slice": sl, "traced_steps": 1}
    for name in READERS:
        assert harness.reader(name).read(rec) is None


def test_a_program_without_spans_gives_nothing(monkeypatch):
    sl = tr.Slice(records=[("k", 0.0, 10.0)], spans=[], host_ops=[("aten::mm", 0.0, 5.0)],
                  start_us=0.0, end_us=20.0)
    monkeypatch.setattr(spans, "tracer_records", lambda: [])
    assert spans.view(sl) is None
    for name in READERS:
        assert harness.reader(name).read({"slice": sl}) is None


def _rec(name, sid, parent, ts, dur=10, dev=None, **args):
    r = {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": 1, "tid": 1, "sid": sid,
         "parent": parent, "depth": 0, "args": args}
    if dev is not None:
        r["dev_ts"], r["dev_dur"] = float(dev[0]), float(dev[1] - dev[0])
    return r


def _serving_slice(late=0.0):
    """Two decode steps (each two layers' ``mixer.core`` markers under
    ``decode.step``) and a prefill, on the profiler's clock; the tracer's
    clock runs 10,000 us ahead, and an earlier step lies outside the slice.
    ``late``: how much later than the tracer's the profiler holds the
    second step's host range (its own overhead at that one span)."""
    D = 10_000.0
    host = [("repro.engine.admit", 20.0, 95.0), ("repro.engine.step", 100.0, 400.0),
            ("repro.engine.step", 500.0 + late, 800.0)]
    recs = [
        _rec("engine.step", 0, None, 5_000),  # an earlier wave's: not in the slice
        _rec("engine.replay", 1, 0, 5_001, dev=(5_010, 5_090)),
        _rec("mixer.core", 2, 1, 5_002, dev=(5_020, 5_080), layer=0),
        _rec("engine.admit", 10, None, 20 + D),
        _rec("engine.prefill", 11, 10, 25 + D, dev=(30 + D, 80 + D)),
        _rec("mixer.core", 12, 11, 26 + D, dev=(30 + D, 60 + D), layer=0),
    ]
    sid = 20
    for t0 in (100.0, 500.0):
        step, replay, graph = sid, sid + 1, sid + 2
        recs += [_rec("engine.step", step, None, t0 + D, 300),
                 _rec("engine.replay", replay, step, t0 + 5 + D, dev=(t0 + 40 + D, t0 + 210 + D)),
                 _rec("decode.step", graph, replay, t0 + 6 + D,
                      dev=(t0 + 45 + D, t0 + 205 + D), graph=True),
                 _rec("mixer.core", sid + 3, graph, t0 + 6 + D,
                      dev=(t0 + 50 + D, t0 + 100 + D), layer=0, graph=True),
                 _rec("mixer.core", sid + 4, graph, t0 + 6 + D,
                      dev=(t0 + 150 + D, t0 + 200 + D), layer=1, graph=True)]
        sid += 5
    records = [
        ("flash", 35.0, 55.0),  # the prefill's core: 20
        ("fill", 58.0, 70.0),  # mid 64: past the prefill's core
        ("gemm", 120.0, 150.0),  # mid 135: before step 1's first core
        ("rope", 150.0, 160.0),  # 10
        ("copy", 160.0, 190.0),  # 30
        ("straddle", 190.0, 230.0),  # mid 210: past the core's end at 200
        ("attend", 255.0, 305.0),  # 50, counted whole past the core's end
        ("inside", 260.0, 280.0),  # overlaps attend: no more busy time
        ("a", 550.0, 600.0),  # step 2: 50
        ("b", 640.0, 660.0),  # mid 650, the second core's start: 20
        ("c", 700.0, 720.0),  # mid 710: after step 2's cores
    ]
    return tr.Slice(records=records, spans=[], host_ops=host, start_us=0.0, end_us=1000.0), recs


@pytest.mark.parametrize("name,want", [
    ("decode_mixer_core_device_ms.chat", (90.0 + 70.0) / 2 / 1e3),
    ("prefill_mixer_core_device_ms.longprompt", 20.0 / 1e3),
])
def test_one_offset_from_the_median_of_the_shared_spans(name, want, monkeypatch):
    # the profiler holds one of three shared spans 30 us late: the median
    # offset, that of the other two, places every interval as before
    sl, recs = _serving_slice(late=30.0)
    sl.host_ops.append(("repro.engine.step", 900.0, 950.0))
    recs = recs + [_rec("engine.step", 40, None, 900.0 + 10_000.0, 50)]
    monkeypatch.setattr(spans, "tracer_records", lambda: recs)
    assert spans.view(sl).offset == pytest.approx(-10_000.0)
    # a third step, with no cores, joins the decode reader's count of steps
    per = 2 / 3 if name.startswith("decode") else 1.0
    assert harness.reader(name).read({"slice": sl}) == pytest.approx(want * per)


def _training_slice():
    """One train step: two microbatches' accumulations and the optimizer;
    the tracer's clock 20,000 us ahead."""
    D = 20_000.0
    host = [("repro.train.step", 0.0, 900.0)]
    recs = [_rec("train.step", 0, None, D, 900),
            _rec("train.microbatch", 1, 0, 10 + D, dev=(10 + D, 400 + D), i=0),
            _rec("train.accumulate", 2, 1, 290 + D, dev=(300 + D, 400 + D)),
            _rec("train.microbatch", 3, 0, 410 + D, dev=(410 + D, 750 + D), i=1),
            _rec("train.accumulate", 4, 3, 690 + D, dev=(700 + D, 750 + D)),
            _rec("train.optimizer", 5, 0, 790 + D, dev=(800 + D, 890 + D))]
    records = [("bwd", 200.0, 310.0),  # mid 255: the backward's
               ("add", 300.0, 400.0), ("add", 700.0, 740.0),  # 100 + 40
               ("adam1", 800.0, 850.0), ("adam2", 850.0, 880.0)]  # 50 + 30
    return tr.Slice(records=records, spans=[], host_ops=host, start_us=0.0, end_us=900.0), recs


@pytest.mark.parametrize("name,want", [
    ("decode_mixer_core_device_ms.chat", (90.0 + 70.0) / 2 / 1e3),
    ("prefill_mixer_core_device_ms.longprompt", 20.0 / 1e3),
])
def test_serving_readers_on_a_hand_built_slice(name, want, monkeypatch):
    sl, recs = _serving_slice()
    monkeypatch.setattr(spans, "tracer_records", lambda: recs)
    v = spans.view(sl)
    assert v.offset == pytest.approx(-10_000.0)
    assert len(v.named("engine.step")) == 2  # the earlier wave's left out
    assert harness.reader(name).read({"slice": sl}) == pytest.approx(want)
    no_time = [dict(r, dev_ts=None) if r["name"] == "mixer.core" else r for r in recs]
    monkeypatch.setattr(spans, "tracer_records", lambda: no_time)
    assert harness.reader(name).read({"slice": sl}) is None


@pytest.mark.parametrize("name,want", [
    ("grad_accumulate_device_ms.train", 140.0 / 1e3),
    ("optimizer_device_ms.train", 80.0 / 1e3),
])
def test_training_readers_on_a_hand_built_slice(name, want, monkeypatch):
    sl, recs = _training_slice()
    monkeypatch.setattr(spans, "tracer_records", lambda: recs)
    assert spans.view(sl).offset == pytest.approx(-20_000.0)
    assert harness.reader(name).read({"slice": sl}) == pytest.approx(want)
    shifted = [dict(r, dev_ts=r["dev_ts"] + 1e4) if "dev_ts" in r else r for r in recs]
    monkeypatch.setattr(spans, "tracer_records", lambda: shifted)  # intervals off the slice
    assert harness.reader(name).read({"slice": sl}) == 0.0


def test_busy_in_takes_records_by_their_midpoint_and_unions_them():
    sl = tr.Slice(records=[("a", 0.0, 10.0), ("b", 5.0, 30.0), ("c", 40.0, 50.0),
                           ("d", 90.0, 130.0)],
                  spans=[], host_ops=[], start_us=0.0, end_us=200.0)
    # b's midpoint 17.5 lies in the first interval, c's 45 in none, d's 110
    # in the second (which a nested third does not shorten)
    assert spans.busy_in(sl, [(0.0, 20.0), (100.0, 120.0), (101.0, 102.0)]) == 70.0
    assert spans.busy_in(sl, []) == 0.0
    assert np.isclose(spans.busy_in(sl, [(0.0, 200.0)]), sl.busy_us())
