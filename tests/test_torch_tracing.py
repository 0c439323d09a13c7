"""The port's tracer (``repro_torch.obs.trace``) at the engine's, the
model's and the trainer's layer boundaries, on the CPU.

* Off (not enabled, no profiler recording): a served smoke wave and a smoke
  train step write no record, open no ``record_function`` and make no CUDA
  event (both counted through a monkeypatch).
* On: the spans nest as ``serving/engine.py`` and
  ``training/train_step.py`` state, carry their wave's request ids and
  their layer, and device spans carry ``dev_ts`` None (no CUDA here).
* A recording profiler makes the tracer live, and the profiler holds each
  span as a ``repro.<name>`` range.
* The engine's always-on counters equal the arithmetic that the
  benchmark's ``useful_slot_share.chat`` and
  ``prefill_pad_share.longprompt`` make from outside, over two smoke waves.
* Device spans, graph markers and the Chrome export's device track on a
  stand-in for ``torch.cuda`` whose events read a clock of their own: the
  anchor arithmetic maps each event onto the tracer's clock.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.obs import metrics
from repro_torch.obs import trace
from repro_torch.obs.trace import TRACER
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

SLOTS, CAP = 4, 48
ARCHS = ["yi_6b", "falcon_mamba_7b"]


@pytest.fixture(autouse=True)
def _tracer_off_and_empty():
    TRACER.disable()
    TRACER.clear()
    metrics.reset()
    yield
    TRACER.disable()
    TRACER.clear()


def _engine(arch):
    cfg = get_smoke_config(arch)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, ServeEngine(cfg, params, num_slots=SLOTS, capacity=CAP, device="cpu")


def _wave(cfg, rng, first_rid=0, lens=(8, 5, 8, 3), new=(4, 3, 4, 2)):
    return [Request(rid=first_rid + i, prompt=rng.randint(1, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, new))]


def _serve(eng, reqs):
    """One wave: admit, decode until every request is done, drain."""
    eng.admit(reqs)
    while not all(r.done for r in reqs):
        eng.step()
    eng.drain()
    eng.cache, eng.pos = None, 0


def _train_step(arch="yi_6b", microbatches=2):
    import dataclasses

    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel,
                                                                microbatches=microbatches))
    params = lm.init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    oc = OptConfig(learning_rate=1e-3)
    step = make_train_step(cfg, oc)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=g)
    step(params, init_opt_state(params, oc), {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return cfg


def _count_calls(monkeypatch):
    """Counts of ``record_function`` ranges opened and CUDA events made."""
    seen = {"ranges": 0, "events": 0}
    real = torch.profiler.record_function

    def ranged(*a, **k):
        seen["ranges"] += 1
        return real(*a, **k)

    class Event:
        def __init__(self, *a, **k):
            seen["events"] += 1
            raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.profiler, "record_function", ranged)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_tracer_off_records_nothing_and_opens_nothing(arch, monkeypatch):
    seen = _count_calls(monkeypatch)
    cfg, eng = _engine(arch)
    _serve(eng, _wave(cfg, np.random.RandomState(0)))
    _train_step(arch)
    assert not TRACER and not TRACER.live
    assert TRACER.records() == [] and TRACER.total == 0 and TRACER.pending == 0
    assert seen == {"ranges": 0, "events": 0}


def _children(recs, rec, name=None):
    return [r for r in recs if r["parent"] == rec["sid"] and (name is None or r["name"] == name)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_spans_nest_and_carry_their_wave(arch):
    cfg, eng = _engine(arch)
    TRACER.enable()
    reqs = _wave(cfg, np.random.RandomState(0), first_rid=10)
    _serve(eng, reqs)
    recs = TRACER.records()
    rids = [10, 11, 12, 13]
    layers = list(range(cfg.num_layers))
    (admit,) = [r for r in recs if r["name"] == "engine.admit"]
    assert admit["parent"] is None and admit["args"]["rids"] == rids
    assert admit["args"]["padded"] == 8 and admit["args"]["prompt_tokens"] == 24
    kids = _children(recs, admit)
    assert [k["name"] for k in sorted(kids, key=lambda r: r["ts"])] == \
        ["engine.prefill", "engine.sample"]  # no graph on the CPU: no cache_load
    prefill = kids[0] if kids[0]["name"] == "engine.prefill" else kids[1]
    cores = _children(recs, prefill, "mixer.core")
    assert sorted(c["args"]["layer"] for c in cores) == layers
    steps = sorted((r for r in recs if r["name"] == "engine.step"), key=lambda r: r["ts"])
    assert [s["args"]["step"] for s in steps] == list(range(len(steps))) == [0, 1, 2]
    assert [s["args"]["active"] for s in steps] == [4, 3, 2]
    assert [s["args"]["finished"] for s in steps] == [[13], [11], [10, 12]]
    assert [s["args"]["pos"] for s in steps] == [8, 9, 10]
    for s in steps:
        assert s["parent"] is None and s["args"]["rids"] == rids
        kids = sorted(_children(recs, s), key=lambda r: r["ts"])
        assert [k["name"] for k in kids] == ["engine.replay", "engine.sample", "engine.tokens"]
        assert all(k["args"]["rids"] == rids and k["depth"] == 1 for k in kids)
        assert sorted(c["args"]["layer"] for c in _children(recs, kids[0], "mixer.core")) \
            == layers
    device = [r for r in recs if "dev_ts" in r]
    assert {r["name"] for r in device} == {"engine.prefill", "engine.replay", "mixer.core"}
    assert all(r["dev_ts"] is None and r["dev_dur"] is None for r in device)
    assert not any("dev_ts" in r for r in recs
                   if r["name"] in ("engine.admit", "engine.step", "engine.sample"))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_spans_nest(arch):
    TRACER.enable()
    cfg = _train_step(arch, microbatches=2)
    recs = TRACER.records()
    (step,) = [r for r in recs if r["name"] == "train.step"]
    assert step["parent"] is None and "dev_ts" not in step
    kids = sorted(_children(recs, step), key=lambda r: r["ts"])
    assert [k["name"] for k in kids] == ["train.microbatch", "train.microbatch",
                                         "train.optimizer"]
    assert [k["args"].get("i") for k in kids] == [0, 1, None]
    for mb in kids[:2]:
        assert [a["name"] for a in _children(recs, mb, "train.accumulate")] == \
            ["train.accumulate"]
        layers = sorted(c["args"]["layer"] for c in _children(recs, mb, "mixer.core"))
        assert layers == list(range(cfg.num_layers))  # the forward's; remat's are autograd's
    device = {r["name"] for r in recs if "dev_ts" in r}
    assert {"train.microbatch", "train.accumulate", "train.optimizer", "mixer.core"} == device
    assert all(r["dev_ts"] is None for r in recs if "dev_ts" in r)


def test_a_recording_profiler_makes_the_tracer_live():
    cfg, eng = _engine("yi_6b")
    assert not TRACER
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert TRACER and TRACER.live
        _serve(eng, _wave(cfg, np.random.RandomState(0)))
    assert not TRACER
    recs = TRACER.records()
    names = [e.name for e in prof.events() if e.name.startswith("repro.")]
    for name in ("engine.admit", "engine.prefill", "engine.step", "engine.replay",
                 "engine.sample", "engine.tokens", "mixer.core"):
        assert names.count("repro." + name) == sum(r["name"] == name for r in recs) > 0
    TRACER.clear()
    _serve(eng, _wave(cfg, np.random.RandomState(1)))  # the profiler gone: nothing
    assert TRACER.records() == []


def test_engine_counters_equal_the_benchmarks_arithmetic():
    from portbench import harness
    from portbench.drivers import serve_waves

    cfg, eng = _engine("yi_6b")
    rng = np.random.RandomState(3)
    waves = []
    for lens, new in (((8, 5, 8, 3), (4, 3, 4, 2)), ((12, 12, 2, 7), (2, 5, 2, 3))):
        w = serve_waves.traffic.Wave(
            prompts=[rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in lens],
            new_tokens=list(new))
        waves.append(serve_waves.serve_wave(eng, w, CAP))
    c = {k: metrics.counter(k).value for k in ("engine.tokens_served", "engine.slot_steps",
                                                "engine.prefill_positions",
                                                "engine.prompt_tokens")}
    rec = {"window": waves}
    useful = harness.reader("useful_slot_share.chat").read(rec)
    pads = harness.reader("prefill_pad_share.longprompt").read(rec)
    assert c["engine.tokens_served"] == sum(len(s) for w in waves for s in w["served"]) == 25
    assert c["engine.slot_steps"] == SLOTS * sum(w["steps"] + 1 for w in waves) == 36
    assert c["engine.prefill_positions"] == SLOTS * (8 + 12)
    assert c["engine.prompt_tokens"] == 24 + 33
    assert 100.0 * c["engine.tokens_served"] / c["engine.slot_steps"] == pytest.approx(useful)
    assert 100.0 * (1 - c["engine.prompt_tokens"] / c["engine.prefill_positions"]) \
        == pytest.approx(pads)


class _Clock:
    """A stand-in for ``torch.cuda``: its events read a device clock of its
    own epoch (``epoch`` ms after the host's ``perf_counter``), each taken
    when the event is recorded."""

    def __init__(self, epoch=7.0e6):
        import time

        self.syncs, self.capturing = 0, False
        clock = self

        class Event:
            def __init__(self, enable_timing=False, external=False):
                assert enable_timing
                self.external, self.at = external, None

            def record(self):
                self.at = time.perf_counter_ns() / 1e6 + epoch

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return other.at - self.at

        self.Event = Event

    def is_initialized(self):
        return True

    def current_device(self):
        return 0

    def is_current_stream_capturing(self):
        return self.capturing

    def synchronize(self):
        self.syncs += 1

    def device(self, d):
        import contextlib

        return contextlib.nullcontext()


def test_device_spans_markers_and_the_device_track(monkeypatch, tmp_path):
    clock = _Clock()
    monkeypatch.setattr(trace, "_cuda", lambda: clock)
    TRACER.enable()
    with TRACER.span("outer", device=True, k=1):
        with TRACER.span("inner", device=True):
            pass
    assert TRACER.pending == 2
    with TRACER.capturing() as markers:  # a graph's capture: markers, no records
        with TRACER.span("decode.step", device=True):
            for layer in range(2):
                with TRACER.span("mixer.core", device=True, layer=layer):
                    pass
    assert [(m.name, m.parent, m.depth) for m in markers] == \
        [("decode.step", None, 0), ("mixer.core", 0, 1), ("mixer.core", 0, 1)]
    assert all(m.events[0].external for m in markers) and TRACER.pending == 2
    with TRACER.span("engine.replay", device=True):
        step_ev, cores_ev = markers[0].events, [m.events for m in markers[1:]]
        # a replay records the captured events again, in the captured order
        for ev in [step_ev[0], *(e for pair in cores_ev for e in pair), step_ev[1]]:
            ev.record()
        TRACER.replayed(markers)
    assert TRACER.pending == 6
    clock.capturing = True  # another graph's capture: its device spans are not timed
    with TRACER.span("captured elsewhere", device=True):
        pass
    clock.capturing = False
    assert TRACER.pending == 6
    recs = TRACER.records()
    assert TRACER.pending == 0 and clock.syncs == 1
    (elsewhere,) = [r for r in recs if r["name"] == "captured elsewhere"]
    assert elsewhere["dev_ts"] is None
    recs = [r for r in recs if r is not elsewhere]
    by = {(r["name"], r["args"].get("layer")): r for r in recs}
    outer, inner = by[("outer", None)], by[("inner", None)]
    step, replay = by[("decode.step", None)], by[("engine.replay", None)]
    # each device interval on the tracer's clock: its events were recorded
    # while the span was open (the end one just after its host end), two
    # hours from the device clock's own epoch
    for r in (outer, inner, replay):
        assert r["ts"] - 5.0 <= r["dev_ts"] <= r["dev_ts"] + r["dev_dur"] \
            <= r["ts"] + r["dur"] + 1e3
    assert outer["dev_ts"] <= inner["dev_ts"] <= inner["dev_ts"] + inner["dev_dur"] \
        <= outer["dev_ts"] + outer["dev_dur"]
    assert step["parent"] == replay["sid"] and step["args"]["graph"]
    cores = [by[("mixer.core", i)] for i in range(2)]
    assert all(c["parent"] == step["sid"] and c["depth"] == step["depth"] + 1 for c in cores)
    assert replay["dev_ts"] <= step["dev_ts"] <= cores[0]["dev_ts"] <= cores[1]["dev_ts"] \
        <= cores[1]["dev_ts"] + cores[1]["dev_dur"] <= step["dev_ts"] + step["dev_dur"] \
        <= replay["dev_ts"] + replay["dev_dur"]
    path = tmp_path / "t.json"
    n = TRACER.export_chrome(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert len(events) == n
    dev = [e for e in events if e["tid"] == trace.DEVICE_TID and e["ph"] == "X"]
    assert sorted(e["name"] for e in dev) == sorted(r["name"] for r in recs)
    host = [e for e in events if e["tid"] != trace.DEVICE_TID]
    assert {e["name"] for e in host} == {"outer", "inner", "engine.replay", "captured elsewhere"}
    assert any(e["ph"] == "M" and e["tid"] == trace.DEVICE_TID for e in events)


def test_one_anchor_serves_until_a_fresh_one_is_asked_for(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(trace, "_cuda", lambda: clock)
    made = []
    real = clock.Event

    def event(**kw):
        made.append(real(**kw))
        return made[-1]

    clock.Event = event
    with TRACER.span("off", device=True):  # not live: nothing timed
        pass
    TRACER.enable()
    with TRACER.span("first", device=True):
        pass
    TRACER.resolve()  # no anchor yet: one is taken (a synchronize, an event)
    assert (clock.syncs, len(made)) == (1, 3)
    for name in ("second", "third"):
        with TRACER.span(name, device=True):
            pass
        TRACER.resolve()  # after the caller's readback: it waits for nothing
    assert (clock.syncs, len(made)) == (1, 7)
    TRACER.disable()
    with profile(activities=[ProfilerActivity.CPU]):  # profiled: no kernel of its own
        with TRACER.span("profiled", device=True):
            pass
        TRACER.resolve(anchor=True)  # a wave's fresh anchor
    assert (clock.syncs, len(made)) == (2, 10)
    TRACER.enable()
    with TRACER.span("read", device=True):
        pass
    recs = {r["name"]: r for r in TRACER.records()}  # a reader waits, and keeps the anchor
    assert (clock.syncs, len(made)) == (3, 12)
    assert set(recs) == {"first", "second", "third", "profiled", "read"}
    for r in recs.values():
        assert r["ts"] - 5.0 <= r["dev_ts"] <= r["dev_ts"] + r["dev_dur"] \
            <= r["ts"] + r["dur"] + 1e3
        assert "dev_anchor" not in r
