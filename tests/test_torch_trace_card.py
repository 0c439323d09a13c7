"""The tracer's graph markers on the card (``serving/decode_graph.py``,
``obs/trace.py``): every case is marked ``cuda`` and skips without a card.
Each runs at Yi-6B's or Falcon-Mamba-7B's widths with 64 slots, cut in
depth (``configs.first_layers``).

* One ``DecodeGraph``, its tracer switched on and off from step to step, so
  that it replays its marked capture (``marked``) and its plain one
  (``graph``) in turn over one cache: every replay gives the logits and
  leaves the cache of the eager ``lm.decode_step`` run on a clone of the
  cache it started from, bit for bit; a replay with the tracer on records
  ``decode.step`` and one ``mixer.core`` a layer inside it, and one with
  the tracer off records nothing.
* Served through the engine with the tracer on (from before the engine is
  built, so through its captures), each replay's ``mixer.core`` records
  lie inside its ``decode.step``, which lies inside its ``engine.replay``.
* Profiled, layer by layer (8 layers, a cache of 1280 at position 1018):
  the kernels inside each ``mixer.core`` interval (a kernel by its
  midpoint, as the benchmark's readers take it, ``portbench/spans.py``),
  from the first one's start to the last one's end, agree with the markers'
  own elapsed time to 5%: each interval opens on its layer's first kernel
  and closes on its last.  Their busy time (the union, which the readers
  sum) lies within 10% of it in every layer but the first: a profiled
  replay idles between its kernels (3 to 7% of a step on an H100).  The
  first layer's core holds an idle gap of its own in the marked capture
  (~100 us a replay at Yi-6B's widths on an H100), printed with each
  layer's reading.

The module imports no JAX: the card's machine has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import first_layers, get_config
from repro_torch.models import lm
from repro_torch.models.params import map_tree
from repro_torch.obs.trace import TRACER
from repro_torch.serving.decode_graph import DecodeGraph
from repro_torch.serving.engine import Request, ServeEngine

ARCHS = ["yi_6b", "falcon_mamba_7b"]
SLOTS, CAP, PROMPT, STEPS = 64, 160, 128, 6
#: a layer's kernels' extent against its markers' time, and their busy time
SPAN_REL, BUSY_REL = 0.05, 0.10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    TRACER.disable()
    TRACER.clear()
    yield torch.device("cuda")
    TRACER.disable()
    TRACER.clear()


def _model(cfg):
    return lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")


def _clone(cache):
    return map_tree(lambda _, t: t.clone(), cache)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_one_graph_switched_gives_the_eager_step_bit_for_bit(cuda, arch):
    cfg = first_layers(get_config(arch), 4)
    params = _model(cfg)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (SLOTS, PROMPT + STEPS))).cuda()
    _, cache = lm.prefill(cfg, params, {"tokens": toks[:, :PROMPT]}, capacity=CAP)
    dg = DecodeGraph(cfg, params, cache)
    assert [m.name for m in dg.markers] == ["decode.step"] + ["mixer.core"] * cfg.num_layers
    assert [m.attrs.get("layer") for m in dg.markers[1:]] == list(range(cfg.num_layers))
    for t in range(STEPS):
        on = t % 2 == 0
        step, pos = toks[:, PROMPT + t:PROMPT + t + 1], PROMPT + t
        before = _clone(dg.cache)
        n = len(TRACER.records())
        if on:
            TRACER.enable()
        got = dg.replay(step, pos)
        torch.cuda.synchronize()
        TRACER.resolve()
        TRACER.disable()
        want, after = lm.decode_step(cfg, params, step, before,
                                     torch.tensor(pos, dtype=torch.int64, device="cuda"))
        assert torch.equal(got, want), f"step {t}, tracer {'on' if on else 'off'}"
        mine, theirs = [], []
        map_tree(lambda _, a: mine.append(a), dg.cache)
        map_tree(lambda _, a: theirs.append(a), after)
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs)), f"step {t}: the cache"
        recs = TRACER.records()[n:]
        if not on:
            assert recs == [], f"step {t}: the tracer off recorded"
            continue
        assert [r["name"] for r in recs] == ["decode.step"] + ["mixer.core"] * cfg.num_layers
        s = recs[0]
        for c in recs[1:]:
            assert c["parent"] == s["sid"] and c["dev_dur"] > 0
            assert s["dev_ts"] <= c["dev_ts"] and \
                c["dev_ts"] + c["dev_dur"] <= s["dev_ts"] + s["dev_dur"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_marker_records_nest_inside_their_replay(cuda, arch):
    cfg = first_layers(get_config(arch), 2)
    TRACER.enable()  # on through the captures too: spans there are not timed
    eng = ServeEngine(cfg, _model(cfg), num_slots=SLOTS, capacity=CAP, device="cuda")
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size, PROMPT).astype(np.int32),
                    max_new_tokens=STEPS) for i in range(SLOTS)]
    eng.admit(reqs)
    for _ in range(STEPS - 1):
        eng.step()
    recs = TRACER.records()
    by = {r["sid"]: r for r in recs}
    replays = [r for r in recs if r["name"] == "engine.replay"]
    steps = [r for r in recs if r["name"] == "decode.step"]
    assert len(replays) == len(steps) == STEPS - 1
    for s in steps:
        rp = by[s["parent"]]
        assert rp["name"] == "engine.replay" and s["args"]["graph"]
        assert rp["dev_ts"] <= s["dev_ts"] and \
            s["dev_ts"] + s["dev_dur"] <= rp["dev_ts"] + rp["dev_dur"]
        cores = [r for r in recs if r["parent"] == s["sid"]]
        assert sorted(c["args"]["layer"] for c in cores) == list(range(cfg.num_layers))
        for c in cores:
            assert c["name"] == "mixer.core" and 0 < c["dev_dur"]
            assert s["dev_ts"] <= c["dev_ts"] and \
                c["dev_ts"] + c["dev_dur"] <= s["dev_ts"] + s["dev_dur"]
    prefill = [r for r in recs if r["name"] == "engine.prefill"]
    assert len(prefill) == 1 and prefill[0]["dev_dur"] > 0


def per_layer(sl, v) -> dict:
    """Per layer, summed over the profiled replays (us): the markers'
    elapsed time, the extent of the kernels inside them (the first one's
    start to the last one's end), their busy time (``spans.busy_in``) and
    each replay's longest idle gap between them."""
    from portbench import spans

    recs = np.array([(s, e) for _, s, e in sl.records])
    mids = recs.mean(1)
    out = {}
    for r in v.under("mixer.core", "engine.step"):
        (a, b), = v.device_intervals([r])
        inside = recs[(mids >= a) & (mids <= b)]
        d = out.setdefault(r["args"]["layer"],
                           {"marked": 0.0, "extent": 0.0, "busy": 0.0, "gaps": []})
        d["marked"] += r["dev_dur"]
        d["busy"] += spans.busy_in(sl, [(a, b)])
        if len(inside):
            d["extent"] += inside[:, 1].max() - inside[:, 0].min()
            reach = np.maximum.accumulate(inside[:, 1])
            d["gaps"].append(float(max(0.0, (inside[1:, 0] - reach[:-1]).max(initial=0.0))))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_markers_agree_with_the_profilers_kernel_time_layer_by_layer(cuda, arch):
    from portbench import spans
    from portbench import trace as tr

    cfg = first_layers(get_config(arch), 8)
    cap, pos = 1280, 1018
    eng = ServeEngine(cfg, _model(cfg), num_slots=SLOTS, capacity=cap, device="cuda")
    rng = np.random.RandomState(2)
    eng.admit([Request(rid=i, prompt=rng.randint(1, cfg.vocab_size, pos).astype(np.int32),
                       max_new_tokens=64) for i in range(SLOTS)])
    eng.step()  # one step unprofiled
    _, sl = tr.profiled(lambda: [eng.step() for _ in range(8)])
    layers = per_layer(sl, spans.view(sl))
    assert sorted(layers) == list(range(cfg.num_layers))
    for layer, d in sorted(layers.items()):
        print(f"{arch} layer {layer}: marked {d['marked']:.1f} us, kernels' extent "
              f"{d['extent']:.1f}, busy {d['busy']:.1f}, longest gap a replay (median) "
              f"{np.median(d['gaps']):.1f} us")
        assert d["extent"] == pytest.approx(d["marked"], rel=SPAN_REL), (layer, d)
        if layer > 0:  # the first layer's core opens with an idle gap: printed above
            assert d["busy"] == pytest.approx(d["marked"], rel=BUSY_REL), (layer, d)
