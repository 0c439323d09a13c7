"""Offline batch serving through the port's engine, in waves.

The engine (``serving/engine.ServeEngine``, the decode step a captured CUDA
graph on the card) is built once in set-up, where it captures.  A wave is
``slots`` requests admitted together into the empty cache (``admit``: one
prefill over the prompts left-padded to the wave's longest), then decoded
in lock step (``step``) until every request has its new tokens, then
drained; the engine is returned to its just-built state through its public
``slots``, ``cache`` and ``pos`` (it has no reset of its own).  Set-up
admits one warm-up wave of the traffic's shapes (tokens of their own) and
decodes a few steps of it.

The window is whole waves: it ends with the first wave to finish after
``--seconds``.  End-to-end metrics, on the host's clock:

* ``gen_tokens_per_s``: every token that requests received, over the
  window's whole time;
* ``itl_p95_ms``: the 95th percentile of every gap between two consecutive
  tokens of a request, over every request;
* ``ttft_p95_ms``: the 95th percentile over every request of the time from
  its wave's start to the host's receipt of its first token.

Correct: once the window has closed and the program is gone, a sample of
the finished requests (the seed's draw, the longest among them) is run
through the plain reference over its padded prompt and its served tokens;
the number compared is the widest gap by which a served token's reference
logit lies below the reference's best at its position.  With the control
on, the tokens that the reference in fp8 puts first at the same positions
are judged in the served tokens' place.

Traced (``--trace 1``): after the window one more wave is served twice,
first on the host's clock alone, then under the profiler; the per-layer
readers get the window's counts and that wave's records.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import harness, traffic, weights
from portbench import trace as tr

__all__ = ["run"]

#: decode steps of the warm-up wave
WARMUP_STEPS = 3


def _reset(engine) -> None:
    """The engine as just built: no slot held, no cache, position 0 (the
    captured step's buffers are overwritten by the next admission)."""
    engine.slots = [None] * engine.num_slots
    engine.cache = None
    engine.pos = 0


def serve_wave(engine, wave: traffic.Wave, capacity: int, max_steps: int | None = None) -> dict:
    """One wave through ``engine``; per request its token times on the
    host's clock, the tokens and the wave's padded prompt length.
    ``max_steps``: stop decoding after that many steps (the warm-up)."""
    from repro_torch.serving.engine import Request

    reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(wave.prompts, wave.new_tokens))]
    t0 = time.perf_counter()
    with tr.span("admit"):
        engine.admit(reqs)
    t1 = time.perf_counter()
    times = [[t1] for _ in reqs]
    steps, positions, stuck = 0, [], False
    while not all(r.done for r in reqs) and steps != max_steps:
        if engine.pos >= capacity:
            stuck = True
            break
        active = [i for i, r in enumerate(reqs) if not r.done]
        positions.append(engine.pos)
        with tr.span("step"):
            engine.step()
        t = time.perf_counter()
        steps += 1
        for i in active:
            times[i].append(t)
    engine.drain()
    _reset(engine)
    t2 = time.perf_counter()
    max_len = max(len(p) for p in wave.prompts)
    return {"start": t0, "prefill_end": t1, "end": t2, "times": times, "steps": steps,
            "positions": positions, "max_len": max_len, "stuck": stuck,
            "prompts": wave.prompts, "new_tokens": wave.new_tokens,
            "served": [[int(np.asarray(t).reshape(-1)[0]) for t in r.out_tokens] for r in reqs]}


def _p95(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def e2e(waves: list, elapsed: float) -> dict:
    """The end-to-end metrics of the window's waves over ``elapsed`` s."""
    tokens = sum(len(t) for w in waves for t in w["times"])
    gaps = [b - a for w in waves for t in w["times"] for a, b in zip(t, t[1:])]
    ttft = [t[0] - w["start"] for w in waves for t in w["times"]]
    return {"gen_tokens_per_s": tokens / elapsed, "itl_p95_ms": _p95(gaps) * 1e3,
            "ttft_p95_ms": _p95(ttft) * 1e3}


def _reference(ctx: harness.Ctx, shapes: dict, precision: str):
    from portbench.reference.common import float32_only

    float32_only()
    w = weights.draw(shapes, ctx.seed, ctx.device, dtype=torch.bfloat16)
    return harness.reference(ctx, w, precision)


def sample(waves: list, k: int, seed: int) -> list:
    """``k`` finished requests as ``(wave, index)``: the longest served one,
    then the seed's draw among the rest."""
    all_reqs = [(wi, i) for wi, w in enumerate(waves) for i in range(len(w["served"]))]
    longest = max(all_reqs, key=lambda q: (len(waves[q[0]]["served"][q[1]]), -q[0], -q[1]))
    rest = [q for q in all_reqs if q != longest]
    g = traffic.rng(seed, 5)
    pick = [rest[i] for i in g.choice(len(rest), size=min(k - 1, len(rest)), replace=False)]
    return [longest] + sorted(pick)


def sequences(waves: list, picks: list) -> tuple:
    """The reference's inputs for the picked requests: tokens [n, S] (each
    row its wave's left-padded prompt, then its served tokens but the last,
    right-padded), and for every served token its row, position and id."""
    seqs, rows, pos, want = [], [], [], []
    for r, (wi, i) in enumerate(picks):
        w = waves[wi]
        p = np.asarray(w["prompts"][i], np.int64)
        served = w["served"][i]
        pad = w["max_len"] - len(p)
        seqs.append(np.concatenate([np.zeros(pad, np.int64), p, np.asarray(served[:-1])]))
        for j, tok in enumerate(served):
            rows.append(r)
            pos.append(w["max_len"] - 1 + j)
            want.append(tok)
    S = max(len(s) for s in seqs)
    toks = np.zeros((len(seqs), S), np.int64)
    for r, s in enumerate(seqs):
        toks[r, :len(s)] = s
    return toks, np.asarray(rows), np.asarray(pos), np.asarray(want)


def served_gap(ref, toks, rows, pos, want, device) -> dict:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position; and the reference's logits' scale
    (their median standard deviation), for the record."""
    t = torch.from_numpy(toks).to(device)
    r = torch.from_numpy(rows).to(device)
    p = torch.from_numpy(pos).to(device)
    w = torch.from_numpy(want).to(device)
    lg = ref.logits_at(t, r, p)
    gaps = lg.max(-1).values - lg.gather(-1, w[:, None])[:, 0]
    return {"gap": float(gaps.max()), "flips": int((gaps > 0).sum()), "tokens": len(want),
            "logit_std": float(lg.std(-1).median()), "logits": lg}


def _traced_wave(engine, wave, capacity: int) -> tuple:
    """The wave once on the host's clock, then again under the profiler."""
    torch.cuda.synchronize()
    plain = serve_wave(engine, wave, capacity)
    traced, sl = tr.profiled(lambda: serve_wave(engine, wave, capacity))
    return plain, traced, sl


def run(ctx: harness.Ctx) -> harness.Outcome:
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine

    cfg, tf, dev = ctx.model, ctx.traffic, ctx.device
    if cfg.name.endswith("smoke"):  # the CPU tests: short prompts into a small cache
        tf = dict(tf, **tf["smoke"])
    slots, capacity = int(tf["slots"]), int(tf["capacity"])
    shapes = weights.leaf_shapes(lm.model_meta(cfg))
    params = weights.unflatten_tree(weights.draw(shapes, ctx.seed, dev))
    engine = ServeEngine(cfg, params, num_slots=slots, capacity=capacity, device=dev,
                         seed=int(traffic.rng(ctx.seed, 4).integers(2**31)))
    vocab = cfg.vocab_size
    # warm-up: a prefill at the waves' padded shape (every wave has the same
    # set of lengths) and decode steps, whose graph the engine captured
    serve_wave(engine, next(traffic.waves(tf, vocab, ctx.seed, stream=3)), capacity,
               max_steps=WARMUP_STEPS)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    start = time.perf_counter()
    setup_s = start - ctx.t0
    stream = traffic.waves(tf, vocab, ctx.seed)
    done = []
    while True:
        done.append(serve_wave(engine, next(stream), capacity))
        if time.perf_counter() - start >= ctx.seconds:
            break
    elapsed = time.perf_counter() - start
    harness.log(ctx, f"window {elapsed:.3f} s: {len(done)} waves after a set-up of "
                     f"{setup_s:.3f} s")
    metrics = dict(e2e(done, elapsed), setup_s=setup_s)
    failed = sum(1 for w in done for i, s in enumerate(w["served"])
                 if w["stuck"] or len(s) != w["new_tokens"][i])
    attempted = sum(len(w["served"]) for w in done)
    record = breakdown = busy = window = None
    if ctx.trace:
        plain, traced, sl = _traced_wave(engine, next(stream), capacity)
        record = {"config": ctx.config, "shapes": shapes, "window": done, "plain": plain,
                  "traced": traced, "slice": sl}
        breakdown = {"device_ops": sl.top_device_ops(), "idle_gaps": sl.idle_by_host()}
        busy, window = sl.busy_us() / 1e6, sl.window_us / 1e6
        harness.log(ctx, f"traced a wave of {traced['steps']} steps, "
                         f"{len(sl.records)} device records")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    picks = sample(done, int(tf["check_requests"]), ctx.seed)
    toks, rows, pos, want = sequences(done, picks)
    ref = _reference(ctx, shapes, "float32")
    got = served_gap(ref, toks, rows, pos, want, dev)
    readings = {k: v for k, v in got.items() if k != "logits"}
    harness.log(ctx, f"reference over {len(want)} served tokens")
    judged = got["gap"]
    if ctx.control == "fp8":  # the tokens fp8 puts first, judged in the program's place
        del ref
        low = _reference(ctx, shapes, "fp8")
        lg8 = low.logits_at(*(torch.from_numpy(a).to(dev) for a in (toks, rows, pos)))
        lg = got["logits"]
        gaps = lg.max(-1).values - lg.gather(-1, lg8.argmax(-1)[:, None])[:, 0]
        judged = readings["control_gap"] = float(gaps.max())
        harness.log(ctx, "control")
    limit = ctx.checks["served_logit_gap"]["limit"]
    return harness.Outcome(
        attempted=attempted, failed=failed, e2e=metrics,
        checks=[("served_logit_gap", judged, limit)], record=record,
        memory_peak_bytes=peak, breakdown=breakdown, busy_s=busy, window_s=window,
        readings=readings)
