"""Where a serving run's time goes: ``torch.profiler`` over one prefill and
a few decode steps of the slot engine, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch yi_6b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch falcon_mamba_7b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch h2o_danube_3_4b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch minicpm3_4b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch qwen2_vl_7b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch dbrx_132b --layers 8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch deepseek_v2_236b --layers 8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch jamba_1_5_large_398b --layers 4

The run has the shapes of ``chip_smoke.py``'s serving phase: 4 slots,
prompts of 512 tokens (of 512 x 4 codebooks for MusicGen), a cache of 1024;
H2O-Danube3 takes prompts of 4608 tokens into a cache of 5120, past its
4096-token window.  Prints, for the prefill and for
4 decode steps: host wall time without the profiler (its own cost stays
out of it), and from the profiled run the device's busy time (the sum of
the device's own records: kernels, copies and memsets), its span (the first
record's start to the last one's end) and the streams the records ran on,
hence the device's idle share inside that run (``idle_share``: the span
less the busy time, over the span; busy time above the span or the host
wall is printed as such), the kernels that take most
device time and the operators that take most host time, and the device
time split into the attention (flash) and RMSNorm kernels, and for an MoE
model the layer's stages by their tracer spans (``moe.SPANS``, which the
profiler holds as ``repro.<span>`` ranges: routing,
dispatch, the expert GEMMs, combine, shared experts); the rest is every
other operator (projections, the head, embedding).  A captured step's
replay has no spans: its split is that of the eager step.  ``--layers``
keeps the first layers of the config (``configs.first_layers``: DBRX-132B
and DeepSeek-V2-236B fit one card at 8, Jamba-1.5-Large at 4, its
attention, Mamba, dense and MoE layers).  The decode step is
measured both ways, eager (op by op from Python) and as the engine's
captured CUDA graph, in turns (eager, graph, graph, eager) on fresh
engines: host times move between calls, so only turns inside one call
compare the two.  Each turn also times the engine's build (the capture)
and two admissions on the host clock: the first, right after the build,
and a second after the first wave has drained (its prompts fill the cache
to the capacity, so that prefill runs over 4 x capacity positions), each with
the device memory segments the allocator had to create for it
(``cudaMalloc`` calls: the allocator's cache did not hold the memory).
Last, a graph and an eager engine are built together and admitted one
after the other, in both orders, twice.

``--train`` profiles a train step instead (``training/train_step.py``, the
step ``launch/train.py`` runs): the config's published widths, batch 8 x
``--seq`` (2048 by default) in the config's 8 microbatches with remat,
AdamW; ``--layers`` cuts the depth there too, to what ``chip_smoke.py``
trains where the state of every layer does not fit one card (Yi-6B
``--layers 16``, Gemma-7B ``--layers 10``, Falcon-Mamba-7B ``--layers
32``).  One step warms up, one is timed alone on the host clock
(synchronised), one is profiled; the split gives the selective scan's
forward and backward kernels apart.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch yi_6b --train --layers 16
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch falcon_mamba_7b --train --layers 32
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch h2o_danube_3_4b --train --seq 4608

Qwen2-VL takes embeddings, which no engine drives: its run profiles
``lm.prefill`` over seeded embeds [4, 512, D] and the decode step on seeded
embeds, eager (``lm.decode_step``) and as the captured step
(``DecodeGraph``), in the same turns, each turn with its own prefill and
cache; the admissions' part does not apply.
"""

from __future__ import annotations

import argparse
import re
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs import first_layers, get_config
from repro_torch.models import lm
from repro_torch.models.moe import SPANS
from repro_torch.models.params import torch_dtype
from repro_torch.serving.decode_graph import DecodeGraph
from repro_torch.serving.engine import Request, ServeEngine

SLOTS, STEPS, TOP = 4, 4, 10
#: (prompt length, capacity) by arch, as chip_smoke.py serves it
SHAPES = {"h2o_danube_3_4b": (4608, 5120)}
DEFAULT_SHAPE = (512, 1024)
TURNS = ("eager", "graph", "graph", "eager")
ORDERS = (("graph", "eager"), ("eager", "graph")) * 2


def _device_us(evt) -> float:
    return evt.self_device_time_total


#: the names of the port's hand-written kernels (``kernels/csrc``)
_PORT_KERNEL = re.compile(r"rmsnorm|flash_|mamba_scan|a2a_pack")
#: the selective scan's kernels, unfused (formed terms in) or fused
#: the prefix of the tracer's spans as the profiler holds them
_RANGE = "repro."
_SCAN_FORWARD = re.compile(r"mamba_scan_(fused_)?kernel")
_SCAN_BACKWARD = re.compile(r"mamba_scan_(fused_)?bwd")


def idle_share(span_us: float, busy_us: float, wall_us: float) -> tuple[float, str]:
    """The device's idle share inside one profiled run: its device span (the
    first device record's start to the last one's end) less its busy time
    (the records' summed durations), over the span, unclamped; and a note
    that names busy time above the span (records overlapped: more than one
    stream) or above ``wall_us``, the host wall of the unprofiled run (the
    two runs differ), with the excess in ms; empty when neither holds."""
    share = (span_us - busy_us) / span_us if span_us > 0 else float("nan")
    notes = [f"busy exceeds the {what} by {(busy_us - us) / 1e3:.3f} ms"
             for what, us in (("device span", span_us), ("unprofiled host wall", wall_us))
             if busy_us > us]
    return share, "; ".join(notes)


def _report(name: str, prof, wall_s: float, n: int, top: int = TOP) -> None:
    # device time is read from the device's own records (kernels, copies,
    # memsets) only: an operator's entry repeats the time of its kernels,
    # and a span's annotation on the device covers the kernels inside it
    records = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and not e.name.startswith(_RANGE)]
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation and not e.key.startswith(_RANGE)]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_us = sum(e.time_range.elapsed_us() for e in records)
    span_us = (max(e.time_range.end for e in records)
               - min(e.time_range.start for e in records)) if records else 0.0
    wall_us = wall_s * 1e6
    share, note = idle_share(span_us, busy_us, wall_us)
    print(f"[profile] {name}: device busy {busy_us / n / 1e3:.3f} ms, device span "
          f"{span_us / n / 1e3:.3f} ms per call ({n} calls, {len(records) // n} device "
          f"records each, on {len({e.device_resource_id for e in records})} streams); "
          f"device idle share {share:.3f} of the span; unprofiled host wall "
          f"{wall_us / n / 1e3:.3f} ms per call" + (f" ({note})" if note else ""))
    ranked = sorted(on_device, key=_device_us, reverse=True)
    for e in ranked[:top]:
        print(f"[profile]   device {_device_us(e) / n / 1e3:9.4f} ms/call  "
              f"x{e.count / n:<6g} {e.key[:90]}")
    for e in ranked[top:]:  # the port's own kernels, at whatever rank
        if _PORT_KERNEL.search(e.key):
            print(f"[profile]   device {_device_us(e) / n / 1e3:9.4f} ms/call  "
                  f"x{e.count / n:<6g} {e.key[:90]} (port kernel)")
    for e in sorted(on_host, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]:
        print(f"[profile]   host   {e.self_cpu_time_total / n / 1e3:9.4f} ms/call  "
              f"x{e.count / n:<6g} {e.key[:90]}")
    split = {"flash attention": sum(_device_us(e) for e in on_device if "flash_" in e.key),
             "rmsnorm": sum(_device_us(e) for e in on_device if "rmsnorm" in e.key),
             "scan forward": sum(_device_us(e) for e in on_device
                                 if _SCAN_FORWARD.search(e.key)),
             "scan backward": sum(_device_us(e) for e in on_device
                                  if _SCAN_BACKWARD.search(e.key))}
    for span in SPANS:  # a span's device time: the kernels of the operators inside it
        us = sum(e.device_time_total for e in prof.events()
                 if e.name == _RANGE + span and e.device_type == DeviceType.CPU)
        if us:
            split[span] = us
    split["rest"] = busy_us - sum(split.values())
    print("[profile]   split " + ", ".join(
        f"{k} {us / n / 1e3:.4f} ms ({us / max(busy_us, 1e-9):.3f})" for k, us in split.items()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--train", action="store_true", help="profile a train step")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers of the config to keep (default: all)")
    ap.add_argument("--seq", type=int, default=2048,
                    help="tokens a sequence of a train step (with --train)")
    args = ap.parse_args(argv)
    prompt_len, capacity = SHAPES.get(args.arch, DEFAULT_SHAPE)

    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = first_layers(cfg, args.layers)
    if args.train:
        return _profile_train(cfg, device, seq=args.seq)
    k = cfg.num_codebooks
    params = lm.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    if not cfg.embed_inputs:
        return _profile_embeds(cfg, params, prompt_len, capacity, device)
    rng = np.random.RandomState(0)

    def requests(length=prompt_len, max_new=10**9):
        shape = (length, k) if k > 1 else (length,)
        return [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, shape)
                        .astype(np.int32), max_new_tokens=max_new)
                for i in range(SLOTS)]

    def engine(mode="eager"):
        return ServeEngine(cfg, params, num_slots=SLOTS, capacity=capacity,
                           device=device, cuda_graph=mode == "graph")

    warm = engine()
    warm.admit(requests())
    for _ in range(3):
        warm.step()
    del warm

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # the prefill runs twice on fresh engines: timed alone, then profiled;
    # both end in a host copy of the sampled tokens, so they are synchronised
    t0 = time.perf_counter()
    engine().admit(requests())
    wall = time.perf_counter() - t0
    with profile(activities=acts) as prof:
        engine().admit(requests())
    _report(f"prefill {SLOTS}x{prompt_len}", prof, wall, 1)

    # each turn: a fresh engine (build timed), the first admission timed,
    # one step untimed, STEPS steps timed alone, STEPS more profiled, then
    # the second admission timed once the first wave has drained
    for mode in TURNS:
        t0 = time.perf_counter()
        eng = engine(mode)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        first = _admission(eng, requests(max_new=2 + 2 * STEPS))
        eng.step()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            eng.step()
        wall = time.perf_counter() - t0
        with profile(activities=acts) as prof:
            for _ in range(STEPS):
                eng.step()
        _report(f"decode step of {SLOTS} tokens, {mode}", prof, wall, STEPS)
        assert len(eng.drain()) == SLOTS
        second = _admission(eng, requests(capacity - eng.pos))
        print(f"[profile] {mode} engine: built in {build_ms:.3f} ms; first admission "
              f"({SLOTS}x{prompt_len}) {first[0]:.3f} ms host wall, {first[1]} new device "
              f"segments; second, after a drain ({SLOTS}x{capacity}) {second[0]:.3f} ms, "
              f"{second[1]} new segments")
        del eng

    # a graph engine and an eager engine alive together (as chip_smoke.py
    # holds them), built in that order and then admitted in each order:
    # whether the graph engine's admission or the first one is the slower
    for order in ORDERS:
        engines = {m: engine(m) for m in ("graph", "eager")}
        ms = {m: _admission(engines[m], requests()) for m in order}
        print("[profile] both engines built, admitted " + ", then ".join(
            f"{m} {ms[m][0]:.3f} ms ({ms[m][1]} new segments)" for m in order))
        del engines


def _profile_embeds(cfg, params, prompt_len: int, capacity: int, device) -> None:
    """The prefill and the decode step of a model that takes embeddings,
    driven through ``lm.prefill``, ``lm.decode_step`` and ``DecodeGraph``."""
    gen = torch.Generator(device=device).manual_seed(1)
    embeds = torch.randn(SLOTS, prompt_len + 4 * STEPS, cfg.d_model, generator=gen,
                         device=device).to(torch_dtype(cfg.dtype))
    batch = {"embeds": embeds[:, :prompt_len]}

    def prefill():
        lg, cache = lm.prefill(cfg, params, batch, capacity=capacity)
        lg.cpu()  # synchronised, as an admission's sampling is
        return cache

    cache = prefill()  # warm-up
    for i in range(3):
        lm.decode_step(cfg, params, embeds[:, prompt_len + i:prompt_len + i + 1], cache,
                       prompt_len + i)
    del cache
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    prefill()
    wall = time.perf_counter() - t0
    with profile(activities=acts) as prof:
        prefill()
    _report(f"prefill {SLOTS}x{prompt_len} embeds", prof, wall, 1)

    for mode in TURNS:
        t0 = time.perf_counter()
        cache = lm.init_cache(cfg, SLOTS, capacity, device=device,
                              dtype=torch_dtype(cfg.dtype))
        graph = DecodeGraph(cfg, params, cache) if mode == "graph" else None
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        filled = prefill()
        if graph is None:
            cache = filled
        else:
            graph.load(filled)
        del filled
        pos = prompt_len

        def step():
            nonlocal pos
            e = embeds[:, pos:pos + 1]
            lg = (graph.replay(e, pos) if graph is not None
                  else lm.decode_step(cfg, params, e, cache, pos)[0])
            lg.argmax(-1).cpu()  # the host round trip of greedy sampling
            pos += 1

        step()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        wall = time.perf_counter() - t0
        with profile(activities=acts) as prof:
            for _ in range(STEPS):
                step()
        _report(f"decode step of {SLOTS} embeds, {mode}", prof, wall, STEPS)
        print(f"[profile] {mode} step: cache and capture built in {build_ms:.3f} ms")
        del graph, cache


def _profile_train(cfg, device, batch: int = 8, seq: int = 2048) -> None:
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import batch_to, make_train_step

    opt_cfg = OptConfig(learning_rate=3e-4, warmup_steps=1)
    params = lm.init_model(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    state = init_opt_state(params, opt_cfg)
    data = batch_to(make_batch(cfg, batch, seq, seed=0), device)
    step = make_train_step(cfg, opt_cfg)

    def one():
        nonlocal params, state
        params, state, metrics = step(params, state, data)
        return float(metrics["loss"])  # synchronises

    one()
    t0 = time.perf_counter()
    one()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one()
    print(f"[profile] {cfg.name} at {cfg.num_layers} layers, {batch} x {seq} tokens in "
          f"{cfg.parallel.microbatches} microbatches, remat {cfg.parallel.remat}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    _report("train step", prof, wall, 1, top=25)


def _admission(eng: ServeEngine, reqs: list) -> tuple[float, int]:
    """Admit ``reqs``: host ms (it ends in the host copy of the sampled
    tokens, so it is synchronised) and the device memory segments the
    allocator created meanwhile (its ``cudaMalloc`` calls)."""
    segments = torch.cuda.memory_stats()["segment.all.allocated"]
    t0 = time.perf_counter()
    assert len(eng.admit(reqs)) == SLOTS
    ms = (time.perf_counter() - t0) * 1e3
    return ms, torch.cuda.memory_stats()["segment.all.allocated"] - segments

if __name__ == "__main__":
    main()
