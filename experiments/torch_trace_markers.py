#!/usr/bin/env python3
"""The tracer's graph markers on the card: do they time what they mark, and
what do they cost?

    python3 experiments/torch_trace_markers.py --config yi-6b [--slots 64]
        [--prompt 1018] [--capacity 1280] [--steps 16] [--rounds 4]
        [--replays 50] [--json out.json]

``--config`` names a configuration of the benchmark (``portbench/configs``),
built at its widths and depth by ``portbench.harness.port_config``, its
weights from ``lm.init_model``.

1. Agreement.  An engine (the captured decode step with its markers:
   ``decode.step`` and one ``mixer.core`` a layer) admits one wave of
   ``--slots`` prompts of ``--prompt`` tokens and decodes ``--steps`` steps
   under ``torch.profiler`` (``portbench/trace.profiled``).  For each marker
   name: the markers' own elapsed time (CUDA events) against the device's
   busy time inside their intervals as the profiler has them (a kernel by
   its midpoint, ``portbench/spans.py``), and where the intervals fall
   against the kernels: the gap from each interval's start to its first
   kernel's start (its lead) and from its last kernel's end to its end (its
   trail); the same for each layer's ``mixer.core`` alone.
2. Gaps.  Each capture (``graph``, ``marked``) replayed alone ``--steps``
   times under the profiler, one replay at a time: per replay the device's
   busy time, its kernels' extent, and its three longest idle gaps between
   kernels with where they open (us after the replay's first kernel).
3. Cost.  The engine's two captures of the step, without the markers
   (``DecodeGraph.graph``) and with them (``marked``), each reading the
   device time of ``--replays`` back-to-back replays of the graph alone
   over CUDA events, per replay, in turns (plain, marked, marked, plain)
   for ``--rounds`` rounds.

Prints the card's name and power limit and every reading; ``--json`` also
writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# as the benchmark's runs: the Mamba prefill at 64 x 1018 fragments fixed segments
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, spans  # noqa: E402
from portbench import trace as tr  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _gaps(recs: np.ndarray, iv) -> tuple | None:
    """(first kernel's start - the interval's start, the interval's end -
    the last kernel's end) in us, of the kernels ``recs`` ([n, 2]: start,
    end) whose midpoint is inside."""
    mid = recs.mean(1)
    inside = recs[(mid >= iv[0]) & (mid <= iv[1])]
    if not len(inside):
        return None
    return float(inside[:, 0].min() - iv[0]), float(iv[1] - inside[:, 1].max())


def _summary(xs: list) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def _placed(sl, v, recs: list, recs_np: np.ndarray) -> dict:
    ivs = v.device_intervals(recs)
    gaps = [g for g in (_gaps(recs_np, iv) for iv in ivs) if g is not None]
    marked = sum(r["dev_dur"] for r in recs)
    busy = spans.busy_in(sl, ivs)
    return {"spans": len(recs), "marked_us": marked, "busy_us": busy,
            "busy_over_marked": busy / marked,
            "lead_us": _summary([g[0] for g in gaps]), "trail_us": _summary([g[1] for g in gaps])}


def agreement(eng, steps: int) -> dict:
    eng.step()  # one step unprofiled
    _, sl = tr.profiled(lambda: [eng.step() for _ in range(steps)])
    v = spans.view(sl)
    recs = np.array([(s, e) for _, s, e in sl.records], dtype=np.float64)
    out = {"device_records": len(sl.records), "offset_us": v.offset}
    for name in ("engine.replay", "decode.step", "mixer.core"):
        out[name] = _placed(sl, v, v.under(name, "engine.step"), recs)
    cores = v.under("mixer.core", "engine.step")
    out["layers"] = [_placed(sl, v, [r for r in cores if r["args"]["layer"] == i], recs)
                     for i in sorted({r["args"]["layer"] for r in cores})]
    return out


def gaps(dg, replays: int) -> dict:
    out = {}
    for side, graph in (("plain", dg.graph), ("marked", dg.marked)):
        def run():
            for _ in range(replays):
                graph.replay()
                torch.cuda.synchronize()
                time.sleep(0.01)  # the device idles 10 ms between replays
        _, sl = tr.profiled(run)
        recs = np.array([(s, e) for _, s, e in sl.records], dtype=np.float64)
        # a replay's kernels: split where the device idles over 5 ms
        cut = np.flatnonzero(recs[1:, 0] - np.maximum.accumulate(recs[:, 1])[:-1] > 5000.0)
        rows = []
        for part in np.split(recs, cut + 1):
            reach = np.maximum.accumulate(part[:, 1])
            g = part[1:, 0] - reach[:-1]
            top = np.argsort(g)[::-1][:3]
            rows.append({"busy_us": tr.union_us(map(tuple, part)),
                         "extent_us": float(part[:, 1].max() - part[0, 0]),
                         "gaps_us": [[float(g[i]), float(reach[i] - part[0, 0])] for i in top]})
        out[side] = rows
    return out


def _time(graph: torch.cuda.CUDAGraph, replays: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def cost(dg, rounds: int, replays: int) -> dict:
    graphs = {"plain": dg.graph, "marked": dg.marked}
    ms = {"plain": [], "marked": []}
    for _ in range(rounds):
        for side in ("plain", "marked", "marked", "plain"):
            ms[side].append(_time(graphs[side], replays))
    med = {s: statistics.median(x) for s, x in ms.items()}
    return {"ms": ms, "median": med,
            "marked_over_plain": med["marked"] / med["plain"] - 1.0,
            "event_nodes": 2 * len(dg.markers)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--prompt", type=int, default=1018)
    ap.add_argument("--capacity", type=int, default=1280)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--replays", type=int, default=50)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cfg = harness.port_config(harness.config_file(args.config))
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    eng = ServeEngine(cfg, params, num_slots=args.slots, capacity=args.capacity,
                      device="cuda")
    rng = np.random.RandomState(0)
    eng.admit([Request(rid=i, prompt=rng.randint(1, cfg.vocab_size, args.prompt)
                       .astype(np.int32), max_new_tokens=10**9) for i in range(args.slots)])
    out = {"card": _card(), "config": args.config, "slots": args.slots,
           "prompt": args.prompt, "layers": cfg.num_layers}
    out["agreement"] = agreement(eng, args.steps)
    print(json.dumps(out), flush=True)
    out["gaps"] = gaps(eng.graph, args.steps)
    print(json.dumps(out["gaps"]), flush=True)
    out["cost"] = cost(eng.graph, args.rounds, args.replays)
    print(json.dumps(out), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
