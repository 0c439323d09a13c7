"""Serving driver: batched decode over the slot engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \\
      --requests 4 --max-new 16            # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon_mamba_7b \\
      --requests 4 --max-new 16            # the Mamba path, on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen_large
                                           # 4 codebooks: prompts [S, 4]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b --layers 8
                                           # MoE at full width, 8 of 40 layers
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_1_5_large_398b --layers 4
                                           # the hybrid: attention, Mamba and MoE layers
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b --eager
                                           # the decode step from Python, not a CUDA graph
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b --smoke \\
      --device cpu                         # plain PyTorch on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \\
      --trace build/serve.trace.json       # the tracer on: spans and counters

On the card each decode step replays one captured CUDA graph; ``--eager``
runs it op by op from Python instead, as the CPU always does.  ``--layers``
keeps the first layers of the config (``configs.first_layers``: DBRX-132B and
DeepSeek-V2-236B fit one card at 8, Jamba-1.5-Large at 4, fewer than its
period of 8).  All requests
are admitted in one wave, so ``--requests`` may not exceed
``--slots``, and every prompt and its new tokens must fit the cache: the
engine admits a wave only into an empty cache, and a request it cannot
admit or finish would never complete.

``--trace PATH`` turns the tracer on (``obs/trace.py``) for the run, writes
its Chrome trace to PATH (Perfetto or ``chrome://tracing``: the engine's,
the model's and the graph's spans, host and device on one clock, the
device spans on a track of their own; device times only on the card) and
prints the metrics registry (``obs.metrics.render_text()``: the engine's
counters of slots computed, tokens served, prefill positions and prompt
tokens among them).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import first_layers, get_config, get_smoke_config
from repro_torch.models import lm
from repro_torch.obs import metrics
from repro_torch.obs.trace import TRACER
from repro_torch.serving.engine import Request, ServeEngine, greedy_sample, temperature_sample


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers of the config to keep (default: all)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="decode step op by op, not as a captured CUDA graph (the card)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="trace the run and write its Chrome trace to PATH")
    args = ap.parse_args(argv)
    if args.requests > args.slots:
        ap.error(f"--requests {args.requests} > --slots {args.slots}: requests "
                 "are admitted in one wave, so the rest would never be served")
    if args.prompt_len + args.max_new - 1 > args.capacity:
        ap.error(f"--prompt-len {args.prompt_len} + --max-new {args.max_new} - 1 "
                 f"> --capacity {args.capacity}: the requests could not finish")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = first_layers(cfg, args.layers)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_model(cfg, gen, device=device)
    sampler = (greedy_sample if args.temperature == 0.0
               else temperature_sample(args.temperature))
    eng = ServeEngine(cfg, params, num_slots=args.slots, capacity=args.capacity,
                      sampler=sampler, seed=args.seed, device=device,
                      cuda_graph=False if args.eager else None)

    rng = np.random.RandomState(args.seed)
    k = cfg.num_codebooks
    shape = (args.prompt_len, k) if k > 1 else (args.prompt_len,)
    reqs = [
        Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, shape).astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    if args.trace:
        TRACER.enable()
    t0 = time.time()
    done = eng.run(reqs, max_steps=args.max_new)
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/max(dt,1e-9):.1f} tok/s) on {device}, decode step "
          f"{'eager' if eng.graph is None else 'as a CUDA graph'}")
    for r in done[:4]:
        print(f"  rid={r.rid}: {r.out_tokens[:8]}...")
    if args.trace:
        n = TRACER.export_chrome(args.trace)
        print(f"[serve] trace: {n} events in {args.trace}")
        print(metrics.render_text())
    return done


if __name__ == "__main__":
    main()
