"""Where a serving run's time goes: ``torch.profiler`` over one prefill and
a few decode steps of the slot engine, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch yi_6b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch falcon_mamba_7b

The run has the shapes of ``chip_smoke.py``'s serving phase: 4 slots,
prompts of 512 tokens, a cache of 1024.  Prints, for the prefill and for
4 decode steps: host wall time without the profiler (its own cost stays
out of it), the device's busy time (the sum of the device's own records:
kernels, copies and memsets; this path runs on one stream, so none
overlap), hence the device's idle share, and the kernels that take most
device time and the operators that take most host time.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServeEngine

SLOTS, PROMPT_LEN, CAPACITY, STEPS, TOP = 4, 512, 1024, 4, 10


def _device_us(evt) -> float:
    return evt.self_device_time_total


def _report(name: str, prof, wall_s: float, n: int) -> None:
    # device time is read from the device's own records (kernels, copies,
    # memsets) only: an operator's entry repeats the time of its kernels
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_us = sum(_device_us(e) for e in on_device)
    wall_us = wall_s * 1e6
    print(f"[profile] {name}: host wall {wall_us / n / 1e3:.3f} ms, device busy "
          f"{busy_us / n / 1e3:.3f} ms per call ({n} calls, "
          f"{sum(e.count for e in on_device) // n} device records each); device "
          f"idle share {max(0.0, 1 - busy_us / wall_us):.3f}")
    for e in sorted(on_device, key=_device_us, reverse=True)[:TOP]:
        print(f"[profile]   device {_device_us(e) / n / 1e3:9.4f} ms/call  "
              f"x{e.count / n:<6g} {e.key[:90]}")
    for e in sorted(on_host, key=lambda e: e.self_cpu_time_total, reverse=True)[:TOP]:
        print(f"[profile]   host   {e.self_cpu_time_total / n / 1e3:9.4f} ms/call  "
              f"x{e.count / n:<6g} {e.key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    params = lm.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    rng = np.random.RandomState(0)

    def requests():
        return [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, PROMPT_LEN)
                        .astype(np.int32), max_new_tokens=10**9)
                for i in range(SLOTS)]

    def engine():
        return ServeEngine(cfg, params, num_slots=SLOTS, capacity=CAPACITY,
                           device=device)

    warm = engine()
    warm.admit(requests())
    for _ in range(3):
        warm.step()
    del warm

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # each window runs twice on fresh engines: timed alone, then profiled;
    # both end in a host copy of the sampled tokens, so they are synchronised
    eng = engine()
    t0 = time.perf_counter()
    eng.admit(requests())
    wall = time.perf_counter() - t0
    with profile(activities=acts) as prof:
        engine().admit(requests())
    _report(f"prefill {SLOTS}x{PROMPT_LEN}", prof, wall, 1)

    t0 = time.perf_counter()
    for _ in range(STEPS):
        eng.step()
    wall = time.perf_counter() - t0
    eng = engine()
    eng.admit(requests())
    with profile(activities=acts) as prof:
        for _ in range(STEPS):
            eng.step()
    _report(f"decode step of {SLOTS} tokens", prof, wall, STEPS)


if __name__ == "__main__":
    main()
