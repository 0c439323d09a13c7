#!/usr/bin/env python3
"""How many time steps of loads the port's selective-scan kernel keeps in
flight: build ``src/repro_torch/kernels/csrc/mamba_scan.cu`` with ``kUnroll``
set to each of 2, 4, 8 and 16, hold every build against the plain version
(``scaled_err`` at most 1e-5), and time them in turns at the Falcon-Mamba-7B
prefill shape (a/b [4, 512, 8192, 16] fp32) and at N = 8.

    python3 experiments/torch_scan_unroll.py      # on a machine with an NVIDIA GPU

Prints the card's name and power limit, each build's registers per
instantiation, and each variant's device time (CUDA graph of 10 calls,
between CUDA events; two rounds, forward then backward order) with the
rate it reaches over the bytes the scan must move.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
UNROLLS = (2, 4, 8, 16)
SHAPES = ((4, 512, 8192, 16), (4, 512, 8192, 8))  # B, S, di, N
TOL_F32 = 1e-5


def _graph_ms(fn, iters: int = 10) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_unroll: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import mamba_scan as scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {smi}")
    src = (build.SRC_DIR / "mamba_scan.cu").read_text()
    line = next(ln for ln in src.splitlines() if ln.startswith("constexpr int kUnroll = "))
    out_dir = ROOT / "build" / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for u in UNROLLS:
        path = out_dir / f"mamba_scan_unroll{u}.cu"
        path.write_text(src.replace(line, f"constexpr int kUnroll = {u};"))
        jobs[f"unroll{u}"] = (path, out_dir / f"mamba_scan_unroll{u}.so")
    build.compile_sources(jobs)
    print(f"[build] committed: {line}")
    for name in jobs:
        regs, n = {}, None
        for ln in build.BUILD_LOG[name].splitlines():
            m = re.search(r"Compiling entry function '.*kernelILi(\d+)E", ln)
            if m:
                n = int(m.group(1))
            elif "Used" in ln and n is not None:
                regs[n] = ln.split("Used ")[1].split(",")[0]
        print(f"[build] {name}: {dict(sorted(regs.items()))} (by N)")

    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {(name, shape): [] for name in jobs for shape in SHAPES}
    for shape in SHAPES:
        B, S, di, N = shape
        a = torch.rand(B, S, di, N, generator=gen, device="cuda") * 0.9
        b = torch.randn(B, S, di, N, generator=gen, device="cuda") * 0.1
        c = torch.randn(B, S, N, generator=gen, device="cuda")
        want_y, want_h = ref.mamba_scan_ref(a, b, c)
        nbytes = (a.numel() + b.numel() + c.numel() + want_y.numel() + want_h.numel()) * 4
        for name in list(jobs) + list(jobs)[::-1]:
            build._LIBS["mamba_scan"] = build.load(jobs[name][1], scan._SIGNATURES)
            y, h = scan.mamba_scan_cuda(a, b, c)
            torch.cuda.synchronize()
            err = max(ref.scaled_err(y, want_y), ref.scaled_err(h, want_h))
            if not err <= TOL_F32:
                raise AssertionError(f"{name} {shape}: scaled err {err} > {TOL_F32}")
            times[name, shape].append(_graph_ms(lambda: scan.mamba_scan_cuda(a, b, c)))
        for name in jobs:
            ms = times[name, shape]
            print(f"[time] {name} a/b{list(shape)}: {ms[0]:.6f} / {ms[1]:.6f} ms "
                  f"({nbytes / (min(ms) * 1e-3) / 1e12:.3f} TB/s over {nbytes / 1e9:.4f} GB)")
        del a, b, c, want_y, want_h
    build._LIBS.pop("mamba_scan", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
