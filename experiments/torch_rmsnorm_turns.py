#!/usr/bin/env python3
"""The port's RMSNorm kernel against ``torch.nn.functional.rms_norm``, in
turns inside one run, at the serving path's two shapes.

    python3 experiments/torch_rmsnorm_turns.py [--rounds 6] [--json out.json]

At x[2048,4096] bf16 (Yi's and Falcon-Mamba's prefill of 4 x 512 tokens) and
x[4,4096] bf16 (their decode step), the kernel is first held against its
plain version (``ref.scaled_err`` at most 2e-2), then each round times the
kernel, the library call, the library call again and the kernel again, with
``chip_smoke.py``'s method: device time of one call from a CUDA graph of 100
calls, inputs cold in device memory (rotating through copies spanning 4x the
L2; not at the decode shape, whose 32 KB take more copies than the method
allows) and warm in L2.  Prints the card's name and power limit, every
reading, and for each shape and temperature the medians, each side's spread
(max - min over its readings) and whether the kernel is slower than the call
by more than that spread.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SHAPES = ((2048, 4096), (4, 4096))  # prefill 4 x 512 tokens; decode 4 tokens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ref import rmsnorm_ref, scaled_err
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    if not torch.cuda.is_available():
        print("torch_rmsnorm_turns: CUDA is not available", file=sys.stderr)
        return 1
    smi = cs.card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": smi, "shapes": {}}
    for T, d in SHAPES:
        x = torch.randn(T, d, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.rand(d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        err = scaled_err(rmsnorm_cuda(x, w, 1e-6), rmsnorm_ref(x.float(), w.float(), eps=1e-6))
        if not err <= cs.TOL_BF16:
            raise AssertionError(f"rmsnorm [{T},{d}]: scaled err {err} > {cs.TOL_BF16}")
        sides = {"kernel": lambda x, w: rmsnorm_cuda(x, w, 1e-6),
                 "F.rms_norm": lambda x, w: F.rms_norm(x, (d,), w, 1e-6)}
        readings = {(side, temp): [] for side in sides for temp in ("cold", "warm")}
        for _ in range(args.rounds):
            for side in ("kernel", "F.rms_norm", "F.rms_norm", "kernel"):
                t = cs._ms(sides[side], (x, w), iters=100)
                for temp in ("cold", "warm"):
                    if t[temp] is not None:
                        readings[side, temp].append(t[temp])
        shape = f"x[{T},{d}] bf16"
        rec = {"scaled_err": err, "bound_bytes_ms":
               (2 * T * d + d) * x.element_size() / cs.PEAK_BYTES_PER_S * 1e3}
        for temp in ("cold", "warm"):
            k, lib = readings["kernel", temp], readings["F.rms_norm", temp]
            if not k:
                continue
            mk, ml = statistics.median(k), statistics.median(lib)
            spread = max(max(k) - min(k), max(lib) - min(lib))
            verdict = ("slower by more than the spread" if mk - ml > spread else
                       "faster by more than the spread" if ml - mk > spread else
                       "within the spread")
            rec[temp] = {"kernel_ms": k, "library_ms": lib, "kernel_median": mk,
                         "library_median": ml, "spread": spread, "verdict": verdict}
            print(f"[rmsnorm turns] {shape} {temp}: kernel {[f'{v:.6f}' for v in k]}")
            print(f"[rmsnorm turns] {shape} {temp}: F.rms_norm {[f'{v:.6f}' for v in lib]}")
            print(f"[rmsnorm turns] {shape} {temp}: median kernel {mk:.6f} ms, F.rms_norm "
                  f"{ml:.6f} ms ({(mk / ml - 1) * 100:+.1f}%), spread {spread:.6f} ms: "
                  f"kernel {verdict}; byte bound {rec['bound_bytes_ms']:.6f} ms")
        out["shapes"][shape] = rec
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
