#!/usr/bin/env python3
"""The port's RMSNorm kernel against an earlier build of it and against
``torch.nn.functional.rms_norm``, in turns inside one run.

    python3 experiments/torch_rmsnorm_turns.py [--old path/to/old/rmsnorm.cu]
        [--variant kCtasPerSm=2 ...] [--rounds 6] [--json out.json]

``--old`` is an earlier ``rmsnorm.cu`` with the same C interface (for
example one taken with ``git show <commit>:src/repro_torch/kernels/csrc/rmsnorm.cu``
into a directory the run can read).  Each ``--variant`` is the committed
source with some of its ``constexpr int`` knobs set otherwise
(``kCtasPerSm=2,kVecsPerThread=2``).  The script builds every side, prints
each build's registers, spills and static shared memory (``-Xptxas -v``),
and at x[2048,4096] bf16 (Yi's and Falcon-Mamba's prefill of 4 x 512
tokens), x[4,4096] bf16 (their decode step) and x[2048,5120] bf16 first
holds every side against the plain version (``ref.scaled_err`` at most
2e-2).  Then each round times old, new, the variants, ``F.rms_norm``,
``F.rms_norm``, the variants, new, old, with ``chip_smoke.py``'s method:
device time of one call from a CUDA graph of 100 calls, inputs cold in
device memory (rotating through copies spanning 4x the L2; not at the
decode shape, whose 32 KB take more copies than the method allows) and
warm in L2.  Prints the card's name and power limit, every reading, and
for each shape and temperature each side's median and spread (max - min
over its readings) and whether the new kernel is slower than each other
side by more than the wider of the two spreads.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from turns import ptxas, stats  # noqa: E402

#: prefill 4 x 512 tokens; decode 4 tokens; prefill at DeepSeek-V2's width
SHAPES = ((2048, 4096), (4, 4096), (2048, 5120))
LIB = "F.rms_norm"


def _kernels(log: str) -> list[dict]:
    """Each kernel of a build, labelled by its instance (``rows<bf16,VPT=4>``,
    ``general<f32>``), with its ``ptxas`` reading."""
    out = []
    for e in ptxas(log):
        name = e.pop("entry")
        dt = "bf16" if "bfloat16" in name else "f32"
        k = re.search(r"rmsnorm_rowsI\w+?Li(\d+)EE", name)
        out.append({"kernel": f"rows<{dt},VPT={k.group(1)}>" if k else
                    f"general<{dt}>" if "general" in name else name, **e})
    return out


def _verdict(a: list, b: list) -> tuple[str, float]:
    """Whether median(a) is slower or faster than median(b) by more than the
    wider spread of the two."""
    ma, mb = statistics.median(a), statistics.median(b)
    spread = max(max(a) - min(a), max(b) - min(b))
    return ("slower by more than the spread" if ma - mb > spread else
            "faster by more than the spread" if mb - ma > spread else
            "within the spread"), spread


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path)
    ap.add_argument("--variant", action="append", default=[],
                    help="knobs of the committed source, e.g. kCtasPerSm=2,kVecsPerThread=2")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_rmsnorm_turns: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_ref, scaled_err

    smi = cs.card()
    src = (build.SRC_DIR / "rmsnorm.cu").read_text()
    out_dir = ROOT / "build" / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"new": (build.SRC_DIR / "rmsnorm.cu", out_dir / "rmsnorm_new.so")}
    if args.old:
        jobs["old"] = (args.old.resolve(), out_dir / "rmsnorm_old.so")
    for i, spec in enumerate(args.variant):
        text = src
        for knob in spec.split(","):
            name, value = knob.split("=")
            text, n = re.subn(rf"^constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text, flags=re.M)
            if n != 1:
                raise SystemExit(f"--variant {spec}: no knob {name} in rmsnorm.cu")
        path = out_dir / f"rmsnorm_variant{i}.cu"
        path.write_text(text)
        jobs[spec] = (path, out_dir / f"rmsnorm_variant{i}.so")
    build.compile_sources(jobs)
    record = {"card": smi, "builds": {}, "shapes": {}}
    for name in jobs:
        info = _kernels(build.BUILD_LOG[name])
        record["builds"][name] = info
        regs = max((k.get("regs", 0) for k in info), default=0)
        spills = sum(sum(k.get("spill", [0, 0])) for k in info)
        print(f"[build] {name}: {len(info)} kernels, at most {regs} registers, "
              f"{spills} spill bytes; " + "; ".join(
                  f"{k['kernel']} {k.get('regs')} regs {k.get('smem')} B smem" for k in info))

    libs = {n: build.load(jobs[n][1], rn._SIGNATURES) for n in jobs}
    kernels = [n for n in ("old", "new") if n in jobs] + list(args.variant)
    order = kernels + [LIB, LIB] + kernels[::-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for T, d in SHAPES:
        x = torch.randn(T, d, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.rand(d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        want = rmsnorm_ref(x.float(), w.float(), eps=1e-6)
        sides = {LIB: lambda x, w: F.rms_norm(x, (d,), w, 1e-6)}
        shape = f"x[{T},{d}] bf16"
        rec = {"bound_bytes_ms": (2 * T * d + d) * x.element_size() / cs.PEAK_BYTES_PER_S * 1e3,
               "scaled_err": {}}
        for n in kernels:
            def call(x, w, lib=libs[n]):
                build._LIBS["rmsnorm"] = lib
                return rn.rmsnorm_cuda(x, w, 1e-6)
            sides[n] = call
        for n in sides:
            err = scaled_err(sides[n](x, w), want)
            rec["scaled_err"][n] = err
            if not err <= cs.TOL_BF16:
                raise AssertionError(f"{n} {shape}: scaled err {err} > {cs.TOL_BF16}")
        del want
        readings = {(side, temp): [] for side in sides for temp in ("cold", "warm")}
        for _ in range(args.rounds):
            for side in order:
                t = cs._ms(sides[side], (x, w), iters=100)
                for temp in ("cold", "warm"):
                    if t[temp] is not None:
                        readings[side, temp].append(t[temp])
        print(f"[rmsnorm turns] {shape}: scaled err " + ", ".join(
            f"{n} {e:.3g}" for n, e in rec["scaled_err"].items())
            + f"; byte bound {rec['bound_bytes_ms']:.6f} ms")
        for temp in ("cold", "warm"):
            if not readings["new", temp]:
                continue
            rec[temp] = {side: stats(readings[side, temp]) for side in sides}
            for side in sides:
                r = rec[temp][side]
                print(f"[rmsnorm turns] {shape} {temp}: {side:24s} median {r['median']:.6f} ms, "
                      f"spread {r['spread']:.6f}: " + " ".join(f"{v:.6f}" for v in r["ms"]))
            for other in sides:
                if other == "new":
                    continue
                verdict, spread = _verdict(readings["new", temp], readings[other, temp])
                mn, mo = rec[temp]["new"]["median"], rec[temp][other]["median"]
                rec[temp][other]["new_against_it"] = verdict
                print(f"[rmsnorm turns] {shape} {temp}: new {mn:.6f} against {other} {mo:.6f} "
                      f"ms ({(mn / mo - 1) * 100:+.1f}%), spread {spread:.6f}: new {verdict}")
        record["shapes"][shape] = rec
    build._LIBS.pop("rmsnorm", None)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(record, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
