#!/usr/bin/env python3
"""The fused selective scan (forward and backward) against the unfused path
it replaces, and against variants of its own sources, in turns inside one
run.

    python3 experiments/torch_scan_fused_turns.py [--variant kStatesPerThread=8 ...]
        [--old-bwd build/mamba_scan_fused_bwd_old.cu] [--rounds 2] [--json out.json]

Each ``--variant`` is the committed ``mamba_scan_fused.cu`` and
``mamba_scan_fused_bwd.cu`` with some of their ``constexpr int`` knobs set
otherwise (a knob is set in each source that has it; one at least must).
``--old-bwd`` adds a side "old": an earlier ``mamba_scan_fused_bwd.cu``
(e.g. ``git show <commit>:src/repro_torch/kernels/csrc/mamba_scan_fused_bwd.cu``
into ``build/``) beside the committed forward.
The script builds every side and prints each build's registers, spill bytes
and static shared memory per kernel (``-Xptxas -v``).  At
``chip_smoke.py``'s ``FUSED_SPECS`` (forward) and ``TRAIN_FUSED_SPECS``
(backward; the forward also at the first training case) it holds every
side against the plain version
(``ref.scaled_err`` at ``TOL_F32``; the backward's float32 sums, from a
call on the same values in float32) and times,
each round, the committed build, the variants, the unfused path twice
(the terms formed by PyTorch, then ``mamba_scan``; or the terms,
``mamba_scan_bwd`` and the terms' backward through autograd), the variants
and the committed build again, with ``chip_smoke.py``'s method: device time
of one call from a CUDA graph, inputs cold in device memory and warm in
L2.  Prints the card's name and power limit, every reading, and each
side's median and spread (max - min).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from turns import ptxas, stats  # noqa: E402

SOURCES = ("mamba_scan_fused", "mamba_scan_fused_bwd")
GRADS = ("gdt", "gx", "gB", "gC", "gA", "gh0")
UNFUSED = "unfused"


def _variant_source(text: str, spec: str) -> tuple[str, int]:
    """``text`` with the knobs of ``spec`` (``kA=1,kB=2``) set; the number of
    knobs found.  A ``kStatesPerThread`` past 4 also gets the dispatch
    cases that reach it (8, 16, ...), which the committed sources leave
    out."""
    found = 0
    for knob in spec.split(","):
        name, value = knob.split("=")
        text, n = re.subn(rf"^constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                          text, flags=re.M)
        found += n
        if n and name == "kStatesPerThread":
            wider = "".join(rf"\1\2({p})\n" for p in (8, 16) if p <= int(value))
            text = re.sub(r"^( +)(FUSED(?:_BWD)?_CASE)\(4\)\n", rf"\g<0>{wider}", text,
                          flags=re.M)
    return text, found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    help="knobs of the committed sources, e.g. kStatesPerThread=8,kSteps=64")
    ap.add_argument("--old-bwd", type=Path,
                    help="an earlier mamba_scan_fused_bwd.cu, timed as the side 'old'")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_fused_turns: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import mamba_scan_fused as ff
    from repro_torch.kernels import mamba_scan_fused_bwd as fb
    from repro_torch.kernels.ref import (mamba_scan_fused_bwd_ref, mamba_scan_fused_ref,
                                         scaled_err)

    smi = cs.card()
    out_dir = ROOT / "build" / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    sides = ["new", *args.variant] + (["old"] if args.old_bwd else [])
    jobs = {}
    for i, side in enumerate(sides):
        found = 0
        for src in SOURCES:
            text = (build.SRC_DIR / f"{src}.cu").read_text()
            if side == "old":
                found = 1
                if src == "mamba_scan_fused_bwd":
                    text = args.old_bwd.read_text()
            elif side != "new":
                text, n = _variant_source(text, side)
                found += n
            path = out_dir / f"{src}_side{i}.cu"
            path.write_text(text)
            jobs[f"{src}:{side}"] = (path, out_dir / f"{src}_side{i}.so")
        if side != "new" and not found:
            raise SystemExit(f"--variant {side}: no such knob in {SOURCES}")
    build.build(["mamba_scan", "mamba_scan_bwd"])  # the unfused path's kernels
    build.compile_sources(jobs)
    record = {"card": smi, "builds": {}, "forward": [], "backward": []}
    for name in jobs:
        info = ptxas(build.BUILD_LOG[name])
        record["builds"][name] = info
        print(f"[build] {name}: " + "; ".join(
            f"{re.sub(r'^_ZN.*?_cu_[0-9a-f]{8}[0-9]+', '', k['entry'])[:48]} {k.get('regs')} "
            f"regs, spill {k.get('spill')}, {k.get('smem')} B static smem" for k in info))
    libs = {side: {src: build.load(jobs[f"{src}:{side}"][1],
                                   (ff if src == SOURCES[0] else fb)._SIGNATURES)
                   for src in SOURCES} for side in sides}

    def on(side, fn):
        def call(*a, **kw):
            build._LIBS.update(libs[side])
            return fn(*a, **kw)
        return call

    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    forward_specs = cs.FUSED_SPECS + [(f"{label} (forward)", *rest)
                                      for label, *rest in cs.TRAIN_FUSED_SPECS[:1]]
    for label, B, S, di, N, with_h0, dtype in forward_specs:
        a = cs.fused_inputs(gen, B, S, di, N, with_h0, dtype)
        a = a if with_h0 else a[:5]
        want = mamba_scan_fused_ref(*a)
        fns = {side: on(side, ff.mamba_scan_fused_cuda) for side in sides}
        errs = {}
        for side, fn in fns.items():
            got = fn(*a)
            torch.cuda.synchronize()
            errs[side] = {n: scaled_err(g, w) for n, g, w in zip(("y", "h_last"), got, want)}
            errs[side]["h_last_bit_for_bit"] = torch.equal(got[1], want[1])
        fns = _passing(fns, errs, failed, f"forward {label}")
        fns[UNFUSED] = cs._unfused_forward
        rec = cs._turns(fns, a, 5, args.rounds)
        record["forward"].append({"case": label, "scaled_err": errs, "turns": rec})
        _print("forward", label, errs, rec)
        del a, want
    for label, B, S, di, N, with_h0, dtype in cs.TRAIN_FUSED_SPECS:
        dt, x, Bm, Cm, A, h0 = cs.fused_inputs(gen, B, S, di, N, with_h0, dtype)
        gy = torch.randn(B, S, di, generator=gen, device="cuda")
        gh = torch.randn(B, di, N, generator=gen, device="cuda") if with_h0 else None
        a = (dt, x, Bm, Cm, A, h0, gy, gh)
        want = mamba_scan_fused_bwd_ref(*(t.float() for t in a[:4]), *a[4:])
        fns = {side: on(side, fb.mamba_scan_fused_bwd_cuda) for side in sides}
        errs = {}
        for side, fn in fns.items():  # the float32 instance on the same values: the sums
            got = fn(*(t.float() for t in a[:4]), *a[4:])
            torch.cuda.synchronize()
            errs[side] = {n: scaled_err(g, w) for n, g, w in zip(GRADS, got, want)}
            errs[side]["gh0_bit_for_bit"] = torch.equal(got[5], want[5])
        fns = _passing(fns, errs, failed, f"backward {label}")
        fns[UNFUSED] = cs._unfused_backward
        if not with_h0:  # _ms clones its arguments: no None among them
            a = a[:5]
            fns = {k: (lambda f: lambda *t: f(*t, None, gy, None))(f) for k, f in fns.items()}
        rec = cs._turns(fns, a, 2, args.rounds)
        record["backward"].append({"case": label, "scaled_err": errs, "turns": rec})
        _print("backward", label, errs, rec)
        del a, want, gy
    print(smi)
    record["failed"] = failed
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(record, indent=1))
    if failed:
        print(f"[turns] FAILED the check (not timed): {failed}")
    return 1 if failed else 0


def _passing(fns: dict, errs: dict, failed: list, what: str) -> dict:
    """The sides of ``fns`` whose errors are within ``TOL_F32``; the others
    named in ``failed``."""
    ok = {}
    for side, fn in fns.items():
        worst = max(v for v in errs[side].values() if not isinstance(v, bool))
        if worst <= cs.TOL_F32:
            ok[side] = fn
        else:
            failed.append(f"{side} {what}: {errs[side]}")
            print(f"[turns] {side} {what} FAILED the check: {errs[side]}")
    return ok


def _print(kind: str, label: str, errs: dict, rec: dict) -> None:
    print(f"[turns] {kind} {label}: scaled err {errs}")
    for n, r in rec.items():
        cold, warm = stats(r["cold"]), stats(r["warm"])
        print(f"[turns]   {n}: cold median {cold['median']:.6f} ms (spread "
              f"{cold['spread']:.6f}), warm median {warm['median']:.6f} ms (spread "
              f"{warm['spread']:.6f})")


if __name__ == "__main__":
    sys.exit(main())
