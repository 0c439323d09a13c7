#!/usr/bin/env python3
"""The port's RMSNorm backward against an earlier build of it and against
``F.rms_norm``'s backward, in turns inside one run.

    python3 experiments/torch_rmsnorm_bwd_turns.py --old path/to/old/rmsnorm_bwd.cu
        [--variant kVecs=4 ...] [--cuts] [--rounds 3] [--json out.json]

``--old`` is an earlier ``rmsnorm_bwd.cu`` (for example one taken with
``git show <commit>:src/repro_torch/kernels/csrc/rmsnorm_bwd.cu`` into a
directory the run can read), with the committed C interface or the one
before the in-launch dw sum (a workspace of one row per CTA of a grid the
caller chooses, 2 CTAs an SM, and no barrier counter).  Each ``--variant``
is the committed source with some of its ``constexpr int`` knobs set
otherwise (``kDepth=3,kEvictFirst=0``).  The script builds every side
and prints each build's registers, spill bytes and static shared memory per
kernel (``-Xptxas -v``).  At ``chip_smoke.py``'s ``TRAIN_RMSNORM_SPECS``
(bf16) it prints each side's launch (CTAs, which is also the workspace's
rows; threads; lanes a row team; dynamic shared memory) and holds every side against the
plain version (``ref.scaled_err`` of dx and dw at most 2e-2) and a second
call of each to the same bits.  Then each round times old, new, the
variants, ``F.rms_norm``'s backward twice, the variants, new, old, with
``chip_smoke.py``'s method: device time of one call from a CUDA graph of
100 calls, inputs cold in device memory (rotating through copies spanning
4x the L2; not at shapes whose inputs take more copies than the method
allows) and warm in L2.  ``F.rms_norm``'s backward is its forward and
backward through autograd less its forward, each timed in the same turn.
With ``--cuts`` the committed source stopped after each phase (``CUTS``) is
timed too, next to ``F.rms_norm``'s, and not checked: where the time goes.
Prints the card's name and power limit, every reading, and each side's
median and spread (max - min).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from turns import ptxas, stats  # noqa: E402

#: the C interface before the in-launch dw sum
_TWO_LAUNCHES = {
    "rmsnorm_bwd_launch": (ctypes.c_int, [
        *[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p,
    ]),
    "rmsnorm_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
LIB = "F.rms_norm"
#: ``--cuts``: the committed source stopped after a phase (name: sound text,
#: text that stops there), to show where a call's time goes; their outputs
#: are wrong by construction, so they are timed and not checked
CUTS = {
    "cut: rows only": (
        "  cp_async_wait<0>();\n  __syncthreads();  // the ring's bytes become the units' dw rows\n",
        "  cp_async_wait<0>();\n  __syncthreads();  // the ring's bytes become the units' dw rows\n"
        "  return;\n"),
    "cut: rows and the CTA's dw row": ("  grid_barrier(bar, gen);", "  return;"),
}


def _two_launch_call(lib, x, w, dy):
    """A call of a build with the interface before the in-launch sum, on its
    wrapper's grid: 2 CTAs an SM."""
    import torch

    T, d = x.shape
    blocks = min(T, 2 * torch.cuda.get_device_properties(x.device).multi_processor_count)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    ws = torch.empty(blocks, d, dtype=torch.float32, device=x.device)
    code = lib.rmsnorm_bwd_launch(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                  dw.data_ptr(), ws.data_ptr(), blocks, T, d, 1e-6, 1,
                                  torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"old rmsnorm_bwd launch failed: CUDA error {code}")
    return dx, dw


def _kernels(log: str) -> list[dict]:
    """Each kernel of a build, labelled by its instance (``bwd<bf16,VPT=2>``,
    ``rows<f32>``, ``dw<bf16>``), with its ``ptxas`` reading."""
    out = []
    for e in ptxas(log):
        name = e.pop("entry")
        dt = "bf16" if "bfloat16" in name else "f32"
        k = re.search(r"rmsnorm_bwd_kernelI\w+?Li(\d+)EE", name)
        label = (f"bwd<{dt},VPT={k.group(1)}>" if k else f"rows<{dt}>" if "rows" in name
                 else f"dw<{dt}>" if "_dw" in name else name)
        out.append({"kernel": label, **e})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--variant", action="append", default=[],
                    help="knobs of the committed source, e.g. kDepth=3,kEvictFirst=0")
    ap.add_argument("--cuts", action="store_true",
                    help="also time the committed source stopped after each phase (CUTS)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_rmsnorm_bwd_turns: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm_bwd as rb
    from repro_torch.kernels.ref import rmsnorm_bwd_ref, scaled_err

    smi = cs.card()
    src = (build.SRC_DIR / "rmsnorm_bwd.cu").read_text()
    out_dir = ROOT / "build" / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"old": (args.old.resolve(), out_dir / "rmsnorm_bwd_old.so"),
            "new": (build.SRC_DIR / "rmsnorm_bwd.cu", out_dir / "rmsnorm_bwd_new.so")}
    for i, spec in enumerate(args.variant):
        text = src
        for knob in spec.split(","):
            name, value = knob.split("=")
            text, n = re.subn(rf"^constexpr (int|unsigned) {name} = [^;]+;",
                              rf"constexpr \g<1> {name} = {value};", text, flags=re.M)
            if n != 1:
                raise SystemExit(f"--variant {spec}: no knob {name} in rmsnorm_bwd.cu")
        path = out_dir / f"rmsnorm_bwd_variant{i}.cu"
        path.write_text(text)
        jobs[spec] = (path, out_dir / f"rmsnorm_bwd_variant{i}.so")
    cuts = list(CUTS) if args.cuts else []
    for i, name in enumerate(cuts):
        sound, cut = CUTS[name]
        if src.count(sound) != 1:
            raise SystemExit(f"{name}: its text is not in rmsnorm_bwd.cu once")
        path = out_dir / f"rmsnorm_bwd_cut{i}.cu"
        path.write_text(src.replace(sound, cut))
        jobs[name] = (path, out_dir / f"rmsnorm_bwd_cut{i}.so")
    build.compile_sources(jobs)
    record = {"card": smi, "builds": {}, "cases": []}
    for name in jobs:
        info = _kernels(build.BUILD_LOG[name])
        record["builds"][name] = info
        print(f"[build] {name}: " + "; ".join(
            f"{k['kernel']} {k.get('regs')} regs, spill {k.get('spill')}, "
            f"{k.get('smem')} B static smem" for k in info))

    one_launch = "rmsnorm_bwd_plan" in args.old.read_text()
    libs = {n: build.load(jobs[n][1], rb._SIGNATURES if n != "old" or one_launch
                          else _TWO_LAUNCHES) for n in jobs}
    kernels = ["old", "new", *args.variant]
    order = kernels + cuts + [LIB, LIB] + cuts[::-1] + kernels[::-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for T, d in cs.TRAIN_RMSNORM_SPECS:
        x, dy = (torch.randn(T, d, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        w = (torch.rand(d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        want = rmsnorm_bwd_ref(x.float(), w.float(), dy.float())
        fns = {}
        for n in kernels + cuts:
            def call(x, w, dy, lib=libs[n], two=n == "old" and not one_launch):
                if two:
                    return _two_launch_call(lib, x, w, dy)
                build._LIBS["rmsnorm_bwd"] = lib
                return rb.rmsnorm_bwd_cuda(x, w, dy)
            fns[n] = call
        plans = {}
        for n in kernels:  # the launch shape of each build with the committed interface
            out = (ctypes.c_int * 4)()
            if (n != "old" or one_launch) and not libs[n].rmsnorm_bwd_plan(T, d, 1, out):
                plans[n] = dict(zip(("blocks", "threads", "lanes", "smem"), out))
        errs = {}
        for n in kernels:
            got, again = fns[n](x, w, dy), fns[n](x, w, dy)
            torch.cuda.synchronize()
            errs[n] = max(scaled_err(a, b) for a, b in zip(got, want))
            if not errs[n] <= cs.TOL_BF16:
                raise AssertionError(f"{n} [{T},{d}]: scaled err {errs[n]} > {cs.TOL_BF16}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{n} [{T},{d}]: two calls differ")

        def fwd(x, w, d=d):
            return F.rms_norm(x, (d,), w, 1e-6)

        both = cs._autograd_library(fwd, 2)
        readings = {n: {"cold": [], "warm": []} for n in kernels + cuts + [LIB]}
        for _ in range(args.rounds):
            for n in order:
                if n == LIB:
                    t = cs._ms(both, (x, w, dy), iters=100)
                    f = cs._ms(lambda x, w, dy: fwd(x, w), (x, w, dy), iters=100)
                    t = {k: None if t[k] is None else t[k] - f[k] for k in t}
                else:
                    t = cs._ms(fns[n], (x, w, dy), iters=100)
                for temp in ("cold", "warm"):
                    if t[temp] is not None:
                        readings[n][temp].append(t[temp])
        bound = (3 * T * d + 2 * d) * 2 / cs.PEAK_BYTES_PER_S * 1e3
        case = {"shape": [T, d], "bound_bytes_ms": bound, "scaled_err": errs, "plans": plans,
                "times": {n: {temp: stats(r) for temp, r in rs.items() if r}
                          for n, rs in readings.items()}}
        record["cases"].append(case)
        print(f"[turns] x, dy[{T},{d}] bf16; bound {bound:.6f} ms (bytes); scaled err "
              + ", ".join(f"{n} {e:.4g}" for n, e in errs.items()))
        for n, pl in plans.items():
            print(f"[turns]   {n:32s} plan: {pl['blocks']} CTAs x {pl['threads']} threads "
                  f"(teams of {pl['lanes']} lanes), {pl['smem']} B dynamic smem")
        for n, ts in case["times"].items():
            for temp, st in ts.items():
                print(f"[turns]   {n:32s} {temp}: median {st['median']:.6f} ms, spread "
                      f"{st['spread']:.6f}: " + " ".join(f"{v:.6f}" for v in st["ms"]))
        for temp in ("cold", "warm"):
            if temp not in case["times"]["new"]:
                continue
            med = {n: ts[temp]["median"] for n, ts in case["times"].items()}
            print(f"[turns]   {temp}: new {med['new']:.6f} ms = {med['new'] / med['old']:.3f} of "
                  f"old, {med['new'] / med[LIB]:.3f}x {LIB}'s backward, "
                  f"{bound / med['new']:.3f} of the bound")
        del x, dy, w, want
    build._LIBS.pop("rmsnorm_bwd", None)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(record, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
