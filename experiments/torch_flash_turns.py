#!/usr/bin/env python3
"""The port's flash-attention kernel against an earlier build of it, in one
run and in turns, and the committed kernel at 64 against 128 q rows per CTA.

    python3 experiments/torch_flash_turns.py --old path/to/old/flash_attention.cu

``--old`` is an earlier ``flash_attention.cu`` (for example one taken with
``git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu`` into a
directory the run can read), with the committed C interface or the one
before the value head dim became an argument of its own (one head dim).
The script builds it, the committed source as it is (``kWarps`` warps of 16
q rows per CTA) and the committed source with the other of 4 and 8 warps,
holds every build against the plain version at every attention shape of
``chip_smoke.py``'s phase 3 whose head dims the old build has
(``ref.scaled_err`` at most 2e-2), and times them there in turns (old, 4
warps, 8 warps, SDPA, SDPA, 8 warps, 4 warps, old) with ``chip_smoke.py``'s
method: device time of one call from a CUDA graph of 20 calls, inputs cold
in device memory (rotating through copies spanning 4x the L2) and warm in
L2.  Prints the card's name and power limit, each build's registers,
spills and dynamic shared memory per CTA, each reading, and which tile
size is faster at each shape.  ``--json`` also writes every reading there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from turns import ptxas  # noqa: E402


#: the C interface before the value head dim was an argument of its own
_ONE_HEAD_DIM = {
    "flash_attention_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]),
    "flash_attention_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _one_head_dim_call(lib, q, k, v, *, group_size, causal, window):
    """A call of a build with the one-head-dim interface."""
    import torch

    out = torch.empty_like(q)
    BH, Sq, hd = q.shape
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq, k.shape[1], hd,
        group_size, int(causal), window or 0, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"old flash_attention launch failed: CUDA error {code}")
    return out


def _ptxas(log: str) -> dict:
    """By (q/k, v) head dims: registers and (spill store, spill load) bytes,
    from ``-Xptxas -v``, of the serving instances; a kernel of one head dim
    has both equal."""
    out = {}
    for e in ptxas(log):
        m = re.search(r"kernelILi(\d+)E(?:Li(\d+)E)?(Lb1E)?", e["entry"])
        if m and not m.group(3):  # the training instances (lse written) are not timed here
            hd = (int(m.group(1)), int(m.group(2) or m.group(1)))
            out[hd] = {"spill": tuple(e.get("spill", (0, 0))), "regs": e.get("regs")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_turns: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.card()
    src = (build.SRC_DIR / "flash_attention.cu").read_text()
    const = {m[1]: (m[0], int(m[2])) for m in re.finditer(
        r"^constexpr int (\w+) = (\d+);.*$", src, flags=re.M)}
    line, committed = const.pop("kWarps")
    STAGES = const["STAGES"][1]
    out_dir = ROOT / "build" / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"old": (args.old.resolve(), out_dir / "flash_old.so")}
    for w in (4, 8):
        path = out_dir / f"flash_warps{w}.cu"
        path.write_text(src.replace(line, f"constexpr int kWarps = {w};"))
        jobs[f"warps{w}"] = (path, out_dir / f"flash_warps{w}.so")
    build.compile_sources(jobs)
    record = {"card": smi, "committed_warps": committed, "builds": {}, "cases": []}
    for name in jobs:
        info = _ptxas(build.BUILD_LOG[name])
        if name != "old":
            w = int(name[5:])
            for hd, hdv in info:  # Tile::bytes: Q, then STAGES of K and V, rows padded by 8
                hdpq, hdpv = (-(-d // 16) * 16 for d in (hd, hdv))  # padded to mma's k-step
                bk = 32 if max(hdpq, hdpv) > 128 else 64
                info[hd, hdv]["smem"] = ((16 * w + STAGES * bk) * (hdpq + 8)
                                         + STAGES * bk * (hdpv + 8)) * 2
        record["builds"][name] = {f"{a},{b}": r for (a, b), r in sorted(info.items())}
        print(f"[build] {name}: {json.dumps(record['builds'][name])} (by q/k, v head dims)")

    old_dims = set(_ptxas(build.BUILD_LOG["old"]))
    one_head_dim = "head_dim_v" not in args.old.read_text()
    # the serving entry points only: an earlier build has no lse instance
    serving = {f: sig for f, sig in fa._SIGNATURES.items() if f != "flash_attention_lse_launch"}
    libs = {n: build.load(jobs[n][1], _ONE_HEAD_DIM if n == "old" and one_head_dim
                          else serving) for n in jobs}
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = ["old", "warps4", "warps8", "sdpa", "sdpa", "warps8", "warps4", "old"]
    for label, BH, g, Sq, Skv, hd, hdv, causal, window in cs.FLASH_SPECS:
        if (hd, hdv) not in old_dims:
            print(f"[time] {label}: skipped, the old build has no head dims ({hd}, {hdv})")
            continue
        q, k, v = cs.flash_inputs(gen, BH, g, Sq, Skv, hd, hdv)
        kw = dict(group_size=g, causal=causal, window=window)
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        fns = {"sdpa": cs.flash_library(Sq, Skv, causal, window)}
        for n in jobs:
            def call(q, k, v, lib=libs[n], old=n == "old" and one_head_dim):
                if old:
                    return _one_head_dim_call(lib, q, k, v, **kw)
                build._LIBS["flash_attention"] = lib
                return fa.flash_attention_cuda(q, k, v, **kw)
            fns[n] = call
            err = ref.scaled_err(call(q, k, v), want)
            if not err <= cs.TOL_BF16:
                raise AssertionError(f"{n} {label}: scaled err {err} > {cs.TOL_BF16}")
        del want
        times = {n: [] for n in fns}
        for n in order:
            times[n].append(cs._ms(fns[n], (q, k, v), iters=20))
        bound = cs.flash_bounds(BH, g, Sq, Skv, hd, causal, window, hdv)
        case = {"shape": label, "q": [BH, Sq, hd], "kv": [BH // g, Skv, hd], "g": g,
                "causal": causal, "window": window, "times": times, **bound}
        record["cases"].append(case)
        cold = {n: [t["cold"] if t["cold"] is not None else t["warm"] for t in ts]
                for n, ts in times.items()}
        warm = {n: [t["warm"] for t in ts] for n, ts in times.items()}
        kind = "cold" if times["old"][0]["cold"] is not None else "warm"
        print(f"[time] {label}: q[{BH},{Sq},{hd}] kv[{BH // g},{Skv},{hd}] g={g}"
              f"{' causal' if causal else ''}{f' window={window}' if window else ''}; "
              f"bound {max(bound.values()):.6f} ms (bytes {bound['bound_bytes_ms']:.6f}, "
              f"ops {bound['bound_ops_ms']:.6f})")
        for n in fns:
            print(f"[time]   {n:7s} {kind}: " + " / ".join(f"{t:.6f}" for t in cold[n])
                  + "  L2 warm: " + " / ".join(f"{t:.6f}" for t in warm[n]) + " ms")
        best = lambda n: min(cold[n])  # noqa: E731
        faster = min(("warps4", "warps8"), key=best)
        print(f"[time]   faster tile: {faster} ({best(faster):.6f} against "
              f"{max(best('warps4'), best('warps8')):.6f}); new {best(f'warps{committed}'):.6f}"
              f" = {best('old') / best(f'warps{committed}'):.2f}x faster than old, "
              f"{best(f'warps{committed}') / best('sdpa'):.2f}x SDPA")
        case["faster_tile"] = faster
        del q, k, v
    build._LIBS.pop("flash_attention", None)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
