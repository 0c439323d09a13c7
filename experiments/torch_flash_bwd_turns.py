#!/usr/bin/env python3
"""The port's flash-attention backward against an earlier build of it and
against SDPA's backward, in turns inside one run.

    python3 experiments/torch_flash_bwd_turns.py --old path/to/old/flash_attention_bwd.cu
        [--variant kHeadsPerSlice=2 ...] [--rounds 2] [--json out.json]

``--old`` is an earlier ``flash_attention_bwd.cu`` (for example one taken
with ``git show <commit>:src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
into a directory the run can read), with the committed C interface, the
one of one head dim (a workspace, q/k and v at one head dim: before the
head-dim pairs) or the one before the workspace (ten pointers, dK and dV
summed over the group in registers).  An old build of one head dim sits out
the cases at a head-dim pair it does not take (hd_v != hd, or a head dim
other than 16 and 128).  Each ``--variant`` is the committed source with some of its
``constexpr int`` knobs set otherwise.  The script builds every side and
prints each build's registers, spill bytes and static shared memory per
kernel (``-Xptxas -v``) beside each side's dynamic shared memory per CTA
where the source states it.  At ``chip_smoke.py``'s ``TRAIN_FLASH_SPECS``
it holds every side against the plain version (dq by ``ref.dq_scaled_err``,
dk and dv by ``ref.scaled_err``, at most 2e-2) and a second call of each to
the same bits.  Then each round times old, new, the variants, SDPA's
backward, SDPA's backward, the variants, new, old, with ``chip_smoke.py``'s
method: device time of one call from a CUDA graph of 10 calls, inputs cold
in device memory (rotating through copies spanning 4x the L2) and warm in
L2.  SDPA's backward is its forward and backward through autograd less its
forward, each timed in the same turn.  Prints the card's name and power
limit, every reading, and each side's median and spread (max - min).
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

#: the C interface before the workspace: ten pointers
_NO_WORKSPACE = {
    "flash_attention_bwd_launch": (ctypes.c_int, [
        *[ctypes.c_void_p] * 10,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]),
    "flash_attention_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
#: the C interface of one head dim, with the workspace
_ONE_HEAD_DIM = {
    "flash_attention_bwd_launch": (ctypes.c_int, [
        *[ctypes.c_void_p] * 11,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]),
    "flash_attention_bwd_workspace_bytes": (ctypes.c_longlong, [ctypes.c_int] * 4),
    "flash_attention_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
LIB = "sdpa"


def _no_workspace_call(lib, q, k, v, o, lse, do, *, group_size, causal, window):
    """A call of a build with the interface before the workspace."""
    import torch

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    BH, S, hd = q.shape
    delta = torch.empty(BH, S, dtype=torch.float32, device=q.device)
    code = lib.flash_attention_bwd_launch(
        *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv, delta)),
        BH, S, hd, group_size, int(causal), window or 0, hd ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"old flash_attention_bwd launch failed: CUDA error {code}")
    return dq, dk, dv, delta


def _one_head_dim_call(lib, q, k, v, o, lse, do, *, group_size, causal, window):
    """A call of a build with the interface of one head dim."""
    import torch

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    BH, S, hd = q.shape
    delta = torch.empty(BH, S, dtype=torch.float32, device=q.device)
    work = torch.empty(lib.flash_attention_bwd_workspace_bytes(BH, S, hd, group_size) // 4,
                       dtype=torch.float32, device=q.device)
    code = lib.flash_attention_bwd_launch(
        *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv, delta, work)),
        BH, S, hd, group_size, int(causal), window or 0, hd ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"old flash_attention_bwd launch failed: CUDA error {code}")
    return dq, dk, dv, delta


def _kernels(log: str) -> list[dict]:
    """Each backward kernel of a build, named as in the source
    (``flash_bwd_dkdv<128>``, ``flash_bwd_dkdv<96, 64>``), with its
    ``ptxas`` reading."""
    out = []
    for e in ptxas(log):
        m = re.search(r"\d(flash_bwd_[a-z_]+)(?:I((?:Li\d+E)+)E)?", e["entry"])
        if m:
            dims = ", ".join(re.findall(r"Li(\d+)E", m.group(2) or ""))
            out.append({"kernel": m.group(1) + (f"<{dims}>" if dims else ""),
                        **{k: v for k, v in e.items() if k != "entry"}})
    return out


def _dynamic_smem(src: str) -> str:
    """The source's own statement of its dynamic shared memory per CTA (a
    comment ``// smem per CTA: ...``), or what the old source's ``Tiles``
    formula gives at hd 128."""
    m = re.search(r"// smem per CTA: (.*)", src)
    if m:
        return m.group(1).strip()
    tile = 64 * (128 + 8) * 2  # one padded [64, 128] tile
    return (f"dK/dV {2 * tile + 2 * (2 * tile + 2 * 64 * 4)} B, "
            f"dQ {2 * tile + 2 * 2 * tile} B at hd 128 (padded rows)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--variant", action="append", default=[],
                    help="knobs of the committed source, e.g. kHeadsPerSlice=2")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_bwd_turns: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import dq_scaled_err, flash_attention_bwd_ref, scaled_err

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.card()
    src = (build.SRC_DIR / "flash_attention_bwd.cu").read_text()
    out_dir = ROOT / "build" / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"old": (args.old.resolve(), out_dir / "flash_bwd_old.so"),
            "new": (build.SRC_DIR / "flash_attention_bwd.cu", out_dir / "flash_bwd_new.so")}
    texts = {"old": args.old.read_text(), "new": src}
    for i, spec in enumerate(args.variant):
        text = src
        for knob in spec.split(","):
            name, value = knob.split("=")
            text, n = re.subn(rf"^constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text, flags=re.M)
            if n != 1:
                raise SystemExit(f"--variant {spec}: no knob {name} in flash_attention_bwd.cu")
        path = out_dir / f"flash_bwd_variant{i}.cu"
        path.write_text(text)
        jobs[spec] = (path, out_dir / f"flash_bwd_variant{i}.so")
        texts[spec] = text
    build.compile_sources(jobs)
    record = {"card": smi, "builds": {}, "cases": []}
    for name in jobs:
        info = _kernels(build.BUILD_LOG[name])
        record["builds"][name] = {"kernels": info, "dynamic_smem": _dynamic_smem(texts[name])}
        print(f"[build] {name}: " + "; ".join(
            f"{k['kernel']} {k.get('regs')} regs, spill {k.get('spill')}, "
            f"{k.get('smem')} B static smem" for k in info)
            + f"; dynamic smem per CTA: {record['builds'][name]['dynamic_smem']}")

    old_kind = ("pairs" if "int head_dim_v" in texts["old"] else
                "one head dim" if "flash_attention_bwd_workspace_bytes" in texts["old"]
                else "no workspace")
    old_call = {"one head dim": _one_head_dim_call, "no workspace": _no_workspace_call}
    old_sigs = {"one head dim": _ONE_HEAD_DIM, "no workspace": _NO_WORKSPACE}
    libs = {n: build.load(jobs[n][1], old_sigs.get(old_kind, fb._SIGNATURES) if n == "old"
                          else fb._SIGNATURES) for n in jobs}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, BH, g, S, hd, hdv, window in cs.TRAIN_FLASH_SPECS:
        takes = old_kind == "pairs" or (hd == hdv and hd in (16, 128))
        kernels = ["old", "new", *args.variant] if takes else ["new", *args.variant]
        order = kernels + [LIB, LIB] + kernels[::-1]
        q, k, v = cs.flash_inputs(gen, BH, g, S, S, hd, hdv)
        do = torch.randn(BH, S, hdv, generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(group_size=g, causal=True, window=window)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                                       do.float(), **kw)
        fns = {}
        for n in kernels:
            def call(*a, lib=libs[n], old=n == "old" and old_kind != "pairs"):
                if old:
                    return old_call[old_kind](lib, *a, **kw)[:3]
                build._LIBS["flash_attention_bwd"] = lib
                return fb.flash_attention_bwd_cuda(*a, **kw)[:3]
            fns[n] = call
        args6 = (q, k, v, o, lse, do)
        errs = {}
        for n in kernels:
            got = fns[n](*args6)
            again = fns[n](*args6)
            torch.cuda.synchronize()
            errs[n] = max(dq_scaled_err(got[0], want[0]),
                          *(scaled_err(a, b) for a, b in zip(got[1:], want[1:])))
            if not errs[n] <= cs.TOL_BF16:
                raise AssertionError(f"{n} {label}: scaled err {errs[n]} > {cs.TOL_BF16}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{n} {label}: two calls differ")
            del got, again
        del want
        fwd = cs.flash_library(S, S, True, window)
        both = cs._autograd_library(fwd, 3)
        readings = {n: {"cold": [], "warm": []} for n in kernels + [LIB]}
        for _ in range(args.rounds):
            for n in order:
                if n == LIB:
                    t = cs._ms(both, args6, iters=10)
                    f = cs._ms(lambda q, k, v, o, lse, do: fwd(q, k, v), args6, iters=10)
                    t = {x: None if t[x] is None else t[x] - f[x] for x in t}
                else:
                    t = cs._ms(fns[n], args6, iters=10)
                for temp in ("cold", "warm"):
                    if t[temp] is not None:
                        readings[n][temp].append(t[temp])
        pairs = cs._attn_pairs(S, S, True, window)
        nbytes = 2 * (BH + BH // g) * S * (hd + hdv) * 2 + BH * S * 4
        bound = {"bound_bytes_ms": nbytes / cs.PEAK_BYTES_PER_S * 1e3,
                 "bound_ops_ms": 2 * (3 * hd + 2 * hdv) * BH * pairs / cs.PEAK_BF16_TC_FLOPS
                 * 1e3}
        case = {"shape": label, "q": [BH, S, hd], "k": [BH // g, S, hd],
                "v": [BH // g, S, hdv], "g": g,
                "window": window, "scaled_err": errs, **bound,
                "times": {n: {temp: stats(r) for temp, r in rs.items() if r}
                          for n, rs in readings.items()}}
        record["cases"].append(case)
        print(f"[turns] {label}: q[{BH},{S},{hd}] k[{BH // g},{S},{hd}] v[..,{hdv}] g={g} causal"
              f"{f' window={window}' if window else ''}; bound "
              f"{max(bound.values()):.6f} ms (bytes {bound['bound_bytes_ms']:.6f}, ops "
              f"{bound['bound_ops_ms']:.6f}); scaled err "
              + ", ".join(f"{n} {e:.4g}" for n, e in errs.items()))
        for n, ts in case["times"].items():
            for temp, st in ts.items():
                print(f"[turns]   {n:24s} {temp}: median {st['median']:.6f} ms, spread "
                      f"{st['spread']:.6f}: " + " ".join(f"{x:.6f}" for x in st["ms"]))
        temp = "cold" if "cold" in case["times"]["new"] else "warm"
        med = {n: ts[temp]["median"] for n, ts in case["times"].items()}
        vs_old = f"{med['new'] / med['old']:.3f} of old, " if "old" in med else ""
        print(f"[turns]   {temp}: new {med['new']:.6f} ms = {vs_old}"
              f"{med['new'] / med[LIB]:.3f}x SDPA's backward, "
              f"{max(bound.values()) / med['new']:.3f} of the bound")
        del q, k, v, o, lse, do
    build._LIBS.pop("flash_attention_bwd", None)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(record, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
