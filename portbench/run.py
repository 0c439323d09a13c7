"""Run one cell of the port's benchmark once.

  python3 portbench/run.py --workload yi-6b.chat --seed 7 --seconds 30 --trace 0

From the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; last in it ``checks``, every number
that decided ``correct`` beside its limit, which also close standard
error.  Exits with another code than 0, and prints no result, without a
CUDA card (or with fewer than the cell asks for), when the program is not
in the checkout, or when JAX or the JAX package is loaded at the end.

The program's kernels are built into ``build/kernels`` inside the
checkout (the port's fixed build directory); the other caches a run could
write (``TRITON_CACHE_DIR``, ``TORCH_EXTENSIONS_DIR``) are pointed at
``build/`` too.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    # the program's prefill at a serving batch (Falcon-Mamba, 64 x 1018) leaves
    # the allocator's fixed segments fragmented past a 2 GiB block
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, count: int, memory_peak: int) -> dict:
    if torch.cuda.is_available():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(memory_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             smoke: bool = False, t0: float | None = None, control: str | None = None):
    """One run of ``workload``: ``(ctx, outcome, result line)``.  ``smoke``
    (the CPU tests only) runs the port's smoke config of the cell's
    configuration on ``device``; ``control`` ("fp8", for the control's
    tests and readings only) judges the control in the program's place."""
    _environment()
    import torch

    from portbench import harness

    c = harness.cell(workload)
    cf = harness.config_file(c["config"])
    tr = harness.traffic_file(c["traffic"])
    ctx = harness.Ctx(cell=workload, config=cf, traffic=tr,
                      checks=harness.checks_file(workload),
                      model=harness.port_config(cf, smoke=smoke), seed=seed, seconds=seconds,
                      trace=trace, device=torch.device(device),
                      t0=_T0 if t0 is None else t0, control=control)
    outcome = harness.driver(tr["driver"]).run(ctx)
    info = device_info(torch, c["chips"], outcome.memory_peak_bytes) if device != "cpu" \
        else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace:
        info["busy_s"] = outcome.busy_s
        info["window_s"] = outcome.window_s
    return ctx, outcome, harness.result_line(ctx, outcome, info)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from portbench import harness

    chips = harness.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: the program (src/repro_torch) is not in {ROOT}: no result",
              file=sys.stderr)
        return 2
    _, outcome, line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: modules loaded that the port may not use: {loaded}: no result",
              file=sys.stderr)
        return 3
    print("readings " + json.dumps(outcome.readings), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
