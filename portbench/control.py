"""Readings that set a cell's limits: the program's numbers and the
control's, seed after seed, in one process (set-up is paid per seed, the
CUDA context once).  The benchmark's own runs never run this.

  python3 portbench/control.py --workload yi-6b.chat --seconds 1 --seeds 11 12 13

For each seed, one run of the cell with the control on (``--control
fp8``, the reference in fp8 judged in the program's place: ``checks`` and
``correct`` are the control's) or off (``--control none``: the program's
own); ``readings`` hold the program's compared numbers in both.  One JSON
line a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench.run import run_cell  # noqa: E402


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items() if k not in ("logits",)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (int, float, str)) or x is None:
        return x
    return repr(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default="fp8", choices=("fp8", "none"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        _, outcome, line = run_cell(args.workload, seed, args.seconds, False,
                                    t0=time.perf_counter(),
                                    control=None if args.control == "none" else args.control)
        rec = {"seed": seed, "correct": line["correct"], "checks": line["checks"],
               "metrics": line["metrics"], "readings": _plain(outcome.readings),
               "peak": line["device"]["memory_peak_bytes"],
               "seconds": time.perf_counter() - t}
        print(json.dumps(rec), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
