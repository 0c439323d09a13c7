"""What the turns scripts share: the ``-Xptxas -v`` reading of a build, and a
side's median and spread over its readings.

    from turns import ptxas, stats
"""

from __future__ import annotations

import re
import statistics


def ptxas(log: str) -> list[dict]:
    """Each entry function of a build, in the order ``-Xptxas -v`` reports
    them: ``{"entry": mangled name, "regs": registers, "spill": [store,
    load] bytes, "smem": static shared memory bytes}``."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            out.append({"entry": m.group(1)})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and out:
            out[-1]["spill"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", ln)
            out[-1]["smem"] = int(s.group(1)) if s else 0
    return out


def stats(xs: list) -> dict:
    """The readings, their median and their spread (max - min)."""
    return {"ms": xs, "median": statistics.median(xs), "spread": max(xs) - min(xs)}
