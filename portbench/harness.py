"""Finds a cell's parts by name and turns a driver's outcome into the
result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``portbench/configs/<config>.json``: the configuration as it is run (the
  published keys, each cut listed in ``reduced``), the port config it
  builds (``port_config``, cut to ``first_layers``) and its ``family``;
* ``portbench/reference/<family>.py``: the family's plain reference and
  its published keys as the port states them;
* ``portbench/traffic/<traffic>.json``: the traffic's parameters and its
  ``driver``;
* ``portbench/drivers/<driver>.py``: one per kind of traffic, with
  ``run(ctx) -> Outcome``;
* ``portbench/checks/<cell>.json``: each number that decides ``correct``,
  with its limit and the readings the limit was set from;
* ``portbench/metrics/<metric>.py``: one reader per per-layer metric,
  ``read(record) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

__all__ = ["ROOT", "BENCH", "Ctx", "Outcome", "benchmark", "cell", "config_file",
           "traffic_file", "checks_file", "driver", "reader", "family", "port_config",
           "reference", "e2e_metrics", "layer_metrics", "correct", "result_line", "log"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config_file(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def traffic_file(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def checks_file(cell_name: str) -> dict:
    return _json(BENCH / "checks" / f"{cell_name}.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module(BENCH / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def reader(name: str):
    return _module(BENCH / "metrics" / f"{name}.py",
                   "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


def family(cf: dict):
    """The plain reference of a configuration file's ``family``:
    ``portbench/reference/<family>.py``, with ``WIDTHS``, ``SET`` and
    ``Model``."""
    return importlib.import_module(f"portbench.reference.{cf['family']}")


def port_config(cf: dict, smoke: bool = False):
    """The port's ``ModelConfig`` that ``cf`` (a configuration file) runs:
    ``port_config`` cut to ``first_layers``, with the keys of the family's
    ``SET`` taken from the file, and checked against the file key by key
    (the family's ``WIDTHS``), so the file says what runs.  ``smoke``: the
    port's smoke config of the same name instead, for the CPU tests."""
    from repro_torch.configs import first_layers, get_config, get_smoke_config

    fam = family(cf)
    taken = {field: cf[key] for key, field in fam.SET.items()}
    if smoke:
        return dataclasses.replace(get_smoke_config(cf["port_config"]),
                                   dtype=cf["torch_dtype"], **taken)
    cfg = get_config(cf["port_config"])
    if cf.get("first_layers"):
        cfg = first_layers(cfg, cf["first_layers"])
    cfg = dataclasses.replace(cfg, **taken)
    got = {key: get(cfg) for key, get in fam.WIDTHS.items()}
    got["torch_dtype"] = cfg.dtype
    for key, value in got.items():
        if cf[key] != value:
            raise ValueError(f"configuration file {key} = {cf[key]!r}, but the port's "
                             f"{cf['port_config']} runs {value!r}")
    return cfg


def reference(ctx, weights: dict, precision: str = "float32"):
    """The family's plain reference ``Model`` of the cell's configuration on
    ``weights``; at the port's smoke sizes where the run is the CPU
    tests'."""
    fam = family(ctx.config)
    cf = dict(ctx.config)
    if ctx.model.name.endswith("smoke"):
        cf.update({key: get(ctx.model) for key, get in fam.WIDTHS.items()})
    return fam.Model(cf, weights, precision)


def log(ctx, message: str) -> None:
    """A progress line on standard error, with the seconds since the start."""
    print(f"portbench {time.perf_counter() - ctx.t0:9.3f} s: {message}", file=sys.stderr,
          flush=True)


def _for_cell(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def e2e_metrics(cell_name: str) -> list[dict]:
    return [m for m in benchmark()["end_to_end"] if _for_cell(m, cell_name)]


def layer_metrics(cell_name: str) -> list[dict]:
    e2e = {m["name"] for m in e2e_metrics(cell_name)}
    return [m for m in benchmark()["per_layer"]
            if _for_cell(m, cell_name) and m["moves"] in e2e]


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell, its files and the run's arguments."""
    cell: str
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    checks: dict  # the checks file
    model: object  # the port's ModelConfig
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t0: float  # the process's start on the perf_counter clock
    #: "fp8": the control, the reference in fp8, judged in the program's place
    control: str | None = None


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: dict  # name -> value, every end-to-end metric the driver measures
    checks: list  # (name, value, limit): value <= limit passes
    record: dict | None = None  # what the per-layer readers read (traced runs)
    memory_peak_bytes: int = 0
    breakdown: dict | None = None
    busy_s: float | None = None
    window_s: float | None = None
    readings: dict = dataclasses.field(default_factory=dict)  # extra numbers, not compared


def correct(outcome: Outcome) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in outcome.checks) \
        and outcome.failed == 0 and outcome.attempted > 0


def result_line(ctx: Ctx, outcome: Outcome, device: dict) -> dict:
    """The result's JSON object: the cell's end-to-end metrics (``--trace
    0``) or its per-layer metrics (``--trace 1``, each read by its reader;
    a reader that finds nothing leaves its metric out), and the checks
    last."""
    metrics = {}
    if not ctx.trace:
        for m in e2e_metrics(ctx.cell):
            if m["name"] in outcome.e2e:
                metrics[m["name"]] = {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in layer_metrics(ctx.cell):
            v = reader(m["name"]).read(outcome.record or {})
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct(outcome), "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": device}
    if ctx.trace and outcome.breakdown is not None:
        out["breakdown"] = outcome.breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in outcome.checks}
    return out
