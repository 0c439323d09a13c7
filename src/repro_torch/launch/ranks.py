"""Run a job in ``N`` ranks on one machine, as ``torchrun`` would, and gather
what each returns.

    run("repro_torch.launch.ep_dispatch:job", 8, kwargs={...})  # -> [result of rank 0, ...]

Each rank is a fresh process, ``python -m repro_torch.launch.ranks --job
module:function --rank r --world N --store FILE --backend B``: nothing is
pickled into it and no ``__main__`` is imported again, so the launcher works
from pytest workers and from a process that already holds a CUDA context
(which cannot fork).  The ranks meet through a ``FileStore`` in a temporary
directory, not a TCP port, so runs side by side never collide.  Each rank
runs one thread of PyTorch's own, builds the process group with a timeout,
calls ``function(**kwargs)``, saves its result (tensors, numbers, strings,
lists and dicts; read back with ``weights_only=True``) and checks that it
never imported JAX.

The parent waits until every rank has exited or the deadline has passed.  A
rank whose job raises writes the exception, the time it was caught and its
traceback to ``rank<r>.exc`` before it tears its connections down, so its
peers, which then fail in their collectives, fail later than it.  After the
first non-zero exit the parent waits a short grace for the others, kills
the rest and raises with the rank that failed first (the earliest ``.exc``)
named first and the bystanders after it (a rank that died without a
record, by a signal or in native code, comes before every record); at the
deadline every rank is killed.  A rank that dies never hangs the caller.
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

__all__ = ["RankFailed", "run"]

SRC = Path(__file__).resolve().parents[2]
#: seconds the parent waits, after the first rank fails, for the others to
#: exit and write their errors (never past the deadline)
GRACE_S = 2.0


class RankFailed(RuntimeError):
    """A rank exited non-zero, or the ranks outlived their deadline."""


def run(job: str, world: int, *, kwargs: dict | None = None, backend: str = "gloo",
        timeout_s: float = 300.0) -> list:
    """Run ``job`` (``"module:function"``) in ``world`` ranks and return each
    rank's result, by rank.  ``kwargs`` must be JSON.  Raises
    :class:`RankFailed` with the failing rank's stderr."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        tmp = Path(tmp)
        (tmp / "kwargs.json").write_text(json.dumps(kwargs or {}))
        env = dict(os.environ)
        # the parent's import path, so the rank finds what the parent finds
        paths = [str(SRC), *sys.path, *env.get("PYTHONPATH", "").split(os.pathsep)]
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(p for p in paths if p))
        procs = []
        try:
            for r in range(world):
                cmd = [sys.executable, "-m", "repro_torch.launch.ranks", "--job", job,
                       "--rank", str(r), "--world", str(world), "--backend", backend,
                       "--dir", str(tmp), "--timeout-s", str(timeout_s)]
                with open(tmp / f"rank{r}.err", "wb") as err:
                    procs.append(subprocess.Popen(cmd, env=env, stdout=err,
                                                  stderr=subprocess.STDOUT))
            _wait(procs, tmp, time.monotonic() + timeout_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        import torch

        return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(world)]


def _wait(procs, tmp: Path, deadline: float) -> None:
    exited: list[int] = []  # ranks in the order the parent saw them exit
    grace_end = None
    while True:
        codes = [p.poll() for p in procs]
        exited += [r for r, c in enumerate(codes) if c is not None and r not in exited]
        if grace_end is None and any(c not in (None, 0) for c in codes):
            grace_end = min(time.monotonic() + GRACE_S, deadline)
        if grace_end is not None and (all(c is not None for c in codes)
                                      or time.monotonic() > grace_end):
            raise RankFailed(_failure(codes, exited, tmp))
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            alive = [r for r, c in enumerate(codes) if c is None]
            raise RankFailed(f"ranks {alive} of {len(procs)} still running at the "
                             f"deadline; rank {alive[0]}:\n{_tail(tmp / f'rank{alive[0]}.err')}")
        time.sleep(0.05)


def _failure(codes: list, exited: list[int], tmp: Path) -> str:
    """The error of a failed run, the cause first.  A rank that failed
    without a ``.exc`` record died outside Python's exception handling (a
    signal, ``os._exit``, an abort in native code), before the peers whose
    collectives it broke could record theirs, so the first such rank to
    exit is the cause.  Otherwise the cause is the rank whose job raised
    first (the earliest record).  Then the bystanders: the other failed
    ranks without a record in the order they exited, the ranks with a
    record by its time, and the ranks still running (to be killed)."""
    records = {}
    for r in range(len(codes)):
        path = tmp / f"rank{r}.exc"
        if path.exists():
            records[r] = json.loads(path.read_text())
    order = [r for r in exited if codes[r] != 0 and r not in records]
    order += sorted(records, key=lambda r: records[r]["time"])
    order += [r for r, c in enumerate(codes) if c is None and r not in records]

    def entry(r: int) -> str:
        code = codes[r]
        head = f"rank {r} of {len(codes)} " + (
            "still running, killed" if code is None
            else f"killed by {_signal_name(-code)}" if code < 0
            else f"exited {code}")
        if r in records:
            rec = records[r]
            head += f": {rec['type']}: {rec['message']}\n{rec['traceback']}"
        return f"{head}\n{_tail(tmp / f'rank{r}.err')}"

    text = entry(order[0])
    if order[1:]:
        text += "\n--- bystanders, after the rank above ---\n"
        text += "\n".join(entry(r) for r in order[1:])
    return text


def _signal_name(number: int) -> str:
    try:
        return signal.Signals(number).name
    except ValueError:
        return f"signal {number}"


def _tail(path: Path, n: int = 4000) -> str:
    return path.read_bytes()[-n:].decode(errors="replace")


def _record(path: Path, exc: BaseException, when: float) -> None:
    """Write ``exc`` (its type, message and traceback) and ``when`` to
    ``path``, atomically."""
    rec = {"time": when, "type": type(exc).__name__, "message": str(exc),
           "traceback": "".join(traceback.format_exception(exc))}
    path.with_suffix(".tmp").write_text(json.dumps(rec))
    os.replace(path.with_suffix(".tmp"), path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="One rank of a job started by run().")
    ap.add_argument("--job", required=True, help="module:function")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--dir", required=True, help="the run's directory: store, kwargs, results")
    ap.add_argument("--timeout-s", type=float, default=300.0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    faulthandler.enable()  # a rank killed by a signal leaves its Python stack
    torch.set_num_threads(1)
    tmp = Path(args.dir)
    try:
        dist.init_process_group(args.backend,
                                store=dist.FileStore(str(tmp / "store"), args.world),
                                rank=args.rank, world_size=args.world,
                                timeout=datetime.timedelta(seconds=args.timeout_s))
    except BaseException as e:
        # a peer that fails right after its own connections are up tears
        # them down while this rank may still be connecting: recorded, this
        # failure comes after the peer's record, not before it as a rank
        # without a record would
        _record(tmp / f"rank{args.rank}.exc", e, time.time())
        raise
    try:
        module, fn = args.job.split(":")
        result = getattr(importlib.import_module(module), fn)(
            **json.loads((tmp / "kwargs.json").read_text()))
        # no rank tears its connections down while another still uses them
        dist.barrier()
    except BaseException as e:
        # recorded before the teardown below makes the peers fail: the
        # parent names the rank with the earliest record as the cause
        _record(tmp / f"rank{args.rank}.exc", e, time.time())
        raise
    finally:
        dist.destroy_process_group()
    if "jax" in sys.modules:
        raise RuntimeError(f"rank {args.rank}: job {args.job} imported JAX")
    torch.save(result, tmp / f"rank{args.rank}.pt.tmp")
    os.replace(tmp / f"rank{args.rank}.pt.tmp", tmp / f"rank{args.rank}.pt")


if __name__ == "__main__":
    main()
