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

The parent waits until every rank has exited or the deadline has passed.  If
a rank fails, the rest are killed and the error carries that rank's stderr;
at the deadline every rank is killed.  A rank that dies never hangs the
caller.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

__all__ = ["RankFailed", "run"]

SRC = Path(__file__).resolve().parents[2]


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
    while True:
        codes = [p.poll() for p in procs]
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:  # every rank that has failed so far: one of them is the cause
            raise RankFailed("\n".join(f"rank {r} of {len(procs)} exited {codes[r]}:\n"
                                        f"{_tail(tmp / f'rank{r}.err')}" for r in failed))
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            alive = [r for r, c in enumerate(codes) if c is None]
            raise RankFailed(f"ranks {alive} of {len(procs)} still running at the "
                             f"deadline; rank {alive[0]}:\n{_tail(tmp / f'rank{alive[0]}.err')}")
        time.sleep(0.05)


def _tail(path: Path, n: int = 4000) -> str:
    return path.read_bytes()[-n:].decode(errors="replace")


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

    torch.set_num_threads(1)
    tmp = Path(args.dir)
    dist.init_process_group(args.backend, store=dist.FileStore(str(tmp / "store"), args.world),
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=args.timeout_s))
    try:
        module, fn = args.job.split(":")
        result = getattr(importlib.import_module(module), fn)(
            **json.loads((tmp / "kwargs.json").read_text()))
        # no rank tears its connections down while another still uses them
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if "jax" in sys.modules:
        raise RuntimeError(f"rank {args.rank}: job {args.job} imported JAX")
    torch.save(result, tmp / f"rank{args.rank}.pt.tmp")
    os.replace(tmp / f"rank{args.rank}.pt.tmp", tmp / f"rank{args.rank}.pt")


if __name__ == "__main__":
    main()
