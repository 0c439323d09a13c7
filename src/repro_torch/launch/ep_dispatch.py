"""Expert-parallel dispatch through the paper's hierarchical all-to-all: the
counterpart of the dispatch half of the reference's
``examples/moe_ep_demo.py``.

    PYTHONPATH=src python -m repro_torch.launch.ep_dispatch    # 2 pods x 4 lanes, DeepSeek-V2 width
    PYTHONPATH=src python -m repro_torch.launch.ep_dispatch --device cpu --tokens 64 --d-model 32

Starts ``pods * lanes`` ranks (``launch/ranks.py``, gloo).  Rank ``s`` holds
``x[d]``, the rows it routes to expert group ``d`` (``tokens * top_k / P``
rows of ``d_model`` per destination, seeded per (source, destination)), and
routes them with ``flat_all_to_all`` and with ``fulllane_all_to_all``.  Both
results must be identical, bit for bit, and equal to the numpy oracle of the
dispatch (row block ``s`` of rank ``d``'s result is ``x[d]`` of rank
``s``).  In place of the demo's HLO byte count it prints the transport's
messages and bytes per rank and per axis: the flat alltoall sends ``P - Ni``
cross-pod messages, the full-lane one ``No - 1`` combined ones.  On a card,
the ranks share it and gloo stages every exchange through the host, so the
times printed are host-loopback times, not interconnect times.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.collectives import flat_all_to_all, fulllane_all_to_all
from repro_torch.core.groups import Mesh2D

__all__ = ["job", "main", "run_rank"]


def _block(seed: int, src: int, dst: int, rows: int, d_model: int) -> np.ndarray:
    """The rows rank ``src`` routes to expert group ``dst``."""
    return np.random.default_rng([seed, src, dst]).standard_normal((rows, d_model),
                                                                    dtype=np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rank(mesh: Mesh2D, *, tokens: int, top_k: int, d_model: int, dtype: str,
             device: str, seed: int = 0) -> dict:
    """This rank's dispatch, each way once to warm up and once timed, and its
    checks.  Returns the checks, the host-clock seconds of each timed
    dispatch and the transport's counts over it."""
    P, me = mesh.world.size, mesh.world.index
    if (tokens * top_k) % P:
        raise ValueError(f"tokens x top_k = {tokens * top_k} rows do not split over {P} ranks")
    rows = tokens * top_k // P
    dev, dt = torch.device(device), getattr(torch, dtype)
    x = torch.from_numpy(np.stack([_block(seed, me, d, rows, d_model) for d in range(P)]))
    x = x.to(dt).to(dev)
    out, seconds, traffic = {}, {}, {}
    for name, a2a in (("flat", flat_all_to_all), ("fulllane", fulllane_all_to_all)):
        a2a(x.view(P, -1), mesh.pod, mesh.lane)  # warm-up: connections, pinned buffers
        _sync(dev)
        mesh.traffic.reset()
        t0 = time.perf_counter()
        y = a2a(x.view(P, -1), mesh.pod, mesh.lane)
        _sync(dev)
        seconds[name] = time.perf_counter() - t0
        traffic[name] = mesh.traffic.snapshot()
        out[name] = y.view(x.shape)
    oracle = torch.from_numpy(np.stack([_block(seed, s, me, rows, d_model)
                                        for s in range(P)])).to(dt)
    return {
        "rank": me, "rows_per_destination": rows, "bytes_per_rank": x.numel() * x.element_size(),
        "flat_equals_fulllane": torch.equal(out["flat"], out["fulllane"]),
        "flat_equals_oracle": torch.equal(out["flat"].cpu(), oracle),
        "fulllane_equals_oracle": torch.equal(out["fulllane"].cpu(), oracle),
        "fulllane_calls": 2, "seconds": seconds, "traffic": traffic,
        "transport": f"{mesh.world.transport(x)}, tensors on {dev.type}",
    }


def job(pods: int, lanes: int, **kw) -> dict:
    """The body of one rank (``launch/ranks.py``)."""
    return run_rank(Mesh2D(pods, lanes), **kw)


def summary(results: list[dict], pods: int, lanes: int, dtype: str) -> list[str]:
    """Lines that report the ranks' results."""
    r0 = results[0]
    lines = [f"{pods} pods x {lanes} lanes, {r0['rows_per_destination']} rows per "
             f"destination, {r0['bytes_per_rank'] / 1e6:.1f} MB of {dtype} per rank, "
             f"transport {r0['transport']}"]
    for r in results:
        lines.append(f"rank {r['rank']}: flat == fulllane {r['flat_equals_fulllane']}, "
                     f"== oracle {r['flat_equals_oracle']} / {r['fulllane_equals_oracle']}; "
                     f"host clock flat {r['seconds']['flat'] * 1e3:.3f} ms, fulllane "
                     f"{r['seconds']['fulllane'] * 1e3:.3f} ms")
    for name, counts in r0["traffic"].items():
        for key, c in counts.items():
            lines.append(f"rank 0 {name} {key}: {c['messages']} messages, {c['bytes']} bytes; "
                         f"cross-pod {c['cross_pod_messages']} messages, "
                         f"{c['cross_pod_bytes']} bytes; staged through the host "
                         f"{c['staged_bytes']} bytes")
    return lines


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=1024, help="tokens per rank")
    ap.add_argument("--top-k", type=int, default=6)
    ap.add_argument("--d-model", type=int, default=5120)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import build

        build.build(["a2a_pack"])  # once here, not in every rank
    from repro_torch.launch import ranks

    results = ranks.run("repro_torch.launch.ep_dispatch:job", args.pods * args.lanes,
                        kwargs=dict(pods=args.pods, lanes=args.lanes, tokens=args.tokens,
                                    top_k=args.top_k, d_model=args.d_model,
                                    dtype=args.dtype, device=str(device), seed=args.seed))
    for line in summary(results, args.pods, args.lanes, args.dtype):
        print(f"[ep_dispatch] {line}")
    bad = [r["rank"] for r in results if not (r["flat_equals_fulllane"] and
                                              r["flat_equals_oracle"] and
                                              r["fulllane_equals_oracle"])]
    if bad:
        raise AssertionError(f"dispatch differs on ranks {bad}")
    return results


if __name__ == "__main__":
    main()
