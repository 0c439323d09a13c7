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
``s``).  Then each way differentiates the loss ``sum(w * y)`` of the
dispatched rows ``y``, ``w`` a seeded cotangent per (rank, block): the
gradient of rank ``s``'s rows is the same permutation of the cotangents
(its block ``d`` is ``w[s]`` of rank ``d``), so the two gradients must be
identical too, bit for bit, and equal to their numpy oracle; a full-lane
call with its backward launches ``a2a_pack`` four times on a card.  In
place of the demo's HLO byte count it prints the transport's
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

__all__ = ["CHECKS", "job", "main", "run_rank"]


def _block(seed: int, src: int, dst: int, rows: int, d_model: int) -> np.ndarray:
    """The rows rank ``src`` routes to expert group ``dst``."""
    return np.random.default_rng([seed, src, dst]).standard_normal((rows, d_model),
                                                                    dtype=np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _blocks(seed: int, pairs, rows: int, d_model: int, dtype) -> torch.Tensor:
    """``_block(seed, s, d)`` for each ``(s, d)`` of ``pairs``, stacked."""
    return torch.from_numpy(np.stack([_block(seed, s, d, rows, d_model)
                                      for s, d in pairs])).to(dtype)


def run_rank(mesh: Mesh2D, *, tokens: int, top_k: int, d_model: int, dtype: str,
             device: str, seed: int = 0) -> dict:
    """This rank's dispatch, each way once to warm up, once timed and once
    timed with its backward, and its checks.  Returns the checks, the
    host-clock seconds of each timed call and the transport's counts over
    the timed dispatch and over the call with its backward."""
    P, me = mesh.world.size, mesh.world.index
    if (tokens * top_k) % P:
        raise ValueError(f"tokens x top_k = {tokens * top_k} rows do not split over {P} ranks")
    rows = tokens * top_k // P
    dev, dt = torch.device(device), getattr(torch, dtype)
    x = _blocks(seed, [(me, d) for d in range(P)], rows, d_model, dt).to(dev)
    # the cotangent of the dispatched rows: block s of this rank's result
    w = _blocks(seed + 1, [(me, s) for s in range(P)], rows, d_model, dt).to(dev)
    out, grad, seconds, traffic = {}, {}, {}, {}
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
        xg = x.detach().requires_grad_()
        mesh.traffic.reset()
        t0 = time.perf_counter()
        y = a2a(xg.view(P, -1), mesh.pod, mesh.lane).view(x.shape)
        (grad[name],) = torch.autograd.grad((w.float() * y.float()).sum(), xg)
        _sync(dev)
        seconds[f"{name} with backward"] = time.perf_counter() - t0
        traffic[f"{name} with backward"] = mesh.traffic.snapshot()
    oracle = _blocks(seed, [(s, me) for s in range(P)], rows, d_model, dt)
    grad_oracle = _blocks(seed + 1, [(d, me) for d in range(P)], rows, d_model, dt)
    return {
        "rank": me, "rows_per_destination": rows, "bytes_per_rank": x.numel() * x.element_size(),
        "flat_equals_fulllane": torch.equal(out["flat"], out["fulllane"]),
        "flat_equals_oracle": torch.equal(out["flat"].cpu(), oracle),
        "fulllane_equals_oracle": torch.equal(out["fulllane"].cpu(), oracle),
        "grad_flat_equals_fulllane": torch.equal(grad["flat"], grad["fulllane"]),
        "grad_flat_equals_oracle": torch.equal(grad["flat"].cpu(), grad_oracle),
        "grad_fulllane_equals_oracle": torch.equal(grad["fulllane"].cpu(), grad_oracle),
        "grad_dtype": str(grad["fulllane"].dtype).removeprefix("torch."),
        "fulllane_calls": 2, "fulllane_calls_with_backward": 1,
        "seconds": seconds, "traffic": traffic,
        "transport": f"{mesh.world.transport(x)}, tensors on {dev.type}",
    }


#: the checks of ``run_rank`` that must all hold
CHECKS = ("flat_equals_fulllane", "flat_equals_oracle", "fulllane_equals_oracle",
          "grad_flat_equals_fulllane", "grad_flat_equals_oracle",
          "grad_fulllane_equals_oracle")


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
        t = {k: f"{v * 1e3:.3f} ms" for k, v in r["seconds"].items()}
        lines.append(f"rank {r['rank']}: flat == fulllane {r['flat_equals_fulllane']}, "
                     f"== oracle {r['flat_equals_oracle']} / {r['fulllane_equals_oracle']}; "
                     f"gradient flat == fulllane {r['grad_flat_equals_fulllane']}, == oracle "
                     f"{r['grad_flat_equals_oracle']} / {r['grad_fulllane_equals_oracle']}; "
                     f"host clock flat {t['flat']}, fulllane {t['fulllane']}; with backward "
                     f"flat {t['flat with backward']}, fulllane {t['fulllane with backward']}")
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
    bad = [r["rank"] for r in results if not all(r[k] for k in CHECKS)]
    if bad:
        raise AssertionError(f"dispatch differs on ranks {bad}")
    return results


if __name__ == "__main__":
    main()
