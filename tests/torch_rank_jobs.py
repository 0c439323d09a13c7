"""Jobs that the tests run in ranks (``repro_torch.launch.ranks``).  This
module imports no JAX, and no torch until a job runs.

``run_cases`` runs the cases of ``tests/test_collectives.py`` and
``tests/test_collectives_meshes.py`` through the port's collectives;
``tests/test_torch_collectives.py`` runs the same cases through the
reference.  Each case names its mesh (pods, lanes), its
global input ([8, ...], made with numpy from the reference test's seed;
device/rank ``r`` holds row ``r``, as under ``P(("pod", "lane"))``), its
dtype, and the collective with its keywords.
"""

from __future__ import annotations

import numpy as np

WORLD = 8


def _bcast_input(root: int, n: int) -> np.ndarray:
    x = np.full((WORLD, n), -1.0, np.float32)
    x[root] = np.arange(n) + 1.0
    return x


def _fulllane_bcast_input(pod: int, lanes: int) -> np.ndarray:
    """The payload arange(24) lane-sharded on ``pod``; -99 elsewhere."""
    payload = np.arange(24, dtype=np.float32)
    x = np.full((WORLD, 24 // lanes), -99.0, np.float32)
    for lane in range(lanes):
        x[pod * lanes + lane] = payload[lane * (24 // lanes):(lane + 1) * (24 // lanes)]
    return x


def _scatter_input(root: int) -> np.ndarray:
    blocks = np.random.RandomState(3).randn(WORLD, 2).astype(np.float32)
    x = np.zeros((WORLD, WORLD, 2), np.float32)
    x[root] = blocks
    return x


def _randn(seed: int, *shape: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


#: name: (mesh, input, dtype, kind, keywords).  Kinds: "psum"
#: (hierarchical_psum of the rank's row block, and flat_psum), "a2a"
#: (fulllane_all_to_all of the rank's row, and flat_all_to_all),
#: "fulllane_bcast", "kported_bcast", "kported_scatter" (of the rank's row).
CASES = {
    # tests/test_collectives.py
    "hierarchical_psum": ((2, 4), lambda: _randn(0, 8, 33, 5), "float32", "psum", {}),
    "fulllane_all_to_all": ((2, 4), lambda: _randn(2, 8, 8, 3), "float32", "a2a", {}),
    "fulllane_broadcast": ((2, 4), lambda: _fulllane_bcast_input(0, 4), "float32",
                           "fulllane_bcast", {"root": 0}),
    **{f"kported_broadcast_k{k}": ((2, 4), lambda: _bcast_input(0, 5), "float32",
                                   "kported_bcast", {"k": k, "root": 0})
       for k in (1, 2, 3, 5)},
    **{f"kported_scatter_k{k}": ((2, 4), lambda: _scatter_input(0), "float32",
                                 "kported_scatter", {"k": k, "root": 0})
       for k in (1, 2, 4)},
    "psum_pad": ((2, 4), lambda: _randn(4, 8, 7), "float32", "psum", {}),
    # tests/test_collectives_meshes.py
    **{f"psum_mesh_{p}x{n}": ((p, n), lambda: _randn(0, 8, 13), "float32", "psum", {})
       for p, n in ((2, 4), (4, 2), (8, 1), (1, 8))},
    **{f"a2a_mesh_{p}x{n}": ((p, n), lambda: _randn(1, 8, 8, 5), "float32", "a2a", {})
       for p, n in ((2, 4), (4, 2), (8, 1), (1, 8))},
    **{f"psum_{dt}": ((2, 4), lambda: _randn(2, 8, 16), dt, "psum", {})
       for dt in ("float32", "bfloat16")},
    "kported_broadcast_root5": ((2, 4), lambda: _bcast_input(5, 4), "float32",
                                "kported_bcast", {"k": 2, "root": 5}),
    # beyond the reference's tests: a root on the second pod, a scatter root
    # off rank 0
    "fulllane_broadcast_root1": ((2, 4), lambda: _fulllane_bcast_input(1, 4), "float32",
                                 "fulllane_bcast", {"root": 1}),
    "kported_scatter_root5": ((2, 4), lambda: _scatter_input(5), "float32",
                              "kported_scatter", {"k": 2, "root": 5}),
}


def run_cases() -> dict:
    """Every case on this rank, one mesh at a time (every rank builds every
    mesh, in the same order).  Returns, by case, this rank's result as
    ``[1, ...]`` float32 (``"port"``) and, for "psum" and "a2a", the flat
    baseline's (``"flat"``), and the traffic counts of the case (by "op/axis":
    the port's call on the pod and lane axes, the flat one's on the world)."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.core.groups import Mesh2D

    meshes = {}
    out = {}
    for name, (shape, make, dtype, kind, kw) in CASES.items():
        if shape not in meshes:
            meshes[shape] = Mesh2D(*shape)
        mesh = meshes[shape]
        me = mesh.world.index
        v = torch.from_numpy(make()[me:me + 1]).to(getattr(torch, dtype))
        mesh.traffic.reset()
        res = {}
        if kind == "psum":
            res["port"] = C.hierarchical_psum(v, mesh.pod, mesh.lane)
            res["flat"] = C.flat_psum(v, mesh.pod, mesh.lane)
        elif kind == "a2a":
            res["port"] = C.fulllane_all_to_all(v[0], mesh.pod, mesh.lane)[None]
            res["flat"] = C.flat_all_to_all(v[0], mesh.pod, mesh.lane)[None]
        elif kind == "fulllane_bcast":
            res["port"] = C.fulllane_broadcast(v[0], mesh.pod, mesh.lane, **kw)[None]
        elif kind == "kported_bcast":
            res["port"] = C.kported_broadcast_ppermute(v[0], mesh.world, **kw)[None]
        else:
            res["port"] = C.kported_scatter_ppermute(v[0], mesh.world, **kw)[None]
        res["traffic"] = mesh.traffic.snapshot()
        res["input_unchanged"] = torch.equal(
            v, torch.from_numpy(make()[me:me + 1]).to(getattr(torch, dtype)))
        out[name] = {k: (t.float() if isinstance(t, torch.Tensor) else t)
                     for k, t in res.items()}
    return out


def fail_on_rank(rank: int, how: str = "raise") -> int:
    """Fail on ``rank``, by raising or (``how="kill"``) by a SIGKILL that no
    Python handler sees; the others wait for it in a collective."""
    import os
    import signal

    import torch.distributed as dist

    if dist.get_rank() == rank:
        if how == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise RuntimeError(f"planted failure on rank {rank}")
    dist.barrier()
    return dist.get_rank()


def sleep(seconds: float) -> None:
    import time

    time.sleep(seconds)


def train_step_ranks(pods: int, lanes: int, arch: str, params_npz: str, batch: int, seq: int,
                     lr: float, warmup: int) -> dict:
    """One train step of the float32 smoke config of ``arch`` on this rank's
    share of ``make_batch(seed=0, step=0)`` (rank ``r`` holds rows ``r *
    batch / world`` on, as under ``P(("pod", "data"))``), from the
    parameters in ``params_npz`` (by "/"-joined key), with the gradients
    synced over the (pods, lanes) mesh by each backend.  Returns, by
    backend, the synced gradients and the updated parameters (by key) and
    the metrics."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.groups import Mesh2D
    from repro_torch.models import lm
    from repro_torch.models.params import map_tree
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import batch_to, grad_and_metrics, make_train_step, sync

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    mesh = Mesh2D(pods, lanes)
    me, per = mesh.world.index, batch // mesh.world.size
    mine = {k: v[me * per:(me + 1) * per]
            for k, v in make_batch(cfg, batch, seq, seed=0, step=0).items()}
    saved = np.load(params_npz)
    opt_cfg = OptConfig(learning_rate=lr, warmup_steps=warmup)
    out = {}
    for backend in ("xla", "fulllane"):
        params = map_tree(lambda path, _: torch.from_numpy(saved[path].copy()),
                          lm.model_meta(cfg))
        axes = (mesh.pod, mesh.lane)
        grads, _ = sync(*grad_and_metrics(cfg, params, batch_to(mine, "cpu")), axes, backend)
        step = make_train_step(cfg, opt_cfg, axes=axes, backend=backend)
        params, _, metrics = step(params, init_opt_state(params, opt_cfg), mine)
        flat = {"grads": {}, "params": {}}
        map_tree(lambda path, t: flat["grads"].__setitem__(path, t), grads)
        map_tree(lambda path, t: flat["params"].__setitem__(path, t), params)
        out[backend] = {**flat, "metrics": {k: float(v) for k, v in metrics.items()}}
    return out
