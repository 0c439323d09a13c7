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


#: name: (mesh, input, dtype, collective, keywords) for ``run_grad_cases``:
#: the gradient of every rank's loss ``sum(c * f(x))``, ``c`` a seeded
#: cotangent of f's output on each rank: the adjoint of f applied to c.  Collectives: the public functions
#: of ``core/collectives.py``, the k-ported ones on the world axis.
GRAD_CASES = {
    **{f"hierarchical_psum_{dt}": ((2, 4), lambda: _randn(10, 8, 33, 5), dt,
                                   "hierarchical_psum", {})
       for dt in ("float32", "bfloat16")},
    "fulllane_psum_4x2": ((4, 2), lambda: _randn(11, 8, 13), "float32", "fulllane_psum", {}),
    **{f"flat_psum_{dt}": ((2, 4), lambda: _randn(12, 8, 16), dt, "flat_psum", {})
       for dt in ("float32", "bfloat16")},
    **{f"fulllane_all_to_all_{dt}": ((2, 4), lambda: _randn(13, 8, 8, 3), dt,
                                     "fulllane_all_to_all", {})
       for dt in ("float32", "bfloat16")},
    "fulllane_all_to_all_4x2": ((4, 2), lambda: _randn(14, 8, 8, 5), "float32",
                                "fulllane_all_to_all", {}),
    "flat_all_to_all": ((2, 4), lambda: _randn(15, 8, 8, 3), "float32", "flat_all_to_all", {}),
    **{f"fulllane_broadcast_root{r}_{dt}": ((2, 4), lambda: _randn(16, 8, 6, 2), dt,
                                            "fulllane_broadcast", {"root": r})
       for r in (0, 1) for dt in ("float32", "bfloat16")},
    **{f"kported_broadcast_k{k}": ((2, 4), lambda: _randn(17, 8, 5), "float32",
                                   "kported_broadcast_ppermute", {"k": k, "root": 0})
       for k in (1, 2, 3, 5)},
    "kported_broadcast_root5_bfloat16": ((2, 4), lambda: _randn(18, 8, 4), "bfloat16",
                                         "kported_broadcast_ppermute", {"k": 2, "root": 5}),
    **{f"kported_scatter_k{k}": ((2, 4), lambda: _randn(19, 8, 8, 2), "float32",
                                 "kported_scatter_ppermute", {"k": k, "root": 0})
       for k in (1, 2, 4)},
    "kported_scatter_root5": ((2, 4), lambda: _randn(20, 8, 8, 2), "float32",
                              "kported_scatter_ppermute", {"k": 2, "root": 5}),
}


def grad_cotangent(name: str, out_shape: tuple) -> np.ndarray:
    """The seeded cotangent of case ``name``: [8, *out_shape], row r rank r's."""
    return _randn(100 + list(GRAD_CASES).index(name), WORLD, *out_shape)


def run_grad_cases() -> dict:
    """Every case of ``GRAD_CASES`` on this rank, one mesh at a time.
    Returns, by case, this rank's gradient ``[1, ...]`` as float32
    (``"grad"``), its dtype, the output's shape and whether the input was
    left unchanged."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.core.groups import Mesh2D

    meshes = {}
    out = {}
    for name, (shape, make, dtype, fn, kw) in GRAD_CASES.items():
        if shape not in meshes:
            meshes[shape] = Mesh2D(*shape)
        mesh = meshes[shape]
        me = mesh.world.index
        dt = getattr(torch, dtype)
        x = torch.from_numpy(make()[me]).to(dt).requires_grad_()
        f = getattr(C, fn)
        if fn.startswith("kported"):
            y = f(x, mesh.world, **kw)
        else:
            y = f(x, mesh.pod, mesh.lane, **kw)
        c = torch.from_numpy(grad_cotangent(name, tuple(y.shape))[me]).to(dt)
        (g,) = torch.autograd.grad((c * y).sum(), x)
        out[name] = {"grad": g.float()[None], "dtype": str(g.dtype).removeprefix("torch."),
                     "out_shape": list(y.shape),
                     "input_unchanged": torch.equal(x.detach(),
                                                    torch.from_numpy(make()[me]).to(dt))}
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
    synced over the (pods, lanes) data-parallel axes of a (pod, data,
    model = 1) ``DeviceMesh`` (``core.groups.MeshAxes``) by each backend.
    Returns, by backend, the synced gradients and the updated parameters
    (by key) and the metrics."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.groups import MeshAxes
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import map_tree
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import batch_to, grad_and_metrics, make_train_step, sync

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    mesh = MeshAxes(make_device_mesh((pods, lanes, 1), ("pod", "data", "model"), "cpu"))
    me, per = mesh.world.index, batch // mesh.world.size
    mine = {k: v[me * per:(me + 1) * per]
            for k, v in make_batch(cfg, batch, seq, seed=0, step=0).items()}
    saved = np.load(params_npz)
    opt_cfg = OptConfig(learning_rate=lr, warmup_steps=warmup)
    out = {}
    for backend in ("xla", "fulllane"):
        params = map_tree(lambda path, _: torch.from_numpy(saved[path].copy()),
                          lm.model_meta(cfg))
        axes = (mesh.pod, mesh.data)
        grads, _ = sync(*grad_and_metrics(cfg, params, batch_to(mine, "cpu")), axes, backend)
        step = make_train_step(cfg, opt_cfg, axes=axes, backend=backend)
        params, _, metrics = step(params, init_opt_state(params, opt_cfg), mine)
        flat = {"grads": {}, "params": {}}
        map_tree(lambda path, t: flat["grads"].__setitem__(path, t), grads)
        map_tree(lambda path, t: flat["params"].__setitem__(path, t), params)
        out[backend] = {**flat, "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


#: the sharded step's parity cases: (arch, microbatches), float32 smoke
#: configs at the reference's FSDP default
SHARDED_CASES = [("yi_6b", 1), ("gemma_7b", 2), ("musicgen_large", 2), ("deepseek_v2_236b", 1),
                 ("falcon_mamba_7b", 1), ("jamba_1_5_large_398b", 1)]
#: every config whose placements are checked, at fsdp True and False
PLACED_ARCHS = ["yi_6b", "gemma_7b", "musicgen_large", "deepseek_v2_236b", "falcon_mamba_7b",
                "jamba_1_5_large_398b", "h2o_danube_3_4b", "minicpm3_4b", "qwen2_vl_7b",
                "dbrx_132b"]
#: the dispatchers whose plain versions' input shapes are recorded, and the
#: argument whose shape is kept
RECORDED = {"rmsnorm_ref": 0, "rmsnorm_bwd_ref": 0, "flash_attention_ref": 0,
            "flash_attention_bwd_ref": 0, "mamba_scan_ref": 0, "mamba_scan_bwd_ref": 0}


def sharded_config(arch: str, microbatches: int = 1, fsdp: bool = True):
    """The float32 smoke config of ``arch`` with ``microbatches`` and
    ``fsdp`` (shared with the test, which builds the reference's)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, dtype="float32", parallel=dataclasses.replace(
        cfg.parallel, microbatches=microbatches, fsdp=fsdp))


def _flat(tree) -> dict:
    from repro_torch.models.params import map_tree

    out = {}
    map_tree(lambda path, t: out.__setitem__(path, t), tree)
    return out


def sharded_ranks(npz_dir: str, batch: int, seq: int, lr: float, warmup: int) -> dict:
    """The sharded train step on the (pod 2, data 2, model 2) mesh of 8
    ranks, on the CPU.  For each case of ``SHARDED_CASES``, from the
    reference's parameters in ``<npz_dir>/<arch>.npz`` (by "/"-joined key)
    and ``make_batch(seed=0, step=0)``: one step of
    ``make_train_step_sharded``; rank 0 returns the metrics and the
    gathered updated parameters and moments, and every rank its local shard
    of each parameter before the step and the shapes its kernels' plain
    versions were called at.  Then the shard_map step with TP on ``yi_6b``
    (``fsdp=False``) for both backends, the local shapes of every
    parameter and moment of every config of ``PLACED_ARCHS`` at fsdp True
    and False, RMSNorm's ``dw`` under batch sharding against the one-card
    ``dw``, and the staged process group's collectives on the CPU."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import layers, lm
    from repro_torch.models.params import full_params, map_tree, shard_params, shard_tensor
    from repro_torch.training import train_step as T
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state

    rank = dist.get_rank()
    mesh = make_device_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    opt_cfg = OptConfig(learning_rate=lr, warmup_steps=warmup)

    def load(cfg, arch):
        saved = np.load(f"{npz_dir}/{arch}.npz")
        return map_tree(lambda path, _: torch.from_numpy(saved[path].copy()), lm.model_meta(cfg))

    shapes = []

    def recording(name, fn):
        def wrapped(*args, **kw):
            shapes.append((name, list(args[RECORDED[name]].shape)))
            return fn(*args, **kw)
        return wrapped

    saved_refs = {n: getattr(ops, n) for n in RECORDED}
    out = {"sharded": {}, "tp": {}, "placed": {}}
    try:
        for n, fn in saved_refs.items():
            setattr(ops, n, recording(n, fn))
        for arch, micro in SHARDED_CASES:
            cfg = sharded_config(arch, micro)
            step, (pspec, _) = T.make_train_step_sharded(cfg, mesh, opt_cfg)
            params = shard_params(load(cfg, arch), pspec, mesh)
            before = {k: t.to_local().clone() for k, t in _flat(params).items()}
            opt = init_opt_state(params, opt_cfg, T.opt_placements(cfg, mesh))
            shapes.clear()
            params, opt, metrics = step(params, opt, make_batch(cfg, batch, seq, seed=0, step=0))
            case = {"metrics": metrics, "local_before": before, "kernel_shapes": list(shapes),
                    "step": int(opt["step"])}
            full = {"params": full_params(params), "m": full_params(opt["m"]),
                    "v": full_params(opt["v"])}
            if rank == 0:
                case.update({k: _flat(v) for k, v in full.items()})
            out["sharded"][arch] = case
    finally:
        for n, fn in saved_refs.items():
            setattr(ops, n, fn)

    cfg = sharded_config("yi_6b", fsdp=False)
    for backend in ("xla", "fulllane"):
        params = shard_params(load(cfg, "yi_6b"), T.param_pspecs(cfg, mesh), mesh)
        opt = init_opt_state(params, opt_cfg, T.opt_placements(cfg, mesh))
        step = T.make_train_step(cfg, opt_cfg, backend=backend, mesh=mesh)
        params, opt, metrics = step(params, opt, make_batch(cfg, batch, seq, seed=0, step=0))
        full = {"params": _flat(full_params(params)), "m": _flat(full_params(opt["m"]))}
        out["tp"][backend] = {"metrics": {k: float(v) for k, v in metrics.items()},
                              **(full if rank == 0 else {})}

    for arch in PLACED_ARCHS:
        for fsdp in (True, False):
            cfg = sharded_config(arch, fsdp=fsdp)
            params = shard_params(lm.init_model(cfg, torch.Generator().manual_seed(0),
                                                device="cpu"), T.param_pspecs(cfg, mesh), mesh)
            opt = init_opt_state(params, opt_cfg, T.opt_placements(cfg, mesh))
            out["placed"][f"{arch} fsdp={fsdp}"] = {
                "params": {k: list(t.to_local().shape) for k, t in _flat(params).items()},
                "m": {k: list(t.to_local().shape) for k, t in _flat(opt["m"]).items()},
                "v": {k: list(t.to_local().shape) for k, t in _flat(opt["v"]).items()}}

    # RMSNorm's dw from each rank's rows, and the one-card dw
    r = np.random.RandomState(7)
    x, w, c = (torch.from_numpy(r.randn(*s).astype(np.float32))
               for s in ((8, 16, 64), (64,), (8, 16, 64)))
    dp = (Shard(0), Shard(0), Replicate())
    xs = shard_tensor(x, mesh, dp).requires_grad_()
    ws = shard_tensor(w, mesh, (Replicate(),) * 3).requires_grad_()
    (layers.rms_norm(xs, ws) * shard_tensor(c, mesh, dp)).sum().backward()
    w1 = w.clone().requires_grad_()
    (layers.rms_norm(x, w1) * c).sum().backward()
    out["dw"] = {"sharded": ws.grad.full_tensor(), "one_card": w1.grad,
                 "placements": str(ws.grad.placements)}

    # every kernel dispatcher on DTensors, against the call on whole tensors
    out["dispatch"] = _dispatch_on_shards(mesh)

    # the staged group (the card's mesh groups under gloo) on the CPU: DTensor's
    # collectives and the paper's sums through it, against plain gloo
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from repro_torch.core import collectives as C
    from repro_torch.core.groups import STAGED, MeshAxes, mesh_groups, register_staged

    register_staged()
    staged = DeviceMesh.from_group(mesh_groups((2, 2, 2), STAGED), "cpu",
                                   mesh=torch.arange(8).reshape(2, 2, 2),
                                   mesh_dim_names=("pod", "data", "model"))
    v = torch.arange(16.0).reshape(4, 4) + rank
    sv = DTensor.from_local(v, staged, (Shard(0), Shard(1), Partial()))
    gv = DTensor.from_local(v, mesh, (Shard(0), Shard(1), Partial()))
    to = (Shard(1), Replicate(), Shard(0))
    view = MeshAxes(staged)
    out["staged"] = {
        "backend": str(dist.get_backend(staged.get_group("data"))),
        "full": torch.equal(sv.full_tensor(), gv.full_tensor()),
        "reshard": torch.equal(sv.redistribute(staged, to).to_local(),
                               gv.redistribute(mesh, to).to_local()),
        "psum": torch.equal(C.hierarchical_psum(v, view.pod, view.data),
                            C.flat_psum(v, view.pod, view.data)),
        "transport": view.data.transport(v)}

    return out


def _dispatch_on_shards(mesh) -> dict:
    """Each ``kernels/ops`` dispatcher called with DTensors (seeded inputs,
    sharded over rows, heads or channels) and with the whole tensors: the
    largest difference of each output, gathered, over max(its largest
    value, 1)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels import ops
    from repro_torch.models.params import shard_tensor

    r = np.random.RandomState(11)

    def t(*shape):
        return torch.from_numpy(r.randn(*shape).astype(np.float32))

    rows, rep = (Shard(0), Shard(0), Shard(1)), (Replicate(),) * 3
    heads = (Shard(0), Shard(0), Shard(0))
    chans, batch = (Shard(0), Shard(0), Shard(2)), (Shard(0), Shard(0), Replicate())
    x, w, dy = t(8, 4, 16), t(16), t(8, 4, 16)
    q, k, v, do = t(16, 32, 8), t(8, 32, 8), t(8, 32, 8), t(16, 32, 8)
    o, lse = ops.flash_attention(q, k, v, group_size=2, return_lse=True)
    a = torch.from_numpy(r.uniform(0.5, 1.0, (4, 8, 16, 4)).astype(np.float32))
    b, c, gy = t(4, 8, 16, 4), t(4, 8, 4), t(4, 8, 16)
    pk = t(4, 2, 3, 5)
    cases = {
        "rmsnorm": (ops.rmsnorm, (x, w), (rows, rep), {}),
        "rmsnorm_bwd": (ops.rmsnorm_bwd, (x, w, dy), (rows, rep, rows), {}),
        "flash_attention": (ops.flash_attention, (q, k, v), (heads,) * 3,
                            {"group_size": 2, "return_lse": True}),
        "flash_attention_bwd": (ops.flash_attention_bwd, (q, k, v, o, lse, do), (heads,) * 6,
                                {"group_size": 2}),
        "mamba_scan": (ops.mamba_scan, (a, b, c), (chans, chans, batch), {}),
        "mamba_scan_bwd": (ops.mamba_scan_bwd, (a, b, c, None, gy),
                           (chans, chans, batch, None, chans), {}),
        "a2a_pack": (ops.a2a_pack, (pk,), ((Shard(0), Shard(1), Replicate()),), {}),
    }
    out = {}
    for name, (fn, args, pls, kw) in cases.items():
        whole = fn(*args, **kw)
        sharded = fn(*(None if a_ is None else shard_tensor(a_, mesh, pl)
                       for a_, pl in zip(args, pls)), **kw)
        whole = whole if isinstance(whole, tuple) else (whole,)
        sharded = sharded if isinstance(sharded, tuple) else (sharded,)
        out[name] = max(float((s_.full_tensor() - w_).abs().max() / max(w_.abs().max(), 1.0))
                        for s_, w_ in zip(sharded, whole))
    return out


def cli_runs(runs: list) -> list:
    """Each argument list of ``runs`` through ``launch/train.main`` in these
    ranks, in turn (each a meshed run: the world is up); rank 0's result of
    each."""
    from repro_torch.launch import train

    return [train.main(argv) for argv in runs]
