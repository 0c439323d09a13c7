"""Jobs that the tests run in ranks (``repro_torch.launch.ranks``).  This
module imports no JAX, and no torch until a job runs.  Among them:
``sharded_ranks`` and ``moe_ranks`` (the sharded train steps and the
expert-parallel MoE layer), ``sharded_serve_ranks`` (sharded serving) and
``dryrun_ranks`` (the dry-run's sharded cells run for real).

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


#: the sharded step's parity cases: name -> (arch, microbatches,
#: moe_groups), float32 smoke configs at the reference's FSDP default;
#: ``moe_groups`` 4 is the data-parallel world, each rank routing its own
#: group
SHARDED_CASES = {"yi_6b": ("yi_6b", 1, 1), "gemma_7b": ("gemma_7b", 2, 1),
                 "musicgen_large": ("musicgen_large", 2, 1),
                 "deepseek_v2_236b": ("deepseek_v2_236b", 1, 1),
                 "falcon_mamba_7b": ("falcon_mamba_7b", 1, 1),
                 "jamba_1_5_large_398b": ("jamba_1_5_large_398b", 1, 1),
                 "dbrx_132b": ("dbrx_132b", 1, 1), "dbrx_132b-g4": ("dbrx_132b", 1, 4),
                 "deepseek_v2_236b-g4": ("deepseek_v2_236b", 1, 4)}
#: the shard_map step with TP's parity cases (``fsdp=False``): name ->
#: (arch, backend)
TP_CASES = {"xla": ("yi_6b", "xla"), "fulllane": ("yi_6b", "fulllane"),
            "deepseek_v2_236b": ("deepseek_v2_236b", "xla")}
#: every config whose placements are checked, at fsdp True and False
PLACED_ARCHS = ["yi_6b", "gemma_7b", "musicgen_large", "deepseek_v2_236b", "falcon_mamba_7b",
                "jamba_1_5_large_398b", "h2o_danube_3_4b", "minicpm3_4b", "qwen2_vl_7b",
                "dbrx_132b"]
#: the dispatchers whose plain versions' input shapes are recorded, and the
#: argument whose shape is kept
RECORDED = {"rmsnorm_ref": 0, "rmsnorm_bwd_ref": 0, "flash_attention_ref": 0,
            "flash_attention_bwd_ref": 0, "mamba_scan_ref": 0, "mamba_scan_bwd_ref": 0}


def sharded_config(arch: str, microbatches: int = 1, fsdp: bool = True, moe_groups: int = 1):
    """The float32 smoke config of ``arch`` with ``microbatches``, ``fsdp``
    and ``moe_groups`` (shared with the test, which builds the
    reference's)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, dtype="float32", parallel=dataclasses.replace(
        cfg.parallel, microbatches=microbatches, fsdp=fsdp, moe_groups=moe_groups))


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
    versions were called at.  Then the shard_map step with TP
    (``fsdp=False``) for each case of ``TP_CASES``, the local shapes of every
    parameter and moment of every config of ``PLACED_ARCHS`` at fsdp True
    and False, RMSNorm's ``dw`` under batch sharding against the one-card
    ``dw``, and the staged process group's collectives on the CPU."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import layers, lm
    from repro_torch.models import moe as moe_mod
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
    saved_moe = moe_mod.moe
    out = {"sharded": {}, "tp": {}, "placed": {}}
    try:
        for n, fn in saved_refs.items():
            setattr(ops, n, recording(n, fn))
        for name, (arch, micro, groups) in SHARDED_CASES.items():
            cfg = sharded_config(arch, micro, moe_groups=groups)
            step, (pspec, _) = T.make_train_step_sharded(cfg, mesh, opt_cfg)
            params = shard_params(load(cfg, arch), pspec, mesh)
            before = {k: t.to_local().clone() for k, t in _flat(params).items()}
            opt = init_opt_state(params, opt_cfg, T.opt_placements(cfg, mesh))
            shapes.clear()
            with comms(mesh) as comm:
                moe_mod.moe = moe_tagged(saved_moe, comm)
                params, opt, metrics = step(params, opt, make_batch(cfg, batch, seq, seed=0,
                                                                    step=0))
            case = {"metrics": metrics, "local_before": before, "kernel_shapes": list(shapes),
                    "step": int(opt["step"]),
                    "moe_collectives": [c[:3] for c in comm.calls if c[3] == "moe"]}
            full = {"params": full_params(params), "m": full_params(opt["m"]),
                    "v": full_params(opt["v"])}
            if rank == 0:
                case.update({k: _flat(v) for k, v in full.items()})
            out["sharded"][name] = case
        for n, fn in saved_refs.items():
            setattr(ops, n, fn)
        for name, (arch, backend) in TP_CASES.items():
            cfg = sharded_config(arch, fsdp=False)
            params = shard_params(load(cfg, arch), T.param_pspecs(cfg, mesh), mesh)
            opt = init_opt_state(params, opt_cfg, T.opt_placements(cfg, mesh))
            step = T.make_train_step(cfg, opt_cfg, backend=backend, mesh=mesh)
            with comms(mesh) as comm:
                moe_mod.moe = moe_tagged(saved_moe, comm)
                params, opt, metrics = step(params, opt, make_batch(cfg, batch, seq, seed=0,
                                                                    step=0))
            full = {"params": _flat(full_params(params)), "m": _flat(full_params(opt["m"]))}
            out["tp"][name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                               "moe_collectives": [c[:3] for c in comm.calls if c[3] == "moe"],
                               **(full if rank == 0 else {})}
    finally:
        moe_mod.moe = saved_moe
        for n, fn in saved_refs.items():
            setattr(ops, n, fn)

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


def comms(mesh):
    """A ``CommDebugMode`` that also keeps each collective of a mesh dim's
    group in ``calls``, as (op, mesh dim name, input shape, its ``tag`` at
    the time)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    names = mesh.mesh_dim_names
    dims = {mesh.get_group(i).group_name: names[i] for i in range(mesh.ndim)}

    class Comms(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.calls, self.tag = [], None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(t is DTensor for t in types) and hasattr(func, "_overloadpacket"):
                group = next((a for a in reversed(args) if isinstance(a, str) and a in dims),
                             None)
                if group is not None:
                    self.calls.append((func._overloadpacket.__name__, dims[group],
                                       list(args[0].shape), self.tag))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Comms()


def moe_tagged(fn, comm):
    """``fn`` (``models/moe.moe``) with the collectives it issues tagged
    "moe" in ``comm`` (``comms``)."""
    def tagged(*args, **kw):
        comm.tag = "moe"
        try:
            return fn(*args, **kw)
        finally:
            comm.tag = None
    return tagged


#: the expert-parallel MoE layer's cases (``moe_ranks``): name -> (arch,
#: moe_groups, num_experts or None for the config's).  Three experts do not
#: split over ``model`` = 2, so the rules give it the experts' ``ff``
MOE_CASES = {
    "dbrx_g1": ("dbrx_132b", 1, None),
    "dbrx_g2": ("dbrx_132b", 2, None),
    "dbrx_g4": ("dbrx_132b", 4, None),
    "dbrx_e3_g1": ("dbrx_132b", 1, 3),
    "dbrx_e3_g4": ("dbrx_132b", 4, 3),
    "deepseek_g1": ("deepseek_v2_236b", 1, None),
    "deepseek_g4": ("deepseek_v2_236b", 4, None),
}
#: faults planted in one rank of a case (``moe_ranks``), each of which the
#: test's check must catch: name -> (case, rank)
MOE_FAULTS = {"dropped_partial": ("dbrx_g4", 1), "group_offset": ("dbrx_g4", 2)}
#: the layer's input [B, S, D] over the (pod 2, data 2, model 2) mesh: 2 rows
#: of 16 tokens a data-parallel rank
MOE_B, MOE_S = 8, 16


def moe_config(arch: str, groups: int, experts):
    """The float32 smoke config of ``arch`` with ``moe_groups`` and
    ``num_experts`` (None: the config's); the test builds the same."""
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    e = cfg.moe if experts is None else dataclasses.replace(cfg.moe, num_experts=experts)
    return dataclasses.replace(cfg, dtype="float32", moe=e, parallel=dataclasses.replace(
        cfg.parallel, moe_groups=groups))


def moe_inputs(cfg) -> dict:
    """The layer's seeded inputs, float32 numpy: its parameters (by key,
    each drawn at ``1/sqrt`` of its input width), ``x`` [B, S, D] and the
    output's cotangent ``c``."""
    from repro_torch.models.moe import moe_meta

    r = np.random.RandomState(29)
    out = {k: (r.randn(*m.shape) / np.sqrt(m.shape[-2])).astype(np.float32)
           for k, m in sorted(moe_meta(cfg).items())}
    out["x"] = _randn(30, MOE_B, MOE_S, cfg.d_model)
    out["c"] = _randn(31, MOE_B, MOE_S, cfg.d_model)
    return out


def moe_ranks() -> dict:
    """The expert-parallel MoE layer (``models/moe.moe`` on DTensors) on the
    (pod 2, data 2, model 2) mesh of 8 ranks, on the CPU, for each case of
    ``MOE_CASES``: its parameters placed by the FSDP rules, ``x`` and ``c``
    over the data-parallel dims, the loss ``sum(c * out) + aux`` and its
    gradients.  Rank 0 returns the output, aux loss and every gradient,
    gathered; every rank the weight shapes each ``expert_ffn`` call saw,
    its bmm FLOPs in the forward (``FlopCounterMode``) beside the one-rank
    layer's, and the collectives of the forward and of the backward by
    (op, mesh dim, input shape).  Then each fault of ``MOE_FAULTS`` planted
    in its rank (``_route_on_rank`` routing the next data-parallel rank's
    rows, ``_experts_on_rank``'s partial dropped): the gathered output and
    gradients."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.params import partition_specs, shard_params, shard_tensor

    rank = dist.get_rank()
    mesh = make_device_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    names = mesh.mesh_dim_names

    def bmm_flops(counter) -> int:
        return int(counter.get_flop_counts().get("Global", {}).get(torch.ops.aten.bmm, 0))

    spied = []

    def run(cfg, inputs, record=False):
        keys = [k for k in inputs if k not in ("x", "c")]
        full = {k: torch.from_numpy(inputs[k]) for k in keys}
        specs = partition_specs(M.moe_meta(cfg), dict(zip(names, mesh.shape)), fsdp=True)
        p = {k: t.requires_grad_() for k, t in shard_params(full, specs, mesh).items()}
        dp = (Shard(0), Shard(0), Replicate())
        x = shard_tensor(torch.from_numpy(inputs["x"]), mesh, dp).requires_grad_()
        c = shard_tensor(torch.from_numpy(inputs["c"]), mesh, dp)
        fwd, bwd, flops = comms(mesh), comms(mesh), FlopCounterMode(display=False)
        with fwd, flops:
            out, aux = M.moe(cfg, p, x)
        loss = (out * c).sum() + aux
        with bwd:
            grads = torch.autograd.grad(loss, [x, *(p[k] for k in keys)])
        res = {"out": out.full_tensor().detach(), "aux": aux.full_tensor().detach(),
               "grads": {k: g.full_tensor() for k, g in zip(["x", *keys], grads)},
               "grad_placements": {k: str(g.placements) for k, g in zip(["x", *keys], grads)}}
        if record:
            res["expert_ffn"] = list(spied)  # the sharded forward's calls
            one = FlopCounterMode(display=False)
            with one:
                M.moe(cfg, full, torch.from_numpy(inputs["x"]))
            res.update(fwd=[c[:3] for c in fwd.calls], bwd=[c[:3] for c in bwd.calls],
                       flops=bmm_flops(flops),
                       one_rank_flops=bmm_flops(one), specs={k: list(v) for k, v in specs.items()})
        return res

    saved = {n: getattr(M, n) for n in ("expert_ffn", "_route_on_rank", "_experts_on_rank")}

    def spy(be, wg, wu, wd):
        spied.append([list(wg.shape), list(wu.shape), list(wd.shape)])
        return saved["expert_ffn"](be, wg, wu, wd)

    def next_rows(inputs):
        """``_route_on_rank`` routing the rows of the next data-parallel rank."""
        def route(cfg_, router, x, G):
            share = (rank // 2 + 1) % 4 * x.shape[0]
            x = torch.from_numpy(inputs["x"][share:share + x.shape[0]]) + 0 * x
            return saved["_route_on_rank"](cfg_, router, x, G)
        return route

    def no_partial(*args):
        """``_experts_on_rank`` whose partial is left out of the sum over model."""
        return saved["_experts_on_rank"](*args) * 0

    out = {"cases": {}, "faults": {}}
    try:
        M.expert_ffn = spy
        for name, case in MOE_CASES.items():
            cfg = moe_config(*case)
            spied.clear()
            out["cases"][name] = run(cfg, moe_inputs(cfg), record=True)
        for name, (case, bad) in MOE_FAULTS.items():
            cfg = moe_config(*MOE_CASES[case])
            inputs = moe_inputs(cfg)
            if rank == bad and name == "group_offset":
                M._route_on_rank = next_rows(inputs)
            elif rank == bad:
                M._experts_on_rank = no_partial
            out["faults"][name] = run(cfg, inputs)
            M._route_on_rank = saved["_route_on_rank"]
            M._experts_on_rank = saved["_experts_on_rank"]
    finally:
        for n, fn in saved.items():
            setattr(M, n, fn)
    if rank:
        for res in (*out["cases"].values(), *out["faults"].values()):
            for k in ("out", "aux", "grads"):
                res.pop(k)
    return out


#: sharded serving's parity cases (``sharded_serve_ranks``): name -> (arch,
#: moe_groups), float32 smoke configs at the reference's FSDP default
SERVE_CASES = {"yi_6b": ("yi_6b", 1), "h2o_danube_3_4b": ("h2o_danube_3_4b", 1),
               "falcon_mamba_7b": ("falcon_mamba_7b", 1),
               "deepseek_v2_236b": ("deepseek_v2_236b", 1), "dbrx_132b": ("dbrx_132b", 1),
               "dbrx_132b-g4": ("dbrx_132b", 4),
               "jamba_1_5_large_398b": ("jamba_1_5_large_398b", 1),
               "musicgen_large": ("musicgen_large", 1), "qwen2_vl_7b": ("qwen2_vl_7b", 1)}
#: prompts [B, S], decode steps, and the cache's capacity: Danube's 8-slot
#: ring wraps in decode (S % 8 == 0, where the two packages' rings agree)
SERVE_B, SERVE_S, SERVE_STEPS = 8, 16, 4
SERVE_CAP = {"h2o_danube_3_4b": 8}
#: the case also served at B = 1 (no activation hook: the batch does not
#: split over the data-parallel ranks)
SERVE_B1 = "yi_6b"


def serve_capacity(name: str) -> int:
    return SERVE_CAP.get(SERVE_CASES[name][0], 32)


def sharded_serve_ranks(npz_dir: str) -> dict:
    """Sharded serving (``lm.prefill`` and ``lm.decode_step`` on DTensors,
    with ``make_act_shard``'s hook) on the (pod 2, data 2, model 2) mesh of
    8 ranks, on the CPU.  For each case of ``SERVE_CASES``, from
    ``<npz_dir>/<name>.npz`` (the reference's parameters under "p/", the
    prompt under "x/prompt" (and "x/positions"), the decode inputs under
    "x/steps"): the parameters placed by ``param_pspecs``
    (``convert.params_from_numpy``, then ``shard_params``), the prompt and
    each step's tokens by ``batch_pspecs``; a prefill into the case's
    capacity, then ``SERVE_STEPS`` decode steps.  Every rank returns its
    logits (replicated) after the prefill and each step, and its local
    shard and placements of every cache leaf after the prefill and after
    the last step.  ``SERVE_B1`` is served again on the first prompt row
    alone, with no hook."""
    import torch
    import torch.distributed as dist

    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import map_tree, placements, shard_params, shard_tensor
    from repro_torch.training import train_step as T

    del dist
    mesh = make_device_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")

    def place(tree):
        return map_tree(lambda _, t, spec: shard_tensor(t, mesh, placements(spec, mesh)),
                        tree, SP.batch_pspecs(mesh, tree))

    def shards(cache):
        return {path: (t.to_local().clone(), str(t.placements))
                for path, t in _flat(cache).items()}

    def serve(cfg, params, saved, rows, act, cap):
        prompt = {"tokens" if cfg.embed_inputs else "embeds":
                  torch.from_numpy(saved["x/prompt"][rows].copy())}
        if "x/positions" in saved:
            prompt["positions"] = torch.from_numpy(saved["x/positions"][rows].copy())
        lg, cache = lm.prefill(cfg, params, place(prompt), capacity=cap, act_shard=act)
        out = {"logits": [lg.to_local().clone()], "prefill_cache": shards(cache)}
        for t, step in enumerate(saved["x/steps"]):
            lg, cache = lm.decode_step(cfg, params, place(torch.from_numpy(step[rows].copy())),
                                       cache, SERVE_S + t, act_shard=act)
            out["logits"].append(lg.to_local().clone())
        out["cache"] = shards(cache)
        return out

    out = {}
    for name, (arch, groups) in SERVE_CASES.items():
        cfg = sharded_config(arch, moe_groups=groups)
        saved = dict(np.load(f"{npz_dir}/{name}.npz"))
        tree = map_tree(lambda path, _: saved[f"p/{path}"], lm.model_meta(cfg))
        full = params_from_numpy(cfg, tree, device="cpu")
        params = shard_params(full, T.param_pspecs(cfg, mesh), mesh)
        act = T.make_act_shard(cfg, mesh)
        out[name] = serve(cfg, params, saved, slice(None), act, serve_capacity(name))
        if name == SERVE_B1:
            out[name + "-b1"] = serve(cfg, params, saved, slice(0, 1), None,
                                      serve_capacity(name))
    return out


#: the dry-run's sharded cells (``launch/dryrun.measure_cell`` at smoke
#: size on the (pod 2, data 2, model 2) mesh) that ``dryrun_ranks`` runs
#: for real: (arch, kind, global batch, sequence)
DRYRUN_REAL = [("yi_6b", "train", 16, 64), ("yi_6b", "prefill", 8, 64),
               ("yi_6b", "decode", 8, 64), ("deepseek_v2_236b", "prefill", 8, 64),
               ("deepseek_v2_236b", "decode", 8, 64), ("falcon_mamba_7b", "decode", 8, 64)]


def dryrun_ranks() -> dict:
    """Each cell of ``DRYRUN_REAL`` run for real in 8 gloo ranks on the CPU,
    as the dry-run runs it on meta shards: the smoke config as it is
    (bf16), random parameters placed by ``param_pspecs``; a train cell one
    step of ``make_train_step_sharded`` (moments by ``opt_placements``,
    ``make_batch``), a prefill ``lm.prefill`` of int32 tokens placed by
    ``batch_pspecs`` into a capacity of S, a decode step ``lm.decode_step``
    of int32 tokens against a zero cache of capacity S placed by
    ``shard_cache``, at a tensor position, each with ``make_act_shard``'s
    hook.  Every rank returns the collectives its pass issued
    (``costanalysis.CollectiveBytes``): bytes and counts by kind."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import costanalysis as CA
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import map_tree, placements, shard_params, shard_tensor
    from repro_torch.training import train_step as T
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state

    mesh = make_device_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")

    def place(tree):
        return map_tree(lambda _, t, spec: shard_tensor(t, mesh, placements(spec, mesh)),
                        tree, SP.batch_pspecs(mesh, tree))

    out = {}
    for arch, kind, B, S in DRYRUN_REAL:
        cfg = get_smoke_config(arch)
        full = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
        params = shard_params(full, T.param_pspecs(cfg, mesh), mesh)
        act = T.make_act_shard(cfg, mesh)
        tokens = torch.from_numpy(np.random.RandomState(1).randint(
            0, cfg.vocab_size, (B, S)).astype(np.int32))
        rec = CA.CollectiveBytes()
        if kind == "train":
            opt_cfg = OptConfig(moment_dtype=cfg.parallel.optimizer_dtype)
            opt = init_opt_state(params, opt_cfg, T.opt_placements(cfg, mesh))
            step, _ = T.make_train_step_sharded(cfg, mesh, opt_cfg)
            batch = make_batch(cfg, B, S, seed=0, step=0)
            with rec:
                step(params, opt, batch)
        elif kind == "prefill":
            batch = place({"tokens": tokens})
            with rec:
                lm.prefill(cfg, params, batch, capacity=S, act_shard=act)
        else:
            cache = SP.shard_cache(cfg, lm.init_cache(cfg, B, S, device="cpu"), mesh)
            tok = place(tokens[:, :1].contiguous())
            pos = torch.tensor(S // 2)
            with rec:
                lm.decode_step(cfg, params, tok, cache, pos, act_shard=act)
        out[f"{arch}/{kind}"] = {"bytes": rec.bytes, "counts": rec.counts}
    return out


#: the fused scan's shapes on the (2, 2, 2) mesh: batch rows over (pod,
#: data), channels over model
FUSED_SHAPE = {"B": 4, "S": 9, "di": 16, "N": 4}


def fused_scan_ranks() -> dict:
    """Each rank: ``ops.mamba_scan_fused`` and ``ops.mamba_scan_fused_bwd``
    on DTensors (dt, x, y, gy over rows and channels; B, C over rows; A
    over channels; h0, gh_fin, h_last over rows and channels) against the
    same calls on the whole tensors, and ``models.mamba.selective_scan_fused``
    differentiated on DTensors against its one-tensor gradients: each
    output's largest difference, gathered, over max(its largest value, 1),
    and the gradients' placements."""
    import torch
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import mamba as TM
    from repro_torch.models.params import shard_tensor

    mesh = make_device_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    r = np.random.RandomState(5)
    B, S, di, N = (FUSED_SHAPE[k] for k in ("B", "S", "di", "N"))

    def t(*shape):
        return torch.from_numpy(r.randn(*shape).astype(np.float32))

    dt, x, Bm, Cm = F.softplus(t(B, S, di)), t(B, S, di), t(B, S, N), t(B, S, N)
    A, h0, gy, gh = -torch.exp(0.1 * t(di, N)), t(B, di, N), t(B, S, di), t(B, di, N)
    rc = (Shard(0), Shard(0), Shard(2))  # [B, S, di]
    rows = (Shard(0), Shard(0), Replicate())  # [B, S, N]
    chans = (Replicate(), Replicate(), Shard(0))  # [di, N]
    hs = (Shard(0), Shard(0), Shard(1))  # [B, di, N]
    pls = (rc, rc, rows, rows, chans, hs, rc, hs)
    whole = (dt, x, Bm, Cm, A, h0, gy, gh)
    placed = [shard_tensor(w, mesh, pl) for w, pl in zip(whole, pls)]

    def err(got, want) -> float:
        return float((got.full_tensor() - want).abs().max() / max(want.abs().max(), 1.0))

    out = {"forward": [err(g, w) for g, w in zip(ops.mamba_scan_fused(*placed[:6]),
                                                 ops.mamba_scan_fused(*whole[:6]))]}
    got = ops.mamba_scan_fused_bwd(*placed)
    out["backward"] = [err(g, w) for g, w in zip(got, ops.mamba_scan_fused_bwd(*whole))]
    out["backward_placements"] = [str(tuple(g.placements)) for g in got]
    # the custom VJP on DTensors: the loss sum(y gy) + sum(h_last gh)
    leaves = [w.clone().requires_grad_() for w in whole[:6]]
    y, h = TM.selective_scan_fused(*leaves)
    want = torch.autograd.grad((y * gy).sum() + (h * gh).sum(), leaves)
    dleaves = [p.detach().requires_grad_() for p in placed[:6]]
    y, h = TM.selective_scan_fused(*dleaves)
    loss = (y * placed[6]).sum() + (h * placed[7]).sum()
    grads = torch.autograd.grad(loss.full_tensor(), dleaves)
    out["vjp"] = [err(g, w) for g, w in zip(grads, want)]
    out["vjp_placements"] = [str(tuple(g.placements)) for g in grads]
    return out
