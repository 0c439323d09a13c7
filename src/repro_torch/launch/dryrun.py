"""Dry-run of every (arch x shape x mesh) cell on the meta device (the
counterpart of the reference's ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --backend fulllane
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --skip-existing   # resumable

The reference AOT-compiles each cell on 512 fake CPU devices and reads the
compiled module.  The port runs each cell's own program once, on meta
tensors (shapes and dtypes, no storage, nothing computed), and needs no
device.  The reference's programs, as its ``build_cell`` makes them:

* ``xla`` train cells: the production step (``make_train_step_pjit``; the
  port's ``training/train_step.sharded_update``, the body of
  ``make_train_step_sharded``), ``fsdp`` as the config says, with the
  parameters, moments and batch placed by ``param_pspecs``,
  ``opt_pspecs`` and ``batch_pspec``;
* prefill and decode cells (both backends): ``lm.prefill`` and
  ``lm.decode_step`` on parameters placed by ``param_pspecs``, the batch
  by ``batch_pspecs``, the cache by ``cache_pspecs``, with
  ``make_act_shard``'s hook (none for a decode batch that does not split
  over the data-parallel ranks, the reference's ``dec_act``);

each run as rank 0 of the production mesh over a fake process group of
its size (``launch/mesh.fake_device_mesh``, 256 or 512 ranks, device type
``cuda`` by default), on DTensors over meta shards.  A train cell runs
one microbatch (``sharded_update`` with one microbatch, on the global
batch's ``1/n``) and counts its gradient pass ``n`` times and the update
once; ``n`` is the config's microbatches, or fewer where a data-parallel
rank's batch holds fewer rows (``microbatches`` in the record).
``fulllane`` train cells (and ``step="shardmap"``) run the reference's
shard_map step with fsdp off, as the reference does: the gradients of one
microbatch on one data-parallel rank's rows with whole parameters, the
AdamW update, and the data-parallel sync of the reference's shard_map
step run by the port's own collectives on a device-free
``RecordingMesh`` (``flat_psum`` for ``xla``, ``hierarchical_psum`` for
``fulllane``; a one-pod mesh sums flat for both) with the ZeRO-1 gathers
of the sharded moments; ``dp_sync_sent_per_device`` gives what one rank of
that sync sends, and how much crosses pods (the paper's count,
``core.groups.Traffic``).

For each cell one JSON record goes to ``--out-dir`` (``build/dryrun/`` by
default), with the reference's keys where they mean the same thing:

* ``memory.argument_bytes`` — per device, exact: the shard bytes of the
  parameters, the optimizer state and the batch (or the cache, token and
  position) under the reference's specs;
* ``memory.peak_bytes`` — the peak of the pass's live tensors beyond its
  arguments (``launch/costanalysis.py``): rank 0's own under DTensor (a
  shard_map cell: one data-parallel rank's pass with whole parameters);
* ``flops_per_device`` — rank 0's matrix-product FLOPs (a shard_map cell:
  the global batch's over the device count, an ideal split);
* ``collective_bytes_per_device`` (and ``collective_counts_per_device``)
  — what rank 0's program issues, by the reference's kind names
  (``costanalysis.CollectiveBytes``), where the reference reads what GSPMD
  inserted from the HLO; a shard_map cell: its data-parallel sync and
  ZeRO-1 gathers.

``hbm_bytes_per_device`` is null with its reason: the reference's is a
fused-HLO traffic model.  Every number is a count from shapes, not a time
or a measurement on a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.launch import costanalysis as CA
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import MeshShape, fake_device_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.params import map_tree, torch_dtype
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.training.train_step import (
    batch_pspec,
    batch_to,
    dp_axes,
    grad_and_metrics,
    make_act_shard,
    mesh_axis_sizes,
    microbatch,
    opt_pspecs,
    param_pspecs,
    sharded_update,
)

__all__ = ["main", "measure_cell", "optimized_config", "run_cell"]


def optimized_config(cfg: ModelConfig, mesh: MeshShape) -> ModelConfig:
    """The reference's beyond-baseline ParallelConfig: group-local MoE
    dispatch sized to the DP world, bf16 gradient accumulation for the
    >=100B configs."""
    sizes = mesh_axis_sizes(mesh)
    ndp = math.prod(sizes[a] for a in dp_axes(mesh))
    pl = dataclasses.replace(
        cfg.parallel, moe_groups=ndp,
        grad_dtype="bfloat16" if cfg.param_count() > 1e11 else cfg.parallel.grad_dtype)
    return dataclasses.replace(cfg, parallel=pl)


def _per_rank(tree, n: int):
    """Each leaf's first ``1/n`` along dim 0: one DP rank's share."""
    return map_tree(lambda _, t: t[: t.shape[0] // n], tree)


def _microbatches(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshShape) -> tuple[int, int]:
    """(data-parallel ranks the global batch splits over, or 1; the
    microbatches a pass counts: the config's, or fewer where one rank's
    rows are fewer)."""
    sizes = mesh_axis_sizes(mesh)
    ndp = math.prod(sizes[a] for a in dp_axes(mesh))
    split = ndp if shape.global_batch % ndp == 0 else 1
    return split, math.gcd(shape.global_batch // split, max(cfg.parallel.microbatches, 1))


def _shardmap_train_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshShape,
                         backend: str) -> dict:
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, fsdp=False))
    sizes, dp = mesh_axis_sizes(mesh), dp_axes(mesh)
    ndp = math.prod(sizes[a] for a in dp)
    opt_cfg = OptConfig(moment_dtype=cfg.parallel.optimizer_dtype)
    params = lm.abstract_model(cfg)
    opt = init_opt_state(params, opt_cfg)
    batch = SP.batch_structs(cfg, shape.global_batch, shape.seq_len)
    pspec, ospec = param_pspecs(cfg, mesh), opt_pspecs(cfg, mesh)
    args = {"params": CA.tree_shard_bytes(params, pspec, sizes),
            "opt_state": CA.tree_shard_bytes(opt, ospec, sizes),
            "batch": CA.tree_shard_bytes(batch, batch_pspec(mesh, batch), sizes)}
    # the microbatches are alike: the pass takes one, with the accumulators
    # and the update, and counts its FLOPs once for each
    split, micro = _microbatches(cfg, shape, mesh)
    one = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, microbatches=1))

    def step(params, opt, batch):
        grads, metrics = grad_and_metrics(one, params, batch)
        adamw_update(grads, opt, params, opt_cfg)
        return metrics

    metrics, cost = CA.measure(step, params, opt, _per_rank(batch, split * micro))
    # one device's gradients: its tensor-parallel shard of each
    gdt = torch_dtype(cfg.parallel.grad_dtype)
    grads = map_tree(lambda _, p, s: torch.empty(CA.shard_shape(p.shape, s, sizes), dtype=gdt,
                                                 device="meta"), params, pspec)
    pods, lanes = (sizes[dp[0]], sizes[dp[1]]) if len(dp) == 2 else (1, sizes[dp[0]])
    coll, sent = CA.sync_bytes(grads, metrics, pods, lanes, backend if len(dp) == 2 else "xla")
    zero1 = CA.zero1_gather_bytes(opt, ospec, sizes, dp)
    if zero1:
        coll["all-gather"] = coll.get("all-gather", 0) + zero1
    return {"args": args, "flops": cost.flops * split * micro / mesh.size,
            "flops_of_pass": {"matmul": cost.matmul_flops, "kernels": cost.kernel_flops,
                              "passes_in_global_batch": split * micro,
                              "microbatches": micro},
            "peak": cost.peak_bytes, "collectives": coll, "counts": {},
            "dp_sync_sent": {"bytes": sum(c["bytes"] for c in sent.values()),
                             "cross_pod_bytes": sum(c["cross_pod_bytes"] for c in sent.values()),
                             "by_op": sent},
            "collective_sources": {"dp_sync": "training.train_step.sync on a RecordingMesh, "
                                              f"{pods} x {lanes}, backend "
                                              f"{backend if len(dp) == 2 else 'xla'}",
                                   "zero1_all_gather": zero1},
            "program": "shard_map step (fsdp off), one data-parallel rank's rows"}


def _placed_opt(opt: dict, ospec: dict, mesh) -> dict:
    return {"m": SP.placed_structs(opt["m"], ospec["m"], mesh),
            "v": SP.placed_structs(opt["v"], ospec["v"], mesh), "step": opt["step"]}


def _sum_costs(grad: CA.PassCost, total: CA.PassCost, n: int) -> tuple[float, dict, dict]:
    """FLOPs, collective bytes and counts of ``n`` gradient passes
    (``grad``: the snapshot after one) and one update (``total - grad``)."""
    def scaled(a: dict, b: dict) -> dict:
        return {k: (n - 1) * a.get(k, 0) + b[k] for k in b}
    flops = (n - 1) * grad.flops + total.flops
    return (flops, scaled(grad.collective_bytes, total.collective_bytes),
            scaled(grad.collective_counts, total.collective_counts))


def _sharded_train_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshShape,
                        device_type: str) -> dict:
    """The production step (the reference's ``make_train_step_pjit``) as
    rank 0 over a fake group: one microbatch cut from the placed global
    batch and its gradients, counted once for each microbatch, and the
    update once."""
    sizes = mesh_axis_sizes(mesh)
    opt_cfg = OptConfig(moment_dtype=cfg.parallel.optimizer_dtype)
    params = lm.abstract_model(cfg)
    opt = init_opt_state(params, opt_cfg)
    batch = SP.batch_structs(cfg, shape.global_batch, shape.seq_len)
    pspec, ospec = param_pspecs(cfg, mesh), opt_pspecs(cfg, mesh)
    args = {"params": CA.tree_shard_bytes(params, pspec, sizes),
            "opt_state": CA.tree_shard_bytes(opt, ospec, sizes),
            "batch": CA.tree_shard_bytes(batch, batch_pspec(mesh, batch), sizes)}
    _, micro = _microbatches(cfg, shape, mesh)
    one = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, microbatches=1))
    with fake_device_mesh(mesh, device_type=device_type) as dm:
        pp = SP.placed_structs(params, pspec, dm)
        po = _placed_opt(opt, ospec, dm)
        # the step's integers, as ``place_batch`` makes them (int64)
        pb = SP.placed_structs(batch_to(batch, "meta"), batch_pspec(dm, batch), dm)
        act = make_act_shard(one, dm)
        marks = []
        with CA.Meter((pp, po, pb)) as meter:
            # the step's first microbatch, cut as it cuts each, then its pass
            mb = microbatch(pb, 0, micro, act)
            sharded_update(one, pp, po, mb, act, opt_cfg,
                           grads_done=lambda: marks.append(meter.snapshot()))
            total = meter.snapshot()
    flops, coll, counts = _sum_costs(marks[0], total, micro)
    return {"args": args, "flops": flops,
            "flops_of_pass": {"matmul": total.matmul_flops, "kernels": total.kernel_flops,
                              "gradient_pass": marks[0].flops, "microbatches": micro},
            "peak": total.peak_bytes, "collectives": coll, "counts": counts,
            "dp_sync_sent": None, "collective_sources": {},
            "program": "training.train_step.sharded_update (make_train_step_sharded), "
                       f"fsdp={cfg.parallel.fsdp}, as rank 0 of {mesh.size} over a fake group"}


def _serve_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshShape, device_type: str,
                capacity: int | None = None) -> dict:
    """The reference's sharded prefill or decode step as rank 0 over a fake
    group; a prefill fills a cache of ``capacity`` (the reference's: S)."""
    sizes, dp = mesh_axis_sizes(mesh), dp_axes(mesh)
    ndp = math.prod(sizes[a] for a in dp)
    B, S = shape.global_batch, shape.seq_len
    params = lm.abstract_model(cfg)
    pspec = param_pspecs(cfg, mesh)
    args = {"params": CA.tree_shard_bytes(params, pspec, sizes)}
    with fake_device_mesh(mesh, device_type=device_type) as dm:
        pp = SP.placed_structs(params, pspec, dm)
        act = make_act_shard(cfg, dm)
        if shape.kind == "prefill":
            # the reference's jit drops an argument its program never reads
            # (``keep_unused=False``): the batch's labels
            inputs = {k: v for k, v in SP.batch_structs(cfg, B, S).items() if k != "labels"}
            args["batch"] = CA.tree_shard_bytes(inputs, SP.batch_pspecs(mesh, inputs), sizes)
            pb = SP.placed_structs(inputs, SP.batch_pspecs(dm, inputs), dm)
            _, cost = CA.measure(lambda p, b: lm.prefill(cfg, p, b, capacity=capacity or S,
                                                         act_shard=act), pp, pb)
        else:
            cache = lm.abstract_cache(cfg, B, S)
            tok = SP.decode_token_struct(cfg, B)
            args["cache"] = CA.tree_shard_bytes(cache, SP.cache_pspecs(cfg, mesh, cache), sizes)
            args["tokens"] = CA.tree_shard_bytes(tok, SP.batch_pspecs(mesh, tok), sizes)
            if cfg.attn is not None:  # int32, replicated; unread where nothing attends
                args["position"] = 4
            pos = torch.empty((), dtype=torch.int64, device="meta")
            dec_act = act if B % ndp == 0 else None  # the reference's dec_act
            pc = SP.abstract_placed_cache(cfg, dm, B, S)
            pt = SP.placed_structs(tok, SP.batch_pspecs(dm, tok), dm)
            _, cost = CA.measure(lambda p, t, c: lm.decode_step(cfg, p, t, c, pos,
                                                                act_shard=dec_act), pp, pt, pc)
    return {"args": args, "flops": cost.flops,
            "flops_of_pass": {"matmul": cost.matmul_flops, "kernels": cost.kernel_flops},
            "peak": cost.peak_bytes, "collectives": cost.collective_bytes,
            "counts": cost.collective_counts, "dp_sync_sent": None, "collective_sources": {},
            "program": f"models.lm.{'prefill' if shape.kind == 'prefill' else 'decode_step'}, "
                       f"act_shard={'on' if shape.kind == 'prefill' or B % ndp == 0 else 'none'}, "
                       f"as rank 0 of {mesh.size} over a fake group"}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, backend: str = "xla",
             opt: bool = False) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = SP.cell_eligible(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "backend": backend,
           "params": cfg.param_count(), "params_active": cfg.param_count(True)}
    if not ok:
        return {**rec, "status": "skipped", "reason": why}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    if opt:
        cfg = optimized_config(cfg, mesh)
        rec["opt"] = True
    return {**rec, **measure_cell(cfg, shape, mesh, backend=backend)}


def measure_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshShape, *,
                 backend: str = "xla", step: str = "sharded", device_type: str = "cuda",
                 capacity: int | None = None) -> dict:
    """The record's measured fields for ``cfg`` at ``shape`` on ``mesh``.
    A train cell runs the production step (``step="sharded"``) for
    ``backend="xla"``, or the shard_map step (``step="shardmap"``, and
    always for ``"fulllane"``); prefill and decode cells run the sharded
    serving programs (a prefill into ``capacity``, by default the prompt's
    length, as the reference's).  ``device_type``: the fake mesh's."""
    if step not in ("sharded", "shardmap"):
        raise ValueError(f"step must be 'sharded' or 'shardmap', got {step!r}")
    t0 = time.perf_counter()
    if shape.kind != "train":
        cell = _serve_cell(cfg, shape, mesh, device_type, capacity)
    elif backend == "fulllane" or step == "shardmap":
        cell = _shardmap_train_cell(cfg, shape, mesh, backend)
    else:
        cell = _sharded_train_cell(cfg, shape, mesh, device_type)
    coll = cell["collectives"]
    return dict(
        status="ok",
        pass_s=round(time.perf_counter() - t0, 2),
        num_devices=mesh.size,
        mesh_axes=mesh.axis_sizes,
        program=cell["program"],
        flops_per_device=cell["flops"],
        flops_of_pass=cell["flops_of_pass"],
        hbm_bytes_per_device=None,
        hbm_bytes_reason=CA.HBM_BYTES_ABSENT,
        collective_bytes_per_device=coll,
        collective_counts_per_device=cell["counts"],
        collective_bytes_total=int(sum(coll.values())),
        collective_sources=cell["collective_sources"],
        dp_sync_sent_per_device=cell["dp_sync_sent"],
        memory={"argument_bytes": sum(cell["args"].values()),
                "argument_bytes_by_part": cell["args"], "peak_bytes": cell["peak"]},
        notes="counts from shapes on the meta device, not card measurements",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+",
                    choices=ARCH_IDS + [a.replace("_", "-") for a in ARCH_IDS])
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--backend", default="xla", choices=["xla", "fulllane"])
    ap.add_argument("--opt", action="store_true",
                    help="the reference's optimized ParallelConfig (optimized_config)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=os.path.join("build", "dryrun"))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("give --arch or --all")

    archs = ARCH_IDS if args.all else [a.replace("-", "_") for a in args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out_dir, exist_ok=True)

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}__{shape}__{mesh_kind}"
                if args.backend != "xla":
                    tag += f"__{args.backend}"
                if args.opt:
                    tag += "__opt"
                path = os.path.join(args.out_dir, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] {tag}: exists, skipping")
                    continue
                try:
                    rec = run_cell(arch, shape, mesh_kind, backend=args.backend,
                                   opt=args.opt)
                except Exception as e:  # a failing cell is a bug: record it, go on
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "backend": args.backend, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    failures.append(tag)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                extra = ""
                if rec["status"] == "ok":
                    gib = (rec["memory"]["argument_bytes"] + rec["memory"]["peak_bytes"]) / 2**30
                    extra = (f" flops/dev={rec['flops_per_device']:.3g}"
                             f" coll={rec['collective_bytes_total'] / 2**20:.1f}MiB"
                             f" mem={gib:.2f}GiB pass={rec['pass_s']}s")
                print(f"[dryrun] {tag}: {rec['status']}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    return 0


if __name__ == "__main__":
    main()
