"""Dry-run of every (arch x shape x mesh) cell on the meta device (the
counterpart of the reference's ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --backend fulllane
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --skip-existing   # resumable

The reference AOT-compiles each cell on 512 fake CPU devices and reads the
compiled module.  The port runs each cell's own code once, on meta tensors
(shapes and dtypes, no storage, nothing computed) and needs no device: a
train cell runs the train step's gradients of one microbatch and the AdamW
update (``training/train_step.py``; the microbatches are alike, so their
FLOPs are that pass's times their number: the config's, or fewer where one
rank's batch holds fewer sequences), a prefill cell ``lm.prefill``, a
decode cell ``lm.decode_step`` against a full cache, each on the batch one
data-parallel rank holds (the global batch where it does not split) with
the whole parameters.  For each cell it writes one JSON record to
``--out-dir`` (``build/dryrun/`` by default), with the reference's keys
where they mean the same thing:

* ``memory.argument_bytes`` — per device, exact: the shard bytes of the
  parameters, the optimizer state and the batch (or the cache, token and
  position) under the reference's specs (``param_pspecs``, ``opt_pspecs``,
  ``launch/specs.py``);
* ``memory.peak_bytes`` — the peak of the pass's live tensors beyond its
  arguments (``launch/costanalysis.py``), on one data-parallel rank's batch
  with whole parameters (the reference's ``temp_bytes`` is per device,
  tensor-parallel shards included);
* ``flops_per_device`` — the global batch's matrix-product FLOPs
  (``costanalysis.measure``) divided by the device count: an ideal split,
  where GSPMD can replicate work (a decode batch of 1, say);
* ``collective_bytes_per_device`` — train cells: the data-parallel gradient
  and metric sync of the reference's shard_map step, run by the port's own
  collectives on a device-free ``RecordingMesh`` (``flat_psum`` for
  ``--backend xla``, ``hierarchical_psum`` for ``fulllane``; a one-pod mesh
  has one DP axis, where the reference's step sums flat for both), and the
  ZeRO-1 gathers of the sharded moments into that step;
  ``dp_sync_sent_per_device`` gives what one rank of that sync sends, and
  how much of it crosses pods, under each op's direct algorithm (the
  paper's count, ``core.groups.Traffic``).  The port has no
  GSPMD, so ``xla`` is the shard_map step's flat backend, not the
  reference's ``make_train_step_pjit``, and both backends run with
  ``fsdp`` off, as the reference's shard_map step requires.  The
  collectives GSPMD would add for tensor parallelism (and, in serving
  cells, for FSDP-sharded parameters) are not counted:
  ``collective_bytes_gspmd`` is null with its reason.

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
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.params import map_tree, torch_dtype
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.training.train_step import (
    batch_pspec,
    dp_axes,
    grad_and_metrics,
    mesh_axis_sizes,
    opt_pspecs,
    param_pspecs,
)

__all__ = ["main", "measure_cell", "optimized_config", "run_cell"]

GSPMD_ABSENT = ("the port has no GSPMD: the collectives it would insert for tensor "
                "parallelism over 'model' (and for FSDP-sharded parameters) are not counted")


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


def _train_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshShape, backend: str) -> dict:
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
    split = ndp if shape.global_batch % ndp == 0 else 1
    # the microbatches are alike: the pass takes one, with the accumulators
    # and the update, and counts its FLOPs once for each
    rows = shape.global_batch // split
    micro = math.gcd(rows, max(cfg.parallel.microbatches, 1))
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
    return {"args": args, "cost": cost, "split": split * micro, "microbatches": micro,
            "collectives": coll, "sent": sent,
            "collective_sources": {"dp_sync": "training.train_step.sync on a RecordingMesh, "
                                              f"{pods} x {lanes}, backend "
                                              f"{backend if len(dp) == 2 else 'xla'}",
                                   "zero1_all_gather": zero1}}


def _serve_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshShape) -> dict:
    sizes, dp = mesh_axis_sizes(mesh), dp_axes(mesh)
    ndp = math.prod(sizes[a] for a in dp)
    B, S = shape.global_batch, shape.seq_len
    params = lm.abstract_model(cfg)
    args = {"params": CA.tree_shard_bytes(params, param_pspecs(cfg, mesh), sizes)}
    split = ndp if B % ndp == 0 else 1
    if shape.kind == "prefill":
        batch = SP.batch_structs(cfg, B, S)
        args["batch"] = CA.tree_shard_bytes(batch, SP.batch_pspecs(mesh, batch), sizes)
        inputs = {k: v for k, v in _per_rank(batch, split).items() if k != "labels"}
        _, cost = CA.measure(lambda p, b: lm.prefill(cfg, p, b, capacity=S), params, inputs)
    else:
        cache = lm.abstract_cache(cfg, B, S)
        tok = SP.decode_token_struct(cfg, B)
        args["cache"] = CA.tree_shard_bytes(cache, SP.cache_pspecs(cfg, mesh, cache), sizes)
        args["tokens"] = CA.tree_shard_bytes(tok, SP.batch_pspecs(mesh, tok), sizes)
        args["position"] = 4  # int32, replicated
        pos = torch.empty((), dtype=torch.int64, device="meta")
        _, cost = CA.measure(lambda p, t, c: lm.decode_step(cfg, p, t, c, pos), params,
                             _per_rank(tok, split), lm.abstract_cache(cfg, B // split, S))
    return {"args": args, "cost": cost, "split": split, "microbatches": 1, "collectives": {},
            "sent": {}, "collective_sources": {}}


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
                 backend: str = "xla") -> dict:
    """The record's measured fields for ``cfg`` at ``shape`` on ``mesh``."""
    t0 = time.perf_counter()
    cell = (_train_cell(cfg, shape, mesh, backend) if shape.kind == "train"
            else _serve_cell(cfg, shape, mesh))
    cost: CA.PassCost = cell["cost"]
    coll = cell["collectives"]
    return dict(
        status="ok",
        pass_s=round(time.perf_counter() - t0, 2),
        num_devices=mesh.size,
        mesh_axes=mesh.axis_sizes,
        flops_per_device=cost.flops * cell["split"] / mesh.size,
        flops_of_pass={"matmul": cost.matmul_flops, "kernels": cost.kernel_flops,
                       "passes_in_global_batch": cell["split"],
                       "microbatches": cell["microbatches"]},
        hbm_bytes_per_device=None,
        hbm_bytes_reason=CA.HBM_BYTES_ABSENT,
        collective_bytes_per_device=coll,
        collective_bytes_total=int(sum(coll.values())),
        collective_sources=cell["collective_sources"],
        dp_sync_sent_per_device={
            "bytes": sum(c["bytes"] for c in cell["sent"].values()),
            "cross_pod_bytes": sum(c["cross_pod_bytes"] for c in cell["sent"].values()),
            "by_op": cell["sent"]},
        collective_bytes_gspmd=None,
        collective_bytes_gspmd_reason=GSPMD_ABSENT,
        memory={"argument_bytes": sum(cell["args"].values()),
                "argument_bytes_by_part": cell["args"], "peak_bytes": cost.peak_bytes},
        notes=("counts from shapes on the meta device, not card measurements; "
               "flops_per_device is the global work over the device count (an ideal "
               "split); peak_bytes is one data-parallel rank's pass with whole parameters"
               + ("; train cells run the reference's shard_map step (fsdp off): 'xla' is "
                  "its flat backend, not make_train_step_pjit" if shape.kind == "train"
                  else "")),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS + [a.replace("_", "-") for a in ARCH_IDS])
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

    archs = ARCH_IDS if args.all else [args.arch.replace("-", "_")]
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
