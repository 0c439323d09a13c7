"""Training entry point: config -> fault-tolerant train loop, on one card or
over a mesh of ranks (the counterpart of the reference's
``repro/launch/train.py``).

Usage:

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --smoke \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ck    # on the card
  ... --device cpu                                          # the plain path
  ... --arch falcon_mamba_7b --layers 32 --seq 2048         # full width, 32 of 64 layers
  ... --arch yi_6b --layers 2 --mesh 2,2,2                  # 8 ranks, (pod, data, model)

The reference's CLI, with ``--device``, ``--layers`` and ``--microbatches``
added (a full-width config's 8 microbatches would not split 16 rows over 4
data-parallel ranks).  Without
``--mesh`` the loop runs on one card (``--backend`` then changes nothing
but ``fsdp``, as in the reference: no gradient is synced).  ``--mesh
P,D,M`` (``D,M``: ``("data", "model")``) runs the loop in ``P * D * M``
ranks (``launch/ranks.run``, each rank on ``--device``, the world on
gloo) over a ``DeviceMesh`` of that shape (``launch/mesh.
make_device_mesh``): ``--backend xla`` runs the sharded step,
``training/train_step.make_train_step_sharded`` (FSDP and TP parameters,
ZeRO-1 moments), and ``fulllane`` the shard_map step with TP and the
paper's hierarchical gradient sum (``make_train_step(mesh=)``, with
``fsdp=False``).  Every rank draws the same parameters from the seed and
the same global batches, and keeps its shards; checkpoints keep the
one-card layout, written by rank 0, and restore into any mesh.  The
meshed CLI returns rank 0's result, without the state.  The loop is the
reference's:
resume from the latest committed checkpoint, a prefetched deterministic data
stream, async checkpoints every ``--ckpt-every`` steps (keep-last GC), the
straggler monitor.  ``--layers N`` keeps the config's first N layers, at
its published widths (a full-width model whose AdamW state at full depth
would not fit one card).  ``train(cfg, opt_cfg, ...)`` runs the loop for a
config the caller builds (``chip_smoke.py`` passes Yi-6B at 16 of its 32
layers).

One deliberate difference: a checkpoint saved after step N holds the state
after N's update, and a resumed run starts at step N + 1; the reference's
resumes at N and applies N's batch a second time (ROADMAP, reference
caveats).  So a run stopped at a checkpoint and resumed gives the losses
of a run that never stopped.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import first_layers, get_config, get_smoke_config
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import lm
from repro_torch.models.params import shard_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import Prefetcher, SyntheticLM
from repro_torch.training.elastic import StragglerMonitor
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import (make_train_step, make_train_step_sharded,
                                             opt_placements, param_pspecs)

__all__ = ["main", "train"]


def train(cfg, opt_cfg: OptConfig, *, steps: int, batch: int, seq: int, ckpt_dir: str = "",
          ckpt_every: int = 25, seed: int = 0, log_every: int = 10, corpus_size: int = 0,
          backend: str = "xla", device="cuda", arch: str | None = None,
          on_step=None, mesh=None) -> dict:
    """Train ``cfg`` for ``steps`` steps (counted from 0, resumed ones
    included).  ``on_step(step, metrics, seconds)``, if given, sees each
    step's metrics (0-d tensors, or floats over a mesh) and its host-clock
    seconds, the step synchronised.  ``mesh``: a ``DeviceMesh`` of the
    ranks (every rank calls ``train``), or None for one card.  Returns the
    first and last loss, the step count, the seconds, every step's loss,
    ``grad_norm``, ``lr`` and seconds, and the final ``{"params", "opt"}``
    under ``"state"`` (DTensors over a mesh)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_model(cfg, gen, device=device)
    if mesh is None:
        step_fn = make_train_step(cfg, opt_cfg, backend=backend)
        opt_state = init_opt_state(params, opt_cfg)
    else:
        if backend == "xla":
            step_fn, _ = make_train_step_sharded(cfg, mesh, opt_cfg)
        else:
            step_fn = make_train_step(cfg, opt_cfg, backend=backend, mesh=mesh)
        params = shard_params(params, param_pspecs(cfg, mesh), mesh)
        opt_state = init_opt_state(params, opt_cfg, opt_placements(cfg, mesh))

    start_step = 0
    if ckpt_dir:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            restored, _ = ckpt.restore(ckpt_dir, latest, {"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            start_step = latest + 1
            print(f"[train] resumed from step {latest}")

    stream = Prefetcher(
        SyntheticLM(cfg, batch, seq, seed=seed, start_step=start_step,
                    corpus_size=corpus_size or None),
        depth=2,
    )
    saver = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    monitor = StragglerMonitor()
    history = []
    t_total = time.time()
    for step, b in stream:
        if step >= steps:
            break
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])  # sync point
        dt = time.time() - t0
        action = monitor.observe(dt)
        if action != "ok":
            print(f"[train] step {step}: straggler action={action} "
                  f"({dt:.2f}s vs ema {monitor.ema:.2f}s)")
        history.append({"step": step, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"]), "seconds": dt})
        if on_step is not None:
            on_step(step, metrics, dt)
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss={loss:.4f} "
                  f"gnorm={history[-1]['grad_norm']:.3f} {dt:.2f}s")
        if saver and step > start_step and step % ckpt_every == 0:
            saver.save(step, {"params": params, "opt": opt_state},
                       extra={"arch": arch or cfg.name})
    if saver:
        saver.wait()
    out = {"first_loss": history[0]["loss"] if history else None,
           "last_loss": history[-1]["loss"] if history else None,
           "steps": len(history), "seconds": time.time() - t_total}
    print(f"[train] done: {out}")
    out.update(history=history, state={"params": params, "opt": opt_state})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers of the config to keep (default: all)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="gradient-accumulation microbatches (default: the config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="",
                    help="comma shape, e.g. 2,2,2 (pod,data,model) or 2,2 (data,model): "
                         "that many ranks; default one card")
    ap.add_argument("--backend", default="xla", choices=["xla", "fulllane"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--corpus-size", type=int, default=0,
                    help=">0: cycle over a fixed corpus (learnable target)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    shape = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else ()
    if shape and not dist.is_initialized():  # this process starts the ranks
        out = ranks.run("repro_torch.launch.train:main", math.prod(shape),
                        kwargs={"argv": list(argv) if argv is not None else None},
                        timeout_s=3600.0)
        return out[0]
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = first_layers(cfg, args.layers)
    if args.microbatches:
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, microbatches=args.microbatches))
    if args.backend != "xla":
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, fsdp=False))
    opt_cfg = OptConfig(learning_rate=args.lr, moment_dtype=cfg.parallel.optimizer_dtype)
    mesh = None
    if shape:  # one rank of the mesh
        device = resolve_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        mesh = make_device_mesh(shape, ("pod", "data", "model")[-len(shape):], device)
    out = train(cfg, opt_cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
                log_every=args.log_every, corpus_size=args.corpus_size,
                backend=args.backend, device=args.device, arch=args.arch, mesh=mesh)
    if mesh is not None:
        del out["state"]  # DTensors stay with their ranks
    return out


if __name__ == "__main__":
    main()
