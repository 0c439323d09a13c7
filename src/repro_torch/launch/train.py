"""Training entry point: config -> fault-tolerant train loop, on one card (the
counterpart of the reference's ``repro/launch/train.py``).

Usage:

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --smoke \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ck    # on the card
  ... --device cpu                                          # the plain path

The reference's CLI, with ``--device`` added and ``--mesh`` left out (one
card has no mesh; the data-parallel backends are reached through ranks,
``training/train_step.make_train_step(axes=...)``, and ``--backend`` only
names the sync that such a step would use).  The loop is the reference's:
resume from the latest committed checkpoint, a prefetched deterministic data
stream, async checkpoints every ``--ckpt-every`` steps (keep-last GC), the
straggler monitor.  ``train(cfg, opt_cfg, ...)`` runs the loop for a config
the caller builds (``chip_smoke.py`` passes Yi-6B at 16 of its 32 layers).

One deliberate difference: a checkpoint saved after step N holds the state
after N's update, and a resumed run starts at step N + 1; the reference's
resumes at N and applies N's batch a second time (ROADMAP, reference
caveats).  So a run stopped at a checkpoint and resumed gives the losses
of a run that never stopped.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import Prefetcher, SyntheticLM
from repro_torch.training.elastic import StragglerMonitor
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

__all__ = ["main", "train"]


def train(cfg, opt_cfg: OptConfig, *, steps: int, batch: int, seq: int, ckpt_dir: str = "",
          ckpt_every: int = 25, seed: int = 0, log_every: int = 10, corpus_size: int = 0,
          backend: str = "xla", device="cuda", arch: str | None = None,
          on_step=None) -> dict:
    """Train ``cfg`` for ``steps`` steps (counted from 0, resumed ones
    included).  ``on_step(step, metrics, seconds)``, if given, sees each
    step's metrics (0-d tensors) and its host-clock seconds, the step
    synchronised.  Returns the first and last loss, the step count, the
    seconds, every step's loss, ``grad_norm``, ``lr`` and seconds, and the
    final ``{"params", "opt"}`` under ``"state"``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_model(cfg, gen, device=device)
    opt_state = init_opt_state(params, opt_cfg)

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
    step_fn = make_train_step(cfg, opt_cfg, backend=backend)
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
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--backend", default="xla", choices=["xla", "fulllane"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--corpus-size", type=int, default=0,
                    help=">0: cycle over a fixed corpus (learnable target)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = OptConfig(learning_rate=args.lr, moment_dtype=cfg.parallel.optimizer_dtype)
    return train(cfg, opt_cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
                 log_every=args.log_every, corpus_size=args.corpus_size,
                 backend=args.backend, device=args.device, arch=args.arch)


if __name__ == "__main__":
    main()
