"""Training through the port's train step, on batches made on the device.

Set-up draws the weights, builds one train step
(``training/train_step.make_train_step``, AdamW of ``training/optimizer``)
and its state, makes ``batches`` batches of token ids from the seed, and
drives that same step through its first ``first_steps`` steps, which also
warm it up.  It keeps, of the program's own state, what the check reads:
each step's loss; after the first step the gradient as the optimizer got it,
leaf by leaf (its first moment over ``1 - beta1``, undone from the clip by
the step's own ``grad_norm``); after ``check_steps`` steps each leaf's
change from the drawn weights, before the next step overwrites them.

The window is whole steps, cycling through the batches: it ends with the
first step to finish after ``--seconds``.  ``train_tokens_per_s``: every
token trained in the window over the window's whole time.  A step whose
loss is not finite fails.

Correct: once the window has closed and the program is gone, the plain
reference trains the same weights on the same batches for ``check_steps``
steps.  Read, each by the worst: the steps' losses (relative gap), the
first gradient's leaf norms, and the leaves' change (the gap of the two
norms over the larger of the reference's norm of that leaf and of the
median leaf; the change leaves out the leaves whose reference gradient is
under a thousandth of the median leaf's).  Compared: those that the
cell's checks file gives a limit.  With the control on, the reference
trained in fp8 is judged in the program's place.

Traced (``--trace 1``): after the window one more step runs on the host's
clock alone, then one under the profiler.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench import harness, traffic, weights
from portbench import trace as tr

__all__ = ["run", "gaps"]

#: a leaf whose reference gradient is under this share of the median leaf's
#: moves by round-off alone and is left out of the change
NOUGHT = 1e-3


def _leaf(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _norm(t: torch.Tensor) -> torch.Tensor:
    """The float32 norm of ``t``, a stacked leaf one layer at a time (no
    float32 copy of a whole leaf), on the device."""
    if t.dim() < 2:
        return torch.linalg.vector_norm(t.float())
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(r.float())
                                                 for r in t]))


def _leaf_norms(tree: dict, shapes: dict) -> dict:
    norms = {path: _norm(_leaf(tree, path)) for path in shapes}
    return {p: float(n) for p, n in norms.items()}


def _norm_of_change(now: torch.Tensor, drawn: torch.Tensor) -> torch.Tensor:
    if now.dim() < 2:
        return torch.linalg.vector_norm(now.float() - drawn.float())
    return torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(a.float() - b.float()) for a, b in zip(now, drawn)]))


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2])


def _norm_gap(got: dict, want: dict, keep=None) -> tuple:
    """The worst leaf's ``|got - want| / max(want, median want)`` and its
    path."""
    paths = [p for p in want if keep is None or p in keep]
    med = _median([want[p] for p in want])
    worst, at = 0.0, None
    for p in paths:
        g = abs(got[p] - want[p]) / max(want[p], med, 1e-30)
        if not math.isfinite(g):
            return math.inf, p
        if g > worst:
            worst, at = g, p
    return worst, at


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers compared, from two sets of readings (``losses``,
    ``first_grad``, ``change``; the reference's decides which leaves count)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med = _median(list(ref["first_grad"].values()))
    keep = {p for p, g in ref["first_grad"].items() if g >= NOUGHT * med}
    grad, grad_at = _norm_gap(prog["first_grad"], ref["first_grad"])
    change, change_at = _norm_gap(prog["change"], ref["change"], keep)
    return {"loss_gap": loss if math.isfinite(loss) else math.inf, "first_grad_gap": grad,
            "change_gap": change, "first_grad_worst": grad_at, "change_worst": change_at,
            "change_left_out": sorted(set(ref["first_grad"]) - keep)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx: harness.Ctx) -> harness.Outcome:
    from repro_torch.models import lm
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    cfg, tf, dev = ctx.model, ctx.traffic, ctx.device
    if cfg.name.endswith("smoke"):
        tf = dict(tf, **tf["smoke"])
    shapes = weights.leaf_shapes(lm.model_meta(cfg))
    params = weights.unflatten_tree(weights.draw(shapes, ctx.seed, dev))
    oc = OptConfig(learning_rate=tf["lr"], beta1=tf["beta1"], beta2=tf["beta2"], eps=tf["eps"],
                   weight_decay=tf["weight_decay"], grad_clip=tf["grad_clip"],
                   warmup_steps=tf["warmup_steps"], moment_dtype=cfg.parallel.optimizer_dtype)
    step = make_train_step(cfg, oc)
    opt = init_opt_state(params, oc)
    batches = traffic.token_batches(tf, cfg.vocab_size, ctx.seed, dev)
    nb, check = len(batches), int(tf["check_steps"])
    prog = {"losses": []}
    for i in range(int(tf["first_steps"])):
        params, opt, m = step(params, opt, batches[i % nb])
        prog["losses"].append(float(m["loss"]))
        harness.log(ctx, f"set-up step {i + 1}: loss {prog['losses'][-1]:.6f}")
        if i == 0:
            clip = min(1.0, tf["grad_clip"] / max(float(m["grad_norm"]), 1e-9))
            prog["first_grad"] = {p: n / ((1 - tf["beta1"]) * clip)
                                  for p, n in _leaf_norms(opt["m"], shapes).items()}
            prog["grad_norm"] = float(m["grad_norm"])
        if i == check - 1:
            drawn = weights.draw(shapes, ctx.seed, dev)
            prog["change"] = {p: float(_norm_of_change(_leaf(params, p), drawn[p]))
                              for p in shapes}
            del drawn
    prog["losses"] = prog["losses"][:check]
    _sync(dev)
    start = time.perf_counter()
    setup_s = start - ctx.t0
    i, steps, failed = int(tf["first_steps"]), 0, 0
    while True:
        params, opt, m = step(params, opt, batches[i % nb])
        failed += not math.isfinite(float(m["loss"]))
        i, steps = i + 1, steps + 1
        if time.perf_counter() - start >= ctx.seconds:
            break
    elapsed = time.perf_counter() - start
    harness.log(ctx, f"window {elapsed:.3f} s: {steps} steps after a set-up of {setup_s:.3f} s")
    tokens = int(tf["batch"]) * int(tf["seq"])
    e2e = {"train_tokens_per_s": steps * tokens / elapsed, "setup_s": setup_s}
    record = breakdown = busy = window = None
    if ctx.trace:
        t = time.perf_counter()
        params, opt, m = step(params, opt, batches[i % nb])
        float(m["loss"])
        plain_s = time.perf_counter() - t

        def one():
            with tr.span("train_step"):
                out = step(params, opt, batches[(i + 1) % nb])
                float(out[2]["loss"])
            return out

        (params, opt, m), sl = tr.profiled(one)
        record = {"config": ctx.config, "shapes": shapes, "steps": steps, "elapsed": elapsed,
                  "batch": int(tf["batch"]), "seq": int(tf["seq"]), "plain_s": plain_s,
                  "microbatches": cfg.parallel.microbatches,
                  "slice": sl, "traced_steps": 1}
        breakdown = {"device_ops": sl.top_device_ops(), "idle_gaps": sl.idle_by_host()}
        busy, window = sl.busy_us() / 1e6, sl.window_us / 1e6
        harness.log(ctx, f"traced a step: {len(sl.records)} device records")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del params, opt, step, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = _reference(ctx, tf, shapes, batches, check)
    g = gaps(prog, ref)
    readings = dict(program=prog, reference=ref, **g)
    judged = g
    if ctx.control == "fp8":  # the reference in fp8, judged in the program's place
        judged = readings["control"] = gaps(_reference(ctx, tf, shapes, batches, check,
                                                       "fp8"), ref)
        harness.log(ctx, "control")
    checks = [(n, judged[n], c["limit"]) for n, c in ctx.checks.items()]
    return harness.Outcome(attempted=steps, failed=failed, e2e=e2e, checks=checks,
                           record=record, memory_peak_bytes=peak, breakdown=breakdown,
                           busy_s=busy, window_s=window, readings=readings)


def _reference(ctx, tf, shapes, batches, check, precision="float32") -> dict:
    """The plain reference's readings over the first ``check`` steps, on
    the weights drawn again from the seed."""
    from portbench.reference.train import train

    opt = {k: tf[k] for k in ("lr", "beta1", "beta2", "eps", "weight_decay", "grad_clip",
                              "warmup_steps")}
    out = train(harness.reference(ctx, {}, precision),
                lambda: weights.draw(shapes, ctx.seed, ctx.device), batches, steps=check,
                microbatches=ctx.model.parallel.microbatches, opt=opt,
                log=lambda line: harness.log(ctx, line))
    harness.log(ctx, f"reference ({precision}): {check} steps")
    return out
