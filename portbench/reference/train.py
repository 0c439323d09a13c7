"""The plain reference's training steps: the configuration's loss over each
batch in its microbatches (each row's loss averaged, the gradients summed
in float32 as ``loss / n``), then the configuration's AdamW
(``common.AdamW``), for the first ``steps`` batches.

Returns the readings the training check compares, per leaf of the
parameter tree (a stacked leaf's layers together): each step's loss, the
first step's gradient norms and global norm, and the norms of each leaf's
change after the last step.  Imports plain PyTorch alone.
"""

from __future__ import annotations

import torch

from portbench.reference.common import AdamW, float32_only

__all__ = ["train"]


def _leaves(weights: dict, stacked: set) -> dict:
    """Float32 leaves: a stacked leaf as the list of its layers."""
    out = {}
    for path, t in weights.items():
        if path in stacked:
            out[path] = [t[i].float().requires_grad_() for i in range(t.shape[0])]
        else:
            out[path] = t.float().requires_grad_()
    return out


def _flat(params: dict) -> list:
    return [t for v in params.values() for t in (v if isinstance(v, list) else [v])]


def _norms(params: dict, of) -> dict:
    """Each leaf's float32 norm (a stacked leaf's layers together)."""
    out = {}
    for path, v in params.items():
        ts = v if isinstance(v, list) else [v]
        out[path] = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(of(t)) for t in ts]))
    return {p: float(n) for p, n in out.items()}


def train(model, draw, batches: list, *, steps: int, microbatches: int, opt: dict,
          log=None) -> dict:
    """``model`` (with ``loss(params, tokens, labels)``) trained from the
    weights ``draw()`` gives (``{path: tensor}``, bf16 as drawn;
    ``blocks/...`` leaves stacked over layers), drawn once to start and
    once more to measure the change, on ``batches[:steps]``.  ``log``:
    called with a line after each step."""
    float32_only()
    weights = draw()
    stacked = {p for p in weights if p.startswith("blocks/")}
    params = _leaves(weights, stacked)
    del weights
    flat = _flat(params)
    adam = AdamW(flat, lr=opt["lr"], beta1=opt["beta1"], beta2=opt["beta2"], eps=opt["eps"],
                 weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
                 warmup_steps=opt["warmup_steps"],
                 moments_on="cpu" if flat[0].device.type == "cuda" else None)
    losses, first, gnorm0 = [], None, None
    for s in range(steps):
        b = batches[s]
        toks, labs = b["tokens"], b["labels"]
        n = min(microbatches, toks.shape[0])
        per = toks.shape[0] // n
        total = 0.0
        for p in flat:
            p.grad = None
        for i in range(n):
            loss = model.loss(params, toks[i * per:(i + 1) * per], labs[i * per:(i + 1) * per])
            (loss / n).backward()
            total += float(loss.detach()) / n
        losses.append(total)
        if log is not None:
            log(f"reference step {s + 1}: loss {total:.6f}")
        if s == 0:
            first = _norms(params, lambda t: t.grad)
        g = adam.step()
        if s == 0:
            gnorm0 = g
    for p in flat:
        p.grad = None
    del adam
    weights = draw()
    with torch.no_grad():
        change = {}
        for path, v in params.items():
            w0 = weights[path]
            if isinstance(v, list):
                change[path] = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(t - w0[i].float()) for i, t in enumerate(v)]))
            else:
                change[path] = torch.linalg.vector_norm(v - w0.float())
        change = {p: float(n) for p, n in change.items()}
    return {"losses": losses, "first_grad": first, "grad_norm": gnorm0, "change": change}
