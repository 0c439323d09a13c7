"""AdamW (the counterpart of the reference's ``repro/training/optimizer.py``).

The state mirrors the parameter tree: ``{"m": tree, "v": tree, "step": 0-d
int32}``, the moments in ``moment_dtype``.  The update is the reference's,
step for step: global-norm clip, linear warmup, bias correction, decoupled
weight decay, all in float32, the moments rounded to ``moment_dtype`` and
the parameters to theirs.  Plain PyTorch (the reference has no kernel
here).  Unlike the reference's pure function it updates the parameters and
moments in place, leaf by leaf and in slices of the leading dim, so a
full-width update needs float32 temporaries of one slice rather than of the
whole tree.  The slices change no value: the update is elementwise, and the
global norm sums each row of the leading dim on its own (a slice holds whole
rows) before one sum over all rows of all leaves.  ZeRO-1 sharding of the
moments has no one-GPU counterpart.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import map_tree, torch_dtype

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "global_norm"]

#: elements of the largest slice an update or norm takes at once (float32
#: temporaries of 256 MiB each)
_SLICE = 2**26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    moment_dtype: str = "float32"


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict in the reference's leaf order (sorted
    keys, as ``jax.tree.leaves`` of a dict)."""
    out = []
    map_tree(lambda _, t: out.append(t), tree)
    return out


def _slices(*ts: torch.Tensor):
    """Matching slices of equal-shaped tensors along their leading dim, each
    of at most ``_SLICE`` elements (the whole tensors when they are small)."""
    t0 = ts[0]
    if t0.numel() <= _SLICE or t0.dim() == 0:
        yield ts
        return
    step = max(1, _SLICE // max(1, t0[0].numel()))
    for i in range(0, t0.shape[0], step):
        yield tuple(t[i:i + step] for t in ts)


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    dt = torch_dtype(cfg.moment_dtype)

    def zeros(_, p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params), "step": step}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf; a float32 0-d
    tensor.  Each row of a leaf's leading dim (each element of a 1-d leaf,
    a 0-d leaf whole) is summed on its own, then all rows of all leaves, in
    the reference's leaf order, in one sum.  So the value does not depend
    on how ``_SLICE`` cuts a leaf, as long as a row's sum has the same bits
    however many rows the call holds.  PyTorch does not promise that; the
    tests check it on the CPU and, on the card, at Yi's embedding and at a
    stacked [4, 4096, 11008] leaf in one-row slices."""
    rows = []
    for leaf in leaves(tree):
        for (s,) in _slices(leaf):
            sq = s.float().square()
            rows.append(sq.reshape(1) if s.dim() == 0 else sq.reshape(s.shape[0], -1).sum(1))
    return torch.sqrt(torch.cat(rows).sum())


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1).float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.learning_rate * warm


def adamw_update(grads: dict, state: dict, params: dict, cfg: OptConfig):
    """One AdamW step.  Returns ``(params, state, {"grad_norm", "lr"})``:
    the parameters and moments updated in place, the step counter a new
    0-d tensor."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _schedule(cfg, state["step"])
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    mdt = torch_dtype(cfg.moment_dtype)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        for ps, gs, ms, vs in _slices(p, g, m, v):
            g32 = gs.float() * clip
            m32 = ms.float() * b1 + g32 * (1 - b1)
            v32 = vs.float() * b2 + g32 * g32 * (1 - b2)
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) + cfg.weight_decay * ps.float()
            ps.copy_((ps.float() - lr * delta).to(ps.dtype))
            ms.copy_(m32.to(mdt))
            vs.copy_(v32.to(mdt))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gnorm,
                                                                        "lr": lr}
