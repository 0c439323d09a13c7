"""The train step (the counterpart of the reference's
``repro/training/train_step.py``, its ``_grad_and_metrics`` and
``make_train_step_shardmap``).

``make_train_step(cfg, opt_cfg, axes=None, backend=...)`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``:

* the gradients of ``lm.loss_fn`` accumulated over
  ``parallel.microbatches`` slices of the batch into ``grad_dtype``
  accumulators, each microbatch's ``g.to(grad_dtype) / n`` added in turn,
  and the metrics averaged the same way (with one microbatch the gradients
  are only cast), as the reference's ``lax.scan`` does;
* with ``axes = (outer, inner)`` (the two axes of a
  ``core.groups.Mesh2D``, pods and lanes, every rank holding its slice of
  the global batch), the data-parallel gradient sync: ``flat_psum`` for
  ``backend="xla"``, the paper's full-lane ``hierarchical_psum`` for
  ``"fulllane"``, each divided by the number of ranks, and the metrics
  summed and divided likewise; with no axes (one card) nothing is synced;
* one AdamW update (``training/optimizer.py``), whose ``grad_norm`` and
  ``lr`` join the metrics.

The reference's sharding specs are ported for the dry-run
(``launch/dryrun.py``), over a device-free ``launch/mesh.MeshShape``:
``dp_axes``, ``mesh_axis_sizes``, ``batch_pspec``, ``param_pspecs`` and
``opt_pspecs`` (ZeRO-1: the moments always under the FSDP rules).  A spec
is a tuple of mesh-axis names (or tuples of them) or None per dim, as
``models/params.partition_specs`` gives it.  The reference's GSPMD
machinery, ``make_train_step_pjit``, ``make_act_shard`` and
``launch/specs.named``, has no one-card counterpart: nothing here
partitions a tensor by a spec.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.models import lm
from repro_torch.models.params import map_tree, partition_specs, torch_dtype
from repro_torch.training.optimizer import OptConfig, adamw_update, leaves

__all__ = ["batch_to", "grad_and_metrics", "make_train_step", "sync", "dp_axes",
           "mesh_axis_sizes", "dim_spec", "batch_pspec", "param_pspecs", "opt_pspecs"]


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors on ``device``: integers (tokens,
    labels, positions) as int64, floats (embeds) as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        out[k] = t.to(device=device, dtype=torch.int64 if not t.is_floating_point() else None)
    return out


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of ``mesh`` (a ``launch/mesh.MeshShape``)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def dim_spec(axes: tuple[str, ...]):
    """One dim's entry of a spec sharded over ``axes``: a tuple of names, or
    the one name alone (as the reference's ``PartitionSpec`` holds it)."""
    return axes[0] if len(axes) == 1 else axes


def batch_pspec(mesh, batch_tree) -> dict:
    """Every batch leaf's leading (batch) dim over the DP axes."""
    dp = dim_spec(dp_axes(mesh))
    return map_tree(lambda _, __: (dp,), batch_tree)


def param_pspecs(cfg, mesh):
    return partition_specs(lm.model_meta(cfg), mesh_axis_sizes(mesh), fsdp=cfg.parallel.fsdp)


def opt_pspecs(cfg, mesh) -> dict:
    """ZeRO-1: the moments always use the FSDP rules, whatever the
    parameters' ``fsdp``."""
    mom = partition_specs(lm.model_meta(cfg), mesh_axis_sizes(mesh), fsdp=True)
    return {"m": mom, "v": mom, "step": ()}


def _pieces(params: dict) -> dict:
    """The parameters as autograd leaves, views of their storage: a stacked
    ``blocks`` leaf as the list of its periods' slices (``lm`` indexes a
    list as it indexes the stacked tensor), every other leaf whole.  Each
    period's gradient then arrives as a tensor of its own, where the
    backward of indexing the stacked tensor would fill and add a
    stacked-size gradient for every period (on Yi-6B at 16 layers, ~1 s of a
    2.2 s step)."""
    def whole(_, t):
        return t.detach().requires_grad_()

    def periods(_, t):
        return [t[i].detach().requires_grad_() for i in range(t.shape[0])]

    return {k: map_tree(periods if k == "blocks" else whole, v) for k, v in params.items()}


def grad_and_metrics(cfg, params: dict, batch: dict) -> tuple[dict, dict]:
    """(gradients in ``grad_dtype``, metrics) of ``lm.loss_fn`` over the
    batch, accumulated over ``parallel.microbatches`` as the reference's
    ``_grad_and_metrics``: ``acc + g.to(grad_dtype) / n`` and ``m + v / n``
    from zeros, in microbatch order (with one microbatch that is the cast
    gradient and the metrics themselves, exactly).  Each gradient is added
    in one pass, ``acc.add_(g, alpha=1 / n)``: where ``n`` is a power of two,
    as in every config (1, 8 or 16), ``g / n`` is exact and the sum is the
    reference's bit for bit; otherwise it may differ by one rounding."""
    n = max(cfg.parallel.microbatches, 1)
    gdt = torch_dtype(cfg.parallel.grad_dtype)
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch of {B} does not split into {n} microbatches")
    acc = [torch.zeros(p.shape, dtype=gdt, device=p.device) for p in leaves(params)]
    macc = None
    for i in range(n):
        b = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
        tree = _pieces(params)
        pieces = leaves(tree)  # per parameter: a tensor, or its periods' slices
        flat = [t for x in pieces for t in (x if isinstance(x, list) else [x])]
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(cfg, tree, b)
            grads = list(torch.autograd.grad(loss, flat))
        del tree, flat
        targets = [t for a, x in zip(acc, pieces)
                   for t in (list(a) if isinstance(x, list) else [a])]
        for j, a in enumerate(targets):
            a.add_(grads[j], alpha=1.0 / n)
            grads[j] = None  # the model-dtype gradient is freed piece by piece
        if macc is None:
            macc = {k: torch.zeros((), dtype=torch.float32, device=v.device)
                    for k, v in metrics.items()}
        macc = {k: macc[k] + metrics[k].detach() / n for k in macc}
    it = iter(acc)
    return map_tree(lambda _, p: next(it), params), macc


def sync(grads: dict, metrics: dict, axes, backend: str) -> tuple[dict, dict]:
    """The data-parallel sync over ``axes = (outer, inner)``: each gradient
    summed by ``flat_psum`` (``"xla"``) or ``hierarchical_psum``
    (``"fulllane"``) and divided by the number of ranks, each metric summed
    and divided likewise, as the reference's ``make_train_step_shardmap``."""
    outer, inner = axes
    ndp = outer.size * inner.size
    fn = C.hierarchical_psum if backend == "fulllane" else C.flat_psum
    return (map_tree(lambda _, g: fn(g, outer, inner) / ndp, grads),
            {k: C.flat_psum(v.reshape(1), outer, inner)[0] / ndp for k, v in metrics.items()})


def make_train_step(cfg, opt_cfg: OptConfig, *, axes=None, backend: str = "xla"):
    """The train step of ``cfg``.  ``axes``: None (one card, no sync) or
    ``(outer, inner)`` data-parallel axes of a ``Mesh2D``; ``backend``:
    ``"xla"`` (flat all-reduce) or ``"fulllane"`` (hierarchical)."""
    if backend not in ("xla", "fulllane"):
        raise ValueError(f"backend must be 'xla' or 'fulllane', got {backend!r}")

    def step(params: dict, opt_state: dict, batch: dict):
        batch = batch_to(batch, leaves(params)[0].device)
        grads, metrics = grad_and_metrics(cfg, params, batch)
        if axes is not None:
            grads, metrics = sync(grads, metrics, axes, backend)
        params, opt_state, info = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {**metrics, **info}

    return step
