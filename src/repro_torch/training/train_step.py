"""The train steps (the counterpart of the reference's
``repro/training/train_step.py``: ``_grad_and_metrics``,
``make_train_step_shardmap``, ``make_act_shard`` and
``make_train_step_pjit``).

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
* with ``mesh`` (a ``(pod, data, model)`` ``DeviceMesh``,
  ``launch/mesh.make_device_mesh``) the reference's shard_map step with
  its tensor parallelism: the parameters stay sharded over ``model`` by
  ``param_pspecs`` (which needs ``fsdp=False``, as the reference's does),
  each rank runs its batch rows on DTensors over the ``model`` dim, and
  the local gradient shards are synced over ``(pod, data)``
  (``core/groups.MeshAxes``) by the backend's sum;
* one AdamW update (``training/optimizer.py``), whose ``grad_norm`` and
  ``lr`` join the metrics.

While the tracer is live (``obs/trace.py``: on, or a profiler recording)
a step records ``train.step`` over ``train.microbatch`` (device; ``i``),
whose gradients' accumulation is ``train.accumulate`` (device), and
``train.optimizer`` (device: the global norm, the clip and the update); the
step resolves their device times at its end, through an anchor of its own.

``make_train_step_sharded(cfg, mesh, opt_cfg)`` is the counterpart of the
reference's production default, ``make_train_step_pjit``: DTensor
(``torch.distributed.tensor``) stands where GSPMD does.  Parameters are
DTensors placed by ``param_pspecs`` (TP over ``model``, FSDP over
``data``), the moments by ``opt_pspecs`` (ZeRO-1) and the batch by
``batch_pspec``; DTensor's sharding propagation inserts the collectives;
``make_act_shard``'s hook re-pins the residual stream's batch dim to the
data-parallel mesh dims as ``with_sharding_constraint`` does, and every
kernel runs on its rank's shards (``kernels/ops.on_shards``).  The
reference drops the hook for multi-codebook configs with microbatches, a
guard against a miscompile of its pinned JAX; the port applies it always.

The specs (``dp_axes``, ``mesh_axis_sizes``, ``batch_pspec``,
``param_pspecs`` and ``opt_pspecs``: ZeRO-1, the moments always under the
FSDP rules) take a ``DeviceMesh`` or the dry-run's device-free
``launch/mesh.MeshShape``.  A spec is a tuple of mesh-axis names (or
tuples of them) or None per dim, as ``models/params.partition_specs``
gives it; ``models/params.placements`` binds it to a ``DeviceMesh``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core import collectives as C
from repro_torch.core.groups import MeshAxes
from repro_torch.models import lm
from repro_torch.models.params import (map_tree, partition_specs, placements, shard_tensor,
                                       torch_dtype)
from repro_torch.obs.trace import TRACER
from repro_torch.training.optimizer import OptConfig, adamw_update, leaves

__all__ = ["batch_to", "grad_and_metrics", "make_train_step", "sync", "dp_axes",
           "mesh_axis_sizes", "dim_spec", "batch_pspec", "param_pspecs", "opt_pspecs",
           "make_act_shard", "make_train_step_sharded", "place_batch", "opt_placements",
           "sharded_update", "microbatch"]


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors on ``device``: integers (tokens,
    labels, positions) as int64, floats (embeds) as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        out[k] = t.to(device=device, dtype=torch.int64 if not t.is_floating_point() else None)
    return out


def _names(mesh) -> tuple[str, ...]:
    """The axis names of a ``MeshShape`` or a ``DeviceMesh``."""
    return tuple(getattr(mesh, "axis_names", None) or mesh.mesh_dim_names)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of ``mesh`` (a ``launch/mesh.MeshShape`` or a
    ``DeviceMesh``)."""
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(_names(mesh), tuple(mesh.shape)))


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


def microbatch(batch: dict, i: int, n: int, act_shard=None) -> dict:
    """Microbatch ``i`` of ``n`` of ``batch``: rows ``[i B/n, (i + 1) B/n)``
    of every leaf (a slice of the global batch, as the reference's), each
    re-pinned by ``act_shard``; the batch itself when ``n`` is 1."""
    if n == 1:
        return batch
    B = next(iter(batch.values())).shape[0]
    b = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
    if act_shard is not None:
        b = {k: act_shard(v) for k, v in b.items()}
    return b


def grad_and_metrics(cfg, params: dict, batch: dict, act_shard=None) -> tuple[dict, dict]:
    """(gradients in ``grad_dtype``, metrics) of ``lm.loss_fn`` over the
    batch, accumulated over ``parallel.microbatches`` as the reference's
    ``_grad_and_metrics``: ``acc + g.to(grad_dtype) / n`` and ``m + v / n``
    from zeros, in microbatch order (with one microbatch that is the cast
    gradient and the metrics themselves, exactly).  Each gradient is added
    in one pass, ``acc.add_(g, alpha=1 / n)``: where ``n`` is a power of two,
    as in every config (1, 8 or 16), ``g / n`` is exact and the sum is the
    reference's bit for bit; otherwise it may differ by one rounding.

    DTensor parameters (the sharded step, under ``implicit_replication``)
    get DTensor accumulators placed like them; a microbatch is a slice of
    the global batch, as the reference's, re-pinned to the data-parallel
    dims by ``act_shard``; the metrics come back as plain tensors."""
    n = max(cfg.parallel.microbatches, 1)
    gdt = torch_dtype(cfg.parallel.grad_dtype)
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch of {B} does not split into {n} microbatches")
    acc = [torch.zeros_like(p, dtype=gdt) if isinstance(p, DTensor)
           else torch.zeros(p.shape, dtype=gdt, device=p.device) for p in leaves(params)]
    macc = None
    for i in range(n):
        with TRACER.span("train.microbatch", device=True, i=i):
            b = microbatch(batch, i, n, act_shard)
            tree = _pieces(params)
            pieces = leaves(tree)  # per parameter: a tensor, or its periods' slices
            flat = [t for x in pieces for t in (x if isinstance(x, list) else [x])]
            with torch.enable_grad():
                loss, metrics = lm.loss_fn(cfg, tree, b, act_shard=act_shard)
                metrics = {k: _plain(v) for k, v in metrics.items()}
                grads = list(torch.autograd.grad(_plain(loss), flat))
            del tree, flat
            targets = [t for a, x in zip(acc, pieces)
                       for t in (list(a) if isinstance(x, list) else [a])]
            with TRACER.span("train.accumulate", device=True):
                for j, a in enumerate(targets):
                    a.add_(grads[j], alpha=1.0 / n)
                    grads[j] = None  # the model-dtype gradient is freed piece by piece
            if macc is None:
                macc = {k: torch.zeros((), dtype=torch.float32, device=v.device)
                        for k, v in metrics.items()}
            macc = {k: macc[k] + metrics[k].detach() / n for k in macc}
    it = iter(acc)
    return map_tree(lambda _, p: next(it), params), macc


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor as its full value (differentiable), a tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


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


def make_train_step(cfg, opt_cfg: OptConfig, *, axes=None, backend: str = "xla", mesh=None):
    """The train step of ``cfg``.  ``axes``: None (one card, no sync) or
    ``(outer, inner)`` data-parallel axes of a ``Mesh2D``; ``backend``:
    ``"xla"`` (flat all-reduce) or ``"fulllane"`` (hierarchical).

    ``mesh``, in place of ``axes``: a ``DeviceMesh`` with a ``"model"`` dim
    and ``"data"`` (and ``"pod"``) dims, the shard_map step with TP.  The
    step then takes the parameters as DTensors placed by
    ``param_pspecs(cfg, mesh)`` (``fsdp=False``: replicated over the
    data-parallel dims, sharded over ``model``), the moments as
    ``init_opt_state(params, opt_cfg, opt_placements(cfg, mesh))`` places
    them, and the global batch, of which rank ``(p, d, m)`` takes the ``p *
    data + d``-th share of rows, as under ``P(("pod", "data"))``.  Its
    forward and backward run on those rows on DTensors over the ``model``
    dim alone, its gradients are synced over ``(pod, data)``, and the
    update runs as the sharded step's."""
    if backend not in ("xla", "fulllane"):
        raise ValueError(f"backend must be 'xla' or 'fulllane', got {backend!r}")
    if mesh is not None:
        if axes is not None:
            raise ValueError("make_train_step: pass axes or mesh, not both")
        if cfg.parallel.fsdp:
            raise ValueError("the shard_map step requires fsdp=False (replicated DP params)")
        view = MeshAxes(mesh)
        axes = (view.pod, view.data)
        tp, m = mesh["model"], mesh.mesh_dim_names.index("model")

    def on_model(_, p: DTensor) -> DTensor:
        return DTensor.from_local(p.to_local(), tp, (p.placements[m],), run_check=False)

    def step(params: dict, opt_state: dict, batch: dict):
        with TRACER.span("train.step"):
            batch = batch_to(batch, leaves(params)[0].device)
            if mesh is None:
                grads, metrics = grad_and_metrics(cfg, params, batch)
            else:  # this rank's rows, on DTensors over ``model``
                batch = {k: v.chunk(view.world.size)[view.world.index]
                         for k, v in batch.items()}
                local = map_tree(on_model, params)
                with implicit_replication():
                    grads, metrics = grad_and_metrics(cfg, local, batch)
                grads = map_tree(lambda _, g, p: g.redistribute(tp, p.placements).to_local(),
                                 grads, local)
            if axes is not None:
                grads, metrics = sync(grads, metrics, axes, backend)
            if mesh is not None:
                grads = map_tree(lambda _, g, p: DTensor.from_local(g, mesh, p.placements,
                                                                   run_check=False),
                                 grads, params)
            with TRACER.span("train.optimizer", device=True):
                params, opt_state, info = adamw_update(grads, opt_state, params, opt_cfg)
            if TRACER:
                TRACER.resolve(anchor=True)
        return params, opt_state, {**metrics, **info}

    return step


def opt_placements(cfg, mesh) -> dict:
    """The moments' placements on ``mesh``: ``opt_pspecs``' (ZeRO-1)."""
    return map_tree(lambda _, spec: placements(spec, mesh), opt_pspecs(cfg, mesh)["m"])


def make_act_shard(cfg, mesh):
    """The activation-sharding hook over the ``DeviceMesh`` ``mesh``, the
    reference's: ``act(x)`` pins the leading (batch) dim of the DTensor
    ``x`` to the data-parallel mesh dims (every other dim replicated);
    ``act(x, spec)`` pins an explicit spec (a mesh-axis name, a tuple of
    them, ``"dp"`` for the data-parallel axes, or None per dim).  Both
    redistribute, as ``with_sharding_constraint`` does, and are
    differentiable."""
    del cfg
    dp = dim_spec(dp_axes(mesh))

    def act(x: DTensor, spec=None) -> DTensor:
        spec = (dp,) if spec is None else tuple(dp if s == "dp" else s for s in spec)
        return x.redistribute(mesh, placements(spec, mesh))

    return act


def place_batch(batch: dict, mesh, device) -> dict:
    """The global batch (numpy arrays or tensors, the same on every rank) as
    DTensors on ``mesh`` placed by ``batch_pspec``: each rank keeps its rows.
    DTensors pass as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            out[k] = v
            continue
        (t,) = batch_to({k: v}, device).values()
        out[k] = shard_tensor(t, mesh, placements((dim_spec(dp_axes(mesh)),), mesh))
    return out


def sharded_update(cfg, params: dict, opt_state: dict, batch: dict, act_shard,
                   opt_cfg: OptConfig, *, grads_done=None) -> tuple[dict, dict, dict]:
    """The sharded step's body on placed DTensors (``make_train_step_sharded``):
    the gradients and metrics of ``batch`` accumulated over
    ``parallel.microbatches`` with ``act_shard``, then the AdamW update in
    place, under ``implicit_replication``.  Returns ``(params, opt_state,
    metrics)``, the metrics as tensors; nothing is read back to the host,
    so it runs on meta shards too (the dry-run's ``xla`` train cells).
    ``grads_done()``, if given, is called between the gradients and the
    update."""
    with implicit_replication():
        grads, metrics = grad_and_metrics(cfg, params, batch, act_shard=act_shard)
        if grads_done is not None:
            grads_done()
        with TRACER.span("train.optimizer", device=True):
            params, opt_state, info = adamw_update(grads, opt_state, params, opt_cfg)
    return params, opt_state, {**metrics, **info}


def make_train_step_sharded(cfg, mesh, opt_cfg: OptConfig):
    """The counterpart of the reference's ``make_train_step_pjit``, its
    production default: returns ``(step, (pspec, ospec))``.  ``step(params,
    opt_state, batch) -> (params, opt_state, metrics)`` takes the parameters
    as DTensors on ``mesh`` placed by ``pspec = param_pspecs(cfg, mesh)``
    (``models/params.shard_params``), the AdamW state with its moments
    placed by ``ospec = opt_pspecs(cfg, mesh)`` (``init_opt_state(params,
    opt_cfg, opt_placements(cfg, mesh))``), and the batch placed by
    ``batch_pspec`` (or the global batch, which it places:
    ``place_batch``).  It accumulates ``parallel.microbatches`` slices of
    the global batch in ``grad_dtype`` as the reference's
    ``_grad_and_metrics`` does, with ``make_act_shard``'s hook applied
    always, updates the parameters and moments in place on their shards,
    and returns the metrics as Python floats, the same on every rank."""
    pspec, ospec = param_pspecs(cfg, mesh), opt_pspecs(cfg, mesh)
    act = make_act_shard(cfg, mesh)

    def step(params: dict, opt_state: dict, batch: dict):
        with TRACER.span("train.step"):
            local = leaves(params)[0].to_local()
            batch = place_batch(batch, mesh, local.device)
            params, opt_state, metrics = sharded_update(cfg, params, opt_state, batch, act,
                                                        opt_cfg)
            metrics = {k: float(v) for k, v in metrics.items()}
            if TRACER:
                TRACER.resolve(anchor=True)
        return params, opt_state, metrics

    return step, (pspec, ospec)
