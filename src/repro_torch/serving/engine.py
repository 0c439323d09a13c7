"""Batched serving engine: slot-based continuous batching over a fixed-size
decode batch (the counterpart of the reference's ``repro/serving/engine.py``).

``ServeEngine`` keeps ``num_slots`` independent sequences in one KV cache;
requests are admitted into free slots (prefill), all active slots decode in
lock-step (one ``decode_step`` per iteration), and finished sequences free
their slot.  As in the reference, the cache has one synchronized write
position: admission left-pads every prompt to the longest one with token 0,
and the pad tokens are not masked (under Mamba they enter the state).

On the card the decode step runs as one captured CUDA graph
(``serving/decode_graph.py``), as the reference jits it: the engine captures
it when it is built, over a cache of ``num_slots`` x ``capacity`` that every
admission's prefill is copied into, and each ``step`` replays it.  Sampling
stays outside the graph.  ``cuda_graph=False`` runs the step eagerly, as the
CPU always does.

While the tracer is live (``obs/trace.py``: on, or a profiler recording)
each call records its spans, those of one wave sharing its admitted
request ids ``rids``: ``engine.admit`` (``rids``, ``padded`` length,
``prompt_tokens``) over ``engine.prefill`` (device), ``engine.cache_load``
(device; the graph's ``load``) and ``engine.sample``; ``engine.step``
(``step``, ``pos``, ``active`` slots, the ``finished`` rids) over
``engine.replay`` (device; the eager step where there is no graph),
``engine.sample`` (the sampler and the readback, where the host waits) and
``engine.tokens``.  After each readback the engine resolves the device
spans' times (``TRACER.resolve``), through a fresh anchor once a wave, at
its admission.  Always on, one increment per admission
or step, are the counters ``engine.slot_steps`` (slots computed: every slot
at each prefill and step), ``engine.tokens_served``,
``engine.prefill_positions`` (slots times the prefill's length) and
``engine.prompt_tokens``.

With ``plan_mesh=(num_nodes, procs_per_node, k_lanes)`` the engine pins its
per-decode-step collective plans (``serving/planner.py``, through
``api.plan_batch``) once, when it is built, and replans them only on a
``FaultEvent`` that ``inject_fault`` reports, as the reference's engine does.
The planner is numpy on the host, off the decode path: the step, the
captured graph and sampling do not see it.  ``plan_cost`` (a ``CostParams``)
prices the plans; None prices at the reference's TPU v5e costs, and a GPU
cluster is priced at ``core.topology.NVLINK_IB.cost``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.params import torch_dtype
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import TRACER
from repro_torch.serving.decode_graph import DecodeGraph

__all__ = ["Request", "ServeEngine", "greedy_sample", "temperature_sample"]

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32, or [S, K] for K codebooks
    max_new_tokens: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


def greedy_sample(logits: torch.Tensor, generator=None) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(temp: float) -> Callable:
    def fn(logits, generator):
        probs = torch.softmax(logits.float() / temp, dim=-1)
        picks = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
        return picks.reshape(probs.shape[:-1]).to(torch.int32)

    return fn


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        num_slots: int = 4,
        capacity: int = 512,
        sampler: Callable = greedy_sample,
        seed: int = 0,
        monitor=None,
        plan_mesh: tuple[int, int, int] | None = None,
        replan_deadline_s: float = 0.25,
        plan_cost=None,
        device="cuda",
        cuda_graph: bool | None = None,
    ):
        """``cuda_graph``: replay the decode step as a captured CUDA graph;
        None means on for ``cuda`` and off for ``cpu``, and True on the CPU
        raises."""
        self.device = resolve_device(device)
        if not cfg.embed_inputs:  # as the reference's: embeds go through lm.prefill,
            # lm.decode_step and the captured step (DecodeGraph) themselves
            raise ValueError("serving engine drives token models")
        emb = params["embed"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params on {emb.device}, engine on {self.device}")
        if cuda_graph is None:
            cuda_graph = self.device.type == "cuda"
        if cuda_graph and self.device.type != "cuda":
            raise ValueError(f"cuda_graph=True needs device 'cuda', not {self.device}")
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.capacity = capacity
        self.sampler = sampler
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.slots: list[Request | None] = [None] * num_slots
        self.cache = None
        self.pos = 0  # synchronized cache position
        self.steps = 0  # decode steps taken since the last admission
        self._rids: list = []  # the current wave's request ids, for its spans
        # optional fault/straggler hook: any object with observe(seconds)
        # and observe_fault(event) -> "ok"|"warn"|"evict" (duck-typed, as
        # training.elastic.StragglerMonitor).  run() times every decode step
        # through it and stops decoding on "evict".
        self.monitor = monitor
        self.fault_events: list = []
        self.monitor_actions: list[str] = []
        # with plan_mesh set the decode-collective plans are pinned here,
        # once, via plan_batch; thereafter they replan only on an injected
        # FaultEvent (under the planner's backoff/deadline budget and
        # circuit breaker)
        self.plan_cost = plan_cost
        self.planner = None
        if plan_mesh is not None:
            from repro_torch.serving.planner import DecodePlanner

            nn, ppn, kl = plan_mesh
            self.planner = DecodePlanner(
                num_slots=num_slots, d_model=cfg.d_model,
                num_codebooks=cfg.num_codebooks,
                num_nodes=nn, procs_per_node=ppn, k_lanes=kl,
                replan_deadline_s=replan_deadline_s, cost=plan_cost,
            )
        self.graph = None
        if cuda_graph:  # its cache takes the model dtype, as a prefill's does
            self.graph = DecodeGraph(cfg, params, lm.init_cache(
                cfg, num_slots, capacity, device=self.device, dtype=torch_dtype(cfg.dtype)))

    def _tok_shape(self, n: int) -> tuple:
        k = self.cfg.num_codebooks
        return (self.num_slots, n, k) if k > 1 else (self.num_slots, n)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return self.sampler(logits, self.generator).cpu().numpy()

    def admit(self, requests: list[Request]) -> list[Request]:
        """Fill free slots; prefill runs over the padded batch of prompts.
        Returns the admitted subset."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        admitted = requests[: len(free)]
        if not admitted:
            return []
        max_len = max(len(r.prompt) for r in admitted)
        prompt_tokens = sum(len(r.prompt) for r in admitted)
        start = self.pos
        toks = np.zeros(self._tok_shape(start + max_len), np.int64)
        for slot, req in zip(free, admitted):
            p = np.asarray(req.prompt)
            toks[slot, start + max_len - len(p):start + max_len] = p
            self.slots[slot] = req
        self._rids = [r.rid for r in admitted]
        with TRACER.span("engine.admit", rids=self._rids, padded=max_len,
                         prompt_tokens=prompt_tokens):
            with TRACER.span("engine.prefill", device=True, rids=self._rids):
                lgts, cache = lm.prefill(
                    self.cfg, self.params,
                    {"tokens": torch.from_numpy(toks).to(self.device)},
                    capacity=self.capacity,
                )
            if self.graph is None:
                self.cache = cache
            else:  # into the buffers the captured step reads
                with TRACER.span("engine.cache_load", device=True, rids=self._rids):
                    self.graph.load(cache)
                self.cache = self.graph.cache
            self.pos = start + max_len
            self.steps = 0
            # first sampled token from prefill logits
            with TRACER.span("engine.sample", rids=self._rids):
                nxt = self._sample(lgts)
            if TRACER:  # after the readback: the device spans' times, a wave's anchor
                TRACER.resolve(anchor=True)
            for slot, req in zip(free, admitted):
                req.out_tokens.append(nxt[slot].tolist())
            self._pending = self._tokens(nxt)
        obs_metrics.counter("engine.slot_steps").inc(self.num_slots)
        obs_metrics.counter("engine.tokens_served").inc(len(admitted))
        obs_metrics.counter("engine.prefill_positions").inc(self.num_slots * (start + max_len))
        obs_metrics.counter("engine.prompt_tokens").inc(prompt_tokens)
        return admitted

    def step(self) -> None:
        """One lock-step decode for all active slots."""
        if self.cache is None or self.pos >= self.capacity:
            return
        active = [(slot, req) for slot, req in enumerate(self.slots)
                  if req is not None and not req.done]
        with TRACER.span("engine.step", rids=self._rids, step=self.steps, pos=self.pos,
                         active=len(active)) as sp:
            with TRACER.span("engine.replay", device=True, rids=self._rids):
                if self.graph is None:
                    lgts, self.cache = lm.decode_step(self.cfg, self.params, self._pending,
                                                      self.cache, self.pos)
                else:
                    lgts = self.graph.replay(self._pending, self.pos)
            self.pos += 1
            self.steps += 1
            with TRACER.span("engine.sample", rids=self._rids):
                nxt = self._sample(lgts)
            if TRACER:  # after the readback: the device spans' times
                TRACER.resolve()
            with TRACER.span("engine.tokens", rids=self._rids):
                self._pending = self._tokens(nxt)
                finished = []
                for slot, req in active:
                    req.out_tokens.append(nxt[slot].tolist())
                    if len(req.out_tokens) >= req.max_new_tokens:
                        req.done = True
                        finished.append(req.rid)
            if sp:
                sp.attrs["finished"] = finished
        obs_metrics.counter("engine.slot_steps").inc(self.num_slots)
        obs_metrics.counter("engine.tokens_served").inc(len(active))

    def _tokens(self, nxt: np.ndarray) -> torch.Tensor:
        """The sampled tokens as the next step's input, [B, 1] or [B, 1, K]."""
        return torch.from_numpy(nxt.astype(np.int64).reshape(self._tok_shape(1))).to(self.device)

    def plan_decode_collectives(
        self,
        *,
        num_nodes: int = 2,
        procs_per_node: int = 8,
        k_lanes: int = 2,
        faults=None,
    ):
        """Plan the per-decode-step collectives for this engine's shapes on
        the given collective mesh, in one :func:`repro_torch.api.plan_batch`
        call, priced at ``plan_cost``:

        * ``broadcast`` of the pending sampled-token batch (one int32 per
          slot per codebook) from the sampling host to every proc;
        * ``scatter`` of the activation block (``num_slots * d_model``
          split over procs) for tensor-parallel resharding;
        * ``alltoall`` with the per-pair block of that same activation
          resharding (the transpose the paper's Section 5 lowers).

        Returns ``{op: Plan}``.  The planning layer prices schedules, it
        does not run them, so a monitor process can call this off the hot
        path.  Faulted meshes flow through the selector's degradation ladder
        via ``faults``.

        With a pinned planner (``plan_mesh`` at construction) a query for
        the pinned mesh is a dict lookup, no re-pricing; the pinned set
        only moves on :meth:`inject_fault`.  Explicit ``faults`` or a
        different mesh still price ad hoc."""
        from repro_torch import api

        if self.planner is not None and faults is None \
                and (num_nodes, procs_per_node, k_lanes) == self.planner.mesh:
            return self.planner.plans()

        p = num_nodes * procs_per_node
        bcast_elems = self.num_slots * max(1, self.cfg.num_codebooks)
        act = self.num_slots * self.cfg.d_model
        reqs = [
            api.PlanRequest("broadcast", bcast_elems, num_nodes=num_nodes,
                            procs_per_node=procs_per_node, k_lanes=k_lanes,
                            faults=faults),
            api.PlanRequest("scatter", max(1, act // p), num_nodes=num_nodes,
                            procs_per_node=procs_per_node, k_lanes=k_lanes,
                            faults=faults),
            api.PlanRequest("alltoall", max(1, act // (p * p)),
                            num_nodes=num_nodes,
                            procs_per_node=procs_per_node, k_lanes=k_lanes,
                            faults=faults),
        ]
        plans = api.plan_batch(reqs, cost=self.plan_cost)
        obs_metrics.counter("engine.collective_plans").inc(len(plans))
        if TRACER:
            TRACER.event("engine.plan_collectives",
                         mesh=(num_nodes, procs_per_node, k_lanes),
                         algs={pl.op: pl.algorithm for pl in plans})
        return {pl.op: pl for pl in plans}

    def inject_fault(self, event) -> str:
        """Report a mid-run fault (a ``training.elastic.FaultEvent``) into
        the engine: the event is recorded and folded into the monitor's
        warn/evict policy.  Returns the resulting action; without a monitor
        the default policy is kind-based (node faults evict, lane faults
        warn: lanes are survivable via schedule repair).

        With a pinned planner the event also triggers exactly one
        bounded-latency replan of the pinned decode collectives
        (``DecodePlanner.observe_fault``)."""
        self.fault_events.append(event)
        if self.monitor is not None:
            action = self.monitor.observe_fault(event)
        else:
            action = "evict" if getattr(event, "kind", "node") == "node" else "warn"
        self.monitor_actions.append(action)
        if self.planner is not None:
            self.planner.observe_fault(event)
        obs_metrics.counter("engine.fault_events").inc()
        obs_metrics.counter(f"engine.fault_action.{action}").inc()
        if TRACER:
            TRACER.event("engine.fault", kind=getattr(event, "kind", None),
                         action=action)
        return action

    def drain(self) -> list[Request]:
        """Release finished requests from their slots."""
        out = []
        for i, req in enumerate(self.slots):
            if req is not None and req.done:
                out.append(req)
                self.slots[i] = None
        return out

    def run(self, requests: list[Request], *, max_steps: int = 256) -> list[Request]:
        """Convenience driver: admit everything (in waves), decode to done.

        With a monitor attached every decode step is timed through
        ``monitor.observe``; an "evict" verdict (a straggling host over the
        hard deadline ``patience`` times, or an injected node fault) stops
        the decode loop: the finished requests so far are returned and the
        caller remeshes (``elastic.plan_remesh_for_faults``) before
        resuming the rest."""
        pending = list(requests)
        finished: list[Request] = []
        steps = 0
        while (pending or any(s is not None for s in self.slots)) and steps < max_steps:
            if pending and any(s is None for s in self.slots) and self.cache is None:
                n = self.admit(pending)
                pending = pending[len(n):]
            t0 = time.perf_counter()
            self.step()
            dt = time.perf_counter() - t0
            if self.monitor is not None:
                action = self.monitor.observe(dt)
                self.monitor_actions.append(action)
                if action == "evict":
                    break
            finished.extend(self.drain())
            steps += 1
            if not any(s is not None and not s.done for s in self.slots) and not pending:
                break
        return finished
