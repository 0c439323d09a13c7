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

The reference's decode-collective planner (``plan_mesh``,
``plan_decode_collectives``, ``inject_fault``) comes with the planner slice.
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

#: decode-step latency buckets (seconds): 100us .. 10s geometric
_STEP_EDGES = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 10.0)


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
        device="cuda",
        cuda_graph: bool | None = None,
    ):
        """``cuda_graph``: replay the decode step as a captured CUDA graph;
        None means on for ``cuda`` and off for ``cpu``, and True on the CPU
        raises."""
        self.device = resolve_device(device)
        if plan_mesh is not None:
            raise NotImplementedError(
                "plan_mesh: the decode-collective planner comes with the "
                "planner slice (ROADMAP queue 1 item 14)")
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
        # optional fault/straggler hook: any object with observe(seconds) ->
        # "ok"|"warn"|"evict" (duck-typed).  run() times every decode step
        # through it and stops decoding on "evict".
        self.monitor = monitor
        self.monitor_actions: list[str] = []
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
        start = self.pos
        toks = np.zeros(self._tok_shape(start + max_len), np.int64)
        for slot, req in zip(free, admitted):
            p = np.asarray(req.prompt)
            toks[slot, start + max_len - len(p):start + max_len] = p
            self.slots[slot] = req
        lgts, cache = lm.prefill(
            self.cfg, self.params,
            {"tokens": torch.from_numpy(toks).to(self.device)},
            capacity=self.capacity,
        )
        if self.graph is None:
            self.cache = cache
        else:  # into the buffers the captured step reads
            self.graph.load(cache)
            self.cache = self.graph.cache
        self.pos = start + max_len
        # first sampled token from prefill logits
        nxt = self._sample(lgts)
        for slot, req in zip(free, admitted):
            req.out_tokens.append(nxt[slot].tolist())
        self._pending = self._tokens(nxt)
        return admitted

    def step(self) -> None:
        """One lock-step decode for all active slots."""
        if self.cache is None or self.pos >= self.capacity:
            return
        if self.graph is None:
            lgts, self.cache = lm.decode_step(self.cfg, self.params, self._pending,
                                              self.cache, self.pos)
        else:
            lgts = self.graph.replay(self._pending, self.pos)
        self.pos += 1
        nxt = self._sample(lgts)
        self._pending = self._tokens(nxt)
        for slot, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            req.out_tokens.append(nxt[slot].tolist())
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True

    def _tokens(self, nxt: np.ndarray) -> torch.Tensor:
        """The sampled tokens as the next step's input, [B, 1] or [B, 1, K]."""
        return torch.from_numpy(nxt.astype(np.int64).reshape(self._tok_shape(1))).to(self.device)

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
        ``monitor.observe``; an "evict" verdict stops the decode loop and
        the finished requests so far are returned."""
        pending = list(requests)
        finished: list[Request] = []
        steps = 0
        while (pending or any(s is not None for s in self.slots)) and steps < max_steps:
            if pending and any(s is None for s in self.slots) and self.cache is None:
                n = self.admit(pending)
                pending = pending[len(n):]
            sp = TRACER.start("decode_step", step=steps) if TRACER else None
            t0 = time.perf_counter()
            try:
                self.step()
            except BaseException:
                if sp:
                    TRACER.finish(sp, outcome="error")
                raise
            dt = time.perf_counter() - t0
            if sp:
                TRACER.finish(sp, pos=self.pos)
            obs_metrics.histogram(
                "engine.step_latency_s", edges=_STEP_EDGES
            ).observe(dt)
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
