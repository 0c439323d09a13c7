"""The decode step as one captured CUDA graph: the port's counterpart of the
reference's jitted step (``repro/serving/engine.py``, ``jax.jit`` of
``lm.decode_step`` with the cache position traced).

Run from Python, one decode step at serving batch launches some 2,000 to
3,000 small kernels, and the host's launch cost, not the card, sets its
time.  ``DecodeGraph`` records the step's launches once and replays them
with one call.  It owns static buffers that every replay reads and writes:

* ``inputs``, tokens [B, 1] int64 ([B, 1, K] for K codebooks) or, for a
  model that takes embeddings, embeds [B, 1, D] in the model dtype, and
  ``pos`` (0-d int64), the step's inputs, which ``replay`` overwrites on
  the device;
* ``cache``, the cache it was given, written in place by every replay (the
  caller loads a new prefill's cache into it with ``load``);
* the logits the captured step writes, of which ``replay`` returns a copy.

Capture first runs warm-up steps on a side stream, as ``torch.cuda.graphs``
asks (cuBLAS handles and workspaces, the kernels' libraries), over a scratch
copy of the cache: a warm-up is a real step, and on the cache itself it
would advance a Mamba state.  It then captures on a side stream of its own
and leaves the allocator's cache as it was.  Nothing falls back to the
eager step: on the CPU, or when capture fails, the class raises.

Kernel launch counts (``kernels/ops.py``) are Python integers that a
wrapper adds to when it is called: at capture, where nothing is launched.
Capture takes those counts back and keeps them as ``launches``, which every
replay adds to the dispatchers' counts again.

A replay has no host code inside it, so the tracer's device spans
(``obs/trace.py``) are captured as graph markers: ``decode.step`` around the
step and ``mixer.core`` in each layer, each a pair of timed external
events (``markers``, in capture order) that a replay records.  An event
node costs the step a few microseconds (on the H100 at 64 slots, 66 of
them added 0.9% to Yi-6B's step and 1.9% to a Falcon-Mamba-width one's),
so the step is captured twice into one memory pool: ``graph`` without the markers and ``marked`` with them.
``replay`` replays ``marked`` only while the tracer is live (on, or a
profiler recording), turns its markers into records of that replay, which
``TRACER.resolve`` times after the caller's readback, and ``graph``
otherwise.  Both read the same inputs and write the same cache.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.params import map_tree, torch_dtype
from repro_torch.obs.trace import TRACER

__all__ = ["DecodeGraph"]


def _leaves(tree: dict) -> list[torch.Tensor]:
    out = []
    map_tree(lambda _, t: out.append(t), tree)
    return out


class DecodeGraph:
    """``lm.decode_step`` captured once over ``cache`` (its tensors stacked
    over periods, batch in dim 1, on a CUDA device) and replayed per step."""

    #: eager steps run before capture, on a side stream
    WARMUP_STEPS = 3

    def __init__(self, cfg: ModelConfig, params: dict, cache: dict):
        leaves = _leaves(cache)
        device = leaves[0].device
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs the cache on a CUDA device, not {device}: "
                             "the CPU runs the eager step")
        self.cfg, self.params, self.cache = cfg, params, cache
        batch = leaves[0].shape[1]
        if not cfg.embed_inputs:
            self.inputs = torch.zeros(batch, 1, cfg.d_model, dtype=torch_dtype(cfg.dtype),
                                      device=device)
        else:
            codebooks = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
            self.inputs = torch.zeros(batch, 1, *codebooks, dtype=torch.int64, device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.marked = torch.cuda.CUDAGraph()  # the same step with the tracer's markers
        self.markers = []  # the tracer's markers, in capture order
        self.launches = self._capture()

    def _warm_up(self, cache: dict) -> None:
        """``WARMUP_STEPS`` eager steps over ``cache`` on a side stream."""
        side = torch.cuda.Stream(device=self.pos.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP_STEPS):
                lm.decode_step(self.cfg, self.params, self.inputs, cache, self.pos)
        torch.cuda.current_stream().wait_stream(side)

    def _capture(self) -> dict[str, int]:
        """Both graphs, ``marked`` into ``graph``'s memory pool; the launch
        counts of one."""
        self._warm_up(map_tree(lambda _, t: t.clone(), self.cache))
        before = ops.launch_counts()
        torch.cuda.synchronize(self.pos.device)
        try:
            # not ``torch.cuda.graph``, which empties the allocator's cache
            # first: the next prefill would then allocate its activations
            # anew with ``cudaMalloc``
            with torch.cuda.stream(torch.cuda.Stream(device=self.pos.device)):
                self._logits = self._capture_one(self.graph)
                captured = {k: n - before[k] for k, n in ops.launch_counts().items()}
                self._marked_logits = self._capture_one(self.marked, marked=True)
        except RuntimeError as e:
            raise RuntimeError(f"{self.cfg.name}: the decode step could not be captured "
                               "in a CUDA graph") from e
        finally:
            ops.add_launches({k: before[k] - n for k, n in ops.launch_counts().items()})
        return captured

    def _capture_one(self, graph, marked: bool = False) -> torch.Tensor:
        """``lm.decode_step`` captured into ``graph`` (``marked``: with the
        tracer's markers, into the plain graph's memory pool); its logits."""
        graph.capture_begin(pool=self.graph.pool() if marked else None)
        try:
            if not marked:
                return self._decode()
            with TRACER.capturing() as self.markers:
                with TRACER.span("decode.step", device=True):
                    return self._decode()
        finally:
            graph.capture_end()

    def _decode(self) -> torch.Tensor:
        logits, _ = lm.decode_step(self.cfg, self.params, self.inputs, self.cache, self.pos)
        return logits

    def load(self, cache: dict) -> None:
        """Copy ``cache`` (a prefill's) into the captured cache; its tensors
        must have the captured ones' shapes and dtypes."""
        def check(path, have, new):
            if (new.shape, new.dtype) != (have.shape, have.dtype):
                raise ValueError(f"cache {path}: {tuple(new.shape)} {new.dtype} does not "
                                 f"match the captured {tuple(have.shape)} {have.dtype}")

        map_tree(check, self.cache, cache)
        map_tree(lambda _, have, new: have.copy_(new), self.cache, cache)

    def replay(self, inputs: torch.Tensor, pos: int) -> torch.Tensor:
        """One decode step: tokens [B, 1] (or [B, 1, K]), or embeds [B, 1, D],
        at position ``pos`` (the tokens already in the cache).  Returns the
        logits [B, V] (or [B, K, V]); the cache is updated in place."""
        lm.check_position(self.cfg, self.cache, pos)
        self.inputs.copy_(inputs)
        self.pos.fill_(pos)
        if TRACER:  # live: the marked graph, its last replay's markers resolved first
            TRACER.resolve(wait=True)
            self.marked.replay()
            TRACER.replayed(self.markers)
            logits = self._marked_logits
        else:
            self.graph.replay()
            logits = self._logits
        ops.add_launches(self.launches)
        return logits.clone()
