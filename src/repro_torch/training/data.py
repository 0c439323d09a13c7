"""Synthetic sharded data pipeline (a copy of the reference's
``repro/training/data.py``: numpy only, so the port and the reference draw
bit-identical batches from the same seed and step).

Deterministic token streams keyed by (seed, step, shard): every data-parallel
host generates exactly its shard of the global batch with no coordination —
the property that makes restart/elastic-rescale trivial (the stream is a
pure function of the step counter, so resuming from checkpoint step k
reproduces the exact batch sequence, and a re-meshed job keeps data
consistency by construction).

A background prefetch thread keeps ``depth`` batches ready.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig

__all__ = ["SyntheticLM", "Prefetcher", "make_batch"]


def make_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
               step: int = 0) -> dict:
    """One deterministic global batch for ``cfg`` (token LMs get tokens +
    next-token labels; the VLM stub gets embeddings + labels)."""
    rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 0, step]))
    V = cfg.vocab_size
    if cfg.embed_inputs:
        shape = (batch, seq + 1, cfg.num_codebooks) if cfg.num_codebooks > 1 \
            else (batch, seq + 1)
        toks = rng.integers(0, V, shape, dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    emb = rng.standard_normal((batch, seq, cfg.d_model), dtype=np.float32)
    labels = rng.integers(0, V, (batch, seq), dtype=np.int32)
    return {"embeds": emb, "labels": labels}


class SyntheticLM:
    """Iterator over (step, batch) pairs, resumable at any step.

    ``corpus_size=None`` streams fresh i.i.d. noise (throughput testing);
    ``corpus_size=k`` cycles over k fixed batches (a learnable target for
    convergence tests and the examples), still a pure function of step."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                 start_step: int = 0, corpus_size: int | None = None):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.step = start_step
        self.corpus_size = corpus_size

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        data_step = self.step if self.corpus_size is None \
            else self.step % self.corpus_size
        b = make_batch(self.cfg, self.batch, self.seq, seed=self.seed,
                       step=data_step)
        out = (self.step, b)
        self.step += 1
        return out


class Prefetcher:
    """Background-thread prefetch of an iterator (depth-bounded)."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Exception | None = None

        def work():
            try:
                for item in it:
                    self._q.put(item)
            except Exception as e:
                self._err = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err:
                raise self._err
            raise StopIteration
        return item
