"""The one traffic generator: what a cell sends, from its traffic file's
parameters and the run's ``--seed``.

Every seed gets the same set of sizes, in another order, so that two seeds
give the same work and differ only in which request has which size and in
the token ids:

* serving (``waves``): each wave holds ``slots`` requests whose prompt
  lengths and new-token counts are the ``slots`` stratified points of the
  traffic's ranges (``strata``), shuffled by the seed independently of
  each other, with token ids drawn uniformly from ``[1, vocab)`` (0 is the
  engine's pad);
* training (``token_batches``): ``batches`` batches of ``batch`` rows of
  ``seq + 1`` token ids, drawn on the device in one call, every row
  different; the first ``seq`` are the inputs, the last ``seq`` the labels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Wave", "strata", "waves", "token_batches", "rng"]

#: the seed is any whole number up to a little over 2**31: folded into a
#: 64-bit generator seed (numpy takes any non-negative integer)
_SEED_SALT = 0x5EED_0F_B0


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The host generator of ``stream`` under ``seed`` (negative seeds too)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), _SEED_SALT, stream])


def strata(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` stratified points of the integers ``[lo, hi]``: the midpoints of
    ``n`` equal strata, the same for every seed."""
    i = np.arange(n)
    return np.minimum(lo + ((hi - lo + 1) * (2 * i + 1)) // (2 * n), hi).astype(np.int64)


@dataclasses.dataclass
class Wave:
    prompts: list  # [S_i] int32 token ids
    new_tokens: list  # ints


def waves(traffic: dict, vocab: int, seed: int, stream: int = 1):
    """The endless sequence of waves of the serving traffic ``traffic``
    (``slots``, ``prompt_tokens`` and ``new_tokens`` as ``[lo, hi]``) under
    ``seed``; another ``stream`` gives other token ids and orders."""
    n = int(traffic["slots"])
    lens = strata(*traffic["prompt_tokens"], n)
    news = strata(*traffic["new_tokens"], n)
    g = rng(seed, stream)
    while True:
        pl = g.permutation(lens)
        nl = g.permutation(news)
        prompts = [g.integers(1, vocab, int(s), dtype=np.int32) for s in pl]
        yield Wave(prompts=prompts, new_tokens=[int(x) for x in nl])


def token_batches(traffic: dict, vocab: int, seed: int, device) -> list[dict]:
    """``batches`` training batches ``{"tokens", "labels"}`` [batch, seq]
    int64 on ``device``, drawn from ``seed`` in one call."""
    import torch

    b, s, k = int(traffic["batch"]), int(traffic["seq"]), int(traffic["batches"])
    g = torch.Generator(device=device).manual_seed(int(rng(seed, 2).integers(2**62)))
    ids = torch.randint(0, vocab, (k, b, s + 1), generator=g, device=device, dtype=torch.int64)
    return [{"tokens": ids[i, :, :-1].contiguous(), "labels": ids[i, :, 1:].contiguous()}
            for i in range(k)]
