"""The decode step as one captured CUDA graph
(``repro_torch.serving.decode_graph``) against the eager step, on the card.

Both run the same kernels on the same inputs, so their logits must be equal
bit for bit.  On the yi, falcon-mamba, h2o-danube (a sliding window),
musicgen (2 codebooks: a [B, 1, K] token buffer), minicpm3 (MLA: a latent
cache), dbrx (MoE: routing and dispatch inside the graph), deepseek-v2
(MoE after a dense prelude layer) and jamba (a KV cache beside Mamba conv
windows and states in one captured cache, MoE after attention and after
Mamba) smoke configs (bf16), and on qwen2-vl's (embeds: a [B, 1, D] input
buffer; no engine drives it):

* the serving engine with the graph (the default on the card) and without
  it give the same tokens and per-step logits over 16 steps, for a first
  wave of requests and a second admitted after the first drained, and the
  graph's replays count their kernel launches;
* a graph captured over a live cache (a prefill's) replays the eager steps;
  a warm-up run over that cache instead of a scratch copy (a planted fault)
  must fail that check;
* a host read inside the step (a position baked in by ``int``) makes
  capture raise, and nothing falls back to the eager step.

Every case is marked ``cuda`` and skips without a card.  The module imports
no JAX: the card's machine has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.params import map_tree
from repro_torch.serving.decode_graph import DecodeGraph
from repro_torch.serving.engine import Request, ServeEngine, greedy_sample

ARCHS = ["yi_6b", "falcon_mamba_7b", "h2o_danube_3_4b", "musicgen_large", "minicpm3_4b",
         "dbrx_132b", "deepseek_v2_236b", "jamba_1_5_large_398b"]
#: the captured step alone also takes a model that takes embeddings
REPLAY_ARCHS = ARCHS + ["qwen2_vl_7b"]
SLOTS, CAP, PROMPT, STEPS = 4, 64, 8, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _model(arch):
    cfg = get_smoke_config(arch)
    return cfg, lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                              device="cuda")


def _tokens(cfg, rng, shape):
    """Token ids of ``shape``, with a trailing codebook axis for K > 1."""
    k = cfg.num_codebooks
    return rng.randint(0, cfg.vocab_size, shape + ((k,) if k > 1 else ()))


def _norms_per_forward(cfg) -> int:
    """norm1, norm2 unless the FFN is "none", and MLA's q_norm and kv_norm."""
    mla = cfg.attn is not None and cfg.attn.kind == "mla"
    per_period = sum(1 + (s.ffn != "none") + 2 * (mla and s.mixer == "attn")
                     for s in cfg.layer_pattern)
    return per_period * cfg.num_periods + 1  # a prelude layer has the period's norms


def _serve(cfg, params, cuda_graph: bool, waves):
    """Admit each wave of prompts once the last has drained and decode it
    for ``STEPS`` steps.  Returns (out_tokens by wave, the logits of every
    sampling, the kernels' launches over the run, the engine's graph or
    None)."""
    logits = []

    def sampler(lg, generator):
        logits.append(lg.clone())
        return greedy_sample(lg, generator)

    eng = ServeEngine(cfg, params, num_slots=SLOTS, capacity=CAP, sampler=sampler,
                      device="cuda", cuda_graph=cuda_graph)
    ops.reset_launches()
    tokens = []
    for prompts in waves:
        reqs = [Request(rid=i, prompt=p, max_new_tokens=STEPS + 1)
                for i, p in enumerate(prompts)]
        assert len(eng.admit(reqs)) == SLOTS
        for _ in range(STEPS):
            eng.step()
        assert all(r.done for r in reqs) and len(eng.drain()) == SLOTS
        tokens.append([r.out_tokens for r in reqs])
    return tokens, logits, ops.launch_counts(), eng.graph


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_engine_equals_the_eager_engine(cuda, arch):
    cfg, params = _model(arch)
    rng = np.random.RandomState(0)
    waves = [[_tokens(cfg, rng, (n,)).astype(np.int32) for n in (8, 5, 8, 3)]
             for _ in range(2)]
    want_tokens, want_logits, _, no_graph = _serve(cfg, params, False, waves)
    tokens, logits, launches, graph = _serve(cfg, params, True, waves)
    assert no_graph is None and graph is not None
    assert tokens == want_tokens
    assert len(logits) == len(want_logits) == 2 * (1 + STEPS)
    for i, (got, want) in enumerate(zip(logits, want_logits)):
        assert torch.equal(got, want), f"sampling {i}: max abs diff " \
            f"{(got.float() - want.float()).abs().max().item()}"
    per_forward = _norms_per_forward(cfg)
    assert graph.launches == {**dict.fromkeys(graph.launches, 0), "rmsnorm": per_forward}
    assert launches["rmsnorm"] == per_forward * 2 * (1 + STEPS)  # 2 prefills, 32 replays


def _replay_against_eager(cfg, params) -> None:
    """A graph captured over a prefill's cache, against eager steps from a
    copy of that cache, on the same (teacher-forced) tokens or embeds."""
    rng = np.random.RandomState(1)
    if cfg.embed_inputs:
        toks = torch.from_numpy(_tokens(cfg, rng, (SLOTS, PROMPT + STEPS))).cuda()
        key = "tokens"
    else:
        toks = torch.from_numpy(rng.randn(SLOTS, PROMPT + STEPS, cfg.d_model)).cuda()
        key = "embeds"
    _, cache = lm.prefill(cfg, params, {key: toks[:, :PROMPT]}, capacity=CAP)
    graph = DecodeGraph(cfg, params, map_tree(lambda _, t: t.clone(), cache))
    for t in range(STEPS):
        step = toks[:, PROMPT + t:PROMPT + t + 1]
        want, _ = lm.decode_step(cfg, params, step, cache, PROMPT + t)
        got = graph.replay(step, PROMPT + t)
        assert torch.equal(got, want), f"step {t}"


@pytest.mark.cuda
@pytest.mark.parametrize("arch", REPLAY_ARCHS)
def test_capture_leaves_a_live_cache_as_it_was(cuda, arch, monkeypatch):
    cfg, params = _model(arch)
    _replay_against_eager(cfg, params)
    sound = DecodeGraph._warm_up
    monkeypatch.setattr(DecodeGraph, "_warm_up", lambda self, scratch: sound(self, self.cache))
    with pytest.raises(AssertionError, match="step 0"):
        _replay_against_eager(cfg, params)


@pytest.mark.cuda
def test_a_host_read_in_the_step_fails_capture(cuda, monkeypatch):
    cfg, params = _model("yi_6b")
    step = lm.decode_step
    monkeypatch.setattr(lm, "decode_step",
                        lambda c, p, tok, cache, pos: step(c, p, tok, cache, int(pos)))
    with pytest.raises(RuntimeError, match="could not be captured"):
        ServeEngine(cfg, params, num_slots=SLOTS, capacity=CAP, device="cuda")
