"""The port's serving engine (``repro_torch.serving.engine``) against the JAX
package's (``repro.serving.engine``), on the same parameters, prompts,
slots and capacity, and the port's serve CLI.

Float32 copies of the yi, falcon-mamba, musicgen, minicpm3 (MLA), dbrx
(MoE) and deepseek-v2 (MoE, a dense prelude, MLA) smoke configs, so the
logits agree to 1e-5 of their scale.  The port's engine is fed the reference's
tokens (teacher forcing), so every step's logits are comparable even where
a near-tie could flip a greedy choice; its own greedy choice must equal
the reference's wherever the reference's top-2 gap exceeds the tolerance.
A second, free-running greedy port engine must then give the reference's
``out_tokens``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as JLM
from repro.serving import engine as JE
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as TLM
from repro_torch.serving import engine as TE
from repro_torch.serving.decode_graph import DecodeGraph

TOL = 1e-5
SLOTS, CAP, MAX_NEW = 4, 48, 6
PROMPT_LENS = (5, 12, 9)  # unequal: admission left-pads to 12


def _setup(arch="yi_6b"):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = JLM.init_model(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(4)
    k = tcfg.num_codebooks
    prompts = [rng.randint(0, tcfg.vocab_size, (n, k) if k > 1 else n).astype(np.int32)
               for n in PROMPT_LENS]
    return jcfg, tcfg, jp, tp, prompts


def _requests(mod, prompts):
    return [mod.Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]


def test_engine_matches_reference():
    _engine_matches_reference("yi_6b")


def test_falcon_mamba_engine_matches_reference():
    """The Mamba path: as in the reference, the left pads (token 0) of the
    shorter prompts enter the state."""
    _engine_matches_reference("falcon_mamba_7b")


def test_musicgen_engine_matches_reference():
    """Two codebooks: prompts [S, K], logits [B, K, V], a token list of K
    ids per request and step, as in the reference."""
    _engine_matches_reference("musicgen_large")


def test_minicpm3_engine_matches_reference():
    """MLA: the expanded prefill fills the latent cache that the absorbed
    decode steps read."""
    _engine_matches_reference("minicpm3_4b")


def test_dbrx_engine_matches_reference():
    """MoE in every layer: as in the reference, each call routes its own
    tokens at its own capacity (the prefill's 4 x 12, the step's 4), and
    the left pads (token 0) of the shorter prompts are routed and take
    capacity slots."""
    _engine_matches_reference("dbrx_132b")


def test_deepseek_engine_matches_reference():
    """The dense prelude layer, MLA and shared experts."""
    _engine_matches_reference("deepseek_v2_236b")


def test_engine_refuses_a_model_that_takes_embeddings():
    """As the reference's engine: Qwen2-VL takes embeddings, which go
    through ``lm.prefill`` / ``lm.decode_step`` (or the captured step), not
    the token engine."""
    cfg = get_smoke_config("qwen2_vl_7b")
    params = TLM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="serving engine drives token models"):
        TE.ServeEngine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="serving engine drives token models"):
        JE.ServeEngine(jax_smoke_config("qwen2_vl_7b"), {})


def _engine_matches_reference(arch):
    jcfg, tcfg, jp, tp, prompts = _setup(arch)

    ref_logits = []

    def ref_sampler(logits, rng):
        ref_logits.append(np.asarray(logits, np.float32))
        return JE.greedy_sample(logits)

    jeng = JE.ServeEngine(jcfg, jp, num_slots=SLOTS, capacity=CAP, sampler=ref_sampler)
    jdone = jeng.run(_requests(JE, prompts))

    port_logits = []

    def forced(logits, generator):
        port_logits.append(logits.float().numpy())
        return torch.from_numpy(ref_logits[len(port_logits) - 1].argmax(-1)).to(torch.int32)

    teng = TE.ServeEngine(tcfg, tp, num_slots=SLOTS, capacity=CAP, sampler=forced,
                          device="cpu")
    teng.run(_requests(TE, prompts))

    assert len(port_logits) == len(ref_logits) == MAX_NEW
    for step, (got, want) in enumerate(zip(port_logits, ref_logits)):
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() <= TOL * scale, f"step {step}"
        top2 = np.sort(want, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > TOL * scale
        assert (got.argmax(-1) == want.argmax(-1))[decided].all(), f"step {step}"

    greedy = TE.ServeEngine(tcfg, tp, num_slots=SLOTS, capacity=CAP, device="cpu")
    tdone = greedy.run(_requests(TE, prompts))
    assert sorted(r.rid for r in tdone) == sorted(r.rid for r in jdone) == [0, 1, 2]
    want = {r.rid: r.out_tokens for r in jdone}
    for r in tdone:
        assert len(r.out_tokens) == MAX_NEW and r.done
        assert r.out_tokens == want[r.rid], r.rid


def test_engine_records_steps_and_stops_on_evict():
    _, tcfg, _, tp, prompts = _setup()

    class Evict:
        def __init__(self):
            self.seen = []

        def observe(self, dt):
            self.seen.append(dt)
            return "evict" if len(self.seen) == 2 else "ok"

    mon = Evict()
    eng = TE.ServeEngine(tcfg, tp, num_slots=SLOTS, capacity=CAP, monitor=mon,
                         device="cpu")
    done = eng.run(_requests(TE, prompts))
    assert done == [] and len(mon.seen) == 2 and eng.monitor_actions == ["ok", "evict"]
    assert all(len(r.out_tokens) == 3 for r in eng.slots if r is not None)


def test_engine_refuses_planner_until_its_slice():
    _, tcfg, _, tp, _ = _setup()
    with pytest.raises(NotImplementedError, match="planner"):
        TE.ServeEngine(tcfg, tp, plan_mesh=(2, 8, 2), device="cpu")


def test_engine_refuses_a_cuda_graph_on_the_cpu():
    """The CPU runs the eager step; a graph asked for there raises rather
    than falling back to it."""
    _, tcfg, _, tp, _ = _setup()
    assert TE.ServeEngine(tcfg, tp, device="cpu").graph is None
    with pytest.raises(ValueError, match="cuda_graph=True needs device 'cuda'"):
        TE.ServeEngine(tcfg, tp, device="cpu", cuda_graph=True)
    cache = TLM.init_cache(tcfg, SLOTS, CAP, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        DecodeGraph(tcfg, tp, cache)


def test_serve_cli_runs_smoke_on_cpu():
    _serve_cli_runs_smoke_on_cpu("yi_6b")


def test_serve_cli_runs_falcon_mamba_smoke_on_cpu():
    _serve_cli_runs_smoke_on_cpu("falcon_mamba_7b")


def test_serve_cli_runs_musicgen_smoke_on_cpu():
    _serve_cli_runs_smoke_on_cpu("musicgen_large")


def test_serve_cli_runs_minicpm3_smoke_on_cpu():
    _serve_cli_runs_smoke_on_cpu("minicpm3_4b")


def test_serve_cli_runs_dbrx_smoke_on_cpu():
    _serve_cli_runs_smoke_on_cpu("dbrx_132b")


def _serve_cli_runs_smoke_on_cpu(arch):
    done = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "4", "--prompt-len", "8",
                        "--max-new", "5", "--capacity", "16"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 5 for r in done)
    k = get_smoke_config(arch).num_codebooks
    assert all(np.shape(t) == ((k,) if k > 1 else ()) for r in done for t in r.out_tokens)


@pytest.mark.parametrize("args,err", [
    (["--requests", "6", "--slots", "4"], "--requests 6 > --slots 4"),
    (["--prompt-len", "200", "--capacity", "64"], "could not finish"),
])
def test_serve_cli_rejects_runs_that_could_not_finish(args, err, capsys):
    """The reference's loop admits only into an empty cache, so with more
    requests than slots it spins forever; the port's CLI refuses instead."""
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--arch", "yi_6b", "--smoke", "--device", "cpu", *args])
    assert exc.value.code == 2
    assert err in capsys.readouterr().err


def test_temperature_sample_follows_the_softmax():
    """It cannot reproduce ``jax.random``'s draws, so its distribution is
    checked: logits (0, log 3) at temperature 1 give the second token 3/4
    of the time (4000 draws, 4 sigma = 0.027)."""
    sample = TE.temperature_sample(1.0)
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, float(np.log(3.0))]]).expand(4000, 2)
    picks = sample(logits, gen)
    assert picks.dtype == torch.int32 and set(picks.tolist()) <= {0, 1}
    assert abs(picks.float().mean().item() - 0.75) < 0.027
    sharp = TE.temperature_sample(0.01)(torch.tensor([[0.0, 1.0, 0.5]]), gen)
    assert sharp.tolist() == [1]
    codebooks = TE.temperature_sample(0.01)(torch.tensor([[[0.0, 1.0], [2.0, 0.0]]] * 3), gen)
    assert codebooks.tolist() == [[1, 0]] * 3  # [B, K, V] -> one pick per codebook
