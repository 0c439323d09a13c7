"""The port's serving engine (``repro_torch.serving.engine``) against the JAX
package's (``repro.serving.engine``), on the same parameters, prompts,
slots and capacity, and the port's serve CLI.

With ``plan_mesh`` set, both engines pin and replan the same
decode-collective plans (``test_engine_pins_and_replans_on_fault``,
``test_engine_plans_decode_collectives``: the reference's tests, run on
both), and the port's greedy tokens do not change with it.

Float32 copies of the yi, falcon-mamba, musicgen, minicpm3 (MLA), dbrx
(MoE), deepseek-v2 (MoE, a dense prelude, MLA) and jamba (attention, Mamba
and MoE layers in one stack) smoke configs, so the
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
from repro.core import faults as JF
from repro.serving import engine as JE
from repro.training import elastic as JEL
from repro_torch import api as t_api
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults as TF
from repro_torch.core import topology as TT
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as TLM
from repro_torch.serving import engine as TE
from repro_torch.serving import planner as TP
from repro_torch.serving.decode_graph import DecodeGraph
from repro_torch.training import elastic as TEL

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


def test_jamba_engine_matches_reference():
    """The hybrid: a slot cache that holds a KV cache (the attention slot)
    beside Mamba conv windows and states, and MoE after attention and
    after Mamba.  Both reference caveats at once: the left pads (token 0)
    of the shorter prompts enter the Mamba states, and they are routed and
    take MoE capacity slots."""
    _engine_matches_reference("jamba_1_5_large_398b")


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
    """The planner's slice is in: ``plan_mesh`` builds the engine's
    ``DecodePlanner`` (pinned, no replan yet) where it was refused, and the
    engine still refuses a CUDA graph on the CPU with it set."""
    _, tcfg, _, tp, _ = _setup()
    eng = TE.ServeEngine(tcfg, tp, plan_mesh=(2, 8, 2), device="cpu")
    assert isinstance(eng.planner, TP.DecodePlanner) and eng.planner.mesh == (2, 8, 2)
    assert eng.planner.replan_count == 0 and eng.planner.cost is None
    assert set(eng.planner.plans()) == {"broadcast", "scatter", "alltoall"}
    with pytest.raises(ValueError, match="cuda_graph=True needs device 'cuda'"):
        TE.ServeEngine(tcfg, tp, plan_mesh=(2, 8, 2), device="cpu", cuda_graph=True)


def _plan_tuple(pl) -> tuple:
    """A plan's answer: its request carries a replan's deadline budget, a
    wall-clock reading, so plans compare by what they chose and priced."""
    return pl.op, pl.algorithm, pl.est_us, pl.candidates


@pytest.fixture
def fresh_selectors():
    from repro.core.selector import selector_cache_reset as j_reset
    from repro_torch.core.selector import selector_cache_reset as t_reset

    j_reset()
    t_reset()
    yield
    j_reset()
    t_reset()


def test_engine_pins_and_replans_on_fault(fresh_selectors):
    """The reference's ``test_engine_pins_and_replans_on_fault`` on both
    engines, on yi's smoke config and the reference's params: equal pinned
    plans, equal actions and replans on the same lane fault, equal ad hoc
    plans on another mesh."""
    jcfg, tcfg, jp, tp, _ = _setup()
    out = {}
    kw = dict(num_slots=2, capacity=64, plan_mesh=(2, 4, 2),
              replan_deadline_s=60.0)  # never fires here: the replan races every rung
    for name, eng in (("ref", JE.ServeEngine(jcfg, jp, **kw)),
                      ("port", TE.ServeEngine(tcfg, tp, **kw, device="cpu"))):
        mesh = dict(num_nodes=2, procs_per_node=4, k_lanes=2)
        pinned = eng.plan_decode_collectives(**mesh)
        assert set(pinned) == {"broadcast", "scatter", "alltoall"}
        assert eng.plan_decode_collectives(**mesh) == pinned  # served verbatim
        assert eng.planner.replan_count == 0
        event = (JEL if name == "ref" else TEL).FaultEvent(kind="lane", node=0, step=1)
        action = eng.inject_fault(event)
        assert eng.planner.replan_count == 1 and len(eng.planner.replan_reports) == 1
        other = eng.plan_decode_collectives(num_nodes=3, procs_per_node=4, k_lanes=2)
        out[name] = ({op: pl.as_dict() for op, pl in pinned.items()}, action,
                     eng.monitor_actions, eng.fault_events[0].kind,
                     {op: _plan_tuple(pl) for op, pl in eng.planner.plans().items()},
                     {k: v for k, v in eng.planner.replan_reports[0].items() if k != "wall_s"},
                     {op: pl.as_dict() for op, pl in other.items()})
    assert out["port"] == out["ref"]
    assert out["port"][1] == "warn"


def test_engine_plans_decode_collectives(fresh_selectors):
    """The reference's ``test_engine_plans_decode_collectives`` on both
    engines: the same plans, healthy and on a faulted mesh, each equal to
    the per-query planner and materialising a schedule over 16 procs; and
    an engine's fault actions under a ``StragglerMonitor``."""
    jcfg, tcfg, jp, tp, _ = _setup()
    jeng = JE.ServeEngine(jcfg, jp, num_slots=4, capacity=64, monitor=JEL.StragglerMonitor())
    teng = TE.ServeEngine(tcfg, tp, num_slots=4, capacity=64, device="cpu",
                          monitor=TEL.StragglerMonitor())
    mesh = dict(num_nodes=2, procs_per_node=8, k_lanes=2)
    for faults in (None, ((1, 1),)):
        want = jeng.plan_decode_collectives(
            **mesh, faults=faults and JF.FaultSpec(dead_lanes=faults))
        got = teng.plan_decode_collectives(
            **mesh, faults=faults and TF.FaultSpec(dead_lanes=faults))
        assert {op: pl.as_dict() for op, pl in got.items()} == \
            {op: pl.as_dict() for op, pl in want.items()}
        for op, pl in got.items():
            assert pl.op == op and pl == t_api.plan(pl.request)
            assert pl.schedule().p == 16
    actions = {}
    for name, eng, el in (("ref", jeng, JEL), ("port", teng, TEL)):
        actions[name] = [eng.inject_fault(el.FaultEvent(kind=k, node=n, step=i))
                         for i, (k, n) in enumerate((("lane", 0), ("lane", 1), ("lane", 0),
                                                     ("node", 1)))]
    assert actions["port"] == actions["ref"] == ["warn", "warn", "evict", "evict"]
    assert teng.monitor_actions == jeng.monitor_actions


@pytest.mark.parametrize("plan_cost", [None, "nvlink_ib"])
def test_engine_greedy_tokens_unchanged_by_the_planner(plan_cost, fresh_selectors):
    """Pinning and a replan on a lane fault after decode step 3 leave the
    greedy tokens as they are without ``plan_mesh``: the planner is off the
    decode path."""
    _, tcfg, _, tp, prompts = _setup()
    cost = TT.NVLINK_IB.cost if plan_cost else None
    runs = []
    for kw in ({}, {"plan_mesh": (2, 8, 2), "plan_cost": cost}):
        eng = TE.ServeEngine(tcfg, tp, num_slots=SLOTS, capacity=CAP, device="cpu", **kw)
        reqs = _requests(TE, prompts)
        eng.admit(reqs)
        for step in range(1, MAX_NEW):
            eng.step()
            if step == 3 and eng.planner is not None:
                assert eng.inject_fault(TEL.FaultEvent(kind="lane", node=0, step=3)) == "warn"
        runs.append([r.out_tokens for r in reqs])
        if eng.planner is not None:
            assert eng.planner.replan_count == 1 and eng.planner.cost is cost
    assert runs[1] == runs[0] and all(len(t) == MAX_NEW for t in runs[0])


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


def test_serve_cli_runs_jamba_smoke_on_cpu():
    """Cut below its pattern's period: the first 2 layers (attention + MoE,
    Mamba + dense)."""
    _serve_cli_runs_smoke_on_cpu("jamba_1_5_large_398b", "--layers", "2")


def _serve_cli_runs_smoke_on_cpu(arch, *args):
    done = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "4", "--prompt-len", "8",
                        "--max-new", "5", "--capacity", "16", *args])
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
