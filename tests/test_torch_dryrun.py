"""The port's dry-run (``repro_torch.launch.dryrun`` over
``launch/costanalysis.py``) against the reference's compiled programs.

The shard_map step (``step="shardmap"``).  At smoke size on
``make_test_mesh((2, 4, 1))`` (2 pods x 4 data x 1 model, the 8 CPU
devices), the reference compiles its shard_map train step
(``make_train_step_shardmap``, fsdp off) and reads ``memory_analysis`` and
``hloanalysis.analyze_module``; the port runs ``dryrun.measure_cell`` on
the meta device.  What must hold, per config and backend:

* argument bytes per device: equal, exactly;
* collective bytes by kind: equal, exactly, but for one XLA rewrite: where
  the config has no MoE, the aux loss is the constant 0 and XLA folds its
  psum away, so the reference's all-reduce carries one float32 scalar (4
  bytes) less than the port's sync, which sums every metric;
* FLOPs: equal, exactly, once two differences of formulation are counted.
  The reference embeds tokens by a one-hot product with the table
  (``onehot @ table``: 2 T V D FLOPs a codebook forward and as many for the
  table's gradient) and picks each label's logit by a one-hot contraction
  (2 T V a codebook); the port indexes, which is no product.  And the
  reference's attention skips masked chunks of its ``attn_chunk_q`` x
  ``attn_chunk_kv``, the port's kernels count 64 x 64 tiles: where a
  config's chunk is smaller (Danube's 32, under its window) the port counts
  the pairs of the 64-tiles its kernel visits.  And one XLA rewrite: the
  unrolled prelude layer (DeepSeek-V2's dense first layer) has its forward
  and backward in one computation, where common-subexpression elimination
  merges the backward's recomputed scores with the forward's (the scanned
  layers' are in two loop bodies and stay apart); the port's backward
  kernel recomputes them.

The sharded programs (the default ``xla`` cells: the production step,
``make_train_step_pjit`` with fsdp on, and the sharded prefill and decode
step), at smoke size on (2, 2, 2), run as rank 0 over a fake process group
on meta shards (``torch_rank_jobs.DRYRUN_REAL``):

* argument bytes per device equal the reference's compiled ones, exactly
  (the reference's jit drops the arguments its program never reads: a
  prefill's labels, the position of a decode step where nothing attends;
  so does the port's count);
* the collectives by kind, bytes and counts, equal what the same program
  records on rank 0 of an 8-rank gloo run on the CPU
  (``torch_rank_jobs.dryrun_ranks``), the fake mesh's device type
  ``cpu`` as the gloo mesh's (DTensor moves a shard to another dim by an
  all-gather there, by an all-to-all on ``cuda``, the CLI's; ``chip_smoke.py``
  phase 9 (c) holds the ``cuda`` count to the card's runs);
* beside the reference's HLO (``analyze_module``) the totals agree within
  a factor of ``HLO_BAND`` (4) once one difference of formulation is
  counted: XLA's host backend carries bf16 collectives in float32 (each
  operand converted before the collective), so the reference's bytes of a
  bf16 operand are twice the port's; the port's total is doubled for the
  comparison.  The rest differs by formulation and is left in the band:
  GSPMD all-reduces a gradient or an activation where DTensor
  reduce-scatters and all-gathers, or gathers a parameter; it moves the
  sequence-sharded MLA cache and the MoE buffers by collective-permutes
  and all-to-alls, where the port's ranks each write their own cache slice
  (``layers.write_at``), gather the scores for the softmax and sum the
  expert-parallel partials once over ``model``; a failure prints both
  programs' bytes by kind;
* on a pure-FSDP (1, 8, 1) mesh, the prefill's all-gathers are each
  FSDP-sharded parameter's shard once, exactly, but the head's, whose
  d_model rows the product contracts on their shards (a partial sum, then
  one all-reduce of the logits).
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import pytest

import torch_rank_jobs as J

from repro.configs import get_smoke_config as ref_smoke
from repro.launch import specs as RSP
from repro.launch.hloanalysis import analyze_module
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.models import lm as ref_lm
from repro.training.optimizer import OptConfig as RefOptConfig
from repro.training.optimizer import init_opt_state as ref_init_opt_state
from repro.training.train_step import make_act_shard as ref_make_act_shard
from repro.training.train_step import make_train_step_pjit, make_train_step_shardmap
from repro.training.train_step import param_pspecs as ref_param_pspecs
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.launch import costanalysis as CA
from repro_torch.launch import dryrun, ranks
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.models.params import map_tree
from repro_torch.training.train_step import param_pspecs

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

MESH = (2, 4, 1)
BATCH, SEQ = 16, 64
CASES = [(a, "xla") for a in ARCH_IDS] + [(a, "fulllane") for a in
                                          ("yi_6b", "falcon_mamba_7b", "dbrx_132b")]


def _fsdp_off(cfg):
    return dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, fsdp=False))


def _reference(arch: str, backend: str) -> dict:
    cfg = _fsdp_off(ref_smoke(arch))
    mesh = ref_test_mesh(MESH)
    opt_cfg = RefOptConfig(moment_dtype=cfg.parallel.optimizer_dtype)
    params = ref_lm.abstract_model(cfg)
    batch = RSP.batch_structs(cfg, BATCH, SEQ)
    opt = jax.eval_shape(lambda p: ref_init_opt_state(p, opt_cfg), params)
    mk, _ = make_train_step_shardmap(cfg, mesh, opt_cfg, backend=backend)
    compiled = mk(batch).lower(params, opt, batch).compile()
    hc = analyze_module(compiled.as_text())
    return {"argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
            "collective_bytes": hc.collective_bytes, "flops": hc.flops}


def _formulation_flops(cfg) -> float:
    """The reference's FLOPs less the port's, per device, from the
    differences the module docstring names: the reference's one-hot
    products; the pairs of the port's 64-tiles that smaller chunks skip;
    the prelude's score recompute that XLA merges away."""
    tokens = BATCH * SEQ // (MESH[0] * MESH[1])
    K, V, D = cfg.num_codebooks, cfg.padded_vocab, cfg.d_model
    onehot = (4 * tokens * V * D * K if cfg.embed_inputs else 0) + 2 * tokens * K * V
    a = cfg.attn
    if a is None:
        return onehot
    hd, hdv = ((a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim) if a.kind == "mla"
               else (a.head_dim, a.head_dim))
    heads = BATCH // (MESH[0] * MESH[1]) * a.num_heads
    pairs = ops.attention_tile_pairs(SEQ, SEQ, True, a.sliding_window)
    chunk = cfg.parallel.attn_chunk_q
    assert chunk == cfg.parallel.attn_chunk_kv
    layers = sum(s.mixer == "attn" for s in cfg.layer_pattern) * (
        cfg.num_layers // len(cfg.layer_pattern))
    extra = pairs - ops.attention_tile_pairs(SEQ, SEQ, True, a.sliding_window, tile=chunk)
    # a pair: forward 2 (hd + hdv), backward 2 (3 hd + 2 hdv), the scores 2 hd
    # of the backward's
    prelude = sum(cfg.layer_pattern[j % len(cfg.layer_pattern)].mixer == "attn"
                  for j in range(cfg.first_k_dense))
    return (onehot - extra * heads * layers * 2 * (4 * hd + 3 * hdv)
            - prelude * pairs * heads * 2 * hd)


@pytest.mark.parametrize("arch,backend", CASES)
def test_smoke_cell_matches_the_compiled_reference(arch, backend):
    cfg = get_smoke_config(arch)
    got = dryrun.measure_cell(cfg, ShapeSpec("smoke", "train", SEQ, BATCH),
                              make_test_mesh(MESH), backend=backend, step="shardmap")
    want = _reference(arch, backend)
    assert got["memory"]["argument_bytes"] == want["argument_bytes"]
    coll = dict(want["collective_bytes"])
    if cfg.moe is None:  # XLA folded the psum of the constant aux loss
        coll["all-reduce"] += 4
    assert got["collective_bytes_per_device"] == coll
    assert got["flops_per_device"] == want["flops"] - _formulation_flops(cfg)


def test_fulllane_sends_less_across_pods():
    """The paper's point at smoke size: per rank, the full-lane sync sends
    a 1/lanes share of the flat sync's cross-pod bytes or less."""
    cfg = get_smoke_config("yi_6b")
    shape = ShapeSpec("smoke", "train", SEQ, BATCH)
    recs = {b: dryrun.measure_cell(cfg, shape, make_test_mesh(MESH), backend=b,
                                   step="shardmap") for b in ("xla", "fulllane")}
    flat, full = (recs[b]["dp_sync_sent_per_device"]["cross_pod_bytes"]
                  for b in ("xla", "fulllane"))
    assert 0 < full * MESH[1] <= flat


def test_cli_writes_a_record_per_cell(tmp_path):
    """Every shape of one config on both production meshes: each cell
    ``ok`` or ``skipped`` by ``cell_eligible``, with the reference's keys;
    and the production step's ``xla`` train cell, whose collectives over a
    mesh with ``model`` > 1 are what its program issues."""
    assert dryrun.main(["--arch", "yi_6b", "--mesh", "both", "--backend", "fulllane",
                        "--out-dir", str(tmp_path)]) == 0
    recs = {p.stem: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert len(recs) == 2 * len(SHAPES)
    for tag, rec in recs.items():
        assert tag.endswith("__fulllane")
        if rec["shape"] == "long_500k":
            assert rec["status"] == "skipped" and rec["reason"]
            continue
        assert rec["status"] == "ok", rec
        assert rec["flops_per_device"] > 0 and rec["memory"]["argument_bytes"] > 0
        assert rec["hbm_bytes_per_device"] is None and rec["hbm_bytes_reason"]
        assert rec["num_devices"] == (512 if rec["mesh"] == "multi" else 256)
    multi = recs["yi_6b__train_4k__multi__fulllane"]
    assert set(multi["collective_bytes_per_device"]) == {"reduce-scatter", "all-reduce",
                                                         "all-gather"}
    assert multi["dp_sync_sent_per_device"]["cross_pod_bytes"] > 0
    assert dryrun.main(["--arch", "yi_6b", "--shape", "train_4k", "--mesh", "single",
                        "--out-dir", str(tmp_path / "xla")]) == 0
    (xla,) = (json.loads(p.read_text()) for p in (tmp_path / "xla").glob("*.json"))
    assert xla["status"] == "ok" and xla["mesh_axes"]["model"] > 1
    assert xla["collective_bytes_per_device"] and all(
        v > 0 for v in xla["collective_bytes_per_device"].values())


def test_meta_calls_count_and_compute_nothing():
    """The dispatchers' meta branch: outputs of the right shape on the meta
    device, the FLOPs counted, no launch counted."""
    import torch

    q = torch.empty(8, 130, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 130, 64, dtype=torch.bfloat16, device="meta")
    ops.reset_launches()
    with ops.count_meta_flops() as counts:
        o, lse = ops.flash_attention(q, kv, kv, group_size=4, return_lse=True)
        y, h = ops.mamba_scan(*(torch.empty(2, 5, 16, 4, device="meta"),) * 2,
                              torch.empty(2, 5, 4, device="meta"))
    assert o.is_meta and o.shape == (8, 130, 64) and lse.dtype == torch.float32
    assert y.shape == (2, 5, 16) and h.shape == (2, 16, 4)
    # causal, 130 rows in 64-tiles: each tile of rows sees the key tiles up
    # to its diagonal, the last (2 rows) all 130 keys
    assert counts["flash_attention"] == 2 * 128 * 8 * (64 * 64 + 64 * 128 + 2 * 130)
    assert counts["mamba_scan"] == 2 * 2 * 5 * 16 * 4
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


SHARDED = (2, 2, 2)
#: the reference's total over the port's, the port's doubled (its bf16
#: operands at float32, as the reference's host compile carries them), lies
#: in [1 / HLO_BAND, HLO_BAND]
HLO_BAND = 4.0
REAL_CELLS = [f"{a}/{k}" for a, k, _, _ in J.DRYRUN_REAL]


def _reference_sharded(arch: str, kind: str, B: int, S: int, shape=SHARDED) -> dict:
    """The reference's program of a sharded cell, compiled as its
    ``build_cell`` compiles it: argument bytes and collective bytes."""
    cfg = ref_smoke(arch)
    mesh = ref_test_mesh(shape)
    params = ref_lm.abstract_model(cfg)
    if kind == "train":
        opt_cfg = RefOptConfig(moment_dtype=cfg.parallel.optimizer_dtype)
        batch = RSP.batch_structs(cfg, B, S)
        opt = jax.eval_shape(lambda p: ref_init_opt_state(p, opt_cfg), params)
        compiled = make_train_step_pjit(cfg, mesh, opt_cfg)[0](batch).lower(
            params, opt, batch).compile()
    else:
        ns = RSP.named(mesh, ref_param_pspecs(cfg, mesh))
        act = ref_make_act_shard(cfg, mesh)
        cache = ref_lm.abstract_cache(cfg, B, S)
        cspec = RSP.named(mesh, RSP.cache_pspecs(cfg, mesh, cache))
        if kind == "prefill":
            batch = RSP.batch_structs(cfg, B, S)
            fn = jax.jit(lambda p, b: ref_lm.prefill(cfg, p, b, capacity=S, act_shard=act),
                         in_shardings=(ns, RSP.named(mesh, RSP.batch_pspecs(mesh, batch))),
                         out_shardings=(None, cspec))
            compiled = fn.lower(params, batch).compile()
        else:
            tok = RSP.decode_token_struct(cfg, B)
            fn = jax.jit(lambda p, t, c, i: ref_lm.decode_step(cfg, p, t, c, i, act_shard=act),
                         in_shardings=(ns, RSP.named(mesh, RSP.batch_pspecs(mesh, tok)), cspec,
                                       None),
                         out_shardings=(None, cspec), donate_argnums=(2,))
            compiled = fn.lower(params, tok, cache,
                                jax.ShapeDtypeStruct((), jnp.int32)).compile()
    return {"argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
            "collective_bytes": analyze_module(compiled.as_text()).collective_bytes}


def _port_sharded(arch: str, kind: str, B: int, S: int) -> dict:
    """The port's sharded cell over a fake mesh of device type ``cpu``: what
    the gloo ranks of ``dryrun_ranks`` issue, and the host the reference
    compiles for."""
    return dryrun.measure_cell(get_smoke_config(arch), ShapeSpec("smoke", kind, S, B),
                               make_test_mesh(SHARDED), device_type="cpu")


@pytest.fixture(scope="module")
def sharded():
    """The 8 ranks' real runs, and the reference's compiled programs and
    the port's meta counts of every ``DRYRUN_REAL`` cell, once for the
    module; the ranks run while this process compiles."""
    got = []
    job = threading.Thread(target=lambda: got.append(_real_runs()), daemon=True)
    job.start()
    want = {f"{a}/{k}": _reference_sharded(a, k, B, S) for a, k, B, S in J.DRYRUN_REAL}
    port = {f"{a}/{k}": _port_sharded(a, k, B, S) for a, k, B, S in J.DRYRUN_REAL}
    job.join(timeout=330)
    assert not job.is_alive() and len(got) == 1, "the ranks' job did not finish"
    if isinstance(got[0], BaseException):
        raise got[0]
    return want, port, got[0][0]


def _real_runs():
    """The ranks' job, its result or the exception it raised."""
    try:
        return ranks.run("torch_rank_jobs:dryrun_ranks", 8, timeout_s=300)
    except Exception as e:  # re-raised by the fixture, in the test's thread
        return e


@pytest.mark.parametrize("cell", REAL_CELLS)
def test_sharded_cell_argument_bytes_match_the_compiled_reference(sharded, cell):
    want, port, _ = sharded
    assert port[cell]["memory"]["argument_bytes"] == want[cell]["argument_bytes"]


@pytest.mark.parametrize("cell", REAL_CELLS)
def test_sharded_cell_collectives_are_what_the_real_run_issues(sharded, cell):
    """Bytes and counts by kind on meta shards over the fake group equal
    rank 0's of the real gloo run, exactly."""
    _, port, real = sharded
    got = port[cell]
    assert got["collective_bytes_per_device"] == real[cell]["bytes"]
    assert got["collective_counts_per_device"] == real[cell]["counts"]


@pytest.mark.parametrize("cell", REAL_CELLS)
def test_sharded_cell_collectives_beside_the_reference_hlo(sharded, cell):
    """The port's collective bytes beside the reference's GSPMD HLO: totals
    within ``HLO_BAND`` once the port's are doubled (the module docstring
    names the differences)."""
    want, port, _ = sharded
    mine = port[cell]["collective_bytes_per_device"]
    theirs = want[cell]["collective_bytes"]
    ratio = sum(theirs.values()) / (2 * sum(mine.values()))
    assert 1 / HLO_BAND <= ratio <= HLO_BAND, f"port {mine} reference {theirs}: {ratio:.3f}"


def test_fsdp_all_gathers_are_each_sharded_parameter_once():
    """On (1, 8, 1) the prefill gathers every parameter whose spec uses
    ``data`` once, at its shard's bytes, but the head, which it contracts
    on its shards and sums by one all-reduce of the logits."""
    cfg = get_smoke_config("yi_6b")
    mesh = make_test_mesh((1, 8, 1))
    B, S = 8, 64
    rec = dryrun.measure_cell(cfg, ShapeSpec("smoke", "prefill", S, B), mesh)
    sizes = mesh.axis_sizes
    total = [0]

    def add(path, t, spec):
        axes = [a for e in spec if e for a in ((e,) if isinstance(e, str) else e)]
        if path != "head/lm_head" and "data" in axes:
            total[0] += CA.shard_bytes(t, spec, sizes)
    map_tree(add, lm.abstract_model(cfg), param_pspecs(cfg, mesh))
    assert total[0] > 0
    assert rec["collective_bytes_per_device"]["all-gather"] == total[0]
    assert rec["collective_bytes_per_device"]["all-reduce"] == B * cfg.padded_vocab * 2
