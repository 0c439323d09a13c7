"""The port's dry-run (``repro_torch.launch.dryrun`` over
``launch/costanalysis.py``) against the reference's compiled step.

At smoke size on ``make_test_mesh((2, 4, 1))`` (2 pods x 4 data x 1
model, the 8 CPU devices), the reference compiles its shard_map train step
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
"""

import dataclasses
import json

import jax
import pytest

from repro.configs import get_smoke_config as ref_smoke
from repro.launch import specs as RSP
from repro.launch.hloanalysis import analyze_module
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.models import lm as ref_lm
from repro.training.optimizer import OptConfig as RefOptConfig
from repro.training.optimizer import init_opt_state as ref_init_opt_state
from repro.training.train_step import make_train_step_shardmap
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

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
                              make_test_mesh(MESH), backend=backend)
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
    recs = {b: dryrun.measure_cell(cfg, shape, make_test_mesh(MESH), backend=b)
            for b in ("xla", "fulllane")}
    flat, full = (recs[b]["dp_sync_sent_per_device"]["cross_pod_bytes"]
                  for b in ("xla", "fulllane"))
    assert 0 < full * MESH[1] <= flat


def test_cli_writes_a_record_per_cell(tmp_path):
    """Every shape of one config on both production meshes: each cell
    ``ok`` or ``skipped`` by ``cell_eligible``, with the reference's keys."""
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
        assert rec["collective_bytes_gspmd"] is None and rec["collective_bytes_gspmd_reason"]
        assert rec["num_devices"] == (512 if rec["mesh"] == "multi" else 256)
    multi = recs["yi_6b__train_4k__multi__fulllane"]
    assert set(multi["collective_bytes_per_device"]) == {"reduce-scatter", "all-reduce",
                                                         "all-gather"}
    assert multi["dp_sync_sent_per_device"]["cross_pod_bytes"] > 0


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
