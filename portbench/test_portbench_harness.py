"""CPU tests of the benchmark's harness: every part found by name, the
seeded traffic, the end-to-end arithmetic, the frozen yardstick against
``chip_smoke.py``'s, the import guard and ``run.py`` without a card."""

from __future__ import annotations

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import bounds, harness, readers, traffic
from portbench import trace as tr
from portbench.drivers import serve_waves

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(autouse=True)
def _src_on_path(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "src"))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_parts_by_name(cell):
    c = harness.cell(cell)
    cf = harness.config_file(c["config"])
    tf = harness.traffic_file(c["traffic"])
    assert (BENCH / "drivers" / f"{tf['driver']}.py").is_file()
    assert hasattr(harness.driver(tf["driver"]), "run")
    checks = harness.checks_file(cell)
    assert checks and all("limit" in v for v in checks.values())
    cfg = harness.port_config(cf)  # the file's keys against what the port runs
    assert cfg.num_layers == cf["num_hidden_layers"]
    entry = next(x for x in SPEC["configs"] if x["name"] == c["config"])
    assert entry["file"] == f"portbench/configs/{c['config']}.json"
    assert entry["reduced"] == cf["reduced"] and entry["source"] == cf["source"]
    assert harness.e2e_metrics(cell) and harness.layer_metrics(cell)
    assert "setup_s" in {m["name"] for m in harness.e2e_metrics(cell)}


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_each_configuration_runs_what_its_file_states(config, monkeypatch):
    cf = harness.config_file(config)
    fam = harness.family(cf)
    assert callable(fam.Model) and fam.WIDTHS and fam.SET
    cfg = harness.port_config(cf)
    for key, field in fam.SET.items():  # taken from the file, not the port's default
        assert getattr(cfg, field) == cf[key]
    assert getattr(harness.port_config(cf, smoke=True), field) == cf[key]
    key = sorted(fam.WIDTHS)[0]
    with pytest.raises(ValueError, match=key):
        harness.port_config(dict(cf, **{key: cf[key] + 1}))


def test_the_mamba_reference_refuses_the_mixer_norms_it_lacks():
    from portbench.reference import mamba

    cf = harness.config_file("mamba1-falcon-widths")
    mamba.Model(cf, {})
    with pytest.raises(ValueError, match="norms"):
        mamba.Model(dict(cf, mixer_rms_eps=1e-6), {})


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_metric_has_a_reader_that_declares_it(metric):
    spec = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    mod = harness.reader(metric)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (spec["layer"], spec["unit"], spec["moves"])
    assert mod.read({}) is None  # nothing to read: nothing returned
    for cell in spec["workloads"]:
        assert spec["moves"] in {m["name"] for m in harness.e2e_metrics(cell)}


def test_traffic_is_the_same_work_for_every_seed_and_deterministic():
    tf = harness.traffic_file("chat")
    a = next(traffic.waves(tf, 64000, 2**31 + 11))
    b = next(traffic.waves(tf, 64000, 2**31 + 11))
    c = next(traffic.waves(tf, 64000, 5))
    assert [len(p) for p in a.prompts] == [len(p) for p in b.prompts]
    assert all(np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))
    assert a.new_tokens == b.new_tokens
    assert sorted(len(p) for p in a.prompts) == sorted(len(p) for p in c.prompts)
    assert sorted(a.new_tokens) == sorted(c.new_tokens)
    assert [len(p) for p in a.prompts] != [len(p) for p in c.prompts]
    lo, hi = tf["prompt_tokens"]
    assert lo <= min(len(p) for p in a.prompts) and max(len(p) for p in a.prompts) <= hi
    assert min(int(p.min()) for p in a.prompts) >= 1  # 0 is the engine's pad
    import torch

    pt = dict(harness.traffic_file("pretrain"), **harness.traffic_file("pretrain")["smoke"])
    x = traffic.token_batches(pt, 1000, -3, torch.device("cpu"))
    y = traffic.token_batches(pt, 1000, -3, torch.device("cpu"))
    assert all(torch.equal(u["tokens"], v["tokens"]) for u, v in zip(x, y))
    assert torch.equal(x[0]["tokens"][:, 1:], x[0]["labels"][:, :-1])


def _wave(start, step_s, n_req=4, steps=5, stall_at=None, stall_s=0.0):
    t = start + 0.5  # prefill
    times = [[t] for _ in range(n_req)]
    for s in range(steps):
        t += step_s + (stall_s if s == stall_at else 0.0)
        for r in times:
            r.append(t)
    return {"start": start, "times": times}, t


def test_e2e_metrics_take_every_sample_and_a_stall_moves_them():
    w1, end = _wave(0.0, 0.01)
    w2, end2 = _wave(end, 0.01)
    base = serve_waves.e2e([w1, w2], end2)
    assert base["gen_tokens_per_s"] == pytest.approx(2 * 4 * 6 / end2)
    assert base["itl_p95_ms"] == pytest.approx(10.0)
    assert base["ttft_p95_ms"] == pytest.approx(500.0)
    s1, end = _wave(0.0, 0.01, stall_at=2, stall_s=0.2)
    s2, end2s = _wave(end, 0.01, stall_at=2, stall_s=0.2)
    stalled = serve_waves.e2e([s1, s2], end2s)
    assert stalled["gen_tokens_per_s"] < base["gen_tokens_per_s"]
    # 2 of the 10 gaps of a request stall: a 95th percentile over all samples sees them
    assert stalled["itl_p95_ms"] > 100.0


def test_frozen_yardstick_equals_chip_smoke_at_the_cells_shapes():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    assert (bounds.PEAK_BF16_TC_FLOPS, bounds.PEAK_BYTES_PER_S, bounds.PEAK_FP32_FLOPS) == \
        (cs.PEAK_BF16_TC_FLOPS, cs.PEAK_BYTES_PER_S, cs.PEAK_FP32_FLOPS)
    for S in (1018, 4002, 300, 1):
        assert bounds.attn_pairs(S, S) == cs._attn_pairs(S, S, True, None)
    assert bounds.attn_pairs(600, 600, True, 128) == cs._attn_pairs(600, 600, True, 128)
    for BH, S in ((8 * 32, 4002), (64 * 32, 1018)):
        assert bounds.flash_bounds(BH, 8, S, S, 128) == cs.flash_bounds(BH, 8, S, S, 128,
                                                                       True, None)
    from repro_torch.configs import first_layers, get_config
    from repro_torch.models import lm
    from portbench import weights

    for arch, layers, name in (("falcon_mamba_7b", 32, "mamba1-falcon-widths"),
                               ("yi_6b", 32, "yi-6b")):
        cfg = first_layers(get_config(arch), layers)
        shapes = weights.leaf_shapes(lm.model_meta(cfg))
        rec = {"config": harness.config_file(name), "shapes": shapes}
        # the parameters the tree holds: ``param_count()`` counts a second norm a
        # layer that Falcon-Mamba's layers lack (32 x 4096 weights, 0.004%)
        want = cs._model_flops(cfg, sum(math.prod(s) for s in shapes.values()), 8, 2048)
        assert readers.train_flops(rec, 8, 2048) == pytest.approx(want, rel=1e-12)


def test_kernel_classifier_and_slice_arithmetic():
    assert tr.kind("flash_fwd_kernel<128>") == "port"
    assert tr.kind("void mamba_scan_fused_bwd_kernel<bf16>") == "port"
    assert tr.kind("sm90_xmma_gemm_bf16bf16_bf16f32") == "cublas"
    assert tr.kind("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NTT") == "cublas"
    assert tr.kind("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert tr.kind("void at::native::vectorized_elementwise_kernel<4>") == "other"
    assert tr.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    sl = tr.Slice(records=[("k1", 1.0, 2.0), ("k2", 2.5, 3.0), ("k3", 6.0, 7.0)],
                  spans=[("step", 0.5, 3.2), ("admit", 5.5, 7.5)],
                  host_ops=[("aten::item", 3.1, 5.9)], start_us=0.0, end_us=8.0)
    assert [r[0] for r in sl.within("step")] == ["k1", "k2"]
    assert [r[0] for r in sl.within("admit")] == ["k3"]
    assert sl.busy_us() == 2.5
    idle = dict(sl.idle_by_host())
    assert idle["aten::item"] == pytest.approx(3.0 / 1e6)


def test_decode_bound_counts_weights_once_and_the_cache_to_the_position():
    cf = harness.config_file("yi-6b")
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from portbench import weights

    shapes = weights.leaf_shapes(lm.model_meta(get_config("yi_6b")))
    rec = {"config": cf, "shapes": shapes}
    every = sum(math.prod(s) for s in shapes.values())
    table = math.prod(shapes["embed/embedding"])
    b0 = readers.decode_bound_s(rec, 64, 0)
    b1 = readers.decode_bound_s(rec, 64, 1000)
    kv = 32 * 64 * 4 * 128 * 2 * 2  # layers x rows x kv heads x hd x (k, v) x bf16
    assert b0 == pytest.approx((2 * (every - table) + 64 * 4096 * 2 + 2 * kv)
                               / bounds.PEAK_BYTES_PER_S)
    assert b1 - b0 == pytest.approx(1000 * kv / bounds.PEAK_BYTES_PER_S)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package_and_the_reference_not_the_program():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        found = _imports(f) & {"jax", "jaxlib", "flax", "repro"}
        assert not found, f"{f.relative_to(ROOT)} imports {found}"
    for f in sorted((BENCH / "reference").rglob("*.py")):
        found = _imports(f) - {"torch", "math", "__future__", "portbench"}
        assert not found, f"{f.relative_to(ROOT)} imports {found}"
        assert "repro_torch" not in f.read_text()


def test_run_without_a_card_fails_with_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the failure path needs one without")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "yi-6b.chat",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
