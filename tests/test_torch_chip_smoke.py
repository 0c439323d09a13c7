"""What ``chip_smoke.py`` prepares on the host for the card, held on the CPU:
the planted faults' sources, and the MoE routing its float32 check records
and forces.

Each planted copy of a kernel's source has the fault's line in place of
the sound one, and of the source's dispatch lines keeps only the instance
that the fault's case runs (the case's head dims, or its state size), so
that the copies build in less time; the check at that case then runs the
faulty instance and no other.  ``moe_routing`` records each MoE layer's
expert choices, or replaces them by another path's, so that the served
prefill's logits can be held to the plain versions' on the same routing.
"""

from pathlib import Path

import pytest

from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    import sys

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _faults():
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = {}
    for node in tree.body:  # the fault tables' names, without importing the script
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id.endswith("_FAULTS") for t in node.targets):
            names[node.targets[0].id] = [k.value for k in node.value.keys]
    return [(table, name) for table, keys in sorted(names.items()) for name in keys]


@pytest.mark.parametrize("table,name", _faults())
def test_a_planted_copy_runs_its_fault_in_its_cases_instance(chip_smoke, table, name):
    kernel = next(k for k, faults in chip_smoke.PLANTED.items()
                  if faults is getattr(chip_smoke, table))
    sound, faulty, label = chip_smoke.PLANTED[kernel][name]
    src = (build.SRC_DIR / f"{kernel}.cu").read_text()
    got = chip_smoke.planted_source(kernel, name)
    assert got.count(faulty) == 1 and sound not in got.replace(faulty, "")
    lines = [m.group(1) for m in chip_smoke._DISPATCH_LINE.finditer(got)]
    keep = chip_smoke._planted_instance(kernel, label)
    if keep is None:  # no dispatch table: the copy is the source with the fault
        assert got == src.replace(sound, faulty)
        return
    assert lines == [keep]
    assert len([m for m in chip_smoke._DISPATCH_LINE.finditer(src)]) > 1
    # only dispatch lines went: the rest of the source is as it was
    strip = chip_smoke._DISPATCH_LINE.sub
    assert strip("", got) == strip("", src.replace(sound, faulty))


def test_the_planted_instances_are_the_cases_dims(chip_smoke):
    """Each kept instance is the one its case's shape dispatches to."""
    inst = chip_smoke._planted_instance
    assert inst("flash_attention", "danube prefill") == "FLASH_CASE(120, 120)"
    assert inst("flash_attention", "deepseek prefill") == "FLASH_CASE(192, 128)"
    assert inst("flash_attention_bwd", "minicpm3 train") == "BWD_CASE(96, 64)"
    assert inst("flash_attention_bwd", "qwen2-vl train") == "BWD_CASE(128, 128)"
    assert inst("mamba_scan_bwd", "h0, gh_fin") == "MAMBA_SCAN_BWD_CASE(16)"
    assert inst("mamba_scan_fused", "ragged") == "FUSED_CASE(4)"
    assert inst("mamba_scan_fused_bwd", "falcon train") == "FUSED_BWD_CASE(4)"
    assert inst("rmsnorm_bwd", (2049, 4096)) is None


def test_moe_routing_records_and_forces_each_layers_choices(chip_smoke):
    """``moe_routing`` (the float32 check's routing on another path's
    choices): recording leaves the forward as it is, forcing the recorded
    choices gives the same logits bit for bit, and forcing other choices
    routes every token as forced (each counted by ``_routing_flips``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config("jamba_1_5_large_398b"), dtype="float32")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=torch.Generator().manual_seed(1))}
    want, _ = lm.prefill(cfg, params, batch)
    seen = []
    with chip_smoke.moe_routing(record=seen):
        got, _ = lm.prefill(cfg, params, batch)
    moe_layers = sum(s.ffn == "moe" for s in cfg.layer_pattern) * cfg.num_periods
    assert torch.equal(got, want) and len(seen) == moe_layers
    with chip_smoke.moe_routing(force=seen):
        got, _ = lm.prefill(cfg, params, batch)
    assert torch.equal(got, want)
    other = [(r + 1) % cfg.moe.num_experts for r in seen]
    routed = []
    with chip_smoke.moe_routing(record=routed, force=other):
        got, _ = lm.prefill(cfg, params, batch)
    assert not torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(routed, other))
    assert chip_smoke._routing_flips(seen, other) == [r[..., 0].numel() for r in seen]
    assert chip_smoke._routing_flips(seen, [r.flip(-1) for r in seen]) == [0] * moe_layers


def test_layers_against_plain_finds_the_layers_of_a_faulty_kernel(chip_smoke, monkeypatch):
    """``_layers_against_plain`` (the check of a model that amplifies
    rounding) on Jamba's smoke config: on the CPU the kernels' dispatch is
    the plain versions, so every layer agrees exactly; an attention kernel
    off by 1% shows in the attention layers alone, at about that much."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config("jamba_1_5_large_398b"), dtype="float32")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=torch.Generator().manual_seed(1))}
    assert chip_smoke._layers_against_plain(cfg, params, batch, 16) == [0.0] * cfg.num_layers
    sound = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **k: sound(*a, **k) * 1.01)
    errs = chip_smoke._layers_against_plain(cfg, params, batch, 16)
    attn = [s.mixer == "attn" for s in cfg.layer_pattern] * cfg.num_periods
    assert all((e > 1e-3) == a for e, a in zip(errs, attn)), errs
    assert max(errs) < 0.02, errs
