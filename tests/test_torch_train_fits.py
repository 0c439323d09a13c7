"""What ``chip_smoke.py``'s phases 8 (c) and 9 count on the host, held on
the CPU: each full-width training run's memory as the dry-run predicts it
against the card's, Qwen2-VL-7B's launches and model FLOPs a step against
counts worked out by hand, and phase 9's band on the dry-run's peak.

The dry-run's cell of a phase 8 (c) run is the one-card step on a (1, 1)
mesh (``chip_smoke.one_rank_cell``), on the meta device: its argument
bytes (parameters, AdamW state, batch) plus its ``peak_bytes`` must lie
under the card's memory, ``torch.cuda.mem_get_info()[1]`` as an NVIDIA
H100 80GB HBM3 at a power limit of 700.00 W reports it.
"""

import importlib
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
try:
    chip_smoke = importlib.import_module("chip_smoke")
finally:
    sys.path.remove(str(ROOT))

#: ``torch.cuda.mem_get_info()[1]`` on an NVIDIA H100 80GB HBM3, 700.00 W
H100_BYTES = 85_031_714_816


@pytest.mark.parametrize("arch,layers,steps,seq", chip_smoke.TRAIN_FULL_WIDTH)
def test_every_full_width_run_fits_the_card(arch, layers, steps, seq):
    mem = chip_smoke.one_rank_cell(arch, layers, seq)["memory"]
    parts = mem["argument_bytes_by_part"]
    assert sum(parts.values()) == mem["argument_bytes"]
    assert mem["argument_bytes"] + mem["peak_bytes"] < H100_BYTES, mem


def test_qwen2_vl_launches_and_model_flops_by_hand():
    """Qwen2-VL-7B at 14 of its 28 layers, 8 x 2048 tokens in 8
    microbatches with remat: every layer launches flash and two RMSNorms
    forward twice (remat) and backward once, the final norm once each way;
    6 FLOPs a token and weight of every product (no embedding table: it
    takes embeds), and causal QK^T and PV over 28 heads of 128."""
    from repro_torch.models import lm

    cfg = chip_smoke._config("qwen2_vl_7b", 14)
    L, M, D, F, V = 14, 8, 3584, 18944, 152064
    assert (cfg.num_layers, cfg.parallel.microbatches, cfg.d_model, cfg.d_ff,
            cfg.vocab_size, cfg.parallel.remat) == (L, M, D, F, V, True)
    assert chip_smoke._launches_per_step(cfg) == {
        "flash_attention": 2 * L * M, "flash_attention_bwd": L * M,
        "rmsnorm": (2 * 2 * L + 1) * M, "rmsnorm_bwd": (2 * L + 1) * M}
    assert chip_smoke._launches_per_step(cfg) == {
        "flash_attention": 224, "flash_attention_bwd": 112, "rmsnorm": 456, "rmsnorm_bwd": 232}
    # wq, wo [D, 28 x 128]; wk, wv [D, 4 x 128]; the gated MLP; the untied head
    products = L * (2 * D * D + 2 * D * 512 + 3 * D * F) + D * V
    norms = 2 * L * D + D
    n_params = products + norms
    assert n_params == 3_807_745_536
    assert n_params == sum(math.prod(t.shape) for t in chip_smoke._leaves(lm.model_meta(cfg)))
    pairs = 2048 * 2049 // 2  # causal, one head
    flops = 6 * products * 8 * 2048 + 6 * pairs * (128 + 128) * 28 * L * 8
    assert chip_smoke._model_flops(cfg, n_params, 8, 2048) == flops
    assert flops == 384_413_095_428_096


def test_train_flash_specs_hold_qwen2_vls_group_of_seven():
    """Phase 8 (a) holds the training flash pair at Qwen2-VL's microbatch,
    28 heads over 4 (the last dK/dV slice of 2 heads holds one), with
    faults planted at that case."""
    specs = [s for s in chip_smoke.TRAIN_FLASH_SPECS if s[2] == 7]
    assert [s[1:] for s in specs] == [(28, 7, 2048, 128, 128, None)]
    faults = [n for n, (_, _, label) in chip_smoke.FLASH_BWD_FAULTS.items()
              if label == specs[0][0]]
    assert len(faults) == 2


def test_train_batch_of_embeds_reaches_the_device_as_float32():
    """``batch_to`` carries Qwen2-VL's embeds as ``make_batch`` makes them
    (float32) and its labels as int64, as both phase 8 (b) paths take them."""
    from repro_torch.training.data import make_batch
    from repro_torch.training.train_step import batch_to

    cfg = chip_smoke._config("qwen2_vl_7b", 2)
    b = make_batch(cfg, 2, 16, seed=0)
    got = batch_to(b, "cpu")
    assert got["embeds"].dtype == torch.float32 and got["labels"].dtype == torch.int64
    assert torch.equal(got["embeds"], torch.from_numpy(b["embeds"]))
    assert torch.equal(got["labels"], torch.from_numpy(b["labels"]).long())


def _row(kind, arguments, peak_bytes, measured):
    return chip_smoke.peak_rows(kind, f"planted {kind}", {
        "arguments": arguments, "peak_bytes": peak_bytes}, {0: measured + 7}, {0: 7})


BANDED = list(chip_smoke.PEAK_BAND)


@pytest.mark.parametrize("kind", BANDED)
def test_peak_check_passes_inside_the_band_and_fails_outside(kind):
    lo, hi = chip_smoke.PEAK_BAND[kind]
    measured = 10**10
    inside = _row(kind, measured // 2, measured // 2, measured)  # ratio 1
    assert chip_smoke.peak_check(inside, "cpu")["planted_halved_outside"] == 1
    for ratio in (lo * 0.99, hi * 1.01):  # predicted too low, too high
        total = int(ratio * measured)
        with pytest.raises(AssertionError, match="outside its band"):
            chip_smoke.peak_check(_row(kind, total // 2, total - total // 2, measured), "cpu")


@pytest.mark.parametrize("kind", BANDED)
def test_peak_check_fails_where_a_halved_peak_would_pass(kind):
    """The band's planted fault: a record whose ``peak_bytes`` halved stays
    inside the band (a peak too small to matter) fails the check."""
    measured = 10**10
    with pytest.raises(AssertionError, match="halved passed"):
        chip_smoke.peak_check(_row(kind, measured - 1000, 1000, measured), "cpu")


def test_peak_rows_hold_each_rank_to_rank_0s_prediction():
    """Each rank's own peak: its ``max_memory_allocated`` less what it held
    beside the cell's arguments when the peak was reset."""
    rows = chip_smoke.peak_rows("train", "cell", {"arguments": 3, "peak_bytes": 5},
                                {0: 8, 1: 14}, {0: 0, 1: 4})
    assert [(r["rank"], r["predicted"], r["measured"], r["ratio"]) for r in rows] == [
        (0, 8, 8, 1.0), (1, 8, 10, 0.8)]


def test_peak_bytes_counts_a_waited_collective_as_its_input():
    """``wait_tensor`` returns its input on a device, where its meta kernel
    allocates: the meter counts the waited output as its input's storage,
    live until both are gone, and not at all where its input is not
    counted."""
    from repro_torch.launch.costanalysis import PeakBytes

    x = torch.empty(1000, device="meta")
    with PeakBytes() as pk:
        y = x * 2  # 4000 bytes
        z = torch.ops._c10d_functional.wait_tensor(y)
        del y
        w = z + 1  # 4000 bytes more, z still holding y's storage
        assert pk.live == 8000
        del z
        assert pk.live == 4000
        v = torch.ops._c10d_functional.wait_tensor(x)  # x made before: not counted
        assert pk.live == 4000 and (v + 1).shape == v.shape and pk.peak == 8000
    assert pk.peak == 8000 and w.shape == v.shape
