#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a GPU

Phases, each reported on its own lines:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: every CUDA kernel of ``src/repro_torch/kernels/csrc`` compiled
   with ``nvcc`` (one process per source, all at once);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the serving paths of the seven served models give it plus ragged,
   windowed (a window edge inside a KV tile), small-head, long-prompt,
   initial-state and small-state cases: error, kernel time, plain time, the
   time of one PyTorch library call computing the same function where there
   is one (each with its inputs cold in device memory and warm in L2), and
   the card's least time (bound); faults planted in copies of the flash
   kernel's source (hd 120's zero-filled pad vector read from the next row,
   hd 256's second half of the output columns left unwritten) must each
   fail that check, and so must a fault planted in the MLA pair (q/k head
   dim 96, v head dim 64: v's last 16-column block left unwritten) and one
   in DeepSeek-V2's MLA pair (q/k 192, v 128: the last 64 q/k columns, the
   rotary part, left out of the scores);
4. full-width Yi-6B (random weights from a seed) served through
   ``ServeEngine``: 4 requests of 512 prompt tokens, 32 new tokens each,
   greedy, each decode step a replay of the engine's captured CUDA graph.
   The kernels' launch counts over that run (each replay adds the launches
   captured in it) must show that every RMSNorm and every prefill attention
   went through them, and the prefill logits must be no further from a
   float32 recomputation than the same bf16 model's logits through the
   plain versions are, and within the bf16 tolerance (rms) of the latter.
   The same requests decoded by an eager engine (the step op by op from
   Python) must give the same tokens, with the logits' difference printed
   (0 expected: the same kernels on the same inputs); the two engines are
   driven step by step in turns, so their step times compare, and each
   engine's launches are counted over its own calls only.  A third engine,
   with ``plan_mesh=(2, 8, 2)`` (2 nodes x 8 GPUs, 2 IB rails) and
   ``plan_cost=NVLINK_IB.cost``, pins its decode-collective plans when it
   is built and serves the same requests as a graph; a lane fault on node
   0 injected after decode step 8 must replan them once, inside the
   planner's deadline, and its tokens and launches must equal the engine's
   without a planner.  The pinned and replanned algorithms (with the cost
   model's estimates, not measurements), the host ms of the pinning (cold
   caches) and of the replan, and a planner pinned at the paper's mesh (36
   x 32, k = 2, Hydra's cost) are printed;
5. full-width Falcon-Mamba-7B, H2O-Danube3-4B, Gemma-7B, MusicGen-Large and
   MiniCPM3-4B, each after the last one's weights are freed, served and
   checked the same way: every RMSNorm and every prefill selective scan or
   attention must go through the kernels.  Danube serves prompts of 4608
   tokens into a 4096-slot sliding-window ring (capacity 5120), so the
   window binds, and its graph engine's logits at decode step 8 must match
   a prefill through the kernels over each row's prompt and first 8
   tokens; MusicGen serves prompts of 512 x 4 codebooks; MiniCPM3 runs MLA
   (the expanded prefill through flash at q/k head dim 96 and v head dim
   64, the absorbed decode over the latent cache).  Then the MoE models at
   full width and 8 layers (their weights at full depth would not fit one
   card): DBRX-132B (16 experts, top-4, every layer MoE; flash at head dim
   128, GQA group 6) and DeepSeek-V2-236B (the dense prelude layer and 7
   MoE layers of 160 routed experts, top-6, and 2 shared; MLA through
   flash at q/k 192 and v 128).  The float32 reference prefill casts each
   weight where it reads it (``float32_reads``), so its float32 copy never
   holds more than one layer's weights.  Last, full-width
   Qwen2-VL-7B, which takes embeddings and M-RoPE positions and which no
   engine drives (the reference's refuses it): seeded embeds [4, 512, 3584]
   with positions whose t is the index and whose h and w walk a 16 x 16
   image grid, through ``lm.prefill``, then 31 decode steps on seeded
   embeds, each a replay of ``DecodeGraph`` with the eager step in turns
   beside it (equal logits), its launches counted, decode step 8 held to a
   prefill over the same 520 embeds and positions, and its prefill logits
   held to float32 as the served models' are;
6. the full-lane alltoall's block regroup, ``a2a_pack``, against its plain
   version on the card, bit for bit (a copy), at the EP-dispatch shapes of
   DeepSeek-V2's width and the reference tests' shapes, timed as in phase
   3; faults planted in copies of its source (built in phase 2) must each
   fail that check;
7. the paper's collectives on the card: 8 ranks (2 pods x 4 lanes), each a
   process on this one card, over gloo (NCCL refuses two ranks on one
   device), every exchange staged through pinned host memory.  Each rank
   routes the EP dispatch of 1024 tokens x top-6 at d_model 5120 (bf16)
   with the flat and the full-lane alltoall, which must equal each other
   and a numpy oracle bit for bit, with 2 ``a2a_pack`` launches per
   full-lane call; sums a 25 MiB float32 gradient bucket (and one element
   more: the pad path) hierarchically, against the flat sum; and
   broadcasts (full-lane; k-ported, k = 1, 2, 3) and scatters (k-ported,
   k = 2) a 25 MiB payload, exactly.  Its times are host-clock times of
   host-staged gloo, not interconnect numbers.  The same job then runs
   in this process as one NCCL rank (a world of one: no peer, but the
   transport's NCCL branch, which must stage nothing);
8. training.  (a) The training forward's lse and the flash backward
   kernel against their plain versions at Yi's training shape (q [32,
   2048, 128], kv [4, 2048, 128], g = 8, causal), a ragged S = 300, a
   window of 100 and the smoke head dim 16, and at every other head-dim
   pair: one microbatch of Gemma (q, k, v [16, 2048, 256]), Danube (q [32,
   4608, 120], kv [8, 4608, 120], window 4096, past the window), MusicGen
   ([32, 2048, 64]), MiniCPM3 (q/k [40, 2048, 96], v [.., 64]) and
   DeepSeek-V2 (q/k [128, 2048, 192], v [.., 128]), the smoke pair (24,
   16), a ragged S = 300 at 256 and at (96, 64), and a window edge inside
   a tile at 120 (dq, dk, dv at 2e-2 in ``ref.scaled_err``, dq's first row
   in ``ref.dq_scaled_err``; lse and delta at 1e-5; a second call of the
   backward to the same bits), faults planted in copies of the backward's
   source (delta dropped, dK/dV summed over one head of the group, the
   diagonal tile unmasked, the last head slice's dK/dV partial left out of
   their sum; the MLA pair's dV partial written at the q/k width and its
   delta read at it, hd 256's second column half of dK dropped, hd 120's
   pad columns left unzeroed) must each fail that check;
   the RMSNorm backward (one launch: dw summed in it after a grid-wide
   barrier) at x [2048, 4096], a ragged T = 2049, the smoke width 64 and
   every other config's widths at T = 2048 (3840, 3072, 2048, 2560, 768,
   256, 3584), with a second call to the same bits and faults planted in
   copies of its source (the last partial row left out of the dw sum, the
   last row's prefetch dropped, a narrow row's shuffle reaching the next
   row's lanes, the last row team left out of the CTA's dw row), which
   must each fail that check; the selective scan's backward at
   Falcon-Mamba's training microbatch (a/b [1, 2048, 8192, 16]), a ragged
   S = 300, with h0 and a nonzero final-state cotangent, and at N = 8
   (ga, gb, gc, gh0 at 1e-5; whether ga, gb and gh0 match bit for bit is
   printed; a second call to the same bits), with faults planted in
   copies of its source (a_t used in place of a_{t+1}, the gh_fin seed
   dropped, the carry lost at a chunk edge, one CTA's gc partial left out
   of the sum), which must each fail that check; each timed as in phase
   3, beside its plain version and SDPA's (or ``F.rms_norm``'s) backward
   through autograd (the forward and backward less the forward; SDPA
   takes Danube's window as a mask; no PyTorch call computes a scan's
   gradient).  (b) One train step at full width and
   2 layers of Yi-6B, H2O-Danube3-4B (sequences of 4608, so the window
   masks), Gemma-7B, MusicGen-Large, MiniCPM3-4B and Falcon-Mamba-7B, each
   through the kernels and through their plain versions, from the same
   parameters and batch (8 microbatches of 1 sequence): loss,
   ``grad_norm``, every gradient and every updated parameter must agree.
   (c) ``launch/train.py``'s loop at full width on Yi-6B at 16 of its 32
   layers for 6 steps, Gemma-7B at 10 of its 28, MiniCPM3-4B at all 62,
   H2O-Danube3-4B at all 24 (sequences of 4608, past its window),
   MusicGen-Large at all 48 and Falcon-Mamba-7B at 32 of its 64 for 4 (the
   depth whose AdamW state fits the card), batch 8 x 2048 in 8 microbatches
   with remat, one repeated batch, learning rate 3e-4 after 1 warmup step:
   the loss must fall, and each step must launch the kernels as the code
   implies (flash forward 2LM, backward LM, or for Mamba layers the scan
   forward 2LM and backward LM; RMSNorm forward (2nL+1)M, backward
   (nL+1)M, n the norms of a layer: 2, 1 for Falcon-Mamba's, 4 with MLA's);
   step time, tokens/s, model FLOPs per second over the card's peak and
   peak memory are printed.  (d) At the
   smoke config's size: a run stopped at its checkpoint and resumed takes
   its next step to the loss, parameters and optimizer state of a run that
   never stopped, bit for bit.

The last three lines are the ``nvidia-smi`` line, one JSON object with the
kernels' numbers, and ``{"ok": true, "device": {...}}``; the full record
(every case, the serving numbers, the compiler's register report) goes to
``build/chip_smoke/``.  Any failed check
raises, and the script exits non-zero; without CUDA, or outside a checkout
of the repository, it exits non-zero before printing any result.  The
``[done]`` line gives each phase's seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"  # the run's full record, beside the built kernels

#: bf16 tolerance on ``ref.scaled_err(kernel, plain)``: every element must
#: satisfy |kernel - plain| <= TOL_BF16 * (|plain| + rms of its row), where the
#: plain version computes in fp32 on the same bf16 inputs (bf16 keeps 8 bits)
TOL_BF16 = 2e-2
#: the same for the fp32 selective scan and its backward, whose kernels and
#: plain versions differ only in the order of a sum (the readout's over the
#: state, gc's over the channels)
TOL_F32 = 1e-5
#: the served logits may stray from a float32 recomputation of the same
#: prefill by at most this many times as far (rms over all logits) as the
#: bf16 model's logits through the plain versions do: the kernels may add
#: rounding, not error
LOGIT_NOISE_RATIO = 1.5
#: published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
L2_BYTES = 50 * 2**20  # H100 SXM L2 cache
#: cold timings rotate through copies of the inputs spanning this many L2s
COLD_SPAN = 4
MAX_COPIES = 256


#: faults planted in copies of ``csrc/a2a_pack.cu`` (name: sound line,
#: faulty line, shape it is checked at): each must fail phase 6's equality
#: check.  ``tests/test_torch_kernels.py`` plants the same ones.
PACK_FAULTS = {
    "tile_written_to_o_i": (
        "uint8_t* dst = out + (i * No + o) * tile_bytes;",
        "uint8_t* dst = out + t * tile_bytes;", (2, 4, 768, 5120)),
    "tail_bytes_dropped": (
        "b < tile_bytes; b += (long long)gridDim.x * kThreads)",
        "b < nvec * 16; b += (long long)gridDim.x * kThreads)", (2, 3, 5, 7)),
    "chunk_stride_off_by_one_vector": (
        "const long long chunk0 = (long long)blockIdx.x * kChunk;",
        "const long long chunk0 = (long long)blockIdx.x * (kChunk + 1);", (2, 4, 768, 5120)),
}
#: faults planted in copies of ``csrc/flash_attention.cu`` (name: sound
#: line, faulty line, label of the phase-3 case it is checked at): each must
#: fail that case's check.  ``tests/test_torch_kernels.py`` plants the same.
FLASH_FAULTS = {
    "hd120_pad_vector_from_the_next_row": (
        "const int bytes = gr < n && c < HD ? 16 : 0;  // zeros past the end and in the pad",
        "const int bytes = gr < n ? 16 : 0;", "danube prefill"),
    "hd256_second_half_of_the_columns_unwritten": (
        "for (int nb = 0; nb < HDV / 8; ++nb)",
        "for (int nb = 0; nb < (HDV == 256 ? HDV / 16 : HDV / 8); ++nb)", "gemma prefill"),
    "mla_last_v_column_block_unwritten": (
        "for (int nb = 0; nb < HDV / 8; ++nb)",
        "for (int nb = 0; nb < (HDQK != HDV ? HDV / 8 - 2 : HDV / 8); ++nb)",
        "minicpm3 prefill"),
    "mla192_rope_columns_left_out_of_the_score": (
        "for (int kk = 0; kk < KQ; ++kk) {",
        "for (int kk = 0; kk < (HDQK == 192 ? KQ - 4 : KQ); ++kk) {", "deepseek prefill"),
}
#: faults planted in copies of ``csrc/flash_attention_bwd.cu`` (name: sound
#: line, faulty line, label of the phase-8 case it is checked at): each must
#: fail that case's check.  ``tests/test_torch_kernels.py`` plants the same.
FLASH_BWD_FAULTS = {
    "delta_dropped": (
        "if (row < rows && lane % LPR == 0) delta[row] = s;  // rowsum(dO * O)",
        "if (row < rows && lane % LPR == 0) delta[row] = 0.f;", "yi train"),
    "dkdv_over_one_head_of_the_group": (
        "const int bh = bkv * group + h0 + it / nqt;",
        "const int bh = bkv * group + it / nqt;", "yi train"),
    "diagonal_tile_unmasked": (
        "const bool edge = q0 + BN > S || (causal && q0 < k0 + BM) ||",
        "const bool edge = q0 + BN > S ||", "yi train"),
    "last_partial_dropped": (
        "for (int j = 1; j < slices; ++j) {  // the partials in slice order",
        "for (int j = 1; j < slices - 1; ++j) {", "yi train"),
    "mla_dv_plane_at_hdqk_width": (
        "float* const rv = pv + (size_t)kp * HDV + c0v + 2 * t;",
        "float* const rv = pv + (size_t)kp * HDQK + c0v + 2 * t;", "minicpm3 train"),
    "hd256_second_dk_half_dropped": (
        "make_float2(dka[4 * nb + 2 * i], dka[4 * nb + 2 * i + 1]);  // dK",
        "c0q ? make_float2(0.f, 0.f) : make_float2(dka[4 * nb + 2 * i], dka[4 * nb + 2 * i + 1]);",
        "gemma train"),
    "hd120_pad_columns_unzeroed": (
        "const int bytes = gr < n && c * 8 < HD ? 16 : 0;  // zeros past the end and in the pad",
        "const int bytes = gr < n ? 16 : 0;", "danube train"),
    "mla_delta_read_at_hdqk": (
        "constexpr int VPR = HDV / 8;  // 16-byte vectors of a row of o or dO",
        "constexpr int VPR = HDQK / 8;", "minicpm3 train"),
}
#: faults planted in copies of ``csrc/rmsnorm_bwd.cu`` (name: sound line,
#: faulty line, phase-8 shape it is checked at): each must fail that shape's
#: check.  ``tests/test_torch_kernels.py`` plants the same.
RMSNORM_BWD_FAULTS = {
    "last_partial_row_left_out": (
        "const int r1 = min(r0 + chunk, rows);  // this thread's share of the partial rows",
        "const int r1 = min(r0 + chunk, rows - 1);", (2049, 4096)),
    "last_row_not_prefetched": (
        "if (next < T_rows) copy_row((it + kDepth) % S, (int)next);  // in flight while this row reduces",
        "if (next < T_rows - 1) copy_row((it + kDepth) % S, (int)next);", (2049, 4096)),
    "segment_shuffle_reaches_the_next_row": (
        "for (int off = L >> 1; off > 0; off >>= 1) {  // inside the row's segment",
        "for (int off = L; off > 0; off >>= 1) {", (2048, 64)),
    "last_team_left_out_of_the_cta_row": (
        "for (int u = 0; u < units; ++u) s += smem[(size_t)u * d + c];  // in unit order",
        "for (int u = 0; u < units - 1; ++u) s += smem[(size_t)u * d + c];", (2049, 4096)),
}
#: faults planted in copies of ``csrc/mamba_scan_bwd.cu`` (name: sound line,
#: faulty line, label of the phase-8 case it is checked at): each must fail
#: that case's check.  ``tests/test_torch_kernels.py`` plants the same.
MAMBA_BWD_FAULTS = {
    "a_t_in_place_of_a_next": (
        "g = __fadd_rn(__fmul_rn(gv[u], cv[u]), __fmul_rn(a_next, g));",
        "g = __fadd_rn(__fmul_rn(gv[u], cv[u]), __fmul_rn(av[u], g));", "falcon train"),
    "gh_fin_seed_dropped": (
        "float g = gh_fin != nullptr ? gh_fin[(int64_t)bi * plane + dn] : 0.f;",
        "float g = 0.f;", "h0, gh_fin"),
    "carry_lost_at_a_chunk_edge": (
        "for (int k = nc - 1; k >= 0; --k) {  // chunks, last to first",
        "for (int k = nc - 1; k >= 0; --k) { if (k < nc - 1) g = 0.f;", "falcon train"),
    "last_cta_partial_left_out_of_gc": (
        "for (int j = 0; j < ctas; ++j) s += p[j * SN];  // the partials in CTA order",
        "for (int j = 0; j < ctas - 1; ++j) s += p[j * SN];", "falcon train"),
}
#: every planted fault, by the kernel whose source it is planted in
PLANTED = {"a2a_pack": PACK_FAULTS, "flash_attention": FLASH_FAULTS,
           "flash_attention_bwd": FLASH_BWD_FAULTS, "rmsnorm_bwd": RMSNORM_BWD_FAULTS,
           "mamba_scan_bwd": MAMBA_BWD_FAULTS}
#: phase 8's attention cases: (label, BH, g, S, hd, hd_v, window): one
#: sequence of a model's heads (a microbatch of its train step: 2048 tokens,
#: Danube's 4608 past its window of 4096), ragged S, window edges inside a
#: 64-row tile, the smoke configs' head dims
TRAIN_FLASH_SPECS = [
    ("yi train", 32, 8, 2048, 128, 128, None),
    ("ragged", 32, 8, 300, 128, 128, None),
    ("window 100", 32, 8, 512, 128, 128, 100),
    ("hd 16 (smoke)", 16, 4, 128, 16, 16, None),
    ("gemma train", 16, 1, 2048, 256, 256, None),
    ("danube train", 32, 4, 4608, 120, 120, 4096),
    ("musicgen train", 32, 1, 2048, 64, 64, None),
    ("minicpm3 train", 40, 1, 2048, 96, 64, None),
    ("deepseek train", 128, 1, 2048, 192, 128, None),
    ("hd 24/16 (minicpm3 smoke)", 16, 1, 128, 24, 16, None),
    ("ragged hd 256", 16, 1, 300, 256, 256, None),
    ("ragged minicpm3", 40, 1, 300, 96, 64, None),
    ("window 100, hd 120", 32, 4, 512, 120, 120, 100),
]
#: phase 8's RMSNorm backward shapes: Yi's microbatch, ragged, the smoke width,
#: then every other config's widths at a microbatch of 2048 tokens (Danube,
#: Gemma, MusicGen, MiniCPM3's hidden, q_norm and kv_norm, Qwen2-VL)
TRAIN_RMSNORM_SPECS = [(2048, 4096), (2049, 4096), (2048, 64), (2048, 3840), (2048, 3072),
                       (2048, 2048), (2048, 2560), (2048, 768), (2048, 256), (2048, 3584)]
#: phase 8's selective-scan backward cases: (label, B, S, di, N, with h0 and
#: gh_fin): Falcon-Mamba's training microbatch, a ragged S (no multiple of
#: the kernel's 8-step chunk), an initial state and a nonzero final-state
#: cotangent, the smoke config's state size
TRAIN_SCAN_SPECS = [("falcon train", 1, 2048, 8192, 16, False),
                    ("ragged", 1, 300, 8192, 16, False),
                    ("h0, gh_fin", 1, 2048, 8192, 16, True), ("N 8", 1, 2048, 8192, 8, False)]
#: phase 8's batch: 8 sequences, one a microbatch (the configs' 8), of 2048
#: tokens (Danube's 4608, past its window of 4096)
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
#: phase 8 (b): (arch, sequence length), each at full width and 2 layers
TRAIN_AGAINST_PLAIN = [("yi_6b", TRAIN_SEQ), ("h2o_danube_3_4b", 4608),
                       ("gemma_7b", TRAIN_SEQ), ("musicgen_large", TRAIN_SEQ),
                       ("minicpm3_4b", TRAIN_SEQ), ("falcon_mamba_7b", TRAIN_SEQ)]
#: phase 8 (c): (arch, layers, steps, sequence length) at full width, the
#: config's own microbatches and remat, at the depth whose AdamW state (~16
#: B a parameter) fits one card: Yi-6B at 16 of its 32 layers (3.29 B
#: parameters, ~54 GB), Gemma-7B at 10 of its 28 (its tied embedding and 10
#: layers are 3.55 B, ~58 GB, with ~5 GB of logits a microbatch at a
#: vocabulary of 256,000), MiniCPM3-4B at all 62 (4.26 B, ~69 GB),
#: H2O-Danube3-4B at all 24 (3.96 B, ~64 GB) on sequences of 4608, past its
#: window, MusicGen-Large at all 48 (2.45 B, ~40 GB) and Falcon-Mamba-7B at
#: 32 of its 64 (3.90 B, ~62 GB, and a layer's backward holds a, b, ga, gb
#: and their products' gradients, 1.07 GB each)
TRAIN_FULL_WIDTH = [("yi_6b", 16, 6, TRAIN_SEQ), ("gemma_7b", 10, 4, TRAIN_SEQ),
                    ("minicpm3_4b", 62, 4, TRAIN_SEQ), ("h2o_danube_3_4b", 24, 4, 4608),
                    ("musicgen_large", 48, 4, TRAIN_SEQ), ("falcon_mamba_7b", 32, 4, TRAIN_SEQ)]
#: the loss averages 16,384 per-token terms: the kernels' bf16 rounding,
#: which differs from the plain versions' float32 element by element,
#: averages out in it
LOSS_TOL = 1e-3
#: phase 7's mesh and sizes: DeepSeek-V2's width, 1024 tokens x top-6 per
#: rank (768 rows per destination); PyTorch DDP's default 25 MiB bucket
COLLECTIVES = {"pods": 2, "lanes": 4, "tokens": 1024, "top_k": 6, "d_model": 5120,
               "bucket": 25 * 2**20 // 4}
HOST_STAGED = "gloo, host-staged, 8 ranks on one card: not an interconnect number"


def _graph_ms(calls) -> float:
    """Device time per call in ms of ``calls``, captured in one CUDA graph
    after a warm-up and replayed between two CUDA events.  The graph keeps
    the host's launch cost out, which a loop of calls from Python would
    measure instead for kernels this short."""
    import torch

    for call in calls[:3]:
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for call in calls:
            call()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(calls)


def _ms(fn, args, iters: int) -> dict:
    """Device ms of one call ``fn(*args)``, L2 warm and cold.  Warm: every
    call reads the same inputs, which stay in the L2 when they fit.  Cold:
    the calls rotate through copies of the inputs that together span
    ``COLD_SPAN`` times the L2, so each call reads its inputs from device
    memory; None where that takes more than ``MAX_COPIES`` copies (inputs of
    a few KB, whose time is launch latency either way)."""
    warm = _graph_ms([lambda: fn(*args)] * iters)
    nbytes = sum(a.numel() * a.element_size() for a in args)
    n = math.ceil(COLD_SPAN * L2_BYTES / nbytes)
    if n > MAX_COPIES:
        return {"warm": warm, "cold": None}
    copies = [[a.clone() for a in args] for _ in range(n)]
    calls = [lambda c=copies[i % n]: fn(*c) for i in range(max(iters, n))]
    return {"warm": warm, "cold": _graph_ms(calls)}


def _times(kernel, plain, library, args, iters: int) -> dict:
    """The case's times: ``ms``, ``plain_ms`` and ``library_ms`` with the
    inputs cold in device memory (warm where cold is not measured), and the
    same three warm.  ``library`` None: no PyTorch call computes the
    function, and ``library_ms`` is None."""
    out = {"library_ms": None, "library_ms_warm": None}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        if fn is None:
            continue
        t = _ms(fn, args, iters)
        out[key] = t["cold"] if t["cold"] is not None else t["warm"]
        out[f"{key}_warm"] = t["warm"]
    out["inputs"] = "cold" if t["cold"] is not None else "warm"
    return out


def _err(out, want) -> tuple[float, float]:
    """(max abs error, ``ref.scaled_err``) of ``out`` against ``want``."""
    from repro_torch.kernels.ref import scaled_err

    return (out.float() - want.float()).abs().max().item(), scaled_err(out, want)


def _rms_rel(a, b) -> float:
    """rms(a - b) / rms(b) over all elements."""
    a, b = a.float(), b.float()
    return ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item()


def card() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {torch.cuda.get_device_name(0)}; "
          f"{torch.cuda.device_count()} device(s)")
    print(f"[card] nvidia-smi: {smi}")
    return smi


def build_kernels() -> dict:
    """Every kernel and every planted fault of ``PLANTED``, one ``nvcc`` per
    source, all at once.  Returns the planted faults' libraries by name."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    planted = OUT_DIR / "planted"
    planted.mkdir(parents=True, exist_ok=True)
    fault_jobs = {}
    for kernel, faults in PLANTED.items():
        src = (build.SRC_DIR / f"{kernel}.cu").read_text()
        for name, (sound, faulty, _) in faults.items():
            if src.count(sound) != 1:
                raise AssertionError(f"planted fault {name}: its sound line is not in {kernel}.cu")
            (planted / f"{name}.cu").write_text(src.replace(sound, faulty))
            fault_jobs[f"{kernel}:{name}"] = (planted / f"{name}.cu", planted / f"{name}.so")
    build.compile_sources({**build.jobs(), **fault_jobs})
    secs = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    log = "\n".join(f"== {n}\n{out}" for n, out in build.BUILD_LOG.items())
    (OUT_DIR / "kernel_build_log.txt").write_text(log)
    print(f"[build] {len(build.KERNELS)} kernels and {len(fault_jobs)} planted faults in "
          f"{secs:.1f} s (nvcc {' '.join(build.NVCC_FLAGS)})")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or line.startswith("=="):
            print(f"[build]   {line.strip()}")
        elif "Compiling entry function" in line:  # which template instance the next lines are
            name = line.split("'")[1]
            print(f"[build]   {re.sub(r'^_ZN.*?_cu_[0-9a-f]{8}[0-9]+', '', name)[:60]}")
    return {name.split(":")[1]: lib for name, (_, lib) in fault_jobs.items()}


def rmsnorm_cases(gen):
    """Kernel against plain version at the serving shapes of Yi-6B and
    Falcon-Mamba-7B, a ragged T (one row past the prefill's 2048), a second
    width (DeepSeek-V2's 5120), and the prefill and decode shapes of
    H2O-Danube3 (d 3840, 4 x 4608 tokens), Gemma (3072), MusicGen (2048),
    Qwen2-VL (3584), MiniCPM3 (2560, and inside MLA 768 for ``q_norm``
    and 256 for ``kv_norm``), DBRX (6144) and DeepSeek-V2 (5120, and inside
    MLA 1536 and 512)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    cases = []
    # prefill 4 x 512 tokens; decode 4 tokens; ragged; second width; then
    # danube's, gemma's, musicgen's, qwen2-vl's, minicpm3's, dbrx's and
    # deepseek-v2's prefill and decode
    for T, d in ((2048, 4096), (4, 4096), (2049, 4096), (2048, 5120), (18432, 3840),
                 (4, 3840), (2048, 3072), (4, 3072), (2048, 2048), (4, 2048),
                 (2048, 3584), (4, 3584), (2048, 2560), (4, 2560), (2048, 768), (4, 768),
                 (2048, 256), (4, 256), (2048, 6144), (4, 6144), (4, 5120), (2048, 1536),
                 (4, 1536), (2048, 512), (4, 512)):
        x = torch.randn(T, d, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.rand(d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        out = rmsnorm_cuda(x, w, 1e-6)
        torch.cuda.synchronize()
        abs_err, err = _err(out, rmsnorm_ref(x.float(), w.float(), eps=1e-6))
        if not err <= TOL_BF16:
            raise AssertionError(f"rmsnorm [{T},{d}]: scaled err {err} > {TOL_BF16}")
        nbytes = 2 * T * d * x.element_size() + d * w.element_size()
        flops = 4 * T * d  # square, add, two multiplies per value, fp32 CUDA cores
        cases.append({
            "shape": f"x[{T},{d}] bf16",
            "max_abs_err": abs_err, "scaled_err": err,
            **_times(lambda x, w: rmsnorm_cuda(x, w, 1e-6),
                     lambda x, w: rmsnorm_ref(x, w, eps=1e-6),
                     lambda x, w: F.rms_norm(x, (d,), w, 1e-6), (x, w), iters=100),
            "bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_ops_ms": flops / PEAK_FP32_FLOPS * 1e3,
        })
    return cases


def _attn_pairs(Sq, Skv, causal, window) -> int:
    """Unmasked (query, key) pairs of one head: the work this input needs."""
    n = 0
    for i in range(Sq):
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


#: phase 3's attention cases: (label, BH, g, Sq, Skv, hd, hd_v, causal,
#: window), hd the q/k head dim and hd_v v's
FLASH_SPECS = [
    ("yi prefill", 4 * 32, 8, 512, 512, 128, 128, True, None),
    ("ragged", 4 * 32, 8, 300, 300, 128, 128, True, None),
    ("window 128", 4 * 32, 8, 512, 512, 128, 128, True, 128),
    ("hd 16", 4 * 8, 4, 256, 256, 16, 16, True, None),
    ("long prompt", 32, 8, 4096, 4096, 128, 128, True, None),  # one sequence at Yi's context
    # the dense serving slice: 4 requests each, Danube past its window
    ("danube prefill", 4 * 32, 4, 4608, 4608, 120, 120, True, 4096),
    ("gemma prefill", 4 * 16, 1, 512, 512, 256, 256, True, None),
    ("musicgen prefill", 4 * 32, 1, 512, 512, 64, 64, True, None),
    ("ragged hd 120", 4 * 32, 4, 300, 300, 120, 120, True, None),
    ("ragged hd 256", 4 * 16, 1, 300, 300, 256, 256, True, None),
    # window edges inside a KV tile (64 keys; 32 at hd 256)
    ("window 100, hd 120", 4 * 32, 4, 512, 512, 120, 120, True, 100),
    ("window 50, hd 256", 4 * 16, 1, 512, 512, 256, 256, True, 50),
    # MiniCPM3's MLA (expanded prefill: q/k 64 + 32, v 64, MHA) and its
    # smoke pair (q/k 16 + 8, padded to 32 inside the kernel; v 16);
    # Qwen2-VL's GQA group of 7
    ("minicpm3 prefill", 4 * 40, 1, 512, 512, 96, 64, True, None),
    ("ragged minicpm3", 4 * 40, 1, 300, 300, 96, 64, True, None),
    ("hd 24/16 (minicpm3 smoke)", 4 * 4, 1, 256, 256, 24, 16, True, None),
    ("qwen2-vl prefill", 4 * 28, 7, 512, 512, 128, 128, True, None),
    # the MoE slice: DBRX's GQA group of 6; DeepSeek-V2's MLA (expanded
    # prefill: q/k 128 + 64, v 128, MHA), ragged and small
    ("dbrx prefill", 4 * 48, 6, 512, 512, 128, 128, True, None),
    ("deepseek prefill", 4 * 128, 1, 512, 512, 192, 128, True, None),
    ("ragged deepseek", 4 * 128, 1, 300, 300, 192, 128, True, None),
    ("small deepseek", 2, 1, 64, 64, 192, 128, True, None),
]


def flash_inputs(gen, BH, g, Sq, Skv, hd, hdv=None):
    """bf16 q [BH, Sq, hd], k [BH // g, Skv, hd] and v [BH // g, Skv, hd_v]
    (hd_v = hd by default) on the card, each the head of a longer
    allocation, so that a planted fault reading one vector past a row's end
    reads memory that is there."""
    import torch

    def mk(n, s, d):
        buf = torch.empty(n * s * d + 64, dtype=torch.bfloat16, device="cuda")
        x = buf[:n * s * d].view(n, s, d)
        return x.copy_(torch.randn(n, s, d, generator=gen, device="cuda"))

    return mk(BH, Sq, hd), mk(BH // g, Skv, hd), mk(BH // g, Skv, hdv or hd)


def flash_library(Sq, Skv, causal, window):
    """The library yardstick: PyTorch's fused attention on [1, BH, S, hd]
    (v's head dim may differ)."""
    import torch
    import torch.nn.functional as F

    mask = None
    if window is not None:
        qp = torch.arange(Sq, device="cuda")[:, None]
        kp = torch.arange(Skv, device="cuda")[None, :]
        mask = (kp > qp - window) & ((kp <= qp) if causal else True)

    def lib(q, k, v):
        return F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask,
            is_causal=mask is None and causal, enable_gqa=True)[0]

    return lib


def flash_bounds(BH, g, Sq, Skv, hd, causal, window, hdv=None) -> dict:
    """The card's least time for one call, by bytes and by operations (hd_v
    = hd by default)."""
    hdv = hdv or hd
    # q in, o out, k and v, bf16; QK^T at hd and PV at hd_v
    nbytes = (BH * Sq * (hd + hdv) + (BH // g) * Skv * (hd + hdv)) * 2
    flops = 2 * (hd + hdv) * BH * _attn_pairs(Sq, Skv, causal, window)
    return {"bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_ops_ms": flops / PEAK_BF16_TC_FLOPS * 1e3}


def flash_cases(gen, fault_libs):
    """Kernel against plain version: Yi prefill, ragged, windowed, hd 16,
    one sequence at Yi's 4096 context (bound by the tensor cores), the
    dense serving slice's shapes at hd 120, 256 and 64, MiniCPM3's MLA pair
    (96, 64) and its smoke pair (24, 16), Qwen2-VL's group of 7, DBRX's
    group of 6 and DeepSeek-V2's MLA pair (192, 128); then
    every planted fault of ``FLASH_FAULTS`` against its case's check."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref, scaled_err

    cases = []
    faults = {label: name for name, (_, _, label) in FLASH_FAULTS.items()}
    for label, BH, g, Sq, Skv, hd, hdv, causal, window in FLASH_SPECS:
        q, k, v = flash_inputs(gen, BH, g, Sq, Skv, hd, hdv)
        kw = dict(group_size=g, causal=causal, window=window)
        out = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        abs_err, err = _err(out, flash_attention_ref(q.float(), k.float(), v.float(), **kw))
        if not err <= TOL_BF16:
            raise AssertionError(f"flash_attention {label}: scaled err {err} > {TOL_BF16}")
        fault = {}
        if label in faults:  # before the timed calls, whose freed outputs hold right answers
            name = faults[label]
            saved = build._LIBS["flash_attention"]
            try:
                build._LIBS["flash_attention"] = build.load(fault_libs[name], fa_mod._SIGNATURES)
                faulty = flash_attention_cuda(q, k, v, **kw)
                torch.cuda.synchronize()
            finally:
                build._LIBS["flash_attention"] = saved
            f_err = scaled_err(faulty, flash_attention_ref(q.float(), k.float(), v.float(), **kw))
            print(f"[kernel] flash_attention planted fault {name} at {label}: scaled err "
                  f"{f_err:.6g} (sound {err:.6g}, tol {TOL_BF16})")
            if f_err <= TOL_BF16:  # a faulty output of NaNs fails the check too
                raise AssertionError(f"planted fault {name} passed the check: {f_err}")
            fault = {"planted_fault_scaled_err": {  # JSON has no NaN
                name: f_err if math.isfinite(f_err) else str(f_err)}}
            del faulty
        lib = flash_library(Sq, Skv, causal, window)
        kv = (f"kv[{BH // g},{Skv},{hd}]" if hdv == hd
              else f"k[{BH // g},{Skv},{hd}] v[{BH // g},{Skv},{hdv}]")
        cases.append({
            "shape": f"{label}: q[{BH},{Sq},{hd}] {kv} g={g}"
                     f"{' causal' if causal else ''}"
                     f"{f' window={window}' if window else ''} bf16",
            "max_abs_err": abs_err, "scaled_err": err,
            "library_scaled_diff": _err(lib(q, k, v), out)[1],
            **_times(lambda q, k, v: flash_attention_cuda(q, k, v, **kw),
                     lambda q, k, v: flash_attention_ref(q, k, v, **kw),
                     lib, (q, k, v), iters=20),
            **flash_bounds(BH, g, Sq, Skv, hd, causal, window, hdv), **fault,
        })
        del q, k, v, out
    return cases


def mamba_cases(gen):
    """Kernel against plain version: Falcon-Mamba prefill, ragged, with an
    initial state, and the smoke config's state size."""
    import torch

    from repro_torch.kernels.mamba_scan import mamba_scan_cuda
    from repro_torch.kernels.ref import mamba_scan_ref

    specs = [  # (label, B, S, di, N, with_h0)
        ("falcon prefill", 4, 512, 8192, 16, False),
        ("ragged", 4, 300, 8192, 16, False),
        ("h0", 4, 512, 8192, 16, True),
        ("N 8", 4, 512, 8192, 8, False),
    ]
    cases = []
    for label, B, S, di, N, with_h0 in specs:
        a = torch.rand(B, S, di, N, generator=gen, device="cuda") * 0.9
        b = torch.randn(B, S, di, N, generator=gen, device="cuda") * 0.1
        c = torch.randn(B, S, N, generator=gen, device="cuda")
        args = (a, b, c)
        if with_h0:
            args += (torch.randn(B, di, N, generator=gen, device="cuda") * 0.1,)
        y, h = mamba_scan_cuda(*args)
        torch.cuda.synchronize()
        want_y, want_h = mamba_scan_ref(*args)
        (abs_y, err_y), (abs_h, err_h) = _err(y, want_y), _err(h, want_h)
        err = max(err_y, err_h)
        if not err <= TOL_F32:
            raise AssertionError(f"mamba_scan {label}: scaled err y {err_y}, h_last "
                                 f"{err_h} > {TOL_F32}")
        del y, h, want_y, want_h
        nbytes = sum(t.numel() for t in args) * 4 + (B * S * di + B * di * N) * 4
        flops = 4 * B * S * di * N  # update (mul, add) and readout (mul, add)
        cases.append({
            "shape": f"{label}: a/b[{B},{S},{di},{N}]{' h0' if with_h0 else ''} fp32",
            "max_abs_err": max(abs_y, abs_h), "scaled_err": err,
            "scaled_err_y": err_y, "scaled_err_h_last": err_h,
            **_times(mamba_scan_cuda, mamba_scan_ref, None, args, iters=5),
            "bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_ops_ms": flops / PEAK_FP32_FLOPS * 1e3,
        })
        del a, b, c, args
    return cases


def kernel_entry(name, source, replaces, cases, launches, tolerance=TOL_BF16):
    """The JSON record of one kernel: numbers at the main path's shape (the
    first case), every case beside them.  ``launches`` maps each run of the
    main path (a served model, a rank) to the kernel's launches over it;
    the record's count is their sum."""
    main = cases[0]
    bound_ms = max(main["bound_bytes_ms"], main["bound_ops_ms"])
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.values()), "launches_by_run": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": bound_ms,
        "bound_by": "bytes" if main["bound_bytes_ms"] >= main["bound_ops_ms"]
                    else "operations",
        "library_ms": main["library_ms"], "shape": main["shape"], "inputs": main["inputs"],
        "scaled_err": max(c["scaled_err"] for c in cases), "tolerance": tolerance,
        "cases": cases,
    }


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to their plain versions (the check's
    reference forward; the port itself never does this)."""
    from repro_torch.kernels import ops, ref

    names = ("rmsnorm", "flash_attention", "mamba_scan", "flash_attention_bwd", "rmsnorm_bwd",
             "mamba_scan_bwd")
    saved = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, getattr(ref, f"{n}_ref"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def pack_cases(gen, fault_libs) -> list:
    """Phase 6: ``a2a_pack`` against its plain version, bit for bit, and
    every planted fault against the same check."""
    import torch

    from repro_torch.kernels import a2a_pack, build
    from repro_torch.kernels.a2a_pack import a2a_pack_cuda
    from repro_torch.kernels.ref import a2a_pack_ref

    specs = [  # (label, [No, Ni, blk, d], dtype)
        ("EP dispatch, 1024 tokens x top-6 per rank (the main path's "
         "[2,4,1,3932160])", (2, 4, 768, 5120), torch.bfloat16),
        ("EP prefill, 4096 tokens x top-6 per rank", (2, 4, 3072, 5120), torch.bfloat16),
        ("EP dispatch, 4 pods x 2 lanes", (4, 2, 768, 5120), torch.bfloat16),
        ("reference test shape", (3, 4, 8, 16), torch.float32),
        ("reference test shape", (8, 1, 2, 32), torch.float32),
        ("70-byte tiles: vectors and tail, or bytes", (2, 3, 5, 7), torch.bfloat16),
    ]
    cases = []
    for label, shape, dt in specs:
        x = torch.randn(*shape, generator=gen, device="cuda").to(dt)
        out = a2a_pack_cuda(x)
        torch.cuda.synchronize()
        if not torch.equal(out, a2a_pack_ref(x)):
            raise AssertionError(f"a2a_pack {shape}: not equal to its plain version")
        nbytes = 2 * x.numel() * x.element_size()  # each byte read once, written once
        cases.append({
            "shape": f"{label}: x[{','.join(map(str, shape))}] {str(dt)[6:]}",
            "max_abs_err": 0.0, "scaled_err": 0.0, "equal": True,
            **_times(a2a_pack_cuda, a2a_pack_ref, a2a_pack_ref, (x,), iters=20),
            "bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_ops_ms": 0.0,
        })
        del x, out
    saved = build._LIBS["a2a_pack"]
    try:
        for name, (_, _, shape) in PACK_FAULTS.items():
            x = torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
            want = a2a_pack_ref(x)  # kept alive: no output reuses its memory
            build._LIBS["a2a_pack"] = build.load(fault_libs[name], a2a_pack._SIGNATURES)
            faulty = a2a_pack_cuda(x)
            torch.cuda.synchronize()
            differ = int((faulty.view(torch.uint8) != want.view(torch.uint8)).sum())
            print(f"[kernel] a2a_pack planted fault {name} at {shape}: {differ} of "
                  f"{want.numel() * want.element_size()} bytes differ")
            if differ == 0:
                raise AssertionError(f"planted fault {name} passed the equality check")
            cases[0].setdefault("planted_faults_bytes_differing", {})[name] = differ
            del x, want, faulty
    finally:
        build._LIBS["a2a_pack"] = saved
    return cases


def collectives_job(pods, lanes, tokens, top_k, d_model, bucket, device="cuda",
                    seed=0) -> dict:
    """Phase 7, the body of one rank (``repro_torch.launch.ranks``): the EP
    dispatch, then the sums, broadcasts and scatter, each checked.  Raises
    on any failed check.  Returns the kernels' launches over the dispatch,
    the host-clock seconds and the traffic of each collective."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.core.groups import Mesh2D
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import scaled_err
    from repro_torch.launch import ep_dispatch

    mesh = Mesh2D(pods, lanes)
    me, P = mesh.world.index, mesh.world.size
    ops.reset_launches()
    dispatch = ep_dispatch.run_rank(mesh, tokens=tokens, top_k=top_k, d_model=d_model,
                                    dtype="bfloat16", device=device, seed=seed)
    launches = ops.launch_counts()
    bad = [k for k in ("flat_equals_fulllane", "flat_equals_oracle",
                       "fulllane_equals_oracle") if not dispatch[k]]
    if bad:
        raise AssertionError(f"rank {me}: EP dispatch fails {bad}")
    want = {**dict.fromkeys(launches, 0),
            "a2a_pack": 2 * dispatch["fulllane_calls"] if device == "cuda" else 0}
    if launches != want:
        raise AssertionError(f"rank {me}: launches {launches} != {want}")

    seconds, traffic = {}, {}

    def timed(name, fn):
        if device == "cuda":
            torch.cuda.synchronize()
        mesh.traffic.reset()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        traffic[name] = mesh.traffic.snapshot()
        return out

    gen = torch.Generator(device=device)
    for n in (bucket, bucket + 1):
        x = torch.randn(n, generator=gen.manual_seed(seed * 1000 + me), device=device)
        C.hierarchical_psum(x, mesh.pod, mesh.lane)  # warm-up
        hier = timed(f"hierarchical_psum {n}", lambda: C.hierarchical_psum(x, mesh.pod, mesh.lane))
        flat = timed(f"flat_psum {n}", lambda: C.flat_psum(x, mesh.pod, mesh.lane))
        err = scaled_err(hier, flat)
        if not err <= TOL_F32:
            raise AssertionError(f"rank {me}: hierarchical_psum of {n}: scaled err {err} "
                                 f"against flat_psum > {TOL_F32}")
    payload = torch.randn(bucket, generator=gen.manual_seed(seed), device=device)
    shard = (payload.view(lanes, -1)[mesh.lane.index] if mesh.pod.index == 0
             else torch.full((bucket // lanes,), -99.0, device=device))
    got = {"fulllane_broadcast": timed("fulllane_broadcast", lambda: C.fulllane_broadcast(
        shard, mesh.pod, mesh.lane, root=0))}
    mine = payload if me == 0 else torch.full_like(payload, -1.0)
    for k in (1, 2, 3):
        got[f"kported_broadcast k={k}"] = timed(
            f"kported_broadcast k={k}",
            lambda: C.kported_broadcast_ppermute(mine, mesh.world, k=k))
    blocks = payload.view(P, -1)
    got["kported_scatter k=2"] = timed(
        "kported_scatter k=2", lambda: C.kported_scatter_ppermute(
            blocks if me == 0 else torch.zeros_like(blocks), mesh.world, k=2))
    for name, out in got.items():
        if not torch.equal(out, blocks[me] if "scatter" in name else payload):
            raise AssertionError(f"rank {me}: {name} did not deliver the payload")
    return {"rank": me, "dispatch": dispatch, "launches": launches, "seconds": seconds,
            "traffic": traffic, "transport": dispatch["transport"]}


def collectives_phase() -> list:
    """Phase 7: ``collectives_job`` in 8 ranks on this card, then as one NCCL
    rank in this process."""
    from repro_torch.launch import ranks

    world = COLLECTIVES["pods"] * COLLECTIVES["lanes"]
    t0 = time.perf_counter()
    results = ranks.run("chip_smoke:collectives_job", world,
                        kwargs={**COLLECTIVES, "device": "cuda"}, timeout_s=600)
    print(f"[collectives] {world} ranks ({COLLECTIVES['pods']} pods x "
          f"{COLLECTIVES['lanes']} lanes) on cuda:0, transport {results[0]['transport']}, in "
          f"{time.perf_counter() - t0:.1f} s (start-up included); every check passed on "
          f"every rank")
    d0 = results[0]["dispatch"]
    print(f"[collectives] EP dispatch: {d0['rows_per_destination']} rows x "
          f"{COLLECTIVES['d_model']} bf16 per destination, "
          f"{d0['bytes_per_rank'] / 1e6:.1f} MB per rank: flat == fulllane == numpy oracle, "
          f"bit for bit, on all {world} ranks; a2a_pack launches by rank "
          f"{[r['launches']['a2a_pack'] for r in results]} (2 per fulllane_all_to_all call, "
          f"{d0['fulllane_calls']} calls)")
    times = {"ep_dispatch flat": [r["dispatch"]["seconds"]["flat"] for r in results],
             "ep_dispatch fulllane": [r["dispatch"]["seconds"]["fulllane"] for r in results]}
    for name in results[0]["seconds"]:
        times[name] = [r["seconds"][name] for r in results]
    for name, ts in times.items():
        print(f"[collectives] {name}: host clock median {statistics.median(ts) * 1e3:.3f} ms, "
              f"max {max(ts) * 1e3:.3f} ms over ranks ({HOST_STAGED})")
    for name, counts in _traffic(results[0]).items():
        for key, c in counts.items():
            print(f"[collectives] rank 0 {name} {key}: {c['messages']} messages, "
                  f"{c['bytes']} bytes; cross-pod {c['cross_pod_messages']} messages, "
                  f"{c['cross_pod_bytes']} bytes; staged through the host {c['staged_bytes']} "
                  f"bytes")

    # the transport's NCCL branch, in the one NCCL world one card allows:
    # this process is its rank, which saves a rank process's start-up
    nccl = _nccl_rank({**COLLECTIVES, "pods": 1, "lanes": 1, "device": "cuda"})
    staged = sum(c["staged_bytes"] for counts in _traffic(nccl).values()
                 for c in counts.values())
    if not nccl["transport"].startswith("nccl,") or staged:
        raise AssertionError(f"NCCL rank: transport {nccl['transport']!r}, {staged} bytes "
                             f"staged through the host")
    print(f"[collectives] NCCL, 1 rank (no peer: the NCCL branch of the transport, "
          f"CUDA tensors as they are): every check passed, transport {nccl['transport']}, "
          f"a2a_pack launches {nccl['launches']['a2a_pack']}, 0 bytes staged")
    return results


def _nccl_rank(kwargs: dict) -> dict:
    """``collectives_job(**kwargs)`` as the one rank of an NCCL world, in
    this process."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        return collectives_job(**kwargs)
    finally:
        dist.destroy_process_group()


def _traffic(result) -> dict:
    """A rank's traffic counts, by collective: the dispatch's and the rest."""
    return {**{f"ep_dispatch {k}": v for k, v in result["dispatch"]["traffic"].items()},
            **result["traffic"]}


def _print_cases(name, cases, tol) -> None:
    for c in cases:
        lib = ("none" if c["library_ms"] is None else
               f"{c['library_ms']:.6f} (L2 warm {c['library_ms_warm']:.6f})")
        print(f"[kernel] {name} {c['shape']}: max abs err {c['max_abs_err']:.3g}, "
              f"scaled {c['scaled_err']:.3g} (tol {tol}); device ms, inputs "
              f"{c['inputs']}: kernel {c['ms']:.6f}, plain {c['plain_ms']:.6f}, "
              f"library {lib}; L2 warm: kernel {c['ms_warm']:.6f}, "
              f"plain {c['plain_ms_warm']:.6f}; "
              f"bound {max(c['bound_bytes_ms'], c['bound_ops_ms']):.6f} ms "
              f"(bytes {c['bound_bytes_ms']:.6f}, ops {c['bound_ops_ms']:.6f})")


def _widths(cfg) -> tuple:
    """The published widths each served config is held to."""
    if cfg.mamba is not None:
        m = cfg.mamba
        return (cfg.num_layers, cfg.d_model, m.d_state, m.d_conv, m.expand,
                m.resolved_dt_rank(cfg.d_model), cfg.vocab_size, cfg.dtype)
    a = cfg.attn
    out = (cfg.num_layers, cfg.d_model, a.num_heads, a.num_kv_heads, a.head_dim,
           cfg.d_ff, cfg.vocab_size, a.sliding_window, cfg.num_codebooks, cfg.act, cfg.dtype)
    if a.kind == "mla":
        out += (a.q_lora_rank, a.kv_lora_rank, a.qk_nope_head_dim, a.qk_rope_head_dim,
                a.v_head_dim)
    if a.mrope_sections is not None:
        out += (a.mrope_sections,)
    if cfg.moe is not None:
        e = cfg.moe
        out += (e.num_experts, e.top_k, e.d_ff_expert, e.num_shared_experts,
                e.capacity_factor, cfg.first_k_dense)
    return out


#: what each served model must be: its published widths (``_widths``), the
#: kernel launches over one prefill (norms per layer: Falcon-Mamba's layers
#: have no second norm, MiniCPM3's MLA adds ``q_norm`` and ``kv_norm``), its
#: prompt length and cache capacity (4 requests, 32 new tokens each), and
#: where set, the decode step whose logits must match a prefill over each
#: row's prompt and its tokens so far.  ``depth``: the layers kept of an
#: MoE model, whose weights at full depth would not fit one card (its
#: widths are the published config's).  Qwen2-VL takes embeddings: no engine
#: drives it (``drive_embeds``)
_DENSE = {"norms_per_layer": 2, "prompt": 512, "capacity": 1024}
SERVED = {
    "yi_6b": {**_DENSE, "prefill": {"flash_attention": 32},
              "widths": (32, 4096, 32, 4, 128, 11008, 64000, None, 1, "silu", "bfloat16")},
    "falcon_mamba_7b": {**_DENSE, "norms_per_layer": 1, "prefill": {"mamba_scan": 64},
                        "widths": (64, 4096, 16, 4, 2, 256, 65024, "bfloat16")},
    # past the 4096-token window: the ring wraps at prefill (4608 % 4096 = 512)
    "h2o_danube_3_4b": {**_DENSE, "prompt": 4608, "capacity": 5120, "full_forward_at": 8,
                        "prefill": {"flash_attention": 24},
                        "widths": (24, 3840, 32, 8, 120, 10240, 32000, 4096, 1, "silu",
                                   "bfloat16")},
    "gemma_7b": {**_DENSE, "prefill": {"flash_attention": 28},
                 "widths": (28, 3072, 16, 16, 256, 24576, 256000, None, 1, "geglu",
                            "bfloat16")},
    "musicgen_large": {**_DENSE, "prefill": {"flash_attention": 48},
                       "widths": (48, 2048, 32, 32, 64, 8192, 2048, None, 4, "gelu",
                                  "bfloat16")},
    "minicpm3_4b": {**_DENSE, "norms_per_layer": 4, "prefill": {"flash_attention": 62},
                    "widths": (62, 2560, 40, 40, 64, 6400, 73448, None, 1, "silu", "bfloat16",
                               768, 256, 64, 32, 64)},
    "dbrx_132b": {**_DENSE, "depth": 8, "prefill": {"flash_attention": 8},
                  "widths": (40, 6144, 48, 8, 128, 10752, 100352, None, 1, "silu", "bfloat16",
                             16, 4, 10752, 0, 1.25, 0)},
    # the dense prelude layer and 7 MoE layers; MLA adds q_norm and kv_norm
    "deepseek_v2_236b": {**_DENSE, "depth": 8, "norms_per_layer": 4,
                         "prefill": {"flash_attention": 8},
                         "widths": (60, 5120, 128, 128, 128, 12288, 102400, None, 1, "silu",
                                    "bfloat16", 1536, 512, 128, 64, 128,
                                    160, 6, 1536, 2, 1.25, 1)},
    "qwen2_vl_7b": {**_DENSE, "full_forward_at": 8, "prefill": {"flash_attention": 28},
                    "widths": (28, 3584, 28, 4, 128, 18944, 152064, None, 1, "silu",
                               "bfloat16", (16, 24, 24))},
}
#: phase 4's planned engine: its decode collectives pinned for 2 nodes x 8
#: GPUs with 2 IB rails, at the NVLink/IB cost model, and replanned once on
#: a lane fault of node 0 after this decode step
PLAN_MESH, FAULT_AFTER_STEP = (2, 8, 2), 8
#: the paper's machine: 36 nodes x 32 processes, k = 2 lanes (Hydra)
PAPER_MESH = (36, 32, 2)
#: Qwen2-VL's prompt: text, then an image of 16 x 16 patches from token 64,
#: then text; t is the index throughout (ROADMAP, reference caveats)
IMAGE_SPAN = (64, 16, 16)


def _finite_greedy(logits, generator):
    """The serving phase's sampler: greedy, after a check that every logit
    is finite."""
    import torch

    from repro_torch.serving.engine import greedy_sample

    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits in serving")
    return greedy_sample(logits, generator)


class _Driven:
    """One engine of ``_serve_in_turns`` and what its calls did: host-clock
    times of its admission and of each decode step, the device memory
    segments its admission created (``cudaMalloc`` calls), the kernels'
    launches and the peak device memory over its own calls, the logits of
    every sampling."""

    def __init__(self, cfg, params, *, cuda_graph: bool, slots: int, capacity: int,
                 **engine_kw):
        import torch

        from repro_torch.serving.engine import ServeEngine

        self.logits = []

        def sampler(lg, generator):
            self.logits.append(lg)  # a replay returns a copy, an eager step a new tensor
            return _finite_greedy(lg, generator)

        t0 = time.perf_counter()
        self.eng = ServeEngine(cfg, params, num_slots=slots, capacity=capacity,
                               sampler=sampler, device="cuda", cuda_graph=cuda_graph,
                               **engine_kw)
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0
        self.launches = dict.fromkeys(("rmsnorm", "flash_attention", "mamba_scan"), 0)
        self.step_s, self.prefill_ms, self.prefill_segments = [], None, None
        self.peak_mem_gb = 0.0

    def call(self, fn, *args) -> float:
        """``fn(*args)``, counted and timed (it ends in the host copy of the
        sampled tokens, so it is synchronised); returns its seconds."""
        import torch

        from repro_torch.kernels import ops

        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        fn(*args)
        dt = time.perf_counter() - t0
        after = ops.launch_counts()
        for k in self.launches:
            self.launches[k] += after[k] - before[k]
        self.peak_mem_gb = max(self.peak_mem_gb, torch.cuda.max_memory_allocated() / 1e9)
        return dt

    def result(self, reqs) -> dict:
        return {"done": reqs, "logits": self.logits, "launches": self.launches,
                "per_replay": None if self.eng.graph is None else self.eng.graph.launches,
                "build_s": self.build_s, "prefill_ms": self.prefill_ms,
                "prefill_segments": self.prefill_segments,
                "step_s": self.step_s, "peak_mem_gb": self.peak_mem_gb}


def _serve_in_turns(cfg, params, prompts, *, slots: int, capacity: int,
                    max_new: int) -> tuple[dict, dict]:
    """Serve ``prompts`` through two fresh engines on the same parameters,
    the decode step as a captured CUDA graph (the main path) and eager, in
    turns: both admit, then each lock-step of one is followed by the same
    step of the other, the order swapped every step.  Each engine's
    launches are counted over its own calls only, from 0.  Returns (graph,
    eager) as ``_Driven.result`` gives them."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request

    ops.reset_launches()
    engines = [_Driven(cfg, params, cuda_graph=g, slots=slots, capacity=capacity)
               for g in (True, False)]
    reqs = [[Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
            for _ in engines]
    for d, rs in zip(engines, reqs):
        segments = torch.cuda.memory_stats()["segment.all.allocated"]
        d.prefill_ms = d.call(d.eng.admit, rs) * 1e3
        d.prefill_segments = torch.cuda.memory_stats()["segment.all.allocated"] - segments
    for step in range(max_new - 1):  # the prefill samples the first token
        for d in engines[::-1] if step % 2 else engines:
            d.step_s.append(d.call(d.eng.step))
    for d in engines:
        d.eng.drain()
    return tuple(d.result(rs) for d, rs in zip(engines, reqs))


def _compare_decodes(graph: dict, eager: dict, slots: int) -> dict:
    """The graph path's tokens and logits against the eager path's, sampling
    by sampling.  Both run the same kernels on the same inputs, so 0 is
    expected; a difference must stay within ``TOL_BF16`` (rms, per row),
    and a token may differ only where the eager top-2 gap is within twice
    the difference (a near tie), after which that row's inputs differ and
    it is no longer compared."""
    import numpy as np
    import torch

    g_tok = [r.out_tokens for r in graph["done"]]
    e_tok = [r.out_tokens for r in eager["done"]]
    released, max_abs, worst_rms = {}, 0.0, 0.0
    for i, (g, e) in enumerate(zip(graph["logits"], eager["logits"])):
        for row in range(slots):
            if row in released:
                continue
            d = (g[row].float() - e[row].float()).abs().max().item()
            max_abs, worst_rms = max(max_abs, d), max(worst_rms, _rms_rel(g[row], e[row]))
            if worst_rms > TOL_BF16:
                raise AssertionError(f"sampling {i}, row {row}: graph logits {worst_rms} "
                                     f"rms from the eager step's > {TOL_BF16}")
            differ = torch.from_numpy(np.atleast_1d(np.not_equal(g_tok[row][i], e_tok[row][i])))
            if differ.any():  # a token, or for K codebooks some of the K
                top2 = e[row].float().reshape(len(differ), -1).topk(2).values
                if (top2[:, 0] - top2[:, 1])[differ].min().item() > 2 * d:
                    raise AssertionError(f"sampling {i}, row {row}: graph token "
                                         f"{g_tok[row][i]} != eager {e_tok[row][i]}")
                released[row] = i
    equal = sum(a == b for gt, et in zip(g_tok, e_tok) for a, b in zip(gt, et))
    return {"tokens_equal": equal, "tokens": sum(map(len, g_tok)),
            "logits_max_abs_diff": max_abs, "logits_worst_rms_rel": worst_rms,
            "rows_released_at_near_ties": released,
            "samplings": min(len(graph["logits"]), len(eager["logits"]))}


def serve(arch: str, seed: int = 0, smi: str = "") -> dict:
    """Serve ``arch`` at full width through the captured decode step, check
    its launches and logits, and hold it against the eager step; for Yi-6B
    (phase 4) serve the same requests again with the decode collectives
    planned (``serve_planned``).  ``smi``: the card's name and power limit,
    printed beside the planner's host times."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_config(arch)
    want = SERVED[arch]
    if _widths(cfg) != want["widths"]:
        raise AssertionError(f"{arch} is not at its published widths: {_widths(cfg)}")
    if "depth" in want:
        cfg = dataclasses.replace(cfg, num_layers=want["depth"])
    slots, capacity, prompt_len, max_new = 4, want["capacity"], want["prompt"], 32
    k = cfg.num_codebooks
    prompt_shape = (prompt_len, k) if k > 1 else (prompt_len,)

    t0 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                           device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name} full width, {cfg.num_layers} layers: {n_params / 1e9:.3f} B "
          f"params, bf16, random init from seed {seed} in {time.perf_counter() - t0:.1f} s")

    rng = np.random.RandomState(seed)

    def prompts():
        return [rng.randint(0, cfg.vocab_size, prompt_shape).astype(np.int32)
                for _ in range(slots)]

    # warm-up drive at the same shapes and through the same sampler
    # (cuBLAS handles and heuristics, each kernel's first load), before the
    # counts are set to 0; eager, since the graph engine warms its own step
    # before capture
    ServeEngine(cfg, params, num_slots=slots, capacity=capacity, sampler=_finite_greedy,
                device="cuda", cuda_graph=False).run(
        [Request(rid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts())])

    # in turns: graph (the run checked and counted) and eager (the run it
    # is held against), step by step on the same requests
    served = prompts()
    main, eager = _serve_in_turns(cfg, params, served, slots=slots, capacity=capacity,
                                  max_new=max_new)
    done, launches = main["done"], main["launches"]
    decode_steps = len(main["step_s"])
    gen_tokens = sum(len(r.out_tokens) for r in done)
    total_s = main["prefill_ms"] / 1e3 + sum(main["step_s"])
    med = {m: statistics.median(r["step_s"]) * 1e3 for m, r in (("graph", main),
                                                                  ("eager", eager))}
    res = {
        "requests": len(done), "tokens": gen_tokens, "decode_steps": decode_steps,
        "prefill_ms": main["prefill_ms"], "prefill_ms_eager": eager["prefill_ms"],
        "prefill_new_segments": main["prefill_segments"],
        "prefill_new_segments_eager": eager["prefill_segments"],
        "decode_ms_per_step_median": med["graph"],
        "decode_ms_per_step_mean": statistics.fmean(main["step_s"]) * 1e3,
        "decode_ms_per_step_median_eager": med["eager"],
        "tok_per_s": gen_tokens / total_s,
        "peak_mem_gb": main["peak_mem_gb"], "peak_mem_gb_eager": eager["peak_mem_gb"],
        "launches": launches, "launches_per_replay": main["per_replay"],
        "engine_build_ms": main["build_s"] * 1e3,
        "engine_build_ms_eager": eager["build_s"] * 1e3,
    }
    print(f"[serve] prefill {slots}x{'x'.join(map(str, prompt_shape))} tokens (cache of "
          f"{capacity}, {_kv_slots(cfg, capacity)}): {main['prefill_ms']:.2f} ms, "
          f"{main['prefill_segments']} new device segments (eager engine, admitted next: "
          f"{eager['prefill_ms']:.2f} ms, {eager['prefill_segments']}); decode as a CUDA graph, "
          f"{decode_steps} steps of {slots} tokens: median "
          f"{res['decode_ms_per_step_median']:.3f} ms, mean "
          f"{res['decode_ms_per_step_mean']:.3f} ms per step; "
          f"{gen_tokens} tokens in {total_s * 1e3:.1f} ms = {res['tok_per_s']:.1f} tok/s; "
          f"peak memory over its calls {main['peak_mem_gb']:.2f} GB (eager "
          f"{eager['peak_mem_gb']:.2f} GB; both engines resident)")
    print(f"[serve] decode ms per step (host clock, median over {decode_steps} steps each, "
          f"graph and eager in turns): graph {med['graph']:.3f}, eager {med['eager']:.3f}; "
          f"eager / graph {med['eager'] / med['graph']:.2f}; engine built in "
          f"{main['build_s'] * 1e3:.1f} ms with the step captured, "
          f"{eager['build_s'] * 1e3:.1f} ms without")
    print(f"[serve] launches over the graph engine's calls: {launches}; per replay of "
          f"the captured step: {main['per_replay']}")

    if len(done) != slots or any(len(r.out_tokens) != max_new for r in done):
        raise AssertionError(f"not every request got {max_new} tokens: "
                             f"{[len(r.out_tokens) for r in done]}")
    per_forward = want["norms_per_layer"] * cfg.num_layers + 1
    if main["per_replay"] != {**dict.fromkeys(main["per_replay"], 0), "rmsnorm": per_forward}:
        raise AssertionError(f"launches per replay {main['per_replay']}: want "
                             f"{per_forward} rmsnorm and nothing else")
    want_launches = {"rmsnorm": per_forward * (1 + decode_steps), "flash_attention": 0,
                     "mamba_scan": 0, **want["prefill"]}
    for mode, run in (("graph", main), ("eager", eager)):
        if run["launches"] != want_launches:
            raise AssertionError(f"{mode} engine: launches {run['launches']} != "
                                 f"{want_launches} ({per_forward} norms per forward, 1 "
                                 f"prefill + {decode_steps} decode steps)")

    cmp = _compare_decodes(main, eager, slots)
    print(f"[serve] graph against eager decode, same requests: {cmp['tokens_equal']}/"
          f"{cmp['tokens']} tokens equal; logits of {cmp['samplings']} samplings: max abs "
          f"diff {cmp['logits_max_abs_diff']:.6g}, worst rms {cmp['logits_worst_rms_rel']:.6g} "
          f"(tol {TOL_BF16}); rows released at a near tie: "
          f"{cmp['rows_released_at_near_ties'] or 'none'}")
    res["graph_vs_eager"] = cmp
    if arch == "yi_6b":
        res["planned"] = serve_planned(cfg, params, served, main["done"], want_launches,
                                       slots=slots, capacity=capacity, max_new=max_new,
                                       smi=smi)
    if "full_forward_at" in want:
        at = want["full_forward_at"]
        ctx = np.stack([np.concatenate([p, np.asarray(r.out_tokens[:at], p.dtype)])
                        for p, r in zip(served, main["done"])])
        res["decode_vs_full_forward"] = _decode_vs_full_forward(
            cfg, params, {"tokens": torch.from_numpy(ctx.astype(np.int64)).cuda()},
            main["logits"][at], at, capacity)
    tokens = torch.from_numpy(np.stack(served).astype(np.int64)).cuda()
    res.update(_prefill_against_float32(cfg, params, {"tokens": tokens}, main["logits"][0],
                                        capacity))
    return res


def _plan_line(plans: dict) -> str:
    return ", ".join(f"{op} {pl.algorithm} {pl.est_us:.6g} us" for op, pl in plans.items())


def serve_planned(cfg, params, prompts, want_done, want_launches, *, slots: int,
                  capacity: int, max_new: int, smi: str) -> dict:
    """Phase 4's planned engine: a graph engine with ``plan_mesh=PLAN_MESH``
    priced at ``NVLINK_IB.cost`` serves ``prompts`` again, with a lane fault
    on node 0 injected after decode step ``FAULT_AFTER_STEP``.  Its tokens
    must equal ``want_done``'s (the engine without a planner), its launches
    ``want_launches``, and it must replan once, inside its deadline.  The
    pinning is timed cold (the planner's caches emptied first, as in a fresh
    process), by a ``DecodePlanner`` of the engine's arguments built just
    before the engine, which must pin the same plans.  Last, a planner is
    pinned at the paper's mesh (``PAPER_MESH``, Hydra's cost), cold too."""
    from repro_torch.core import schedule_ir, selector
    from repro_torch.core.topology import NVLINK_IB, hydra_machine
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request
    from repro_torch.serving.planner import DecodePlanner
    from repro_torch.training.elastic import FaultEvent

    def cold_pin(mesh, cost) -> tuple:
        schedule_ir.schedule_cache_clear()
        selector.selector_cache_reset()
        t0 = time.perf_counter()
        planner = DecodePlanner(num_slots=slots, d_model=cfg.d_model,
                                num_codebooks=cfg.num_codebooks, num_nodes=mesh[0],
                                procs_per_node=mesh[1], k_lanes=mesh[2], cost=cost)
        return planner, (time.perf_counter() - t0) * 1e3

    cost = NVLINK_IB.cost
    cold, pin_ms = cold_pin(PLAN_MESH, cost)
    ops.reset_launches()
    d = _Driven(cfg, params, cuda_graph=True, slots=slots, capacity=capacity,
                plan_mesh=PLAN_MESH, plan_cost=cost)
    planner = d.eng.planner
    pinned = planner.plans()
    if {op: pl.as_dict() for op, pl in pinned.items()} != \
            {op: pl.as_dict() for op, pl in cold.plans().items()}:
        raise AssertionError("the engine pinned other plans than its planner's arguments give")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    d.prefill_ms = d.call(d.eng.admit, reqs) * 1e3
    action, inject_ms = None, math.nan
    for step in range(1, max_new):  # the prefill samples the first token
        d.step_s.append(d.call(d.eng.step))
        if step == FAULT_AFTER_STEP:
            t0 = time.perf_counter()
            action = d.eng.inject_fault(FaultEvent(kind="lane", node=0, step=step))
            inject_ms = (time.perf_counter() - t0) * 1e3
    d.eng.drain()
    replan = planner.replan_reports[0] if planner.replan_reports else {}
    replanned = planner.plans()
    paper, paper_ms = cold_pin(PAPER_MESH, hydra_machine(PAPER_MESH[2]).cost)
    tokens = {r.rid: r.out_tokens for r in reqs}
    equal = sum(a == b for r in want_done for a, b in zip(r.out_tokens, tokens[r.rid]))
    res = {"mesh": PLAN_MESH, "pinned": {op: pl.as_dict() for op, pl in pinned.items()},
           "replanned": {op: pl.as_dict() for op, pl in replanned.items()},
           "replan_report": replan, "action": action, "pin_ms_cold": pin_ms,
           "replan_ms": replan.get("wall_s", math.nan) * 1e3, "inject_fault_ms": inject_ms,
           "engine_build_ms": d.build_s * 1e3, "launches": d.launches,
           "tokens_equal": equal, "tokens": sum(map(len, tokens.values())),
           "paper_mesh": PAPER_MESH, "paper_pin_ms_cold": paper_ms,
           "paper_pinned": {op: pl.as_dict() for op, pl in paper.plans().items()}}
    print(f"[serve] planned engine, plan_mesh {PLAN_MESH} (2 nodes x 8 GPUs, 2 IB rails), "
          f"plans priced by the NVLink/IB cost model (est_us is that model's estimate, not a "
          f"measurement): pinned {_plan_line(pinned)}; replanned after a lane fault on node 0 "
          f"after decode step {FAULT_AFTER_STEP} ({action}, {replan.get('outcome')}): "
          f"{_plan_line(replanned)}")
    print(f"[serve] planner host ms ({smi}): pin {pin_ms:.3f} (cold caches), replan "
          f"{res['replan_ms']:.3f} (deadline {planner.replan_deadline_s * 1e3:.0f}), "
          f"inject_fault {inject_ms:.3f}; engine build with the pin and the capture "
          f"{res['engine_build_ms']:.1f}")
    print(f"[serve] planner at the paper's mesh {PAPER_MESH[0]} x {PAPER_MESH[1]}, k = "
          f"{PAPER_MESH[2]}, Hydra's cost (est_us is that model's estimate, not a "
          f"measurement): {_plan_line(paper.plans())}; pinned in {paper_ms:.3f} host ms "
          f"(cold caches; {smi})")
    print(f"[serve] planned engine: {equal}/{res['tokens']} tokens equal to the engine "
          f"without plan_mesh; launches over its calls {d.launches}")
    if equal != res["tokens"] or sorted(tokens) != sorted(r.rid for r in want_done):
        raise AssertionError("the planned engine's tokens differ from the engine's without "
                             "plan_mesh")
    if d.launches != want_launches:
        raise AssertionError(f"planned engine: launches {d.launches} != {want_launches}")
    if action != "warn" or planner.replan_count != 1 or replan.get("outcome") != "replanned":
        raise AssertionError(f"planned engine: action {action!r}, {planner.replan_count} "
                             f"replans, report {replan}")
    if not replan["wall_s"] < planner.replan_deadline_s:
        raise AssertionError(f"the replan took {replan['wall_s']} s, past its deadline "
                             f"{planner.replan_deadline_s} s")
    return res


class _Float32Rows:
    """A bf16 tensor read as float32: each index of it gives a float32 copy
    of that part, made at the read."""

    def __init__(self, t):
        self.t = t

    def __getitem__(self, i):
        return self.t[i].float()


class _Float32Tree(dict):
    """A parameter tree read as float32: each tensor a float32 copy made at
    the read, each subtree a tree of its own; ``_Float32Rows`` leaves as they
    are."""

    def __getitem__(self, k):
        v = super().__getitem__(k)
        if isinstance(v, dict):
            return _Float32Tree(v)
        return v.float() if hasattr(v, "float") else v


def float32_reads(params: dict) -> dict:
    """``params`` as a float32 forward reads them: every weight cast where it
    is read (a stacked leaf a period at a time, an untied embedding table a
    token's rows at a time), so the float32 copy never holds more than one
    layer's weights: the float32 model in bounded memory (a float32 DBRX at
    8 layers is 109 GB)."""
    from repro_torch.models.params import map_tree

    rows = {"blocks": map_tree(lambda _, t: _Float32Rows(t), params["blocks"])}
    if params["embed"] and params["head"]:  # an untied table, read by rows
        rows["embed"] = {"embedding": _Float32Rows(params["embed"]["embedding"])}
    return _Float32Tree({**params, **rows})


def _prefill_against_float32(cfg, params, batch, kern, capacity: int) -> dict:
    """The prefill's logits through the kernels (``kern``) against the same
    prefill through the plain versions of the kernels, in the model's bf16
    and in float32 (the reference for the bf16 rounding; each weight cast
    where it is read, ``float32_reads``): no further from
    float32 than ``LOGIT_NOISE_RATIO`` times the plain bf16 logits are,
    within ``TOL_BF16`` (rms) of those, and the same first token wherever
    float32's top-2 gap exceeds the bf16 noise."""
    import torch

    from repro_torch.models import lm

    torch.cuda.reset_peak_memory_stats()
    with plain_kernels():
        plain, _ = lm.prefill(cfg, params, batch, capacity=capacity)
        exact, _ = lm.prefill(dataclasses.replace(cfg, dtype="float32"),
                              float32_reads(params), batch, capacity=capacity)
    peak = torch.cuda.max_memory_allocated() / 1e9
    err_kern, err_plain = _rms_rel(kern, exact), _rms_rel(plain, exact)
    err_kp = _rms_rel(kern, plain)
    top2 = exact.topk(2, dim=-1).values
    noise = (plain.float() - exact).abs().max(dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * LOGIT_NOISE_RATIO * noise
    same = kern.float().argmax(-1) == exact.argmax(-1)
    print(f"[serve] prefill logits against float32: rms err through the kernels "
          f"{err_kern:.6f}, through the plain versions {err_plain:.6f} (ratio "
          f"{err_kern / err_plain:.4f}, at most {LOGIT_NOISE_RATIO}); kernels vs plain: "
          f"max abs {_err(kern, plain)[0]:.5f}, rms {err_kp:.6f} (tol {TOL_BF16}); first "
          f"token equal to float32's in {int(same.sum())}/{same.numel()} rows"
          f"{' x codebooks' if cfg.num_codebooks > 1 else ''}, {int(decided.sum())} with a "
          f"top-2 gap above the bf16 noise; peak memory with the float32 copy {peak:.2f} GB")
    if not err_kern <= LOGIT_NOISE_RATIO * err_plain:
        raise AssertionError(f"prefill logits: rms err {err_kern} through the kernels > "
                             f"{LOGIT_NOISE_RATIO} x {err_plain} through the plain versions")
    if not err_kp <= TOL_BF16:
        raise AssertionError(f"prefill logits: rms err {err_kp} against the plain "
                             f"versions > {TOL_BF16}")
    if not bool(same[decided].all()):
        raise AssertionError("first token differs where the top-2 gap exceeds the bf16 noise")
    return {"peak_mem_gb_float32_check": peak, "prefill_logit_rms_err_kernels": err_kern,
            "prefill_logit_rms_err_plain": err_plain,
            "prefill_logit_rms_err_kernels_vs_plain": err_kp}


def _kv_slots(cfg, capacity: int) -> str:
    """What one sequence's cache holds, for the report."""
    if cfg.attn is None:
        return "a Mamba state"
    w = cfg.attn.sliding_window
    return (f"a {min(w, capacity)}-slot sliding-window ring" if w is not None
            else f"{capacity} KV slots")


def _decode_vs_full_forward(cfg, params, batch: dict, dec, at: int, capacity: int) -> dict:
    """The graph step's logits ``dec`` at decode step ``at`` against the last
    logits of a prefill, through the kernels, of ``batch``: each row's prompt
    and its first ``at`` decoded inputs.  Within ``TOL_BF16`` (rms), and the
    same argmax wherever the prefill's top-2 gap exceeds twice the row's
    largest difference (the bf16 noise between the two paths).  Past a
    sliding window, this holds only if prefill leaves the ring as decode
    reads it."""
    from repro_torch.models import lm

    full, _ = lm.prefill(cfg, params, batch, capacity=capacity)
    B, n = next(iter(batch.values())).shape[:2]
    rms = _rms_rel(dec, full)
    noise = (dec.float() - full.float()).abs().max(dim=-1).values
    top2 = full.float().topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * noise
    same = dec.float().argmax(-1) == full.float().argmax(-1)
    print(f"[serve] decode step {at} (position {n - 1}) against a prefill of {B}x{n} "
          f"{'tokens' if cfg.embed_inputs else 'embeds'} through the kernels: rms {rms:.6f} "
          f"(tol {TOL_BF16}), max abs {noise.max().item():.5f}; argmax equal in "
          f"{int(same.sum())}/{same.numel()} rows, {int(decided.sum())} with a top-2 gap above "
          f"twice the difference, all of them equal: {bool(same[decided].all())}")
    if not rms <= TOL_BF16:
        raise AssertionError(f"decode step {at}: logits rms {rms} from the full forward's "
                             f"> {TOL_BF16}")
    if not bool(same[decided].all()):
        raise AssertionError(f"decode step {at}: argmax differs from the full forward's "
                             "where the top-2 gap exceeds the noise")
    return {"step": at, "positions": int(n), "rms_rel": rms,
            "max_abs": noise.max().item(), "argmax_equal": int(same.sum()),
            "decided": int(decided.sum())}


def image_positions(n: int, start: int, rows: int, cols: int) -> "np.ndarray":
    """[n, 3] M-RoPE positions (t, h, w): t is the index; over the image
    span of rows x cols patches from ``start``, h and w walk the grid
    (offset by the span's start), and a text token's h and w equal its t."""
    import numpy as np

    pos = np.repeat(np.arange(n)[:, None], 3, axis=1)
    patch = np.arange(rows * cols)
    pos[start:start + rows * cols, 1] = start + patch // cols
    pos[start:start + rows * cols, 2] = start + patch % cols
    return pos


def drive_embeds(arch: str, seed: int = 0) -> dict:
    """Drive a model that takes embeddings (Qwen2-VL) at full width through
    its entry points: ``lm.prefill`` over seeded embeds and M-RoPE
    positions, then decode steps on seeded embeds, each a replay of the
    captured step (``DecodeGraph``, the main path) with the eager step in
    turns beside it from its own prefill.  Each path's launches are counted
    over its own calls; checks as ``serve``'s."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.params import torch_dtype
    from repro_torch.serving.decode_graph import DecodeGraph

    cfg = get_config(arch)
    want = SERVED[arch]
    if _widths(cfg) != want["widths"]:
        raise AssertionError(f"{arch} is not at its published widths: {_widths(cfg)}")
    slots, capacity, S, steps = 4, want["capacity"], want["prompt"], 31
    dtype = torch_dtype(cfg.dtype)

    t0 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    embeds = torch.randn(slots, S + steps, cfg.d_model, generator=gen, device="cuda").to(dtype)
    positions = torch.from_numpy(image_positions(S + steps, *IMAGE_SPAN)).cuda()
    positions = positions.expand(slots, -1, -1)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name} full width: {n_params / 1e9:.3f} B params, bf16, "
          f"random init from seed {seed} in {time.perf_counter() - t0:.1f} s; embeds "
          f"[{slots}, {S}, {cfg.d_model}] from seed {seed + 1}, M-RoPE positions with an image "
          f"of {IMAGE_SPAN[1]}x{IMAGE_SPAN[2]} patches from token {IMAGE_SPAN[0]}")

    def prompt(n=S):
        return {"embeds": embeds[:, :n], "positions": positions[:, :n]}

    # warm-up at the same shapes (cuBLAS handles and heuristics, each
    # kernel's first load), before the counts are set to 0
    _, cache = lm.prefill(cfg, params, prompt(), capacity=capacity)
    for i in range(3):
        lm.decode_step(cfg, params, embeds[:, S + i:S + i + 1], cache, S + i)
    del cache

    ops.reset_launches()
    t0 = time.perf_counter()
    graph = DecodeGraph(cfg, params, lm.init_cache(cfg, slots, capacity, device="cuda",
                                                   dtype=dtype))
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    runs = {m: {"launches": dict.fromkeys(("rmsnorm", "flash_attention", "mamba_scan"), 0),
                "logits": [], "step_s": []} for m in ("graph", "eager")}

    def call(mode, fn, *args):
        """``fn(*args)`` synchronised, its launches counted for ``mode`` and
        its logits kept; returns its seconds."""
        before = ops.launch_counts()
        t = time.perf_counter()
        lg = fn(*args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = ops.launch_counts()
        for k in runs[mode]["launches"]:
            runs[mode]["launches"][k] += after[k] - before[k]
        runs[mode]["logits"].append(lg)
        return dt

    caches = {}

    def prefill(mode):
        lg, caches[mode] = lm.prefill(cfg, params, prompt(), capacity=capacity)
        if mode == "graph":  # into the buffers the captured step reads
            graph.load(caches.pop(mode))
        return lg

    def step(mode, i):
        e = embeds[:, S + i:S + i + 1]
        if mode == "graph":
            return graph.replay(e, S + i)
        return lm.decode_step(cfg, params, e, caches[mode], S + i)[0]

    torch.cuda.reset_peak_memory_stats()
    prefill_ms = {m: call(m, prefill, m) * 1e3 for m in ("graph", "eager")}
    for i in range(steps):  # in turns, the order swapped every step
        for m in ("eager", "graph") if i % 2 else ("graph", "eager"):
            runs[m]["step_s"].append(call(m, step, m, i))
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = {m: statistics.median(r["step_s"]) * 1e3 for m, r in runs.items()}
    res = {"requests": slots, "decode_steps": steps, "prefill_ms": prefill_ms["graph"],
           "prefill_ms_eager": prefill_ms["eager"], "decode_ms_per_step_median": med["graph"],
           "decode_ms_per_step_mean": statistics.fmean(runs["graph"]["step_s"]) * 1e3,
           "decode_ms_per_step_median_eager": med["eager"],
           "peak_mem_gb": peak, "launches": runs["graph"]["launches"],
           "launches_eager": runs["eager"]["launches"],
           "launches_per_replay": graph.launches, "graph_build_ms": build_ms}
    print(f"[serve] prefill {slots}x{S} embeds (cache of {capacity}, {_kv_slots(cfg, capacity)}): "
          f"{prefill_ms['graph']:.2f} ms (the eager path's, next: {prefill_ms['eager']:.2f} ms); "
          f"decode ms per step (host clock, median over {steps} steps each, in turns): graph "
          f"{med['graph']:.3f}, eager {med['eager']:.3f}; eager / graph "
          f"{med['eager'] / med['graph']:.2f}; step captured in {build_ms:.1f} ms; peak memory "
          f"{peak:.2f} GB (both caches resident)")
    print(f"[serve] launches over the graph path's calls: {runs['graph']['launches']}; per "
          f"replay of the captured step: {graph.launches}")

    per_forward = want["norms_per_layer"] * cfg.num_layers + 1
    if graph.launches != {**dict.fromkeys(graph.launches, 0), "rmsnorm": per_forward}:
        raise AssertionError(f"launches per replay {graph.launches}: want {per_forward} "
                             "rmsnorm and nothing else")
    want_launches = {"rmsnorm": per_forward * (1 + steps), "flash_attention": 0,
                     "mamba_scan": 0, **want["prefill"]}
    for mode, run in runs.items():
        if run["launches"] != want_launches:
            raise AssertionError(f"{mode} path: launches {run['launches']} != {want_launches}"
                                 f" ({per_forward} norms per forward, 1 prefill + {steps} "
                                 "decode steps)")
    max_abs, worst = 0.0, 0.0
    for i, (g, e) in enumerate(zip(runs["graph"]["logits"], runs["eager"]["logits"])):
        max_abs = max(max_abs, (g.float() - e.float()).abs().max().item())
        worst = max(worst, _rms_rel(g, e))
        if not worst <= TOL_BF16:
            raise AssertionError(f"logits {i}: graph {worst} rms from the eager path's "
                                 f"> {TOL_BF16}")
    print(f"[serve] graph against eager, same inputs: logits of {1 + steps} forwards: max abs "
          f"diff {max_abs:.6g}, worst rms {worst:.6g} (tol {TOL_BF16})")
    res["graph_vs_eager"] = {"logits_max_abs_diff": max_abs, "logits_worst_rms_rel": worst,
                             "forwards": 1 + steps}
    del caches["eager"]
    at = want["full_forward_at"]
    res["decode_vs_full_forward"] = _decode_vs_full_forward(
        cfg, params, prompt(S + at), runs["graph"]["logits"][at], at, capacity)
    res.update(_prefill_against_float32(cfg, params, prompt(), runs["graph"]["logits"][0],
                                        capacity))
    return res


def _autograd_library(fwd, n: int):
    """One PyTorch forward of ``n`` inputs and its backward through autograd,
    as a call on the kernel's arguments: ``(*args, grad_out) -> gradients of
    args[:n]``."""
    import torch

    def lib(*args):
        xs = [x.detach().requires_grad_() for x in args[:n]]
        return torch.autograd.grad(fwd(*xs), xs, args[-1])

    return lib


def _less_forward(case: dict, fwd: dict) -> None:
    """A backward case's ``library_ms`` (and warm) as the library's forward
    and backward less its forward, both timed in this run (cold where the
    case's times are)."""
    cold = fwd["cold"] if case["inputs"] == "cold" else fwd["warm"]
    for key, t in (("library_ms", cold), ("library_ms_warm", fwd["warm"])):
        case[f"{key}_forward_and_backward"] = case[key]
        case[key] = case[key] - t


def flash_train_cases(gen, fault_libs) -> tuple[list, list]:
    """Phase 8 (a): the training forward (with lse) and the flash backward
    against their plain versions at ``TRAIN_FLASH_SPECS``, with every
    planted fault of ``FLASH_BWD_FAULTS``; returns (forward cases, backward
    cases)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_bwd as fb_mod
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
    from repro_torch.kernels.ref import (dq_scaled_err, flash_attention_bwd_ref,
                                         flash_attention_ref, scaled_err)

    def bwd_err(got, want) -> float:
        return max(dq_scaled_err(got[0], want[0]),
                   *(scaled_err(a, b) for a, b in zip(got[1:], want[1:])))

    faults = {}
    for name, (_, _, label) in FLASH_BWD_FAULTS.items():
        faults.setdefault(label, []).append(name)
    fwd_cases, bwd_cases = [], []

    def slack(x):  # x as the head of a longer allocation, as flash_inputs makes them
        buf = torch.empty(x.numel() + 64, dtype=x.dtype, device=x.device)
        return buf[:x.numel()].view(x.shape).copy_(x)

    for label, BH, g, S, hd, hdv, window in TRAIN_FLASH_SPECS:
        q, k, v = flash_inputs(gen, BH, g, S, S, hd, hdv)
        do = torch.randn(BH, S, hdv, generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(group_size=g, causal=True, window=window)
        iters = 10 if BH * S <= 2**16 else 5  # fewer calls a graph where the plain one is long
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        want_o, want_lse = flash_attention_ref(q.float(), k.float(), v.float(), return_lse=True,
                                               **kw)
        want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                                       do.float(), **kw)
        errs = {"out": scaled_err(o, want_o), "lse": scaled_err(lse, want_lse),
                "dq": dq_scaled_err(got[0], want[0]), "dk": scaled_err(got[1], want[1]),
                "dv": scaled_err(got[2], want[2]),
                "delta": scaled_err(got[3], (do.float() * o.float()).sum(-1))}
        for name, err in errs.items():
            tol = TOL_F32 if name in ("lse", "delta") else TOL_BF16
            if not err <= tol:
                raise AssertionError(f"flash training {label}: {name} scaled err {err} > {tol}")
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):  # no atomics: the same bits
            raise AssertionError(f"flash training {label}: two backward calls differ")
        del again
        planted = {}
        o_s, do_s = slack(o), slack(do)  # a fault reading past a row's end reads memory
        for name in faults.get(label, []):
            saved = build._LIBS["flash_attention_bwd"]
            try:
                build._LIBS["flash_attention_bwd"] = build.load(fault_libs[name],
                                                                fb_mod._SIGNATURES)
                faulty = flash_attention_bwd_cuda(q, k, v, o_s, lse, do_s, **kw)[:3]
                torch.cuda.synchronize()
            finally:
                build._LIBS["flash_attention_bwd"] = saved
            f_err = bwd_err(faulty, want)
            print(f"[kernel] flash_attention_bwd planted fault {name} at {label}: scaled err "
                  f"{f_err:.6g} (sound {bwd_err(got[:3], want):.6g}, tol {TOL_BF16})")
            if f_err <= TOL_BF16:
                raise AssertionError(f"planted fault {name} passed the check: {f_err}")
            planted[name] = f_err if math.isfinite(f_err) else str(f_err)
            del faulty
        del o_s, do_s
        kv = f"kv[{BH // g},{S},{hd}]" if hdv == hd else f"k[{BH // g},{S},{hd}] v[..,{hdv}]"
        shape = (f"{label}: q[{BH},{S},{hd}] {kv} g={g} causal"
                 f"{f' window={window}' if window else ''} bf16")
        lib = flash_library(S, S, True, window)
        fwd = {"shape": f"{shape}, with lse", "scaled_err": max(errs["out"], errs["lse"]),
               "scaled_err_lse": errs["lse"],
               "max_abs_err": (o.float() - want_o).abs().max().item(),
               **_times(lambda q, k, v: flash_attention_cuda(q, k, v, return_lse=True, **kw),
                        lambda q, k, v: flash_attention_ref(q, k, v, return_lse=True, **kw),
                        lib, (q, k, v), iters=iters),
               **flash_bounds(BH, g, S, S, hd, True, window, hdv)}
        pairs = _attn_pairs(S, S, True, window)
        # q dq and k dk at hd, o do and v dv at hd_v, lse
        nbytes = 2 * (BH + BH // g) * S * (hd + hdv) * 2 + BH * S * 4
        bwd = {"shape": shape, "scaled_err": max(errs[n] for n in ("dq", "dk", "dv")),
               "scaled_err_delta": errs["delta"],
               "max_abs_err": max((a.float() - b).abs().max().item()
                                  for a, b in zip(got[:3], want)),
               **_times(lambda *a: flash_attention_bwd_cuda(*a, **kw)[:3],
                        lambda *a: flash_attention_bwd_ref(*a, **kw),
                        _autograd_library(lib, 3), (q, k, v, o, lse, do), iters=iters),
               "bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
               # P, dQ, dK at hd and dV, dP at hd_v over the unmasked pairs (P
               # and dP computed twice by the kernels, counted once)
               "bound_ops_ms": 2 * (3 * hd + 2 * hdv) * BH * pairs / PEAK_BF16_TC_FLOPS * 1e3}
        if planted:
            bwd["planted_fault_scaled_err"] = planted
        _less_forward(bwd, {"cold": fwd["library_ms"] if fwd["inputs"] == "cold" else None,
                            "warm": fwd["library_ms_warm"]})
        fwd_cases.append(fwd)
        bwd_cases.append(bwd)
        del q, k, v, o, lse, do, got, want, want_o
    return fwd_cases, bwd_cases


def rmsnorm_train_cases(gen, fault_libs) -> list:
    """Phase 8 (a): the RMSNorm backward against its plain version at
    ``TRAIN_RMSNORM_SPECS``, bf16, a second call to the same bits, and every
    planted fault of ``RMSNORM_BWD_FAULTS``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm_bwd as rb_mod
    from repro_torch.kernels.ref import rmsnorm_bwd_ref, scaled_err
    from repro_torch.kernels.rmsnorm_bwd import rmsnorm_bwd_cuda

    faults = {}
    for name, (_, _, shape) in RMSNORM_BWD_FAULTS.items():
        faults.setdefault(shape, []).append(name)
    cases = []
    for T, d in TRAIN_RMSNORM_SPECS:
        x, dy = (torch.randn(T, d, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        w = (torch.rand(d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        dx, dw = rmsnorm_bwd_cuda(x, w, dy)
        torch.cuda.synchronize()
        want_dx, want_dw = rmsnorm_bwd_ref(x.float(), w.float(), dy.float())
        err = max(scaled_err(dx, want_dx), scaled_err(dw, want_dw))
        if not err <= TOL_BF16:
            raise AssertionError(f"rmsnorm_bwd [{T},{d}]: scaled err {err} > {TOL_BF16}")
        if not all(torch.equal(a, b) for a, b in zip((dx, dw), rmsnorm_bwd_cuda(x, w, dy))):
            raise AssertionError(f"rmsnorm_bwd [{T},{d}]: two calls differ")
        planted = {}
        for name in faults.get((T, d), []):
            saved = build._LIBS["rmsnorm_bwd"]
            try:
                build._LIBS["rmsnorm_bwd"] = build.load(fault_libs[name], rb_mod._SIGNATURES)
                f_dx, f_dw = rmsnorm_bwd_cuda(x, w, dy)
                torch.cuda.synchronize()
            finally:
                build._LIBS["rmsnorm_bwd"] = saved
            f_err = max(scaled_err(f_dx, want_dx), scaled_err(f_dw, want_dw))
            print(f"[kernel] rmsnorm_bwd planted fault {name} at [{T},{d}]: scaled err "
                  f"{f_err:.6g} (sound {err:.6g}, tol {TOL_BF16})")
            if f_err <= TOL_BF16:  # a faulty output of NaNs fails the check too
                raise AssertionError(f"planted fault {name} passed the check: {f_err}")
            planted[name] = f_err if math.isfinite(f_err) else str(f_err)
            del f_dx, f_dw

        def lib_fwd(x, w, d=d):
            return F.rms_norm(x, (d,), w, 1e-6)

        case = {
            "shape": f"x, dy[{T},{d}] bf16", "scaled_err": err,
            "max_abs_err": max((dx.float() - want_dx).abs().max().item(),
                               (dw.float() - want_dw).abs().max().item()),
            **_times(lambda x, w, dy: rmsnorm_bwd_cuda(x, w, dy),
                     lambda x, w, dy: rmsnorm_bwd_ref(x, w, dy), _autograd_library(lib_fwd, 2),
                     (x, w, dy), iters=100),
            "bound_bytes_ms": (3 * T * d + 2 * d) * 2 / PEAK_BYTES_PER_S * 1e3,
            "bound_ops_ms": 10 * T * d / PEAK_FP32_FLOPS * 1e3,
        }
        if planted:
            case["planted_fault_scaled_err"] = planted
        _less_forward(case, _ms(lib_fwd, (x, w), iters=100))
        cases.append(case)
        del x, dy, w, dx, dw
    return cases


def scan_train_cases(gen, fault_libs) -> list:
    """Phase 8 (a): the selective scan's backward against its plain version
    at ``TRAIN_SCAN_SPECS``, every output (ga, gb, gc, gh0) at ``TOL_F32``,
    a second call to the same bits, and every planted fault of
    ``MAMBA_BWD_FAULTS``.  No PyTorch call computes a scan's gradient:
    ``library_ms`` is None."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import mamba_scan_bwd as sb_mod
    from repro_torch.kernels.mamba_scan_bwd import (mamba_scan_bwd_cuda,
                                                    mamba_scan_bwd_workspace_bytes)
    from repro_torch.kernels.ref import mamba_scan_bwd_ref, scaled_err

    names = ("ga", "gb", "gc", "gh0")

    def errs(got, want) -> dict:
        return {n: scaled_err(g, w) for n, g, w in zip(names, got, want)}

    def kernel(a, b, c, gy, h0=None, gh=None):
        return mamba_scan_bwd_cuda(a, b, c, h0, gy, gh)

    def plain(a, b, c, gy, h0=None, gh=None):
        return mamba_scan_bwd_ref(a, b, c, h0, gy, gh)

    faults = {}
    for name, (_, _, label) in MAMBA_BWD_FAULTS.items():
        faults.setdefault(label, []).append(name)
    cases = []
    for label, B, S, di, N, with_h0 in TRAIN_SCAN_SPECS:
        a = torch.rand(B, S, di, N, generator=gen, device="cuda") * 0.9
        b = torch.randn(B, S, di, N, generator=gen, device="cuda") * 0.1
        c = torch.randn(B, S, N, generator=gen, device="cuda")
        gy = torch.randn(B, S, di, generator=gen, device="cuda")
        args = (a, b, c, gy)
        if with_h0:
            args += tuple(torch.randn(B, di, N, generator=gen, device="cuda") * 0.1
                          for _ in range(2))
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        err = errs(got, want)
        if not max(err.values()) <= TOL_F32:
            raise AssertionError(f"mamba_scan_bwd {label}: scaled err {err} > {TOL_F32}")
        if not all(torch.equal(x, y) for x, y in zip(got, kernel(*args))):  # no atomics
            raise AssertionError(f"mamba_scan_bwd {label}: two calls differ")
        bitwise = {n: torch.equal(g, w) for n, g, w in zip(names, got, want)}
        planted = {}
        for name in faults.get(label, []):
            saved = build._LIBS["mamba_scan_bwd"]
            try:
                build._LIBS["mamba_scan_bwd"] = build.load(fault_libs[name], sb_mod._SIGNATURES)
                faulty = kernel(*args)
                torch.cuda.synchronize()
            finally:
                build._LIBS["mamba_scan_bwd"] = saved
            f_err = max(errs(faulty, want).values())
            print(f"[kernel] mamba_scan_bwd planted fault {name} at {label}: scaled err "
                  f"{f_err:.6g} (sound {max(err.values()):.6g}, tol {TOL_F32})")
            if f_err <= TOL_F32:  # a faulty output of NaNs fails the check too
                raise AssertionError(f"planted fault {name} passed the check: {f_err}")
            planted[name] = f_err if math.isfinite(f_err) else str(f_err)
            del faulty
        # each input read once (a, b, c, gy, h0, gh_fin), each output written
        # once (ga, gb, gc, gh0)
        nbytes = 4 * (sum(t.numel() for t in args) + 2 * B * S * di * N + B * S * N
                      + B * di * N)
        case = {
            "shape": f"{label}: a/b[{B},{S},{di},{N}]{' h0 gh_fin' if with_h0 else ''} fp32",
            "max_abs_err": max((g - w).abs().max().item() for g, w in zip(got, want)),
            "scaled_err": max(err.values()), **{f"scaled_err_{n}": e for n, e in err.items()},
            "bit_for_bit": bitwise,
            "workspace_bytes": mamba_scan_bwd_workspace_bytes(B, S, di, N),
            **_times(kernel, plain, None, args, iters=2),
            "bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            # per state element and step: h (mul, add), g (2 mul, add), ga
            # (mul), gc's term (mul, add)
            "bound_ops_ms": 8 * B * S * di * N / PEAK_FP32_FLOPS * 1e3,
        }
        if planted:
            case["planted_fault_scaled_err"] = planted
        print(f"[kernel] mamba_scan_bwd {label}: scaled err {err}; bit for bit with the plain "
              f"version: {bitwise}")
        cases.append(case)
        del a, b, c, gy, args, got, want
    return cases


def _config(arch: str, layers: int):
    """``arch`` at its published widths and ``layers`` of its layers."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=layers)


def _launches_per_step(cfg) -> dict:
    """The kernels' launches one train step implies, in each of its M
    microbatches: every layer's forward once, and once more in the backward
    under remat; every layer's backward once; the final norm once each way.
    An attention layer launches flash, a Mamba layer the selective scan; a
    layer has its first norm, a second one unless its FFN is "none"
    (Falcon-Mamba), and MLA's q_norm (with a q_lora_rank) and kv_norm."""
    L, M, a = cfg.num_layers, cfg.parallel.microbatches, cfg.attn
    r = 2 if cfg.parallel.remat else 1
    specs = [cfg.layer_pattern[i % len(cfg.layer_pattern)] for i in range(L)]
    attn = sum(s.mixer == "attn" for s in specs)
    mla = 1 + bool(a.q_lora_rank) if a is not None and a.kind == "mla" else 0
    n = sum(1 + (s.ffn != "none") + (mla if s.mixer == "attn" else 0) for s in specs)
    out = {}
    if attn:
        out.update(flash_attention=r * attn * M, flash_attention_bwd=attn * M)
    if L - attn:
        out.update(mamba_scan=r * (L - attn) * M, mamba_scan_bwd=(L - attn) * M)
    return {**out, "rmsnorm": (r * n + 1) * M, "rmsnorm_bwd": (n + 1) * M}


def _step_share(g, norm: float):
    """A first AdamW step's share of ``lr`` per element, ``c g / (|c g| +
    eps)`` (``c`` the clip factor of the gradients' global norm), float32."""
    cg = g.float() * min(1.0, 1.0 / max(norm, 1e-9))
    return cg / (cg.abs() + 1e-8)


def train_path_against_plain(arch: str, seq: int, seed: int = 0) -> dict:
    """Phase 8 (b): one train step of ``arch`` at full width and 2 layers
    (batch ``TRAIN_BATCH`` x ``seq`` in the config's 8 microbatches, remat)
    through the kernels, and the same step through their plain versions,
    from the same parameters and batch.  The loss within ``LOSS_TOL``
    (relative), ``grad_norm`` and every gradient (rms over its leaf) within
    the bf16 tolerance, and every updated parameter within what the two
    gradients imply for a first AdamW step (``lr`` times the difference of
    the shares of ``_step_share``), one bf16 unit in the last place of the
    larger result (each rounds once, by at most half of one), and 8 float32
    units at the scale of the update's terms (``|p| + lr``)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.params import map_tree
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state, leaves
    from repro_torch.training.train_step import batch_to, grad_and_metrics

    cfg = _config(arch, 2)
    L, M = cfg.num_layers, cfg.parallel.microbatches
    opt_cfg = OptConfig(learning_rate=3e-4, warmup_steps=1)
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(seed))
    batch = batch_to(make_batch(cfg, TRAIN_BATCH, seq, seed=seed), "cuda")
    runs = {}
    for mode in ("kernels", "plain"):
        p = map_tree(lambda _, t: t.clone(), params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_kernels() if mode == "plain" else contextlib.nullcontext():
            ops.reset_launches()
            grads, metrics = grad_and_metrics(cfg, p, batch)
            launches = ops.launch_counts()
            p, _, info = adamw_update(grads, init_opt_state(p, opt_cfg), p, opt_cfg)
        torch.cuda.synchronize()
        runs[mode] = {"grads": leaves(grads), "params": leaves(p), "launches": launches,
                      "seconds": time.perf_counter() - t0,
                      **{k: float(v) for k, v in {**metrics, **info}.items()}}
        del grads, p
        gc.collect()
    kern, plain = runs["kernels"], runs["plain"]
    want = {**dict.fromkeys(kern["launches"], 0), **_launches_per_step(cfg)}
    if kern["launches"] != want or any(plain["launches"].values()):
        raise AssertionError(f"{arch} launches: kernels {kern['launches']} (want {want}), "
                             f"plain {plain['launches']} (want none)")
    loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    gnorm_rel = abs(kern["grad_norm"] - plain["grad_norm"]) / plain["grad_norm"]
    grad_rms = max(_rms_rel(a, b) for a, b in zip(kern["grads"], plain["grads"]))
    norms = (kern["grad_norm"], plain["grad_norm"])
    worst_step, worst_at = 0.0, None
    for j, (pk, pp, gk, gp, pb) in enumerate(zip(kern["params"], plain["params"], kern["grads"],
                                                 plain["grads"], leaves(params))):
        # each result rounds to bf16 once: half a unit in the last place of each
        big = torch.maximum(pk.float().abs(), pp.float().abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        # and the float32 rounding of the update's terms, |p| and lr: where they
        # cancel (p near lr), that is the larger part of the difference
        terms = pb.float().abs() + opt_cfg.learning_rate
        bound = opt_cfg.learning_rate * (_step_share(gk, norms[0]) -
                                         _step_share(gp, norms[1])).abs() + ulp + 2**-21 * terms
        ratio = (pk.float() - pp.float()).abs() / bound
        i = int(ratio.argmax())
        if ratio.flatten()[i].item() > worst_step:
            worst_step = ratio.flatten()[i].item()
            worst_at = {"leaf": j, "shape": list(pk.shape), "index": i, **{
                n: t.flatten()[i].item() for n, t in (("p_kernels", pk), ("p_plain", pp),
                                                      ("p_before", pb),
                                                      ("g_kernels", gk), ("g_plain", gp))}}
    res = {"config": f"{arch}, {L} layers, full width", "batch": [TRAIN_BATCH, seq],
           "microbatches": M, "loss": {m: r["loss"] for m, r in runs.items()},
           "grad_norm": {m: r["grad_norm"] for m, r in runs.items()},
           "loss_rel_diff": loss_rel, "grad_norm_rel_diff": gnorm_rel,
           "grads_worst_rms_rel": grad_rms, "params_worst_over_bound": worst_step,
           "params_worst_element": worst_at,
           "launches": kern["launches"], "seconds": {m: r["seconds"] for m, r in runs.items()}}
    print(f"[train] kernel path against plain path, one step of {arch} at full width and {L} "
          f"layers ({TRAIN_BATCH} x {seq}, {M} microbatches): loss {kern['loss']:.6f} "
          f"against {plain['loss']:.6f} (rel {loss_rel:.3g}, tol {LOSS_TOL}); grad_norm "
          f"{kern['grad_norm']:.6f} against {plain['grad_norm']:.6f} (rel {gnorm_rel:.3g}, tol "
          f"{TOL_BF16}); worst gradient rms rel {grad_rms:.3g} (tol {TOL_BF16}); updated "
          f"params: worst |diff| over its bound {worst_step:.3g} (tol 1); launches "
          f"{kern['launches']}; host seconds kernels {kern['seconds']:.2f}, plain "
          f"{plain['seconds']:.2f}")
    if not (loss_rel <= LOSS_TOL and gnorm_rel <= TOL_BF16 and grad_rms <= TOL_BF16
            and worst_step <= 1.0):
        raise AssertionError(f"kernel path against plain path: {res}")
    return res


#: Mamba's leaves that no product reads: the decay's log (an exponent), the
#: skip and the biases (elementwise)
_MAMBA_ELEMENTWISE = ("a_log", "d_skip", "conv_b", "dt_b")


def _model_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 per token and weight of every
    product (the embedding table is a lookup, but also the head where it is
    tied; the norms' weights and Mamba's ``_MAMBA_ELEMENTWISE`` leaves are
    no product; Mamba's depthwise conv is one), and the attention layers'
    QK^T and PV over the unmasked pairs, forward and backward (3x).  The
    selective scan is elementwise (a multiply and an add per state element
    and step) and counts no FLOPs."""
    from repro_torch.models import lm

    lookup = 0
    for path, leaf in _leaf_paths(lm.model_meta(cfg)):
        name = path.rsplit("/", 1)[-1]
        if (name.endswith("norm") or (name == "embedding" and not cfg.tie_embeddings)
                or name in _MAMBA_ELEMENTWISE):
            lookup += math.prod(leaf.shape)
    out = 6 * (n_params - lookup) * batch * seq
    a = cfg.attn
    if a is None:
        return out
    hd_qk, hd_v = (a.qk_head_dim, a.v_head_dim) if a.kind == "mla" else (a.head_dim,) * 2
    pairs = _attn_pairs(seq, seq, True, a.sliding_window)
    layers = sum(cfg.layer_pattern[i % len(cfg.layer_pattern)].mixer == "attn"
                 for i in range(cfg.num_layers))
    return out + 6 * pairs * (hd_qk + hd_v) * a.num_heads * layers * batch


def train_full_width(arch: str, layers: int, steps: int, seq: int, seed: int = 0) -> dict:
    """Phase 8 (c): ``launch/train.py``'s loop on ``arch`` at full width and
    ``layers`` layers, ``steps`` steps (the first a warm-up) on one repeated
    batch of ``TRAIN_BATCH`` x ``seq`` tokens; returns its numbers and the
    kernels' launches over the run."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.training.optimizer import OptConfig

    cfg = _config(arch, layers)
    L, M = cfg.num_layers, cfg.parallel.microbatches
    # the published widths but the depth (the first of them), bf16, the
    # config's 8 microbatches, remat
    if (_widths(cfg)[1:], M, cfg.parallel.remat) != (SERVED[arch]["widths"][1:], TRAIN_BATCH,
                                                     True):
        raise AssertionError(f"not {arch}'s published widths and microbatches: {cfg}")
    n_params = sum(math.prod(m.shape) for m in _leaves(lm.model_meta(cfg)))
    tokens = TRAIN_BATCH * seq
    model_flops = _model_flops(cfg, n_params, TRAIN_BATCH, seq)
    want = _launches_per_step(cfg)
    per_step = []
    last = {}

    def on_step(step, metrics, seconds):
        now = ops.launch_counts()
        per_step.append({k: now[k] - last.get(k, 0) for k in now})
        last.update(now)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # the main path's counts start here
    out = train(cfg, OptConfig(learning_rate=3e-4, warmup_steps=1), steps=steps,
                batch=TRAIN_BATCH, seq=seq, corpus_size=1, seed=seed, device="cuda",
                log_every=1, arch=arch, on_step=on_step)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del out["state"]
    gc.collect()
    torch.cuda.empty_cache()
    hist = out["history"]
    for i, counts in enumerate(per_step):
        if counts != {**dict.fromkeys(counts, 0), **want}:
            raise AssertionError(f"{arch} step {i}: launches {counts}, want {want}")
    losses = [h["loss"] for h in hist]
    if not (len(losses) == steps and all(map(math.isfinite, losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"{arch}: the loss did not fall: {losses}")
    steady = statistics.median(h["seconds"] for h in hist[1:])
    res = {"config": f"{arch}, {L} layers, full width", "params": n_params,
           "batch": [TRAIN_BATCH, seq], "microbatches": M, "remat": True,
           "steps": steps, "losses": losses,
           "grad_norm": [h["grad_norm"] for h in hist], "lr": [h["lr"] for h in hist],
           "step_s": [h["seconds"] for h in hist], "step_s_median_after_first": steady,
           "tokens_per_s": tokens / steady, "model_flops_per_step": model_flops,
           "mfu": model_flops / (steady * PEAK_BF16_TC_FLOPS), "peak_mem_gb": peak,
           "launches_per_step": want, "launches": launches}
    for h in hist:
        print(f"[train] {arch} x{L} step {h['step']}: loss {h['loss']:.6f}, grad_norm "
              f"{h['grad_norm']:.4f}, lr {h['lr']:.3g}, {h['seconds']:.3f} s (host clock, "
              f"synchronised)")
    print(f"[train] {arch} at full width, {L} layers ({n_params:,} parameters), "
          f"{TRAIN_BATCH} x {seq} tokens in {M} microbatches, remat: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} in {steps} steps; step {steady:.3f} s "
          f"(median after the first), {tokens / steady:,.0f} tokens/s, model FLOPs "
          f"{model_flops:.4g} a step = {res['mfu']:.3f} of 989 TFLOP/s; peak memory "
          f"{peak:.2f} GB; launches per step {want}, as the code implies")
    return res


def train_checkpoint(seed: int = 0) -> dict:
    """Phase 8 (d): at the smoke config's size on the card, a run stopped at
    its checkpoint (saved after step 2) and resumed takes step 3 to the
    loss, parameters and optimizer state of a run that never stopped, bit
    for bit."""
    import shutil

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train
    from repro_torch.models.params import map_tree
    from repro_torch.training.optimizer import OptConfig

    cfg = get_smoke_config("yi_6b")
    kw = dict(batch=8, seq=128, seed=seed, device="cuda", log_every=100, arch="yi_6b")
    opt_cfg = OptConfig(learning_rate=1e-3, warmup_steps=2)
    d = OUT_DIR / "train_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    full = train(cfg, opt_cfg, steps=4, **kw)
    first = train(cfg, opt_cfg, steps=3, ckpt_dir=str(d), ckpt_every=2, **kw)
    rest = train(cfg, opt_cfg, steps=4, ckpt_dir=str(d), ckpt_every=2, **kw)
    shutil.rmtree(d, ignore_errors=True)
    unequal = []
    map_tree(lambda path, a, b: unequal.append(path) if not torch.equal(a, b) else None,
             full["state"], rest["state"])
    losses = [h["loss"] for h in first["history"] + rest["history"]]
    ok = ([h["step"] for h in rest["history"]] == [3] and not unequal
          and losses == [h["loss"] for h in full["history"]])
    print(f"[train] checkpoint at the smoke size: stopped after step 2, resumed at step 3: "
          f"losses {losses} against {[h['loss'] for h in full['history']]}; parameters and "
          f"optimizer state equal bit for bit: {not unequal}")
    if not ok:
        raise AssertionError(f"the resumed run differs: steps "
                             f"{[h['step'] for h in rest['history']]}, unequal {unequal[:5]}")
    return {"losses": losses, "resumed_at": 3, "state_equal": True}


def _leaf_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{path}/{k}")
    else:
        yield path, tree


def _leaves(tree):
    return (leaf for _, leaf in _leaf_paths(tree))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(no src/repro_torch)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = card()
    phase_s = {}
    mark = [time.perf_counter()]

    def done(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase] = now - mark[0]
        mark[0] = now

    fault_libs = build_kernels()
    done("build")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rms = rmsnorm_cases(gen)
    fla = flash_cases(gen, fault_libs)
    mam = mamba_cases(gen)
    for name, cases, tol in (("rmsnorm", rms, TOL_BF16), ("flash_attention", fla, TOL_BF16),
                             ("mamba_scan", mam, TOL_F32)):
        _print_cases(name, cases, tol)
    done("kernels")

    served = {}
    for arch in SERVED:  # one model on the card at a time
        gc.collect()
        torch.cuda.empty_cache()
        served[arch] = (serve(arch, smi=smi) if get_config(arch).embed_inputs
                        else drive_embeds(arch))
        done(f"serve {arch}")
    gc.collect()
    torch.cuda.empty_cache()

    pack = pack_cases(gen, fault_libs)
    _print_cases("a2a_pack", pack, 0)
    done("a2a_pack")
    ranks = collectives_phase()
    done("collectives")

    gc.collect()
    torch.cuda.empty_cache()
    fwd_train, bwd_train = flash_train_cases(gen, fault_libs)
    rms_train = rmsnorm_train_cases(gen, fault_libs)
    scan_train = scan_train_cases(gen, fault_libs)
    for name, cases, tol in (("flash_attention (training forward)", fwd_train, TOL_BF16),
                             ("flash_attention_bwd", bwd_train, TOL_BF16),
                             ("rmsnorm_bwd", rms_train, TOL_BF16),
                             ("mamba_scan_bwd", scan_train, TOL_F32)):
        _print_cases(name, cases, tol)
    done("train kernels")
    gc.collect()
    torch.cuda.empty_cache()
    train = {"path_against_plain": {}, "full_width": {}}
    for arch, seq in TRAIN_AGAINST_PLAIN:
        train["path_against_plain"][arch] = train_path_against_plain(arch, seq)
        gc.collect()
        torch.cuda.empty_cache()
        done(f"train step against plain {arch}")
    for arch, layers, steps, seq in TRAIN_FULL_WIDTH:  # the main path's runs
        train["full_width"][f"train {arch} x{layers}"] = train_full_width(arch, layers, steps,
                                                                          seq)
        done(f"train full width {arch}")
    train["checkpoint"] = train_checkpoint()
    done("train checkpoint")
    runs = {run: r["launches"] for run, r in train["full_width"].items()}

    def by_model(k):
        return {**{a: r["launches"][k] for a, r in served.items()},
                **{run: n[k] for run, n in runs.items()}}

    kernels = [
        kernel_entry("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                     "src/repro/kernels/rmsnorm.py:27", rms, by_model("rmsnorm")),
        kernel_entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:99", fla + fwd_train,
                     by_model("flash_attention")),
        kernel_entry("mamba_scan", "src/repro_torch/kernels/csrc/mamba_scan.cu",
                     "src/repro/kernels/mamba_scan.py:60", mam, by_model("mamba_scan"),
                     tolerance=TOL_F32),
        kernel_entry("a2a_pack", "src/repro_torch/kernels/csrc/a2a_pack.cu",
                     "src/repro/kernels/a2a_pack.py:27", pack,
                     {f"ep_dispatch rank {r['rank']}": r["launches"]["a2a_pack"]
                      for r in ranks}, tolerance=0),
        kernel_entry("flash_attention_bwd",
                     "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                     "src/repro/models/flash.py:108", bwd_train,
                     {run: n["flash_attention_bwd"] for run, n in runs.items()}),
        kernel_entry("rmsnorm_bwd", "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                     "src/repro/models/layers.py:40", rms_train,
                     {run: n["rmsnorm_bwd"] for run, n in runs.items()}),
        kernel_entry("mamba_scan_bwd", "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
                     "src/repro/models/mamba.py:112", scan_train,
                     {run: n["mamba_scan_bwd"] for run, n in runs.items()}, tolerance=TOL_F32),
    ]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "kernels": kernels, "serve": served, "collectives": ranks,
         "train": train}, indent=1))
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()) + ")")
    print(smi)
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
