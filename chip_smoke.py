#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a GPU

Phases, each reported on its own lines:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: every CUDA kernel of ``src/repro_torch/kernels/csrc`` compiled
   with ``nvcc`` (one process per source, all at once);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the serving paths of the served models give it plus ragged,
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
   rotary part, left out of the scores).  A planted copy of a source keeps,
   of its dispatch lines, the instance its fault's case runs alone
   (``planted_source``).  The fused selective scan (the
   Mamba layer's path: it forms ``a = exp(dt A)`` and ``b = (dt x) B`` from
   the layer's dt, x, B and A itself) at Falcon-Mamba-7B's prefill (dt and
   x [4, 512, 8192] bf16), a ragged S = 300, with h0 (float32 inputs), at
   N = 8 and at Jamba-1.5-Large's prefill (dt and x [4, 512, 16384] bf16)
   (y and h_last at 1e-5; whether h_last matches bit for bit is
   printed), each timed in turns against the path it replaces (the terms
   formed by PyTorch, then the unfused scan), with faults planted in copies
   of its source (dt A used in place of dt x, the readout's last shuffle
   left out, each tile's last step dropped) that must each fail the check;
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
   checked the same way: every RMSNorm and every prefill selective scan
   (the fused kernel, 64 launches a Falcon-Mamba prefill) or attention
   must go through the kernels.  Danube serves prompts of 4608
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
   flash at q/k 192 and v 128), and Jamba-1.5-Large, the hybrid, at its
   first 4 of 72 layers (``configs.first_layers``: attention + MoE, Mamba +
   dense, Mamba + MoE, Mamba + dense; 22,996,213,760 parameters, which must
   equal the cut config's ``param_count()``; a whole period of 8 would not
   fit): its slot cache holds a KV cache beside Mamba conv windows and
   states, and its prefill launches flash once (64 heads, GQA group 8) and
   the fused scan three times (d_inner 16384), RMSNorm 9 times a forward
   at d 8192.  The float32 reference prefill casts each weight where it
   reads it (``float32_reads``), so its float32 copy never holds more than
   one layer's weights; where that layer's float32 copy would not fit
   beside the bf16 model (Jamba's MoE layers, up to 40.30 GB), the bf16
   layers move to the host first and each read copies its layer back.  Last, full-width
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
   full-lane call; then differentiates the loss ``sum(w * y)`` of the
   dispatched rows through each, whose gradients must equal each other and
   their numpy oracle bit for bit, with 4 ``a2a_pack`` launches per
   full-lane call with its backward; sums a 25 MiB float32 gradient bucket
   (and one element more: the pad path) hierarchically, against the flat
   sum; and broadcasts (full-lane; k-ported, k = 1, 2, 3) and scatters
   (k-ported, k = 2) a 25 MiB payload, exactly.  Then the backward of
   every other collective (both sums, at the bucket and one more, the
   full-lane broadcast from pod 1, the k-ported broadcasts, the k-ported
   scatter from rank 5), for seeded bf16 cotangents, against the numpy
   oracle of its transpose: the sums in ``ref.scaled_err`` at 2e-2, the
   scatter's gather bit for bit, exact zeros where the transpose gives
   none.  Its times are host-clock times of host-staged gloo, not
   interconnect numbers.  The same job then runs in this process as one
   NCCL rank (a world of one: no peer, but the transport's NCCL branch,
   which must stage nothing);
8. training.  (a) The training forward's lse and the flash backward
   kernel against their plain versions at Yi's training shape (q [32,
   2048, 128], kv [4, 2048, 128], g = 8, causal), a ragged S = 300, a
   window of 100 and the smoke head dim 16, and at every other head-dim
   pair: one microbatch of Gemma (q, k, v [16, 2048, 256]), Danube (q [32,
   4608, 120], kv [8, 4608, 120], window 4096, past the window), MusicGen
   ([32, 2048, 64]), MiniCPM3 (q/k [40, 2048, 96], v [.., 64]) and
   DeepSeek-V2 (q/k [128, 2048, 192], v [.., 128]), the smoke pair (24,
   16), a ragged S = 300 at 256 and at (96, 64), a window edge inside a
   tile at 120, and Qwen2-VL's group of 7 (q [28, 2048, 128], kv [4, 2048,
   128]: the last dK/dV slice of 2 heads holds one) (dq, dk, dv at 2e-2 in
   ``ref.scaled_err``, dq's first row
   in ``ref.dq_scaled_err``; lse and delta at 1e-5; a second call of the
   backward to the same bits), faults planted in copies of the backward's
   source (delta dropped, dK/dV summed over one head of the group, the
   diagonal tile unmasked, the last head slice's dK/dV partial left out of
   their sum; the MLA pair's dV partial written at the q/k width and its
   delta read at it, hd 256's second column half of dK dropped, hd 120's
   pad columns left unzeroed; at the group of 7 the odd last head left out
   of its slice, and the slice count rounded down) must each fail that check;
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
   of the sum), which must each fail that check; the fused scan's
   backward at the same four cases at Falcon-Mamba's training microbatch
   (dt and x [1, 2048, 8192] bf16; gdt, gx, gB, gC, gA and gh0 at 1e-5, the
   first four as float32 sums against the plain version's and, in the
   inputs' dtype, equal to those sums cast; a second call to the same
   bits), timed in turns against the path it replaces (the terms,
   ``mamba_scan_bwd`` and the terms' backward through autograd), with
   faults planted in copies of its source (the gh_fin seed dropped, the
   carry lost at a chunk edge, the last CTA's gB partial left out of the
   sum, dt A used in place of dt x in gB's term), which must each fail
   that check; each timed as in phase
   3, beside its plain version and SDPA's (or ``F.rms_norm``'s) backward
   through autograd (the forward and backward less the forward; SDPA
   takes Danube's window as a mask; no PyTorch call computes a scan's
   gradient).  (b) One train step at full width and
   2 layers of Yi-6B, H2O-Danube3-4B (sequences of 4608, so the window
   masks), Gemma-7B, MusicGen-Large, MiniCPM3-4B, Falcon-Mamba-7B and
   Qwen2-VL-7B (float32 embeds, not tokens), each
   through the kernels and through their plain versions, from the same
   parameters and batch (8 microbatches of 1 sequence): loss,
   ``grad_norm``, every gradient and every updated parameter must agree.
   (c) ``launch/train.py``'s loop at full width on Yi-6B at 16 of its 32
   layers for 6 steps, Gemma-7B at 10 of its 28, MiniCPM3-4B at all 62,
   H2O-Danube3-4B at all 24 (sequences of 4608, past its window),
   MusicGen-Large at all 48, Falcon-Mamba-7B at 32 of its 64 and
   Qwen2-VL-7B at 14 of its 28 on embeds for 4 (the depth whose AdamW
   state fits the card), batch 8 x 2048 in 8 microbatches
   with remat, one repeated batch, learning rate 3e-4 after 1 warmup step:
   the loss must fall, and each step must launch the kernels as the code
   implies (flash forward 2LM, backward LM, or for Mamba layers the fused
   scan's forward 2LM and backward LM; RMSNorm forward (2nL+1)M, backward
   (nL+1)M, n the norms of a layer: 2, 1 for Falcon-Mamba's, 4 with MLA's);
   step time, tokens/s, model FLOPs per second over the card's peak and
   peak memory are printed, and what ``torch.cuda.memory_allocated`` holds
   between steps is kept for phase 9 (a).  (d) At the
   smoke config's size: a run stopped at its checkpoint and resumed takes
   its next step to the loss, parameters and optimizer state of a run that
   never stopped, bit for bit;
9. the dry-run (``launch/dryrun.py``).  (a) Each run of phase 8 (c)
   through the dry-run at its config and batch on a (1, 1) mesh (the
   one-card step, computed on the host beside phase 8): its arguments plus
   its ``peak_bytes`` against the run's ``torch.cuda.max_memory_allocated``
   above what the card held before it, as a ratio (``peak_check``: every
   ratio printed and held to its band, ``PEAK_BAND``, and each record with
   its ``peak_bytes`` halved must fall outside the band); the card
   anchor, Yi-6B at 16 layers: its predicted bytes of parameters and AdamW
   state within 1% of what ``torch.cuda.memory_allocated`` holds between
   its steps.  (b)
   ``--all --mesh both`` for the ``xla`` and ``fulllane`` backends, none
   of the processes seeing the card: every cell ``ok`` or skipped by
   ``cell_eligible``, no error; each ``fulllane`` train cell's cross-pod
   bytes per rank of the shard_map step's gradient sync on 2 x 16 x 16 are
   printed.  The ``xla`` cells run the reference's own sharded programs
   (the production step, the sharded prefill and decode step) as rank 0
   over a fake process group of the mesh's size, on meta shards; the
   sweep runs in eight processes at once (each (backend, mesh) for every
   other config) at the lowest CPU priority, started before phase 8 so
   that it runs on the host while phase 8 runs on the card.  (c) After phase 10: the dry-run's sharded cells of the
   programs phase 10 (b) and (f) run, at their configs, shapes and meshes
   (``dryrun_cells``, computed beside (b)), against rank 0 of those runs:
   argument bytes per rank equal to what it holds (parameters and AdamW
   moments; parameters, cache and tokens), and the collectives by kind,
   bytes and counts, equal to what it issued (``CollectiveBytes``; a train
   step's: one microbatch's times their number, and the update); and each
   cell's arguments plus ``peak_bytes`` against every rank's
   ``max_memory_allocated`` less what it held beside its arguments when its
   peak was reset (``peak_check``, as in (a)).  The
   dry-run's numbers are counts from shapes, not card times;
10. sharded training (``training/train_step.make_train_step_sharded``
   and the shard_map step with TP) on this card, in 8 ranks over gloo as a
   (pod 2, data 2, model 2) ``DeviceMesh`` whose groups stage every
   collective through pinned host memory (``core/groups.StagedGroup``;
   NCCL admits no two ranks on one device).  The one-rank references of
   (a), (d) and (f) run at once, each in a process of its own, beside
   phase 7's ranks and done before phase 8 (``phase10_references``).  (a)
   In a process of its own,
   the one-rank step through the kernels (phase 8 (b)'s) of full-width
   Yi-6B and Falcon-Mamba-7B at 2 layers on 16 x 2048 tokens in 4
   microbatches, and two readings of it that place (b)'s limits: the same
   step in 16 microbatches of one row, a data-parallel rank's rows at a
   time (another summation order) must pass (b)'s checks
   with room (first moments within half their limit), and the step without
   one data-parallel rank's rows must fail them (first moments at twice
   their limit or more, parameters over their allowance).
   (b) In the ranks, from the same seeded parameters and batch, one step of
   the sharded step (FSDP and TP parameters, ZeRO-1 moments) and one of the
   ``fulllane`` shard_map step (TP parameters): loss and ``grad_norm``
   within 2e-2 (relative) of the one-rank step's, every first moment
   within 5e-2 (rms over its leaf, as phase 8 (b) holds gradients) and
   every updated parameter within 2e-2 in its scale, or, where the
   one-rank step's own first moment lies within half its leaf's rms of
   zero, within a sign flip of the first AdamW step
   (``_param_check``), each element checked on the rank that holds it;
   each rank's launches
   those of the one-rank step, every kernel wrapper's input at
   the rank's shard (its rows, its heads, its channels); per rank, the
   parameter and AdamW bytes (at most 1.05 times 1/(data model) of a
   replica's for the sharded step, 1/model for the parameters of the TP
   step), peak memory, the collectives by op (``CommDebugMode``), the
   bytes staged through the host and the step's host-clock seconds
   (host-staged gloo time, not an interconnect number); which c10d ops
   gloo takes on CUDA tensors is printed.  (c) ``launch/train.py --mesh
   2,2,2`` on Yi-6B at 2 layers for 4 steps on one repeated batch, its 8
   ranks beside (f)'s Yi-6B and Falcon-Mamba-7B: the loss must fall.  (d) The
   expert-parallel MoE
   layer alone at full width (``moe_layer_phase``): DBRX at ``moe_groups`` 2 and 1 and DeepSeek-V2 at
   2, x [8, 1024, D] bf16, in 8 ranks as a (pod 1, data 2, model 4) mesh,
   each rank drawing its own shards from per-expert seeds; every rank's
   output rows, x's gradient and its shards of the experts', shared
   experts' and router's gradients within ``MOE_LAYER_TOL`` in
   ``ref.scaled_err`` of the one-rank layer's (run first in a process of
   its own), a limit that must part two readings of the one-rank layer
   (its sums in the ranks' partition, another order, and with a ``model``
   partial dropped); each rank's peak memory printed beside the bytes of
   the replicated layer.  (e) DBRX's and DeepSeek-V2's smoke configs go
   through (a) and (b) beside Yi and Falcon (the sharded step alone),
   each row of a microbatch a dispatch group (``moe_groups`` 4, the
   data-parallel world), their routed leaves' first moments at
   ``SHARDED_MOE_M_TOL``.  (f) Sharded serving (``lm.prefill`` and
   ``lm.decode_step`` on DTensors with ``make_act_shard``'s hook) at full
   width and 2 layers: Yi-6B and Falcon-Mamba-7B on (2, 2, 2), DeepSeek-V2
   (its dense prelude and one MoE layer: MLA with its latent cache split
   over ``model`` on the sequence, expert-parallel) on (1, 2, 4); 4 prompts
   of 512 tokens into a capacity of 1024, then 8 decode steps.  The
   one-rank path through the kernels first, in a process of its own, from
   the same seed (its parameters saved for the ranks, which cut their
   shards from them); every rank's logits after the prefill and after
   each step, and every rank's cache shards against the matching slices
   of the one-rank cache, within ``SERVE_SHARDED_TOL`` in
   ``ref.scaled_err``, a limit that must part the one-rank path through
   the plain versions (which must pass) from a planted fault (one
   ``model`` rank's mixer outputs dropped from the sum, which must fail
   by twice it); the greedy tokens that agree are counted (near-tie
   routing flips in bf16); per rank the bytes held, peak memory,
   collectives, bytes staged through the host and host-clock seconds; the
   path's kernels (RMSNorm, flash attention, the scan) each launched on
   every rank.

The last three lines are the ``nvidia-smi`` line, one JSON object with the
kernels' numbers, and ``{"ok": true, "device": {...}}``; the full record
(every case, the serving numbers, the compiler's register report) goes to
``build/chip_smoke/``.  Any failed check
raises, and the script exits non-zero; without CUDA, or outside a checkout
of the repository, it exits non-zero before printing any result.  The
``[done]`` line gives each phase's seconds.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
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
#: the same for the fp32 selective scan and its backward, fused or not,
#: whose kernels and plain versions differ only in the order of a sum (the
#: readout's over the state, gc's, gB's and gC's over the channels, gA's
#: over the steps)
TOL_F32 = 1e-5
#: the served logits may stray from a float32 recomputation of the same
#: prefill by at most this many times as far (rms over all logits) as the
#: bf16 model's logits through the plain versions do: the kernels may add
#: rounding, not error
LOGIT_NOISE_RATIO = 1.5
#: device memory the float32 reference prefill keeps free beside its
#: largest layer's float32 copy, for its activations (bytes)
FLOAT32_ROOM = 6e9
#: published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
L2_BYTES = 50 * 2**20  # H100 SXM L2 cache
#: cold timings rotate through copies of the inputs spanning this many L2s
COLD_SPAN = 4
MAX_COPIES = 256
#: a plain version taking this long (device ms) is timed over 2 calls a graph
LONG_PLAIN_MS = 1.0


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
    "odd_last_head_left_out": (
        "const int nh = min(kHeadsPerSlice, group - h0);        // and its number of heads",
        "const int nh = group - h0 < kHeadsPerSlice ? 0 : kHeadsPerSlice;", "qwen2-vl train"),
    "head_slices_rounded_down": (
        "int head_slices(int group) { return (group + kHeadsPerSlice - 1) / kHeadsPerSlice; }",
        "int head_slices(int group) { return group / kHeadsPerSlice; }", "qwen2-vl train"),
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
#: faults planted in copies of ``csrc/mamba_scan_fused.cu`` (name: sound
#: line, faulty line, label of the phase-3 case it is checked at): each must
#: fail that case's check.  ``tests/test_torch_kernels.py`` plants the same.
FUSED_FAULTS = {
    "fused_dt_a_in_place_of_dt_x": (
        "const float dx = term_dx(dtv, to_f(sx[u * CH + cl]));",
        "const float dx = term_dx(dtv, ac[0]);", "falcon prefill"),
    "fused_readout_lane_pairs_left_out": (
        "for (int off = L >> 1; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);",
        "for (int off = L >> 1; off > 1; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);",
        "falcon prefill"),
    "fused_last_step_of_a_tile_dropped": (
        "const int steps = min(kSteps, S - t0);",
        "const int steps = min(kSteps - 1, S - t0);", "ragged"),
}
#: faults planted in copies of ``csrc/mamba_scan_fused_bwd.cu`` (name: sound
#: line, faulty line, label of the phase-8 case it is checked at): each must
#: fail that case's check.  ``tests/test_torch_kernels.py`` plants the same.
FUSED_BWD_FAULTS = {
    "fused_gh_fin_seed_dropped": (
        "g[j] = live && gh_fin != nullptr ? gh_fin[hrow + L * j] : 0.f;", "g[j] = 0.f;",
        "h0, gh_fin"),
    "fused_carry_lost_at_a_chunk_edge": (
        "const int tc = t0 + u0;",
        "const int tc = t0 + u0; if (tc + kChunk < S) for (int j = 0; j < P; ++j) g[j] = 0.f;",
        "falcon train"),
    "fused_last_cta_partial_left_out_of_gb": (
        "for (int j = 0; j < ctas; ++j) sb += p[j * stride];  // gB's partials",
        "for (int j = 0; j < ctas - 1; ++j) sb += p[j * stride];", "falcon train"),
    "fused_bwd_dt_a_in_place_of_dt_x": (
        "const float dx = term_dx(dtv, xv);", "const float dx = term_dx(dtv, ac[0]);",
        "falcon train"),
}
#: every planted fault, by the kernel whose source it is planted in
PLANTED = {"a2a_pack": PACK_FAULTS, "flash_attention": FLASH_FAULTS,
           "flash_attention_bwd": FLASH_BWD_FAULTS, "rmsnorm_bwd": RMSNORM_BWD_FAULTS,
           "mamba_scan_bwd": MAMBA_BWD_FAULTS, "mamba_scan_fused": FUSED_FAULTS,
           "mamba_scan_fused_bwd": FUSED_BWD_FAULTS}
#: phase 8's attention cases: (label, BH, g, S, hd, hd_v, window): one
#: sequence of a model's heads (a microbatch of its train step: 2048 tokens,
#: Danube's 4608 past its window of 4096), ragged S, window edges inside a
#: 64-row tile, the smoke configs' head dims; Qwen2-VL's group of 7, whose
#: last dK/dV slice of 2 heads holds one
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
    ("qwen2-vl train", 28, 7, 2048, 128, 128, None),
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
#: the fused selective scan's cases, forward (phase 3) and backward (phase
#: 8): (label, B, S, di, N, with h0 (and gh_fin), dtype of dt, x, B and C):
#: Falcon-Mamba-7B's prefill of 4 x 512 and training microbatch of 1 x 2048
#: in its bf16, a ragged S (no multiple of the kernels' 64-step tiles or
#: 8-step chunks), an initial state (and a final-state cotangent) in
#: float32, the smoke config's state size; Jamba-1.5-Large's prefill (d_inner
#: 16384: twice Falcon's channels, twice the CTAs)
FUSED_SPECS = [("falcon prefill", 4, 512, 8192, 16, False, "bfloat16"),
               ("ragged", 4, 300, 8192, 16, False, "bfloat16"),
               ("h0", 4, 512, 8192, 16, True, "float32"),
               ("N 8", 4, 512, 8192, 8, False, "bfloat16"),
               ("jamba prefill", 4, 512, 16384, 16, False, "bfloat16")]
TRAIN_FUSED_SPECS = [("falcon train", 1, 2048, 8192, 16, False, "bfloat16"),
                     ("ragged", 1, 300, 8192, 16, False, "bfloat16"),
                     ("h0, gh_fin", 1, 2048, 8192, 16, True, "float32"),
                     ("N 8", 1, 2048, 8192, 8, False, "bfloat16")]
#: the kernels a served prefill or decode step may launch, counted per engine
SERVE_KERNELS = ("rmsnorm", "flash_attention", "mamba_scan", "mamba_scan_fused")
#: phase 8's batch: 8 sequences, one a microbatch (the configs' 8), of 2048
#: tokens (Danube's 4608, past its window of 4096)
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
#: phase 8 (b): (arch, sequence length), each at full width and 2 layers
TRAIN_AGAINST_PLAIN = [("yi_6b", TRAIN_SEQ), ("h2o_danube_3_4b", 4608),
                       ("gemma_7b", TRAIN_SEQ), ("musicgen_large", TRAIN_SEQ),
                       ("minicpm3_4b", TRAIN_SEQ), ("falcon_mamba_7b", TRAIN_SEQ),
                       ("qwen2_vl_7b", TRAIN_SEQ)]
#: phase 8 (c): (arch, layers, steps, sequence length) at full width, the
#: config's own microbatches and remat, at the depth whose AdamW state (~16
#: B a parameter) fits one card: Yi-6B at 16 of its 32 layers (3.29 B
#: parameters, ~54 GB), Gemma-7B at 10 of its 28 (its tied embedding and 10
#: layers are 3.55 B, ~58 GB, with ~5 GB of logits a microbatch at a
#: vocabulary of 256,000), MiniCPM3-4B at all 62 (4.26 B, ~69 GB),
#: H2O-Danube3-4B at all 24 (3.96 B, ~64 GB) on sequences of 4608, past its
#: window, MusicGen-Large at all 48 (2.45 B, ~40 GB) and Falcon-Mamba-7B at
#: 32 of its 64 (3.90 B, ~62 GB, and a layer's backward holds a, b, ga, gb
#: and their products' gradients, 1.07 GB each), Qwen2-VL-7B at 14 of its 28
#: on float32 embeds (3.81 B, ~61 GB; at 16 layers 4.27 B, ~68 GB before the
#: logits of its untied head, 152,064 wide)
TRAIN_FULL_WIDTH = [("yi_6b", 16, 6, TRAIN_SEQ), ("gemma_7b", 10, 4, TRAIN_SEQ),
                    ("minicpm3_4b", 62, 4, TRAIN_SEQ), ("h2o_danube_3_4b", 24, 4, 4608),
                    ("musicgen_large", 48, 4, TRAIN_SEQ), ("falcon_mamba_7b", 32, 4, TRAIN_SEQ),
                    ("qwen2_vl_7b", 14, 4, TRAIN_SEQ)]
#: the loss averages 16,384 per-token terms: the kernels' bf16 rounding,
#: which differs from the plain versions' float32 element by element,
#: averages out in it
LOSS_TOL = 1e-3
#: phase 7's mesh and sizes: DeepSeek-V2's width, 1024 tokens x top-6 per
#: rank (768 rows per destination); PyTorch DDP's default 25 MiB bucket
COLLECTIVES = {"pods": 2, "lanes": 4, "tokens": 1024, "top_k": 6, "d_model": 5120,
               "bucket": 25 * 2**20 // 4}
HOST_STAGED = "gloo, host-staged, 8 ranks on one card: not an interconnect number"


#: phase 10: the sharded train step on this card, in 8 ranks over gloo as a
#: (pod 2, data 2, model 2) mesh: full-width Yi-6B and Falcon-Mamba-7B at 2
#: layers, 16 x 2048 tokens in 4 microbatches (a global microbatch of 4
#: rows, 1 on each data-parallel rank: the one-rank step's Falcon layer
#: then holds a, b and their gradients of 4.3 GB each), the config's
#: remat, phase 8's learning rate
SHARDED_MESH = (2, 2, 2)
SHARDED_ARCHS = ("yi_6b", "falcon_mamba_7b")
SHARDED_BATCH, SHARDED_SEQ, SHARDED_MICRO, SHARDED_LR = 16, 2048, 4, 3e-4
#: phase 10's limits on a step against the one-rank step, each checked by
#: phase 10 (a) to lie between two readings of the one-rank step itself: in
#: another summation order (``SHARDED_ORDER_MICRO`` microbatches of one
#: row: the rows a data-parallel rank of the mesh takes at a time), which
#: must pass with room, and without the rows of one data-parallel rank,
#: which must fail.  The first moments: rms of the error over each leaf,
#: relative to the leaf's rms.  An updated parameter: ``TOL_BF16`` in
#: ``ref.scaled_err``'s scale, or a first step's sign flip (2 lr) where the
#: one-rank step's own first moment lies within ``SHARDED_NEAR_ZERO`` of its
#: leaf's rms of zero (``_param_check``)
SHARDED_M_TOL, SHARDED_NEAR_ZERO, SHARDED_ORDER_MICRO = 5e-2, 0.5, 16
#: phase 10's CLI run: ``launch/train.py`` over the mesh, 4 steps on one
#: repeated batch of 16 x 256 in one microbatch (the config's 8 would not
#: split 16 rows over 4 data-parallel ranks; one microbatch gathers the
#: FSDP parameters once a step, not once a microbatch; 4 rows of 256 a
#: rank keep its peak below the phase's 1 x 2048)
SHARDED_CLI = ["--arch", "yi_6b", "--layers", "2", "--mesh", "2,2,2", "--steps", "4",
               "--batch", "16", "--seq", "256", "--microbatches", "1", "--corpus-size", "1",
               "--lr", "3e-4", "--log-every", "1"]
#: phase 10 (d): the expert-parallel MoE layer alone at full width
#: (``models/moe.moe`` on DTensors), in 8 ranks as a (pod 1, data 2, model
#: 4) mesh, its weights placed by the FSDP rules: (label, arch,
#: moe_groups), x [MOE_LAYER_BATCH, MOE_LAYER_SEQ, D] bf16 over the
#: data-parallel dims.  At 2 groups each data-parallel rank routes its own
#: group; at 1 the tokens are gathered
MOE_LAYER_MESH = (1, 2, 4)
MOE_LAYER_CASES = [("dbrx g2", "dbrx_132b", 2), ("dbrx g1", "dbrx_132b", 1),
                   ("deepseek g2", "deepseek_v2_236b", 2)]
MOE_LAYER_BATCH, MOE_LAYER_SEQ = 8, 1024
#: phase 10 (d)'s limit on every quantity of every rank, in
#: ``ref.scaled_err``, checked to lie between two readings of the one-rank
#: layer: its sums in another order (bf16 partials over the data-parallel
#: shares and the ``model`` ranks, each rounded to a unit in the last place
#: of 2^-8, must pass within half of it) and with one ``model`` rank's
#: partial dropped (which must fail by twice it).  On the H100 the first
#: reads up to 0.024 (DeepSeek-V2's x gradient), the second 2.4
MOE_LAYER_TOL = 6e-2
#: the tensors of phase 10 (d)'s layer, each drawn from a seed of its own
#: (an expert-stacked weight one expert at a time): the inputs and the
#: cotangent ``c`` of the loss ``sum(c * out) + aux``
MOE_LAYER_KEYS = ("router", "w_gate", "w_up", "w_down", "shared_gate", "shared_up",
                  "shared_down", "x", "c")
#: phase 10 (e): the sharded step on the MoE configs at their smoke widths,
#: each row of a microbatch a dispatch group (``moe_groups`` 4 = the
#: data-parallel world: each rank routes its own), beside ``SHARDED_ARCHS``
#: in (a) and (b) (the sharded step alone: the shard_map step's groups are
#: the rank's rows', another function)
SHARDED_MOE_ARCHS = ("dbrx_132b", "deepseek_v2_236b")
#: (e)'s learning rate: at the smoke widths a weight is ~1/8, and a first
#: AdamW step must move it by more than ``_param_check``'s allowance
#: (``TOL_BF16`` in its scale) for a wrong gradient's sign to show
SHARDED_MOE_LR = 1e-2
#: (e)'s limit on the first moments of the leaves that follow the routing
#: (the router and the experts, ``_m_tols``), in place of
#: ``SHARDED_M_TOL``: where a token's k-th and (k+1)-th router
#: probabilities tie within bf16 rounding, a rounding elsewhere upstream
#: (the sharded step's sums over ``model``) may flip its choice, which
#: moves its gradient to another expert and the slots of later tokens.
#: Checked to lie between (a)'s readings: the one-rank step through the
#: plain versions (whose attention and norms round otherwise) must pass
#: within half of it
SHARDED_MOE_M_TOL = 0.2
#: the c10d collectives DTensor and the paper's sums issue, each tried on
#: CUDA tensors over the gloo world by phase 10
GLOO_OPS = ("all_reduce", "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor",
            "all_to_all_single")
#: phase 10 (f): sharded serving (``lm.prefill`` and ``lm.decode_step`` on
#: DTensors, with ``make_act_shard``'s hook) at full width and 2 layers, in
#: 8 ranks over the card's host-staged gloo groups: (arch, mesh as (pod,
#: data, model)).  DeepSeek-V2's 2 layers are its dense prelude and one MoE
#: layer (MLA, its latent cache split over ``model`` on its sequence;
#: expert-parallel), on phase 10 (d)'s mesh
SERVE_SHARDED = [("yi_6b", (2, 2, 2)), ("falcon_mamba_7b", (2, 2, 2)),
                 ("deepseek_v2_236b", (1, 2, 4))]
#: (f)'s workload: prompts [SERVE_SHARDED_BATCH, SERVE_SHARDED_PROMPT] into a
#: cache of SERVE_SHARDED_CAPACITY, then SERVE_SHARDED_STEPS decode steps
SERVE_SHARDED_BATCH, SERVE_SHARDED_PROMPT = 4, 512
SERVE_SHARDED_CAPACITY, SERVE_SHARDED_STEPS = 1024, 8
#: (f)'s limit on every rank's logits (after the prefill and after each
#: step) against the one-rank path's, in ``ref.scaled_err``, and on its
#: cache shards, by the rms of the error over the shard relative to the
#: one-rank leaf's rms (the Mamba state is float32 from bf16 activations,
#: whose rounding ``exp(dt A)`` amplifies element by element: up to 2 in
#: ``ref.scaled_err`` on the CPU rehearsal in bf16, 0 in float32); it must
#: part two readings: the one-rank path through the plain versions
#: (another rounding of the same function) must pass, one ``model`` rank's
#: mixer output dropped from the sum over ``model`` (a planted fault) must
#: fail by twice it.  The CPU rehearsal at the smoke widths in bf16 reads up
#: to 0.040 on the logits and 0.014 on the caches, the fault 1.4 to 2.5; the
#: H100 (a first run): logits 0.044 / 0.049 / 0.082 (Yi, Falcon,
#: DeepSeek-V2, whose near-tie routing choices flip in bf16), the plain
#: versions 0.034 / 0 / 0.044, the fault 3.7 / 3.2 / 2.9
SERVE_SHARDED_TOL = 2e-1


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


def _call_ms(fn, args) -> float:
    """Device ms of one call ``fn(*args)`` after a warm-up call, between two
    CUDA events (launch costs included)."""
    import torch

    fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


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
        # a plain version of a millisecond or more: 2 calls a graph, whose
        # launches are a negligible share of its time
        long = key == "plain_ms" and _call_ms(fn, args) >= LONG_PLAIN_MS
        t = _ms(fn, args, min(iters, 2) if long else iters)
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
          f"device 0: {torch.cuda.get_device_name(0)}, {torch.cuda.mem_get_info()[1]:,} "
          f"bytes (torch.cuda.mem_get_info); {torch.cuda.device_count()} device(s)")
    print(f"[card] nvidia-smi: {smi}")
    return smi


#: a source's dispatch lines, one an instance (``FLASH_CASE(128, 128)``)
_DISPATCH_LINE = re.compile(r"^[ \t]*([A-Z_]+_CASE\([^)]*\)).*\n", re.M)


def _planted_instance(kernel: str, label) -> str | None:
    """The dispatch line of the instance that ``kernel``'s fault checked at
    ``label`` runs (the case's head dims, or its state size N: 4 states a
    thread where N >= 4); None where the source has no dispatch table."""
    specs, line = {
        "flash_attention": (FLASH_SPECS, lambda s: f"FLASH_CASE({s[5]}, {s[6]})"),
        "flash_attention_bwd": (TRAIN_FLASH_SPECS, lambda s: f"BWD_CASE({s[4]}, {s[5]})"),
        "mamba_scan_bwd": (TRAIN_SCAN_SPECS, lambda s: f"MAMBA_SCAN_BWD_CASE({s[4]})"),
        "mamba_scan_fused": (FUSED_SPECS, lambda s: f"FUSED_CASE({min(s[4], 4)})"),
        "mamba_scan_fused_bwd": (TRAIN_FUSED_SPECS,
                                 lambda s: f"FUSED_BWD_CASE({min(s[4], 4)})"),
    }.get(kernel, ((), None))
    return next((line(spec) for spec in specs if spec[0] == label), None)


def planted_source(kernel: str, name: str) -> str:
    """The source of the planted fault ``name`` of ``kernel``: its sound line
    replaced by the faulty one, and of the dispatch lines only the instance
    its case runs kept (no check calls the others, whose builds were most of
    the planted copies' build time)."""
    from repro_torch.kernels import build

    sound, faulty, label = PLANTED[kernel][name]
    src = (build.SRC_DIR / f"{kernel}.cu").read_text()
    if src.count(sound) != 1:
        raise AssertionError(f"planted fault {name}: its sound line is not in {kernel}.cu")
    keep = _planted_instance(kernel, label)
    if keep is not None:
        if [m.group(1) for m in _DISPATCH_LINE.finditer(src)].count(keep) != 1:
            raise AssertionError(f"planted fault {name}: {keep} is not a dispatch line of "
                                 f"{kernel}.cu")
        src = _DISPATCH_LINE.sub(lambda m: m.group(0) if m.group(1) == keep else "", src)
    return src.replace(sound, faulty)


def build_kernels() -> dict:
    """Every kernel and every planted fault of ``PLANTED`` (``planted_source``),
    one ``nvcc`` per source, all at once.  Returns the planted faults'
    libraries by name."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    planted = OUT_DIR / "planted"
    planted.mkdir(parents=True, exist_ok=True)
    fault_jobs = {}
    for kernel, faults in PLANTED.items():
        for name in faults:
            (planted / f"{name}.cu").write_text(planted_source(kernel, name))
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
    and 256 for ``kv_norm``), DBRX (6144), DeepSeek-V2 (5120, and inside
    MLA 1536 and 512) and Jamba-1.5-Large (8192)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    cases = []
    # prefill 4 x 512 tokens; decode 4 tokens; ragged; second width; then
    # danube's, gemma's, musicgen's, qwen2-vl's, minicpm3's, dbrx's,
    # deepseek-v2's and jamba's prefill and decode
    for T, d in ((2048, 4096), (4, 4096), (2049, 4096), (2048, 5120), (18432, 3840),
                 (4, 3840), (2048, 3072), (4, 3072), (2048, 2048), (4, 2048),
                 (2048, 3584), (4, 3584), (2048, 2560), (4, 2560), (2048, 768), (4, 768),
                 (2048, 256), (4, 256), (2048, 6144), (4, 6144), (4, 5120), (2048, 1536),
                 (4, 1536), (2048, 512), (4, 512), (2048, 8192), (4, 8192)):
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
    # the MoE slice: DBRX's GQA group of 6; Jamba-1.5-Large's attention
    # layer (64 heads, 8 KV heads); DeepSeek-V2's MLA (expanded prefill:
    # q/k 128 + 64, v 128, MHA), ragged and small
    ("dbrx prefill", 4 * 48, 6, 512, 512, 128, 128, True, None),
    ("jamba prefill", 4 * 64, 8, 512, 512, 128, 128, True, None),
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
    group of 6, Jamba-1.5-Large's 64 heads in groups of 8 and DeepSeek-V2's
    MLA pair (192, 128); then
    every planted fault of ``FLASH_FAULTS`` against its case's check."""
    import torch

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
            faulty = _with_fault("flash_attention", fault_libs[name], fa_mod,
                                 lambda: flash_attention_cuda(q, k, v, **kw))
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


def fused_inputs(gen, B, S, di, N, with_h0, dtype) -> tuple:
    """The fused scan's inputs on the card as a Mamba layer gives them: dt
    (through softplus), x, B and C in ``dtype``, A = -exp(a_log) [di, N]
    float32 about -(1 .. N) (the configs' init, perturbed per channel), and
    h0 [B, di, N] float32 or None."""
    import torch
    import torch.nn.functional as F

    dt_ = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    dt = F.softplus(randn(B, S, di) - 0.5).to(dt_)
    x, Bm, Cm = randn(B, S, di).to(dt_), randn(B, S, N).to(dt_), randn(B, S, N).to(dt_)
    A = -torch.exp(torch.log(torch.arange(1, N + 1, device="cuda", dtype=torch.float32))
                   + 0.1 * randn(di, N))
    return dt, x, Bm, Cm, A, randn(B, di, N) * 0.1 if with_h0 else None


def unfused_terms(dt, x, B, A):
    """The terms as the layer formed them before the fused scan (its
    ``_ssm_terms``): ``a = exp(dt A)`` in place, ``b = (dt x) B``, float32
    [B, S, di, N]."""
    dt32 = dt.float()
    a = (dt32[..., None] * A).exp_()
    b = (dt32 * x.float())[..., None] * B.float()[..., None, :]
    return a, b


def _unfused_forward(dt, x, B, C, A, h0=None):
    """The path the fused forward replaces: the terms, then ``mamba_scan``."""
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda

    return mamba_scan_cuda(*unfused_terms(dt, x, B, A), C.float(), h0)


def _unfused_backward(dt, x, B, C, A, h0, gy, gh=None):
    """The path the fused backward replaces: the terms, ``mamba_scan_bwd``
    on them, and the terms' backward through autograd."""
    import torch

    from repro_torch.kernels.mamba_scan_bwd import mamba_scan_bwd_cuda

    ins = [t.detach().requires_grad_() for t in (dt, x, B, C, A)]
    a, b = unfused_terms(ins[0], ins[1], ins[2], ins[4])
    c = ins[3].float()
    ga, gb, gc, gh0 = mamba_scan_bwd_cuda(a.detach(), b.detach(), c.detach(), h0, gy, gh)
    return torch.autograd.grad((a, b, c), ins, (ga, gb, gc)) + (gh0,)


def _turns(fns: dict, args, iters: int, rounds: int = 1) -> dict:
    """Each of ``fns`` timed on ``args`` as ``_ms`` times a kernel, in turns
    (each in order, then in reverse, ``rounds`` times): its readings, cold
    and warm, and their medians."""
    out = {n: {"cold": [], "warm": []} for n in fns}
    for n in (list(fns) + list(fns)[::-1]) * rounds:
        t = _ms(fns[n], args, iters)
        out[n]["cold"].append(t["cold"] if t["cold"] is not None else t["warm"])
        out[n]["warm"].append(t["warm"])
    for r in out.values():
        r["median"] = statistics.median(r["cold"])
        r["median_warm"] = statistics.median(r["warm"])
    return out


def _fused_ms(turns: dict) -> dict:
    """A fused case's kernel times from its turns against the unfused path
    (the medians, as ``_times`` would give them) and the turns."""
    return {"ms": turns["fused"]["median"], "ms_warm": turns["fused"]["median_warm"],
            "turns": turns, "unfused_ms": turns["unfused"]["median"]}


def _with_fault(kernel: str, lib_path, module, call):
    """``call()`` with ``kernel``'s library replaced by the faulty build at
    ``lib_path``; synchronised."""
    import torch

    from repro_torch.kernels import build

    saved = build._LIBS[kernel]
    try:
        build._LIBS[kernel] = build.load(lib_path, module._SIGNATURES)
        out = call()
        torch.cuda.synchronize()
    finally:
        build._LIBS[kernel] = saved
    return out


def fused_cases(gen, fault_libs) -> list:
    """Phase 3: the fused scan's forward against its plain version on the
    same inputs at ``FUSED_SPECS`` (y and h_last at ``TOL_F32``; whether
    h_last agrees bit for bit is printed), every planted fault of
    ``FUSED_FAULTS``, and each case timed in turns against the path it
    replaces (the terms formed by PyTorch, then ``mamba_scan``).  No
    PyTorch call computes a selective scan: ``library_ms`` is None."""
    import torch

    from repro_torch.kernels import mamba_scan_fused as sf_mod
    from repro_torch.kernels.mamba_scan_fused import mamba_scan_fused_cuda
    from repro_torch.kernels.ref import mamba_scan_fused_ref, scaled_err

    faults = {}
    for name, (_, _, label) in FUSED_FAULTS.items():
        faults.setdefault(label, []).append(name)
    cases = []
    for label, B, S, di, N, with_h0, dtype in FUSED_SPECS:
        args = fused_inputs(gen, B, S, di, N, with_h0, dtype)
        if not with_h0:
            args = args[:5]
        y, h = mamba_scan_fused_cuda(*args)
        torch.cuda.synchronize()
        want_y, want_h = mamba_scan_fused_ref(*args)
        (abs_y, err_y), (abs_h, err_h) = _err(y, want_y), _err(h, want_h)
        err = max(err_y, err_h)
        if not err <= TOL_F32:
            raise AssertionError(f"mamba_scan_fused {label}: scaled err y {err_y}, h_last "
                                 f"{err_h} > {TOL_F32}")
        planted = {}
        for name in faults.get(label, []):
            fy, fh = _with_fault("mamba_scan_fused", fault_libs[name], sf_mod,
                                 lambda: mamba_scan_fused_cuda(*args))
            f_err = max(scaled_err(fy, want_y), scaled_err(fh, want_h))
            print(f"[kernel] mamba_scan_fused planted fault {name} at {label}: scaled err "
                  f"{f_err:.6g} (sound {err:.6g}, tol {TOL_F32})")
            if f_err <= TOL_F32:  # a faulty output of NaNs fails the check too
                raise AssertionError(f"planted fault {name} passed the check: {f_err}")
            planted[name] = f_err if math.isfinite(f_err) else str(f_err)
            del fy, fh
        h_bits = torch.equal(h, want_h)
        del y, h, want_y, want_h
        esz = args[0].element_size()
        # dt, x, B, C read once (and A, h0), y and h_last written once
        nbytes = (esz * (2 * B * S * di + 2 * B * S * N) + 4 * di * N
                  + 4 * (B * S * di + (2 if with_h0 else 1) * B * di * N))
        # per state element and step: dt A, exp, (dt x) B, the update's
        # multiply and add, the readout's multiply and add
        flops = 7 * B * S * di * N + B * S * di
        turns = _turns({"fused": mamba_scan_fused_cuda, "unfused": _unfused_forward}, args,
                       iters=5)
        case = {
            "shape": f"{label}: dt/x[{B},{S},{di}] B/C[{B},{S},{N}] {dtype}"
                     f"{' h0' if with_h0 else ''}",
            "max_abs_err": max(abs_y, abs_h), "scaled_err": err,
            "scaled_err_y": err_y, "scaled_err_h_last": err_h, "h_last_bit_for_bit": h_bits,
            **_times(None, mamba_scan_fused_ref, None, args, iters=5), **_fused_ms(turns),
            "bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_ops_ms": flops / PEAK_FP32_FLOPS * 1e3,
        }
        if planted:
            case["planted_fault_scaled_err"] = planted
        print(f"[kernel] mamba_scan_fused {label}: in turns, fused "
              f"{turns['fused']['median']:.6f} ms, unfused (terms + mamba_scan) "
              f"{turns['unfused']['median']:.6f} ms (medians, inputs cold); h_last bit for "
              f"bit with the plain version: {h_bits}")
        cases.append(case)
        del args
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
             "mamba_scan_bwd", "mamba_scan_fused", "mamba_scan_fused_bwd")
    saved = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, getattr(ref, f"{n}_ref"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def moe_routing(record: list | None = None, force: list | None = None):
    """The MoE layers' routing (``models/moe.route``) with each call's
    expert choices (indices [G, Tg, k]) appended to ``record``, or replaced
    by the next of ``force``'s, the call's gate weights then its own
    probabilities at those experts, renormalised and cast as ``route``
    does: a check's reference forward on another path's routing (the port
    itself never does this)."""
    from repro_torch.models import moe

    sound = moe.route
    forced = None if force is None else iter(force)

    def route(cfg, p, xt):
        probs, gate_w, gate_i = sound(cfg, p, xt)
        if forced is not None:
            gate_i = next(forced)
            w = probs.gather(-1, gate_i)
            gate_w = (w / w.sum(-1, keepdim=True).clamp_min(1e-9)).to(xt.dtype)
        if record is not None:
            record.append(gate_i)
        return probs, gate_w, gate_i

    moe.route = route
    try:
        yield
    finally:
        moe.route = sound


def pack_cases(gen, fault_libs) -> list:
    """Phase 6: ``a2a_pack`` against its plain version, bit for bit, and
    every planted fault against the same check."""
    import torch

    from repro_torch.kernels import a2a_pack
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
    for name, (_, _, shape) in PACK_FAULTS.items():
        x = torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
        want = a2a_pack_ref(x)  # kept alive: no output reuses its memory
        faulty = _with_fault("a2a_pack", fault_libs[name], a2a_pack, lambda: a2a_pack_cuda(x))
        differ = int((faulty.view(torch.uint8) != want.view(torch.uint8)).sum())
        print(f"[kernel] a2a_pack planted fault {name} at {shape}: {differ} of "
              f"{want.numel() * want.element_size()} bytes differ")
        if differ == 0:
            raise AssertionError(f"planted fault {name} passed the equality check")
        cases[0].setdefault("planted_faults_bytes_differing", {})[name] = differ
        del x, want, faulty
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
    bad = [k for k in ep_dispatch.CHECKS if not dispatch[k]]
    if bad:
        raise AssertionError(f"rank {me}: EP dispatch fails {bad}")
    want = {**dict.fromkeys(launches, 0),
            "a2a_pack": (2 * dispatch["fulllane_calls"] +
                         4 * dispatch["fulllane_calls_with_backward"]) if device == "cuda" else 0}
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
    backward = collectives_backward(mesh, bucket, device, seed, timed)
    return {"rank": me, "dispatch": dispatch, "launches": launches, "seconds": seconds,
            "traffic": traffic, "transport": dispatch["transport"], "backward": backward}


def collectives_backward(mesh, bucket: int, device: str, seed: int, timed) -> dict:
    """Phase 7 (a), on one rank: the backward of every collective but the
    alltoalls (the EP dispatch holds theirs), each the gradient of ``sum(c
    * f(x))`` for a seeded bf16 cotangent ``c`` on each rank (numpy,
    ``default_rng([seed, case, rank])``), against the numpy oracle of f's
    transpose (the sums in float64), bit for bit, with exact zeros where
    the transpose gives none.  The cotangents are multiples of 1/8 of at
    most 15/8 in size, so every partial sum of 8 ranks' is exact in bf16
    and a sum in any order is the oracle's to the bit (millions of normal
    values can exceed 2e-2 in ``ref.scaled_err`` against the exact sum by
    the order of the bf16 roundings alone).  Raises on a failed check;
    returns each case's largest absolute error (0)."""
    import numpy as np
    import torch

    from repro_torch.core import collectives as C

    me, P, lanes = mesh.world.index, mesh.world.size, mesh.lane.size
    pod, lane = divmod(me, lanes)

    def cot(case: int, r: int, n: int) -> np.ndarray:
        """Rank ``r``'s cotangent of case ``case``: k / 8, |k| <= 15."""
        rng = np.random.default_rng([seed, case, r])
        return rng.integers(-15, 16, n).astype(np.float32) / 8

    def grad(name, f, x, c):
        xg = x.detach().requires_grad_()

        def run():
            (g,) = torch.autograd.grad((c * f(xg)).float().sum(), xg)
            return g
        run()  # warm-up, as for the timed forwards
        g = timed(f"{name} backward", run)
        if g.dtype != x.dtype:
            raise AssertionError(f"rank {me}: {name}: gradient {g.dtype}, input {x.dtype}")
        return g.float().cpu()

    def held(name, g, want):
        want = torch.from_numpy(want.astype(np.float32))
        err = (g - want).abs().max().item()
        if not torch.equal(g, want):
            raise AssertionError(f"rank {me}: {name} backward differs from the transpose's "
                                 f"oracle by up to {err}")
        out[name] = err

    out = {}
    x = torch.zeros(bucket, dtype=torch.bfloat16, device=device)
    for case, (name, f) in enumerate((
            ("hierarchical_psum", lambda v: C.hierarchical_psum(v, mesh.pod, mesh.lane)),
            ("flat_psum", lambda v: C.flat_psum(v, mesh.pod, mesh.lane)))):
        for n in (bucket, bucket + 1):
            c = torch.from_numpy(cot(case, me, n)).to(device, torch.bfloat16)
            want = sum(cot(case, r, n).astype(np.float64) for r in range(P))
            held(f"{name} {n}", grad(f"{name} {n}", f, x.new_zeros(n), c), want)
    m, root_pod, root = bucket // lanes, 1 % mesh.pod.size, 5 % P  # roots off rank 0
    c = torch.from_numpy(cot(2, me, bucket)).to(device, torch.bfloat16)
    want = sum(cot(2, r, bucket).astype(np.float64) for r in range(P))
    want = want[lane * m:(lane + 1) * m] if pod == root_pod else np.zeros(m)
    held("fulllane_broadcast root=1", grad(
        "fulllane_broadcast root=1",
        lambda v: C.fulllane_broadcast(v, mesh.pod, mesh.lane, root=root_pod), x[:m], c),
        want)
    for k in (1, 2, 3):
        c = torch.from_numpy(cot(3 + k, me, bucket)).to(device, torch.bfloat16)
        want = (sum(cot(3 + k, r, bucket).astype(np.float64) for r in range(P)) if me == 0
                else np.zeros(bucket))
        held(f"kported_broadcast k={k}", grad(
            f"kported_broadcast k={k}",
            lambda v, k=k: C.kported_broadcast_ppermute(v, mesh.world, k=k), x, c), want)
    n = bucket // P
    c = torch.from_numpy(cot(7, me, n)).to(device, torch.bfloat16)
    want = (np.stack([cot(7, r, n) for r in range(P)]) if me == root else np.zeros((P, n)))
    held("kported_scatter k=2 root=5", grad(
        "kported_scatter k=2 root=5",
        lambda v: C.kported_scatter_ppermute(v, mesh.world, k=2, root=root), x.view(P, n), c),
        want)
    return out


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
          f"bit for bit, on all {world} ranks; its gradient (the loss sum(w * y), w a "
          f"seeded bf16 cotangent) flat == fulllane == numpy oracle, bit for bit, on all "
          f"{world} ranks; a2a_pack launches by rank "
          f"{[r['launches']['a2a_pack'] for r in results]} (2 per fulllane_all_to_all call, "
          f"{d0['fulllane_calls']} calls; 4 per call with its backward, "
          f"{d0['fulllane_calls_with_backward']} call)")
    worst = {name: max(r["backward"][name] for r in results) for name in results[0]["backward"]}
    print(f"[collectives] backward of every collective on all {world} ranks, bf16 cotangents "
          f"on a grid where every sum is exact, against the numpy oracle of its transpose: "
          f"bit for bit (largest error over ranks "
          + ", ".join(f"{n} {e:g}" for n, e in worst.items()) + ")")
    times = {f"ep_dispatch {k}": [r["dispatch"]["seconds"][k] for r in results]
             for k in results[0]["dispatch"]["seconds"]}
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
    """The published widths each served config is held to: a Mamba
    model's, an attention model's (MLA's and M-RoPE's too), then its MoE
    widths; a hybrid's Mamba and attention widths together, then its MoE
    widths and its layer pattern."""
    out = ()
    if cfg.mamba is not None:
        m = cfg.mamba
        out += (cfg.num_layers, cfg.d_model, m.d_state, m.d_conv, m.expand,
                m.resolved_dt_rank(cfg.d_model), cfg.vocab_size, cfg.dtype)
    a = cfg.attn
    if a is not None:
        out += (cfg.num_layers, cfg.d_model, a.num_heads, a.num_kv_heads, a.head_dim,
                cfg.d_ff, cfg.vocab_size, a.sliding_window, cfg.num_codebooks, cfg.act,
                cfg.dtype)
        if a.kind == "mla":
            out += (a.q_lora_rank, a.kv_lora_rank, a.qk_nope_head_dim, a.qk_rope_head_dim,
                    a.v_head_dim)
        if a.mrope_sections is not None:
            out += (a.mrope_sections,)
    if cfg.moe is not None:
        e = cfg.moe
        out += (e.num_experts, e.top_k, e.d_ff_expert, e.num_shared_experts,
                e.capacity_factor, cfg.first_k_dense)
    if cfg.mamba is not None and a is not None:
        out += (tuple((s.mixer, s.ffn) for s in cfg.layer_pattern),)
    return out


#: what each served model must be: its published widths (``_widths``), the
#: kernel launches over one prefill (norms per layer: Falcon-Mamba's layers
#: have no second norm, MiniCPM3's MLA adds ``q_norm`` and ``kv_norm``), its
#: prompt length and cache capacity (4 requests, 32 new tokens each), and
#: where set, the decode step whose logits must match a prefill over each
#: row's prompt and its tokens so far.  ``depth``: the layers kept of an
#: MoE model, whose weights at full depth would not fit one card (its
#: widths are the published config's; ``configs.first_layers``), and
#: ``params`` the parameter count of that cut.  Qwen2-VL takes embeddings:
#: no engine drives it (``drive_embeds``)
_DENSE = {"norms_per_layer": 2, "prompt": 512, "capacity": 1024}
SERVED = {
    "yi_6b": {**_DENSE, "prefill": {"flash_attention": 32},
              "widths": (32, 4096, 32, 4, 128, 11008, 64000, None, 1, "silu", "bfloat16")},
    "falcon_mamba_7b": {**_DENSE, "norms_per_layer": 1, "prefill": {"mamba_scan_fused": 64},
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
    # the first 4 of 72 layers, one of each kind: attention + MoE, Mamba +
    # dense, Mamba + MoE, Mamba + dense (a whole period of 8 would not fit)
    "jamba_1_5_large_398b": {**_DENSE, "depth": 4, "params": 22_996_213_760,
                             "prefill": {"flash_attention": 1, "mamba_scan_fused": 3},
                             "widths": (72, 8192, 16, 4, 2, 256, 65536, "bfloat16",
                                        72, 8192, 64, 8, 128, 24576, 65536, None, 1, "silu",
                                        "bfloat16", 16, 2, 24576, 0, 1.25, 0,
                                        (("attn", "moe"),) + (("mamba", "dense"),
                                                              ("mamba", "moe")) * 3
                                        + (("mamba", "dense"),))},
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
        self.launches = dict.fromkeys(SERVE_KERNELS, 0)
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

    from repro_torch.configs import first_layers, get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_config(arch)
    want = SERVED[arch]
    if _widths(cfg) != want["widths"]:
        raise AssertionError(f"{arch} is not at its published widths: {_widths(cfg)}")
    if "depth" in want:
        cfg = first_layers(cfg, want["depth"])
    slots, capacity, prompt_len, max_new = 4, want["capacity"], want["prompt"], 32
    k = cfg.num_codebooks
    prompt_shape = (prompt_len, k) if k > 1 else (prompt_len,)

    t0 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                           device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name} full width, {cfg.num_layers} layers: {n_params / 1e9:.3f} B "
          f"params ({n_params:,}; the config's param_count() {cfg.param_count():,}), bf16, "
          f"random init from seed {seed} in {time.perf_counter() - t0:.1f} s")
    if "params" in want and not n_params == cfg.param_count() == want["params"]:
        raise AssertionError(f"{arch} at {cfg.num_layers} layers: {n_params} parameters, "
                             f"param_count() {cfg.param_count()}, want {want['params']}")

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
    want_launches = {**dict.fromkeys(SERVE_KERNELS, 0),
                     "rmsnorm": per_forward * (1 + decode_steps), **want["prefill"]}
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
    of that part, made at the read on ``device`` (the tensor's own, or the
    card where the tensor is held on the host: the part is copied there
    first)."""

    def __init__(self, t, device=None):
        self.t, self.device = t, device or t.device

    def __getitem__(self, i):
        return self.t[i].to(self.device).float()


class _Float32Tree(dict):
    """A parameter tree read as float32: each tensor a float32 copy made at
    the read, each subtree a tree of its own; ``_Float32Rows`` leaves as they
    are."""

    def __getitem__(self, k):
        v = super().__getitem__(k)
        if isinstance(v, dict):
            return _Float32Tree(v)
        return v.float() if hasattr(v, "float") else v


def _to_host(tree: dict) -> None:
    """Move every tensor of ``tree`` to the host, in place (a card's tensor
    into pinned memory, which the copies back read at the link's rate): the
    tree then holds the host copies, and the card's are freed once nothing
    else holds them."""
    import torch

    for k, v in tree.items():
        if isinstance(v, dict):
            _to_host(v)
        elif v.is_cuda:
            tree[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v)


def float32_reads(params: dict, on_host: bool = False) -> dict:
    """``params`` as a float32 forward reads them: every weight cast where it
    is read (a stacked leaf a period at a time, an untied embedding table a
    token's rows at a time), so the float32 copy never holds more than one
    layer's weights: the float32 model in bounded memory (a float32 DBRX at
    8 layers is 109 GB).  ``on_host``: the stacked leaves first move to the
    host (``params``' own ``blocks`` then hold them there, and the card's
    copies are freed), and each read copies its period back to the card
    before the cast, so the card holds one layer's float32 copy and not the
    bf16 layers beside it (Jamba-1.5-Large's third layer, Mamba + MoE, is
    40.30 GB in float32, beside a 45.99 GB bf16 model at 4 layers)."""
    from repro_torch.models.params import map_tree

    device = params["final_norm"].device
    if on_host:
        _to_host(params["blocks"])
    rows = {"blocks": map_tree(lambda _, t: _Float32Rows(t, device), params["blocks"])}
    if params["embed"] and params["head"]:  # an untied table, read by rows
        rows["embed"] = {"embedding": _Float32Rows(params["embed"]["embedding"])}
    return _Float32Tree({**params, **rows})


def _float32_layer_fits(params) -> tuple[bool, float, float]:
    """Whether the float32 copy of the largest layer (a slot's period),
    with ``FLOAT32_ROOM`` for the activations, fits the card's memory
    beside the bf16 model (what the card has free, and what the allocator
    holds unused); and those two sizes in GB."""
    import torch

    gc.collect()  # the engines' reference cycles, and their captured graphs' pools
    torch.cuda.empty_cache()
    layer = max(sum(t[0].numel() for t in _leaves(slot)) * 4
                for slot in params["blocks"].values())
    free = (torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
            - torch.cuda.memory_allocated())
    return layer + FLOAT32_ROOM <= free, layer / 1e9, free / 1e9


def _routing_flips(a: list, b: list) -> list:
    """Per MoE call, the tokens whose set of experts differs between two
    paths' recorded routings."""
    return [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum()) for x, y in zip(a, b)]


def _layers_against_plain(cfg, params, batch, capacity: int) -> list:
    """Each layer of the prefill on one input, the plain versions' residual
    stream: its output less its input (the mixer's and the FFN's) through
    the kernels against the plain versions', rms relative, the MoE routing
    of the plain call forced on the kernels' call.  A layer held on the host
    (``float32_reads(on_host=True)``) is copied to the card for its turn."""
    from repro_torch.models import lm
    from repro_torch.models.params import map_tree

    x, positions = lm._inputs(cfg, params, batch)
    layers = [(spec, params[name]) for name, spec in lm._prelude(cfg)]
    layers += [(spec, (j, i)) for i in range(lm.scanned_periods(cfg))
               for j, spec in enumerate(cfg.layer_pattern)]
    errs = []
    for spec, p in layers:
        if isinstance(p, tuple):
            p = map_tree(lambda _, t: t.to(x.device),
                         lm._period(params["blocks"][f"slot{p[0]}"], p[1]))
        seen = []
        with moe_routing(record=seen), plain_kernels():
            want = lm._apply_slot(cfg, spec, p, x, positions, capacity=capacity)[0]
        with moe_routing(force=seen):
            got = lm._apply_slot(cfg, spec, p, x, positions, capacity=capacity)[0]
        errs.append(_rms_rel(got - x, want - x))
        x = want
    return errs


def _prefill_against_float32(cfg, params, batch, kern, capacity: int) -> dict:
    """The prefill's logits through the kernels (``kern``) against the same
    prefill through the plain versions of the kernels, in the model's bf16
    and in float32 (the reference for the bf16 rounding; each weight cast
    where it is read, ``float32_reads``, with the bf16 layers moved to the
    host first where a float32 layer does not fit beside them): no further
    from float32 than ``LOGIT_NOISE_RATIO`` times the plain bf16 logits
    are, within ``TOL_BF16`` (rms) of those, and the same first token
    wherever float32's top-2 gap exceeds the bf16 noise.  With MoE layers
    the tokens that the two bf16 paths route to other experts (near ties)
    are counted by layer (``moe_routing`` records each path's choices; the
    forward through the kernels run again to record its own must give
    ``kern`` bit for bit).  Where the bf16 model itself strays from float32
    by more than ``TOL_BF16`` (its layers amplify rounding, as
    Jamba-1.5-Large's random Mamba layers do), the kernels may stray from
    the plain versions as far as that, and each layer, on one input, is held
    to the plain versions within ``TOL_BF16`` (``_layers_against_plain``).
    The bf16 layers stay on the host after it where they were moved."""
    import torch

    from repro_torch.models import lm

    routes = {"kernels": [], "plain": []}
    with moe_routing(record=routes["plain"]), plain_kernels():
        plain, _ = lm.prefill(cfg, params, batch, capacity=capacity)
    routing = {}
    if cfg.moe is not None:
        with moe_routing(record=routes["kernels"]):
            again, _ = lm.prefill(cfg, params, batch, capacity=capacity)
        routing = {"routing_flips_by_layer": _routing_flips(routes["kernels"], routes["plain"]),
                   "tokens_routed_per_layer": [int(r[..., 0].numel()) for r in routes["plain"]],
                   "kernels_rerun_bit_for_bit": torch.equal(again, kern)}
        del again
    fits, layer_gb, free_gb = _float32_layer_fits(params)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with plain_kernels():
        exact, _ = lm.prefill(dataclasses.replace(cfg, dtype="float32"),
                              float32_reads(params, on_host=not fits), batch,
                              capacity=capacity)
    exact_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    err_kern, err_plain = _rms_rel(kern, exact), _rms_rel(plain, exact)
    err_kp = _rms_rel(kern, plain)
    tol_kp = max(TOL_BF16, err_plain)
    top2 = exact.topk(2, dim=-1).values
    noise = (plain.float() - exact).abs().max(dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * LOGIT_NOISE_RATIO * noise
    same = kern.float().argmax(-1) == exact.argmax(-1)
    print(f"[serve] prefill logits against float32: rms err through the kernels "
          f"{err_kern:.6f}, through the plain versions {err_plain:.6f} (ratio "
          f"{err_kern / err_plain:.4f}, at most {LOGIT_NOISE_RATIO}); kernels vs plain: "
          f"max abs {_err(kern, plain)[0]:.5f}, rms {err_kp:.6f} (tol {tol_kp:.6g}); first "
          f"token equal to float32's in {int(same.sum())}/{same.numel()} rows"
          f"{' x codebooks' if cfg.num_codebooks > 1 else ''}, {int(decided.sum())} with a "
          f"top-2 gap above the bf16 noise; the largest layer {layer_gb:.2f} GB in float32, "
          f"{free_gb:.2f} GB free beside the bf16 model: its layers "
          f"{'read on the card' if fits else 'moved to the host, each read copied back'}; "
          f"float32 prefill in {exact_s:.1f} s, peak memory with the float32 copy {peak:.2f} GB")
    if routing:
        print(f"[serve] MoE routing, kernels against plain versions: tokens routed to "
              f"other experts by layer {routing['routing_flips_by_layer']} of "
              f"{routing['tokens_routed_per_layer']}; the kernels' forward run again (its "
              f"routing recorded) gives the served logits bit for bit: "
              f"{routing['kernels_rerun_bit_for_bit']}")
    layers = None
    if err_plain > TOL_BF16:
        layers = _layers_against_plain(cfg, params, batch, capacity)
        print(f"[serve] the bf16 model strays from float32 by {err_plain:.6f} (> {TOL_BF16}): "
              f"each layer's output on the plain versions' input, kernels against plain "
              f"versions, rms {[round(e, 6) for e in layers]} (tol {TOL_BF16})")
    if not err_kern <= LOGIT_NOISE_RATIO * err_plain:
        raise AssertionError(f"prefill logits: rms err {err_kern} through the kernels > "
                             f"{LOGIT_NOISE_RATIO} x {err_plain} through the plain versions")
    if routing and not routing["kernels_rerun_bit_for_bit"]:
        raise AssertionError("the kernels' forward run again gave other logits")
    if not err_kp <= tol_kp:
        raise AssertionError(f"prefill logits: rms err {err_kp} against the plain "
                             f"versions > {tol_kp}")
    if layers is not None and not max(layers) <= TOL_BF16:
        raise AssertionError(f"a layer's output through the kernels is off the plain "
                             f"versions': {layers} > {TOL_BF16}")
    if not bool(same[decided].all()):
        raise AssertionError("first token differs where the top-2 gap exceeds the bf16 noise")
    return {"peak_mem_gb_float32_check": peak, "float32_layers_on_host": not fits,
            "float32_check_s": exact_s, "prefill_logit_rms_err_kernels": err_kern,
            "prefill_logit_rms_err_plain": err_plain,
            "prefill_logit_rms_err_kernels_vs_plain": err_kp,
            "prefill_logit_rms_tol_kernels_vs_plain": tol_kp,
            "layers_rms_err_kernels_vs_plain": layers, **routing}


def _kv_slots(cfg, capacity: int) -> str:
    """What one sequence's cache holds, for the report."""
    if cfg.attn is None:
        return "a Mamba state"
    w = cfg.attn.sliding_window
    kv = (f"a {min(w, capacity)}-slot sliding-window ring" if w is not None
          else f"{capacity} KV slots")
    return kv if cfg.mamba is None else f"{kv} beside Mamba states"


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
    runs = {m: {"launches": dict.fromkeys(SERVE_KERNELS, 0),
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
    want_launches = {**dict.fromkeys(SERVE_KERNELS, 0), "rmsnorm": per_forward * (1 + steps),
                     **want["prefill"]}
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
            faulty = _with_fault("flash_attention_bwd", fault_libs[name], fb_mod,
                                 lambda: flash_attention_bwd_cuda(q, k, v, o_s, lse, do_s,
                                                                  **kw)[:3])
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
            f_dx, f_dw = _with_fault("rmsnorm_bwd", fault_libs[name], rb_mod,
                                     lambda: rmsnorm_bwd_cuda(x, w, dy))
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
            faulty = _with_fault("mamba_scan_bwd", fault_libs[name], sb_mod,
                                 lambda: kernel(*args))
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


def fused_train_cases(gen, fault_libs) -> list:
    """Phase 8 (a): the fused scan's backward against its plain version on
    the same inputs at ``TRAIN_FUSED_SPECS``: every output (gdt, gx, gB, gC,
    gA, gh0) at ``TOL_F32``, the first four in float32 (the kernel on the
    same values in float32: its sums before the cast) against the plain
    version's, and in the inputs' dtype equal bit for bit to those sums
    cast; a second call to the same bits; every planted fault of
    ``FUSED_BWD_FAULTS``; each case timed in turns against the path it
    replaces (the terms, ``mamba_scan_bwd`` and the terms' backward through
    autograd).  ``library_ms`` is None."""
    import torch

    from repro_torch.kernels import mamba_scan_fused_bwd as sb_mod
    from repro_torch.kernels.mamba_scan_fused_bwd import (mamba_scan_fused_bwd_cuda,
                                                          mamba_scan_fused_bwd_workspace_bytes)
    from repro_torch.kernels.ref import mamba_scan_fused_bwd_ref, scaled_err

    names = ("gdt", "gx", "gB", "gC", "gA", "gh0")

    def errs(got, want) -> dict:
        return {n: scaled_err(g, w) for n, g, w in zip(names, got, want)}

    def kernel(dt, x, B, C, A, gy, h0=None, gh=None):
        return mamba_scan_fused_bwd_cuda(dt, x, B, C, A, h0, gy, gh)

    def sums(dt, x, B, C, *rest):  # the float32 instance on the same values
        return kernel(dt.float(), x.float(), B.float(), C.float(), *rest)

    def plain(dt, x, B, C, A, gy, h0=None, gh=None):
        return mamba_scan_fused_bwd_ref(dt, x, B, C, A, h0, gy, gh)

    def unfused(dt, x, B, C, A, gy, h0=None, gh=None):
        return _unfused_backward(dt, x, B, C, A, h0, gy, gh)

    faults = {}
    for name, (_, _, label) in FUSED_BWD_FAULTS.items():
        faults.setdefault(label, []).append(name)
    cases = []
    for label, B, S, di, N, with_h0, dtype in TRAIN_FUSED_SPECS:
        dt, x, Bm, Cm, A, h0 = fused_inputs(gen, B, S, di, N, with_h0, dtype)
        gy = torch.randn(B, S, di, generator=gen, device="cuda")
        args = (dt, x, Bm, Cm, A, gy)
        if with_h0:
            args += (h0, torch.randn(B, di, N, generator=gen, device="cuda"))
        f32 = sums(*args)
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*(t.float() for t in args[:4]), *args[4:])  # float32: before the cast
        err = errs(f32, want)
        if not max(err.values()) <= TOL_F32:
            raise AssertionError(f"mamba_scan_fused_bwd {label}: scaled err {err} > {TOL_F32}")
        cast = all(torch.equal(g, s.to(g.dtype)) for g, s in zip(got[:4], f32[:4]))
        if not (cast and all(g.dtype == t.dtype for g, t in zip(got[:4], args[:4]))):
            raise AssertionError(f"mamba_scan_fused_bwd {label}: the outputs in {dtype} are "
                                 "not the float32 sums cast")
        if not all(torch.equal(a, b) for a, b in zip(got, kernel(*args))):  # no atomics
            raise AssertionError(f"mamba_scan_fused_bwd {label}: two calls differ")
        bitwise = {n: torch.equal(g, w) for n, g, w in zip(names, f32, want)}
        planted = {}
        for name in faults.get(label, []):
            faulty = _with_fault("mamba_scan_fused_bwd", fault_libs[name], sb_mod,
                                 lambda: sums(*args))
            f_err = max(errs(faulty, want).values())
            print(f"[kernel] mamba_scan_fused_bwd planted fault {name} at {label}: scaled err "
                  f"{f_err:.6g} (sound {max(err.values()):.6g}, tol {TOL_F32})")
            if f_err <= TOL_F32:  # a faulty output of NaNs fails the check too
                raise AssertionError(f"planted fault {name} passed the check: {f_err}")
            planted[name] = f_err if math.isfinite(f_err) else str(f_err)
            del faulty
        esz = dt.element_size()
        # read once: dt, x, B, C, A, gy (h0, gh_fin); written once: gdt, gx,
        # gB, gC, gA, gh0
        nbytes = (2 * esz * (2 * B * S * di + 2 * B * S * N) + 4 * B * S * di
                  + 8 * di * N + 4 * (3 if with_h0 else 1) * B * di * N)
        # per state element and step: the forward again (dt A, exp, (dt x) B,
        # the update's multiply and add), gC's term (multiply, add), g (two
        # multiplies, an add), ga a (two multiplies), and the sums of gdt's,
        # gA's, gx's and gB's terms (a multiply and an add each)
        flops = 20 * B * S * di * N
        turns = _turns({"fused": kernel, "unfused": unfused}, args, iters=2)
        case = {
            "shape": f"{label}: dt/x[{B},{S},{di}] B/C[{B},{S},{N}] {dtype}"
                     f"{' h0 gh_fin' if with_h0 else ''}",
            "max_abs_err": max((g - w).abs().max().item() for g, w in zip(f32, want)),
            "scaled_err": max(err.values()), **{f"scaled_err_{n}": e for n, e in err.items()},
            "bit_for_bit": bitwise, "cast_bit_for_bit": cast,
            "workspace_bytes": mamba_scan_fused_bwd_workspace_bytes(B, S, di, N),
            **_times(None, plain, None, args, iters=2), **_fused_ms(turns),
            "bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_ops_ms": flops / PEAK_FP32_FLOPS * 1e3,
        }
        if planted:
            case["planted_fault_scaled_err"] = planted
        print(f"[kernel] mamba_scan_fused_bwd {label}: scaled err {err}; bit for bit with the "
              f"plain version: {bitwise}; in turns, fused {turns['fused']['median']:.6f} ms, "
              f"unfused (terms, mamba_scan_bwd, autograd) {turns['unfused']['median']:.6f} ms "
              "(medians, inputs cold)")
        cases.append(case)
        del dt, x, Bm, Cm, A, h0, gy, args, f32, got, want
    return cases


def _config(arch: str, layers: int):
    """``arch`` at its published widths and ``layers`` of its layers."""
    from repro_torch.configs import first_layers, get_config

    return first_layers(get_config(arch), layers)


def _launches_per_step(cfg) -> dict:
    """The kernels' launches one train step implies, in each of its M
    microbatches: every layer's forward once, and once more in the backward
    under remat; every layer's backward once; the final norm once each way.
    An attention layer launches flash, a Mamba layer the fused selective
    scan (which forms its terms itself); a
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
        out.update(mamba_scan_fused=r * (L - attn) * M, mamba_scan_fused_bwd=(L - attn) * M)
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
        if ("norm" in name or (name == "embedding" and not cfg.tie_embeddings)
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
    held = []  # what the run holds between steps: parameters and AdamW state
    last = {}

    def on_step(step, metrics, seconds):
        now = ops.launch_counts()
        per_step.append({k: now[k] - last.get(k, 0) for k in now})
        last.update(now)
        held.append(torch.cuda.memory_allocated() - base)

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # the main path's counts start here
    out = train(cfg, OptConfig(learning_rate=3e-4, warmup_steps=1), steps=steps,
                batch=TRAIN_BATCH, seq=seq, corpus_size=1, seed=seed, device="cuda",
                log_every=1, arch=arch, on_step=on_step)
    launches = ops.launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    peak = peak_bytes / 1e9
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
           "max_memory_allocated": peak_bytes, "held_bytes": held, "base_bytes": base,
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


def _lowest_priority():
    """In a child before it runs: the lowest CPU priority (a niceness of
    19), so that the card's phases keep their host cores."""
    os.nice(19)


def dryrun_start() -> dict:
    """Phase 9 (b)'s processes, started: ``python -m
    repro_torch.launch.dryrun`` over every cell on both meshes for each
    backend, in eight processes (each (backend, mesh) for every other
    config), and the dry-run side of (a) and (c) (``dryrun_cells``) in a
    ninth, each seeing no card (the dry-run runs on the meta device) and at the lowest
    CPU priority: they run on the host beside phase 8's card work, and
    ``dryrun_phase`` collects them."""
    from repro_torch.configs import ARCH_IDS

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    procs, dirs = {}, {}
    cells_path = OUT_DIR / "dryrun_cells.json"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    kw = dict(env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
              preexec_fn=_lowest_priority)
    for backend in ("xla", "fulllane"):
        dirs[backend] = OUT_DIR / f"dryrun_{backend}"
        shutil.rmtree(dirs[backend], ignore_errors=True)
        for mesh in ("single", "multi"):  # independent host processes
            for half in (0, 1):
                procs[backend, mesh, half] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                     *ARCH_IDS[half::2], "--mesh", mesh, "--backend", backend,
                     "--out-dir", str(dirs[backend])], **kw)
    procs["cells"] = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.dryrun_cells({str(cells_path)!r})"], **kw)
    atexit.register(_stop, list(procs.values()))  # a phase between them may fail
    return {"procs": procs, "dirs": dirs, "cells_path": cells_path,
            "t0": time.perf_counter()}


def _stop(procs: list) -> None:
    """Kill each of ``procs`` still running, and reap it."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def dryrun_phase(smi: str, started: dict) -> dict:
    """Phase 9 (b): waits for ``dryrun_start``'s processes.  Every cell must
    be ``ok`` or ``skipped`` by ``cell_eligible``: an error fails the
    phase.  Returns, by backend, the counts by status and the seconds, each
    ``fulllane`` train cell's cross-pod bytes per rank of the gradient
    sync on the multi-pod mesh, and the cells of (a) and (c)."""
    procs, dirs, cells_path = started["procs"], started["dirs"], started["cells_path"]
    t_wait = time.perf_counter()
    try:
        logs = {k: p.communicate(timeout=900)[0] for k, p in procs.items()}
    finally:
        _stop(procs.values())
    seconds = time.perf_counter() - started["t0"]
    waited = time.perf_counter() - t_wait
    (OUT_DIR / "dryrun_cells.log").write_text(logs["cells"])
    if procs["cells"].returncode:
        raise AssertionError(f"phase 9's dry-run cells: exit {procs['cells'].returncode}; "
                             f"{logs['cells'][-2000:]}")
    out = json.loads(cells_path.read_text())
    for backend, d in dirs.items():
        recs = [json.loads(f.read_text()) for f in sorted(d.glob("*.json"))]
        status = {k: sum(r["status"] == k for r in recs) for k in ("ok", "skipped", "error")}
        rcs = {}
        for mesh in ("single", "multi"):
            (OUT_DIR / f"dryrun_{backend}_{mesh}.log").write_text(
                logs[backend, mesh, 0] + logs[backend, mesh, 1])
            rcs[mesh] = [procs[backend, mesh, h].returncode for h in (0, 1)]
        if any(any(v) for v in rcs.values()) or status["error"] or len(recs) != 80:
            raise AssertionError(f"dryrun --backend {backend}: exit {rcs}, "
                                 f"{len(recs)} records, {status}; logs in build/chip_smoke")
        cross = {r["arch"]: r["dp_sync_sent_per_device"]["cross_pod_bytes"] for r in recs
                 if r["status"] == "ok" and r["shape"] == "train_4k" and r["mesh"] == "multi"
                 and r["dp_sync_sent_per_device"] is not None}
        slowest = max((r for r in recs if r["status"] == "ok"), key=lambda r: r["pass_s"])
        out[backend] = {"status": status, "cross_pod_bytes_train_4k_multi": cross,
                        "pass_s": sum(r.get("pass_s", 0) for r in recs)}
        print(f"[dryrun] --all --mesh both --backend {backend}: {status['ok']} cells ok, "
              f"{status['skipped']} skipped by cell_eligible, {status['error']} errors "
              f"(eight processes and (c)'s at once in {seconds:.1f} s beside phase 8, "
              f"{waited:.1f} s of it waited for; this backend's passes "
              f"{out[backend]['pass_s']:.1f} s, the slowest {slowest['arch']} "
              f"{slowest['shape']} {slowest['mesh']} {slowest['pass_s']} s; on the host: counts "
              f"from shapes on the meta device, not card numbers; {smi})")
    for arch, full in out["fulllane"]["cross_pod_bytes_train_4k_multi"].items():
        print(f"[dryrun] {arch} train_4k on 2 x 16 x 16: the shard_map step's gradient sync "
              f"sends {full / 2**20:.1f} MiB across pods per rank full-lane (the paper's count, "
              f"direct algorithms)")
    out["seconds"], out["waited"] = seconds, waited
    return out


#: phase 9's band on the dry-run's memory prediction: arguments plus
#: ``peak_bytes`` over the run's own peak (``peak_rows``), by kind of cell,
#: set from the ratios read on an H100: a one-card run of phase 8 (c) (read
#: 0.9976 to 1.0099; what the meter does not see, the kernels' workspaces
#: and Qwen2-VL's float32 embeds that the spec counts in bf16, is under
#: 0.3% of the peak), a rank of phase 10 (b)'s steps (0.9911 to 1.0000:
#: cuBLAS's two 32 MiB workspaces, made at a process's first GEMM), a rank
#: of (f)'s serving against its prefill and its decode cell (0.9766 to
#: 0.9981: cuBLAS's workspace and the check's own copies of the cache and
#: the logits)
PEAK_BAND = {"one rank": (0.98, 1.02), "train": (0.97, 1.03), "serve": (0.95, 1.03)}


def peak_rows(kind: str, cell: str, predicted: dict, peaks: dict, held: dict) -> list:
    """Phase 9's rows of one cell: ``predicted`` ({"arguments",
    "peak_bytes"}, the dry-run's rank 0) against each rank's own peak,
    its ``max_memory_allocated`` (``peaks``, by rank) less what the process
    held beside the cell's arguments when the peak was reset (``held``:
    what it kept from earlier work), as a ratio."""
    total = predicted["arguments"] + predicted["peak_bytes"]
    return [{"kind": kind, "cell": cell, "rank": r, **predicted, "predicted": total,
             "max_memory_allocated": m, "held": held[r], "measured": m - held[r],
             "ratio": total / (m - held[r])} for r, m in peaks.items()]


def peak_outside(rows: list) -> list:
    """The rows whose ratio lies outside their kind's ``PEAK_BAND``."""
    return [r for r in rows
            if not PEAK_BAND[r["kind"]][0] <= r["ratio"] <= PEAK_BAND[r["kind"]][1]]


def peak_check(rows: list, smi: str) -> dict:
    """Phase 9's peak check over ``rows`` (``peak_rows``): every ratio
    printed, by cell; any row outside its kind's band fails; and the band's
    planted fault: each row with its ``peak_bytes`` halved must fall
    outside it."""
    by_cell = {}
    for r in rows:
        by_cell.setdefault((r["kind"], r["cell"]), []).append(r)
    for (kind, cell), rs in by_cell.items():
        ratios = ", ".join(f"{r['rank']}: {r['ratio']:.4f}" for r in rs)
        peaks = ", ".join(f"{r['max_memory_allocated']:,} - {r['held']:,}" for r in rs)
        print(f"[dryrun] peak, {cell}: predicted arguments {rs[0]['arguments']:,} + peak_bytes "
              f"{rs[0]['peak_bytes']:,} = {rs[0]['predicted']:,} against max_memory_allocated "
              f"less what was held beside the arguments at its reset {peaks}; ratio by rank "
              f"{{{ratios}}} (band {PEAK_BAND[kind]}; {smi})")
    bad = peak_outside(rows)
    planted = peak_outside([dict(r, ratio=(r["arguments"] + r["peak_bytes"] // 2) / r["measured"])
                            for r in rows])
    if bad:
        raise AssertionError(f"phase 9: the dry-run's peak is outside its band at {bad}")
    if len(planted) != len(rows):
        raise AssertionError("phase 9: a record with its peak_bytes halved passed the band")
    return {"rows": rows, "planted_halved_outside": len(planted)}


def dryrun_one_rank(cells: dict, runs: dict) -> list:
    """Phase 9 (a): each run of phase 8 (c) against the dry-run's cell of
    its config and batch at a (1, 1) mesh (``dryrun_cells``): the
    one-card step (the shard_map cell on one rank: ``grad_and_metrics``
    and ``adamw_update`` on whole parameters, as ``make_train_step``
    runs them).  The card anchor, Yi-6B at 16 layers: the predicted bytes
    of the parameters and the AdamW state within 1% of what
    ``torch.cuda.memory_allocated`` holds between its steps, above what it
    held before the run.  Returns the peak rows (``peak_rows``)."""
    rows = []
    for arch, layers, _, _ in TRAIN_FULL_WIDTH:
        key = f"{arch} x{layers}"
        rec, run = cells[key], runs[f"train {key}"]
        parts = rec["memory"]["argument_bytes_by_part"]
        rows += peak_rows("one rank", f"(a) {key}, one rank", {
            "arguments": rec["memory"]["argument_bytes"],
            "peak_bytes": rec["memory"]["peak_bytes"]},
            {0: run["max_memory_allocated"]}, {0: run["base_bytes"]})
        if arch != "yi_6b":
            continue
        predicted = parts["params"] + parts["opt_state"]
        held = run["held_bytes"]
        ratio = predicted / held[0]
        print(f"[dryrun] (a) card anchor, {key}, {TRAIN_BATCH} x {TRAIN_SEQ}, a (1, 1) mesh: "
              f"predicted parameter and AdamW bytes {predicted:,} against "
              f"torch.cuda.memory_allocated between steps {held[0]:,} ({ratio:.6f}; bound 1%; "
              f"every step {min(held):,} to {max(held):,})")
        if abs(ratio - 1) > 0.01:
            raise AssertionError(f"card anchor: predicted {predicted} bytes, held {held[0]}")
    return rows


def _sharded_config(arch: str, micro: int = SHARDED_MICRO, rows: int = SHARDED_BATCH):
    """Phase 10's config of ``arch`` for a batch of ``rows`` in ``micro``
    microbatches: at full width and 2 layers, or, for an MoE config of
    ``SHARDED_MOE_ARCHS`` (phase 10 (e)), at its smoke widths with each row
    of a microbatch a dispatch group (``moe_groups``), so that the groups,
    and with them the routing, are the same in every reading."""
    from repro_torch.configs import get_smoke_config

    if arch in SHARDED_MOE_ARCHS:
        cfg = get_smoke_config(arch)
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel,
                                                                    moe_groups=rows // micro))
    else:
        cfg = _config(arch, 2)
    return dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel,
                                                                 microbatches=micro))


def sharded_reference(arch: str, path: Path, seed: int = 0) -> dict:
    """Phase 10 (a), in this process: phase 8 (b)'s one-rank step through the
    kernels (``grad_and_metrics`` and ``adamw_update``) on phase 10's
    config and batch; the updated parameters, first moments and each first
    moment's rms over its leaf saved to ``path`` (by key, on the host) for
    the ranks to compare with.  Then the two readings that place phase
    10's limits (``SHARDED_M_TOL``, ``_param_check``): the same step in
    ``SHARDED_ORDER_MICRO`` microbatches (another summation order of the
    same sums; for an MoE config of (e), whose aux loss is a product of
    means over a microbatch, the step through the plain versions) and the
    step without the last data-parallel rank's rows (a fault), each held
    to the first by the checks the ranks make, the first moments leaf by
    leaf at ``_m_tols``' limits."""
    import torch

    from repro_torch.models import lm
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state
    from repro_torch.training.train_step import batch_to, grad_and_metrics

    cfg = _sharded_config(arch)
    lr = _sharded_lr(arch)
    opt_cfg = OptConfig(learning_rate=lr, warmup_steps=1)
    batch = batch_to(make_batch(cfg, SHARDED_BATCH, SHARDED_SEQ, seed=seed), "cuda")

    def one_step(cfg, batch, plain=False):
        params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_kernels() if plain else contextlib.nullcontext():
            grads, metrics = grad_and_metrics(cfg, params, batch)
        params, opt, info = adamw_update(grads, init_opt_state(params, opt_cfg), params,
                                         opt_cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del grads
        return params, opt["m"], {"loss": float(metrics["loss"]),
                                  "grad_norm": float(info["grad_norm"]), "seconds": secs}

    params, m, out = one_step(cfg, batch)
    want = {"params": {k: t.cpu() for k, t in _leaf_paths(params)},
            "m": {k: t.cpu() for k, t in _leaf_paths(m)},
            "m_rms": {k: t.float().square().mean().sqrt().item() for k, t in _leaf_paths(m)}}
    torch.save(want, path)
    del params, m
    pods, data, _ = SHARDED_MESH
    kept = SHARDED_BATCH - SHARDED_BATCH // (pods * data)
    order = (_sharded_config(arch, SHARDED_ORDER_MICRO), batch, False)
    if arch in SHARDED_MOE_ARCHS:
        order = (cfg, batch, True)
    readings = {
        "order": order,
        "fault": (_sharded_config(arch, rows=kept), {k: v[:kept] for k, v in batch.items()},
                  False)}
    tol = _m_tols(cfg)
    for name, (c, b, plain) in readings.items():
        gc.collect()
        torch.cuda.empty_cache()
        params, m, info = one_step(c, b, plain)
        errs = {}
        for (k, pt), (_, mt) in zip(_leaf_paths(params), _leaf_paths(m)):
            wp = want["params"][k].to("cuda").float()
            wm = want["m"][k].to("cuda").float()
            rms = wp.square().mean(dim=-1, keepdim=True).sqrt().clamp_min(1e-30)
            ratio, need = _param_check(pt, wp, wm, rms, want["m_rms"][k], lr)
            errs[k] = (ratio, need, ((mt.float() - wm).square().sum() /
                                     wm.square().sum().clamp_min(1e-30)).sqrt().item())
        out[name] = {"loss": info["loss"], "grad_norm": info["grad_norm"],
                     "param_ratio": max(e[0] for e in errs.values()),
                     "near_zero_needed": max(e[1] for e in errs.values()),
                     "m_err": max(e[2] for e in errs.values()),
                     "m_ratio": max(e[2] / tol[k] for k, e in errs.items()),
                     "m_worst": _worst({k: e[2] for k, e in errs.items()})}
        del params, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_references(archs: list, ref_dir: str) -> dict:
    """Phase 10 (a) in a rank of its own: ``sharded_reference`` of each of
    ``archs`` into ``<ref_dir>/<arch>.pt``."""
    import torch

    torch.cuda.set_device(0)
    out = {}
    for arch in archs:
        out[arch] = sharded_reference(arch, Path(ref_dir) / f"{arch}.pt")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _gloo_ops() -> dict:
    """Which of ``GLOO_OPS`` the world's gloo takes on CUDA tensors, each
    checked for its value: "ok", "wrong values", or what it raised (a
    report: the mesh stages every op through the host whatever it says)."""
    import torch
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.full((4 * n,), float(r + 1), device="cuda")
    each = torch.arange(1.0, n + 1, device="cuda")  # rank r's value at index r
    total = float(n * (n + 1) // 2)

    def call(name: str) -> bool:
        if name == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            return bool(y.eq(total).all())
        if name == "broadcast":
            y = x.clone()
            dist.broadcast(y, 0)
            return bool(y.eq(1.0).all())
        if name == "all_gather_into_tensor":
            y = x.new_empty(4 * n * n)
            dist.all_gather_into_tensor(y, x)
            return bool(y.view(n, -1)[:, 0].eq(each).all())
        if name == "reduce_scatter_tensor":
            y = x.new_empty(4)
            dist.reduce_scatter_tensor(y, x)
            return bool(y.eq(total).all())
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return bool(y.view(n, -1)[:, 0].eq(each).all())

    out = {}
    for name in GLOO_OPS:
        try:  # what the backend takes is reported, never chosen by it
            out[name] = "ok" if call(name) else "wrong values"
        except RuntimeError as e:
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"
        dist.barrier()
    return out


def sharded_job(archs: list, ref_dir: str, seed: int = 0) -> dict:
    """Phase 10 (b), the body of one rank of the (pod 2, data 2, model 2)
    mesh on this card: for each of ``archs``, the sharded step
    (``make_train_step_sharded``) and the shard_map step with TP
    (``make_train_step(mesh=)``, ``"fulllane"``, ``fsdp=False``), each from
    phase 10's seeded parameters and batch; each rank measures its shards
    of every updated parameter and first moment against the same elements
    of the one-rank step's in ``<ref_dir>/<arch>.pt`` (``_shard_errs``; the
    caller takes the worst over ranks).  Each kernel wrapper's input shapes
    are recorded (they must be the rank's shards), the launches counted
    over each step, the collectives counted by ``CommDebugMode``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core.groups import MeshAxes
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import scaled_err
    from repro_torch.launch.costanalysis import CollectiveBytes
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import shard_params
    from repro_torch.training import train_step as T
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state, leaves

    torch.cuda.set_device(0)
    rank = dist.get_rank()
    gloo = _gloo_ops()
    mesh = make_device_mesh(SHARDED_MESH, ("pod", "data", "model"), "cuda")
    view = MeshAxes(mesh)
    wrappers = ("rmsnorm_cuda", "rmsnorm_bwd_cuda", "flash_attention_cuda",
                "flash_attention_bwd_cuda", "mamba_scan_cuda", "mamba_scan_bwd_cuda",
                "mamba_scan_fused_cuda", "mamba_scan_fused_bwd_cuda")
    shapes = []

    def recording(name, fn):
        def wrapped(*args, **kw):
            shapes.append((name, tuple(args[0].shape)))
            return fn(*args, **kw)
        return wrapped

    saved = {n: getattr(ops, n) for n in wrappers}
    out = {"gloo": gloo, "rank": rank}
    if any(v != "ok" for v in gloo.values()):
        print(f"rank {rank}: gloo on CUDA tensors: {gloo}", file=sys.stderr)
    try:
        for n, fn in saved.items():
            setattr(ops, n, recording(n, fn))
        for arch in archs:
            for backend in _sharded_backends(arch):
                print(f"[sharded] rank {rank}: {arch} {backend}, "
                      f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
                      f"{torch.cuda.mem_get_info()[0] / 1e9:.2f} GB free on the card",
                      file=sys.stderr, flush=True)
                cfg = _sharded_config(arch)
                if backend != "xla":
                    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
                        cfg.parallel, fsdp=False))
                opt_cfg = OptConfig(learning_rate=_sharded_lr(arch), warmup_steps=1)
                full = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(seed))
                replica = sum(t.numel() for t in leaves(full))  # a replica's elements
                if backend == "xla":
                    step, (pspec, _) = T.make_train_step_sharded(cfg, mesh, opt_cfg)
                else:
                    step = T.make_train_step(cfg, opt_cfg, backend=backend, mesh=mesh)
                    pspec = T.param_pspecs(cfg, mesh)
                params = shard_params(full, pspec, mesh)
                del full
                opt = init_opt_state(params, opt_cfg, T.opt_placements(cfg, mesh))
                batch = make_batch(cfg, SHARDED_BATCH, SHARDED_SEQ, seed=seed)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated()
                mine = {k: sum(t.to_local().numel() * t.to_local().element_size()
                               for t in leaves(tree))
                        for k, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"]))}
                staged0 = view.staged_bytes()
                shapes.clear()
                ops.reset_launches()  # this run's counts start here
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rec = CollectiveBytes()
                with CommDebugMode() as comm, rec:
                    params, opt, metrics = step(params, opt, batch)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = ops.launch_counts()
                peak = torch.cuda.max_memory_allocated()
                staged = {k: v - staged0.get(k, 0) for k, v in view.staged_bytes().items()}
                res = {"metrics": {k: float(v) for k, v in metrics.items()}, "seconds": secs,
                       "launches": launches, "kernel_shapes": sorted(set(shapes)),
                       "bytes": mine, "replica_elements": replica, "peak_bytes": peak,
                       "allocated_at_start": start,
                       "collectives": {str(k): v for k, v in comm.get_comm_counts().items()},
                       "recorded": (dict(rec.bytes), dict(rec.counts)),
                       "staged_bytes": staged,
                       "dp_traffic": view.traffic.snapshot()}
                view.traffic.reset()
                # each rank holds the elements it owns to the same elements of the
                # one-rank step's: every element of every leaf is compared, none is
                # gathered (eight ranks share the card and its host link)
                gc.collect()
                torch.cuda.empty_cache()
                want = torch.load(Path(ref_dir) / f"{arch}.pt", mmap=True)
                res["errs"] = {k: _shard_errs(pt, want["params"][k], mt, want["m"][k],
                                              want["m_rms"][k], _sharded_lr(arch))
                               for (k, pt), (_, mt) in zip(_leaf_paths(params),
                                                           _leaf_paths(opt["m"]))}
                del params, opt, want
                gc.collect()
                torch.cuda.empty_cache()
                out[f"{arch} {backend}"] = res
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
    return out


def _m_tols(cfg) -> dict:
    """Phase 10's limit on each leaf's first moment, by leaf path
    (``_leaf_paths``'): ``SHARDED_MOE_M_TOL`` for a leaf that follows the
    routing (one with an ``experts`` axis: the router and the experts),
    else ``SHARDED_M_TOL``."""
    from repro_torch.models import lm
    from repro_torch.models.params import map_tree

    return dict(_leaf_paths(map_tree(
        lambda _, m: SHARDED_MOE_M_TOL if "experts" in m.axes else SHARDED_M_TOL,
        lm.model_meta(cfg))))


def _worst(errs: dict, n: int = 3) -> list:
    """The ``n`` largest of ``errs`` (by key), largest first."""
    return sorted(errs.items(), key=lambda kv: -kv[1])[:n]


def _sharded_backends(arch: str) -> tuple:
    """The steps phase 10 (b) runs ``arch`` through: the sharded step and the
    ``fulllane`` shard_map step, or the sharded step alone for an MoE config
    of (e), whose dispatch groups the shard_map step would take from each
    rank's rows."""
    return ("xla",) if arch in SHARDED_MOE_ARCHS else ("xla", "fulllane")


def _sharded_lr(arch: str) -> float:
    """Phase 10's learning rate for ``arch``."""
    return SHARDED_MOE_LR if arch in SHARDED_MOE_ARCHS else SHARDED_LR


def _param_check(p, want, want_m, rms, m_rms: float, lr: float) -> tuple[float, float]:
    """Updated parameters of one leaf (or of a shard of it) after phase 10's
    first AdamW step against the one-rank step's (``want``), judged from
    the one-rank step's side alone: (the largest ``|p - want|`` over its
    allowance, the largest ``|want_m| / m_rms`` of an element off by more
    than ``TOL_BF16`` in its scale).  The allowance is ``TOL_BF16`` in
    ``ref.scaled_err``'s scale (``|want| + rms``, ``rms`` that of ``want``'s
    whole row), and where the one-rank step's first moment ``want_m`` lies
    within ``SHARDED_NEAR_ZERO`` of its leaf's rms ``m_rms`` of zero, at
    least a sign flip of the first step (``2 lr``) plus one bf16 unit in
    the last place: a gradient within rounding of zero may take another
    sign in another summation order, and a first AdamW step moves each
    element by ``lr`` times the sign of its gradient (a zero-initialised
    bias, Falcon's ``conv_b``, is then ``+-lr`` apart, 1 in
    ``scaled_err``)."""
    import torch

    want, p, want_m = want.float(), p.float(), want_m.float()
    big = torch.maximum(p.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    scale = TOL_BF16 * (want.abs() + rms)
    near = want_m.abs() <= SHARDED_NEAR_ZERO * m_rms
    allow = torch.where(near, torch.maximum(scale, 2 * lr + ulp), scale)
    diff = (p - want).abs()
    off = diff > scale
    need = want_m.abs()[off].max().item() / max(m_rms, 1e-30) if off.any() else 0.0
    return (diff / allow).max().item(), need


def _local_slices(t) -> tuple:
    """Where the DTensor ``t``'s local shard sits in the whole tensor, a
    slice per dim (even shards, a dim split in mesh-dim order, as
    ``models/params.shard_tensor`` cuts them)."""
    start, size = [0] * t.ndim, list(t.shape)
    coord = t.device_mesh.get_coordinate()
    for d, p in enumerate(t.placements):
        if p.is_shard():
            size[p.dim] //= t.device_mesh.size(d)
            start[p.dim] += coord[d] * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def _shard_errs(p, want_p, m, want_m, m_rms: float, lr: float) -> tuple:
    """This rank's shard of an updated parameter ``p`` and of its first
    moment ``m`` (DTensors) against the same elements of the one-rank
    step's (``want_p``, ``want_m``: whole tensors on the host; ``m_rms``
    the rms of ``want_m``): (``_param_check``'s two numbers, each over the
    shard with its rows' whole rms, ``ref.scaled_err``, and ``sum (m -
    want_m)^2``, ``sum want_m^2`` over the moment's shard, 0 on all but the
    first rank of each replica, so that the sums over ranks count each
    element once)."""
    local = p.to_local()
    sl = _local_slices(p)
    rows = want_p[sl[:-1]].to(local.device).float()  # whole rows, for their rms
    rms = rows.square().mean(dim=-1, keepdim=True).sqrt().clamp_min(1e-30)
    wp = rows[..., sl[-1]]
    ratio, need = _param_check(local, wp, want_m[sl].to(local.device), rms, m_rms, lr)
    err = ((local.float() - wp).abs() / (wp.abs() + rms)).max().item()
    first = all(c == 0 for c, q in zip(m.device_mesh.get_coordinate(), m.placements)
                if not q.is_shard())
    if not first:
        return ratio, need, err, 0.0, 0.0
    wms = want_m[_local_slices(m)].to(local.device).float()
    return (ratio, need, err, (m.to_local().float() - wms).square().sum().item(),
            wms.square().sum().item())


def _local_shapes(cfg, shapes: list) -> list:
    """The wrapper calls of ``shapes`` that are not at a rank's shard of
    phase 10's step: RMSNorm at the rank's rows (``rows * S`` flattened
    rows), attention at ``rows * H / model`` kernel rows, the scan at
    ``d_inner / model`` channels, ``rows`` a microbatch's rows on one
    data-parallel rank."""
    pods, data, model = SHARDED_MESH
    rows = SHARDED_BATCH // (pods * data) // SHARDED_MICRO
    bad = []
    for name, shape in shapes:
        if name.startswith("rmsnorm"):
            ok = shape[0] == rows * SHARDED_SEQ
        elif name.startswith("flash"):
            ok = shape[:2] == (rows * cfg.attn.num_heads // model, SHARDED_SEQ)
        else:
            ok = shape[:3] == (rows, SHARDED_SEQ, cfg.mamba.expand * cfg.d_model // model)
        if not ok:
            bad.append((name, shape))
    return bad


@contextlib.contextmanager
def _expandable_segments():
    """Ranks started inside get CUDA memory in segments that grow in place:
    8 ranks share the card's memory, and fixed segments strand a share of
    it between allocations."""
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if env is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env


#: phase 10's one-rank references, each a process of its own: (a)'s steps,
#: (d)'s MoE layers, (f)'s serving paths, by the directory (under
#: ``OUT_DIR``) that each leaves its results in for the ranks: (job, kwargs)
PHASE10_REFERENCES = {
    "sharded": ("chip_smoke:sharded_references",
                {"archs": list(SHARDED_ARCHS + SHARDED_MOE_ARCHS)}),
    "moe_layer": ("chip_smoke:moe_layer_reference", {"cases": MOE_LAYER_CASES}),
    "serve_sharded": ("chip_smoke:serve_sharded_reference", {}),
}


def _in_background(fn, *args):
    """``fn(*args)`` in a thread of its own; returns its future, whose
    ``result()`` waits for it and raises what it raised."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    future = pool.submit(fn, *args)
    pool.shutdown(wait=False)
    return future


def phase10_references() -> dict:
    """Phase 10's one-rank references (``PHASE10_REFERENCES``), started
    together and awaited together: each needs a part of the card and
    spends most of its time on the host (its start-up, drawing and saving
    its results).  ``main`` runs them beside phase 7's ranks and awaits
    them before phase 8 times kernels; each has exited, returning its card
    memory, long before phase 10's ranks need the whole card.  Returns
    each one's (result, seconds with its start-up) by directory."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import ranks

    def run(key: str) -> tuple:
        job, kwargs = PHASE10_REFERENCES[key]
        d = OUT_DIR / key
        d.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        (one,) = ranks.run(job, 1, timeout_s=600, kwargs={**kwargs, "ref_dir": str(d)})
        return one, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(PHASE10_REFERENCES)) as pool:
        futures = {key: pool.submit(run, key) for key in PHASE10_REFERENCES}
        out = {key: f.result() for key, f in futures.items()}
    print(f"[sharded] phase 10's one-rank references at once, each in a process of its own: "
          + ", ".join(f"{key} {s:.1f} s" for key, (_, s) in out.items())
          + f"; all in {time.perf_counter() - t0:.1f} s (start-up included)")
    return out


def sharded_phase(smi: str, reference: tuple) -> dict:
    """Phase 10: the sharded train step on this card.  (a) the one-rank
    step of each model of ``SHARDED_ARCHS`` through the kernels, in a
    process of its own (``reference``: its result and seconds, from
    ``phase10_references``); (b) ``sharded_job`` in 8 ranks ((c) is
    ``sharded_cli``).  Each sharded and
    TP step within 2e-2 of the one-rank step (loss and ``grad_norm``
    relative), every first moment's rms over its leaf within
    ``SHARDED_M_TOL``, every updated parameter by ``_param_check``, each on
    the ranks that hold it; its launches those the one-rank step makes on
    each rank, every wrapper call at the rank's shard.  The limits must
    part (a)'s two readings."""
    import torch

    from repro_torch.launch import ranks

    d = OUT_DIR / "sharded"
    pods, data, model = SHARDED_MESH
    archs = list(SHARDED_ARCHS + SHARDED_MOE_ARCHS)
    one, ref_s = reference
    for arch, r in one.items():
        print(f"[sharded] the one-rank step of {arch} through the kernels: loss "
              f"{r['loss']:.6f}, grad_norm {r['grad_norm']:.6f}, {r['seconds']:.2f} s")
        o, f = r["order"], r["fault"]
        how = ("through the plain versions" if arch in SHARDED_MOE_ARCHS
               else f"in {SHARDED_ORDER_MICRO} microbatches")
        print(f"[sharded] {arch}, the checks' two readings against that step: {how} "
              f"(another order) first moments {o['m_err']:.4g}, {o['m_ratio']:.4g} of their "
              f"limit (worst {o['m_worst']}), parameters {o['param_ratio']:.4g} of their "
              f"allowance (near zero needed {o['near_zero_needed']:.4g}, given "
              f"{SHARDED_NEAR_ZERO}); without a data-parallel rank's rows (a fault) first "
              f"moments {f['m_err']:.4g}, {f['m_ratio']:.4g} of their limit, parameters "
              f"{f['param_ratio']:.4g} of their allowance")
        # the limits lie between the readings: another order passes with room, the fault fails
        if not (o["m_ratio"] <= 0.5 and o["param_ratio"] <= 1.0
                and f["m_ratio"] >= 2 and f["param_ratio"] > 1.0):
            raise AssertionError(f"{arch}: phase 10's limits do not part a correct order "
                                 f"{o} from a fault {f}")
    print(f"[sharded] one-rank steps in {ref_s:.1f} s (start-up included); "
          f"{torch.cuda.mem_get_info()[0] / 1e9:.2f} GB free on the card")
    world = math.prod(SHARDED_MESH)
    t0 = time.perf_counter()
    with _expandable_segments():
        got = ranks.run("chip_smoke:sharded_job", world, timeout_s=900,
                        kwargs={"archs": archs, "ref_dir": str(d)})
    job_s = time.perf_counter() - t0
    print(f"[sharded] {world} ranks on cuda:0 as a (pod, data, model) = {SHARDED_MESH} mesh "
          f"over gloo, in {job_s:.1f} s (start-up included); gloo takes CUDA tensors for "
          f"{got[0]['gloo']}; the mesh's groups stage through pinned host memory "
          f"(core/groups.StagedGroup); {smi}")
    out = {"one_rank": one, "ranks": {}, "job_seconds": job_s}
    for arch in archs:
        cfg = _sharded_config(arch)
        tol = _m_tols(cfg)
        want = {**dict.fromkeys(got[0][f"{arch} xla"]["launches"], 0), **_launches_per_step(cfg)}
        for backend in _sharded_backends(arch):
            key = f"{arch} {backend}"
            r0 = got[0][key]
            leaves = r0["errs"]
            ratio = {k: max(r[key]["errs"][k][0] for r in got) for k in leaves}
            need = max(max(r[key]["errs"][k][1] for r in got) for k in leaves)
            err = max(max(r[key]["errs"][k][2] for r in got) for k in leaves)
            m_err = {k: math.sqrt(sum(r[key]["errs"][k][3] for r in got) /
                                  max(sum(r[key]["errs"][k][4] for r in got), 1e-30))
                     for k in leaves}
            worst = sorted(ratio, key=lambda k: -ratio[k])[:3]
            r0 = {**r0, "param_ratio": max(ratio.values()), "param_err": err,
                  "near_zero_needed": need, "m_err": max(m_err.values()),
                  "m_ratio": max(m_err[k] / tol[k] for k in leaves), "m_worst": _worst(m_err),
                  "param_worst": [(k, [ratio[k], m_err[k]]) for k in worst]}
            loss_rel = abs(r0["metrics"]["loss"] - one[arch]["loss"]) / abs(one[arch]["loss"])
            gn_rel = abs(r0["metrics"]["grad_norm"] - one[arch]["grad_norm"]) / one[arch][
                "grad_norm"]
            bad_shapes = {r["rank"]: _local_shapes(cfg, r[key]["kernel_shapes"]) for r in got}
            bad_launches = {r["rank"]: r[key]["launches"] for r in got
                            if r[key]["launches"] != want}
            # a replica's parameters in the model dtype, its moments in float32
            n = r0["replica_elements"]
            p_share = max(r[key]["bytes"]["params"] for r in got) / (2 * n)
            m_share = max(r[key]["bytes"]["m"] + r[key]["bytes"]["v"] for r in got) / (8 * n)
            p_want = 1 / (data * model) if backend == "xla" else 1 / model
            print(f"[sharded] {key}: loss {r0['metrics']['loss']:.6f} against the one-rank "
                  f"step's {one[arch]['loss']:.6f} (rel {loss_rel:.3g}), grad_norm "
                  f"{r0['metrics']['grad_norm']:.6f} against {one[arch]['grad_norm']:.6f} (rel "
                  f"{gn_rel:.3g}); every first moment: rms over its leaf "
                  f"{r0['m_err']:.4g}, {r0['m_ratio']:.4g} of its limit (worst "
                  f"{r0['m_worst']}); every updated parameter: over "
                  f"its allowance {r0['param_ratio']:.4g} (tol 1; plain scaled err "
                  f"{r0['param_err']:.3g}; near zero needed {need:.4g}, given "
                  f"{SHARDED_NEAR_ZERO}; "
                  f"worst leaves {[(k, [round(x, 5) for x in e]) for k, e in r0['param_worst']]})"
                  f"; launches per rank {r0['launches']} "
                  f"(the one-rank step's); wrapper shapes {r0['kernel_shapes']}")
            mem = [r[key]["peak_bytes"] / 1e9 for r in got]
            print(f"[sharded] {key}: per rank, parameters {r0['bytes']['params'] / 1e9:.3f} GB "
                  f"({p_share:.4f} of a replica's {2 * n / 1e9:.3f} GB; 1/{round(1 / p_want)} "
                  f"where a leaf divides), AdamW m + v "
                  f"{(r0['bytes']['m'] + r0['bytes']['v']) / 1e9:.3f} GB ({m_share:.4f} of a "
                  f"replica's, ZeRO-1); peak memory over the step {min(mem):.2f}-{max(mem):.2f} "
                  f"GB; collectives (CommDebugMode) {r0['collectives']}; staged through the "
                  f"host {r0['staged_bytes']}; step {r0['seconds']:.2f} s on rank 0 (host "
                  f"clock, {HOST_STAGED}); {smi}")
            if not (p_share <= 1.05 * p_want and m_share <= 1.05 / (data * model)):
                raise AssertionError(f"{key}: a rank holds {p_share} of the parameters "
                                     f"(want {p_want}), {m_share} of the moments")
            if not (loss_rel <= TOL_BF16 and gn_rel <= TOL_BF16 and r0["m_ratio"] <= 1.0
                    and r0["param_ratio"] <= 1.0 and not any(bad_shapes.values())
                    and not bad_launches):
                raise AssertionError(f"{key}: loss rel {loss_rel}, grad_norm rel {gn_rel}, "
                                     f"moments {r0['m_err']}, params {r0['param_worst']}, "
                                     f"shapes off the shards "
                                     f"{bad_shapes}, launches {bad_launches} (want {want})")
        out["ranks"][arch] = {key: [r[key] for r in got] for key in got[0] if
                              key.startswith(arch)}
    shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_cli() -> dict:
    """Phase 10 (c): ``launch/train.py --mesh 2,2,2`` for 4 steps on one
    repeated batch (``SHARDED_CLI``), in 8 ranks of its own; its loss must
    fall."""
    from repro_torch.launch import train as train_cli

    t0 = time.perf_counter()
    cli = train_cli.main(SHARDED_CLI)
    losses = [h["loss"] for h in cli["history"]]
    print(f"[sharded] launch/train.py {' '.join(SHARDED_CLI)}: losses {losses}, "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start-up, beside (f)'s ranks; "
          f"step seconds {[round(h['seconds'], 2) for h in cli['history']]} ({HOST_STAGED})")
    if not (len(losses) == 4 and all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the meshed CLI's loss did not fall: {losses}")
    return {"argv": SHARDED_CLI, "losses": losses,
            "step_s": [h["seconds"] for h in cli["history"]]}


def _moe_layer_config(arch: str, groups: int, smoke: bool = False):
    """Phase 10 (d)'s config: ``arch`` at its published widths (or its smoke
    widths, a rehearsal's) with ``moe_groups``."""
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if smoke else get_config)(arch)
    return dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel,
                                                                 moe_groups=groups))


def _moe_layer_shapes(cfg, batch: int, seq: int) -> dict:
    """The shape of each tensor of phase 10 (d)'s layer, by key."""
    from repro_torch.models.moe import moe_meta

    shapes = {k: m.shape for k, m in moe_meta(cfg).items()}
    return {**shapes, "x": (batch, seq, cfg.d_model), "c": (batch, seq, cfg.d_model)}


def _moe_layer_rows(key: str, shape: tuple, lo: int, hi: int, seed: int, device: str):
    """Rows ``[lo, hi)`` of dim 0 of phase 10 (d)'s seeded tensor ``key``
    (bf16): an expert-stacked weight drawn an expert at a time, each from a
    generator of its own (a rank draws its experts alone), any other
    tensor drawn whole and cut; a weight at ``1/sqrt`` of its input
    width."""
    import torch

    base = seed * 1_000_003 + MOE_LAYER_KEYS.index(key) * 1009
    scale = 1.0 if key in ("x", "c") else 1 / math.sqrt(shape[-2])

    def draw(shape_, s):
        g = torch.Generator(device=device).manual_seed(s)
        return (torch.randn(shape_, generator=g, device=device) * scale).to(torch.bfloat16)

    if key in ("w_gate", "w_up", "w_down"):
        return torch.stack([draw(shape[1:], base + e) for e in range(lo, hi)])
    return draw(shape, base)[lo:hi]


def _moe_layer_shard(key: str, shape: tuple, mesh, pl: tuple, seed: int):
    """This rank's shard of phase 10 (d)'s tensor ``key`` placed on ``mesh``
    by ``pl``, drawn for its rows of dim 0 alone."""
    from torch.distributed.tensor import DTensor

    coord = mesh.get_coordinate()
    lo, hi = 0, shape[0]
    for d, q in enumerate(pl):  # dim 0 is split in mesh order
        if q.is_shard(0):
            n = (hi - lo) // mesh.size(d)
            lo, hi = lo + coord[d] * n, lo + (coord[d] + 1) * n
    local = _moe_layer_rows(key, shape, lo, hi, seed, mesh.device_type)
    for d, q in enumerate(pl):
        if q.is_shard() and not q.is_shard(0):
            local = local.chunk(mesh.size(d), q.dim)[coord[d]]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False)


def _moe_layer_loss(cfg, params: dict, x, c, fn=None):
    """``moe(cfg, params, x)`` (or ``fn``'s) and the gradients of ``sum(c *
    out) + aux`` by key (``x`` and every weight): (out, aux, grads)."""
    import torch

    from repro_torch.models.moe import moe

    keys = sorted(params)
    out, aux = (fn or moe)(cfg, params, x)
    grads = torch.autograd.grad((out * c).sum() + aux, [x, *(params[k] for k in keys)])
    return out, aux, dict(zip(["x", *keys], grads))


def _moe_emulated(cfg, p: dict, x, mesh_shape: tuple, drop=None):
    """Phase 10 (d)'s expert-parallel layer as one process's sums: each
    data-parallel share's routing (``moe._route_on_rank``) and each
    ``model`` rank's experts on it (``moe._experts_on_rank``, on its slices
    of the whole weights), the ``model`` partials summed in reverse rank
    order (``drop``: one rank's partial left out, a fault), the aux loss
    from the shares' sums.  The same function as ``moe``, in another
    summation order."""
    import torch

    from repro_torch.models import moe as M

    pods, data, model = mesh_shape
    ndp, e = pods * data, cfg.moe
    B, S, _ = x.shape
    G = M._groups(cfg, B * S)
    shares = x.chunk(ndp) if G % ndp == 0 and B % ndp == 0 else [x]
    El = e.num_experts // model
    outs, f_sum, p_sum = [], 0, 0
    for xi in shares:
        gw, gi, fs, ps = M._route_on_rank(cfg, p["router"], xi, G // len(shares))
        f_sum, p_sum, partial = f_sum + fs, p_sum + ps, 0
        for m in reversed(range(model)):
            w = {k: p[k][m * El:(m + 1) * El] for k in ("w_gate", "w_up", "w_down")}
            if e.num_shared_experts:
                w.update(shared_gate=p["shared_gate"].chunk(model, 1)[m],
                         shared_up=p["shared_up"].chunk(model, 1)[m],
                         shared_down=p["shared_down"].chunk(model, 0)[m])
            if m != drop:
                partial = partial + M._experts_on_rank(cfg, w, xi, gw, gi, G // len(shares),
                                                       m * El)
        outs.append(partial)
    T = B * S
    aux = e.num_experts * torch.sum((f_sum / T) * (p_sum / T)) * e.router_aux_weight
    return torch.cat(outs), aux


def _moe_layer_errs(got: dict, want: dict) -> dict:
    """Each quantity's ``ref.scaled_err`` against the one-rank layer's (the
    aux loss: relative)."""
    from repro_torch.kernels.ref import scaled_err

    return {k: (abs(float(got[k]) - float(want[k])) / abs(float(want[k])) if k == "aux"
                else scaled_err(got[k], want[k])) for k in want}


def moe_layer_reference(ref_dir: str, cases: list, smoke: bool = False,
                        batch: int = MOE_LAYER_BATCH, seq: int = MOE_LAYER_SEQ,
                        device: str = "cuda", seed: int = 0) -> dict:
    """Phase 10 (d) (a), in a process of its own: for each case, the
    one-rank layer on the whole seeded tensors, its output, aux loss and
    gradients saved to ``<ref_dir>/<label>.pt`` for the ranks, and the two
    readings that place (d)'s limit: the layer's sums in another order
    (``_moe_emulated``, which must pass with room) and with the last
    ``model`` rank's partial dropped (which must fail)."""
    import torch

    if device == "cuda":
        torch.cuda.set_device(0)
    out = {}
    for label, arch, groups in cases:
        cfg = _moe_layer_config(arch, groups, smoke)
        shapes = _moe_layer_shapes(cfg, batch, seq)
        t = {k: _moe_layer_rows(k, s, 0, s[0], seed, device) for k, s in shapes.items()}
        c = t.pop("c")
        x = t.pop("x").requires_grad_()
        p = {k: v.requires_grad_() for k, v in t.items()}
        t0 = time.perf_counter()
        o, aux, grads = _moe_layer_loss(cfg, p, x, c)
        if device == "cuda":
            torch.cuda.synchronize()
        want = {"out": o.detach(), "aux": aux.detach(), **grads}
        res = {"seconds": time.perf_counter() - t0}
        torch.save({k: v.cpu() for k, v in want.items()}, Path(ref_dir) / f"{label}.pt")
        for name, drop in (("order", None), ("fault", MOE_LAYER_MESH[2] - 1)):
            o, aux, grads = _moe_layer_loss(cfg, p, x, c, lambda cfg_, p_, x_: _moe_emulated(
                cfg_, p_, x_, MOE_LAYER_MESH, drop))
            res[name] = _moe_layer_errs({"out": o.detach(), "aux": aux, **grads}, want)
            del o, grads
        out[label] = res
        del want, p, x, t
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def moe_layer_job(ref_dir: str, cases: list, smoke: bool = False, batch: int = MOE_LAYER_BATCH,
                  seq: int = MOE_LAYER_SEQ, device: str = "cuda", seed: int = 0) -> dict:
    """Phase 10 (d) (b), the body of one rank of the ``MOE_LAYER_MESH``
    mesh: for each case, the expert-parallel layer (``moe`` on DTensors)
    forward and backward on this rank's shards of the seeded tensors
    (weights by the FSDP rules, x and c over the data-parallel dims), and
    each quantity's ``ref.scaled_err`` over the elements this rank holds
    against the same elements of the one-rank layer's in
    ``<ref_dir>/<label>.pt``: its output rows, x's gradient (summed over
    ``model``), its experts', the shared experts' and the router's
    gradients, the aux loss.  Also its peak memory over the case, the
    step's host-clock seconds and the collectives by op."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.moe import moe_meta
    from repro_torch.models.params import partition_specs, placements

    if device == "cuda":
        torch.cuda.set_device(0)
    rank = dist.get_rank()
    mesh = make_device_mesh(MOE_LAYER_MESH, ("pod", "data", "model"), device)
    sizes = dict(zip(mesh.mesh_dim_names, MOE_LAYER_MESH))
    dp = (Shard(0), Shard(0), Replicate())
    out = {"rank": rank}
    for label, arch, groups in cases:
        cfg = _moe_layer_config(arch, groups, smoke)
        shapes = _moe_layer_shapes(cfg, batch, seq)
        specs = partition_specs(moe_meta(cfg), sizes, fsdp=True)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        p = {k: _moe_layer_shard(k, shapes[k], mesh, placements(specs[k], mesh), seed
                                 ).requires_grad_() for k in specs}
        x = _moe_layer_shard("x", shapes["x"], mesh, dp, seed).requires_grad_()
        c = _moe_layer_shard("c", shapes["c"], mesh, dp, seed)
        dist.barrier()
        t0 = time.perf_counter()
        with CommDebugMode() as comm:
            o, aux, grads = _moe_layer_loss(cfg, p, x, c)
            grads["x"] = grads["x"].redistribute(mesh, dp)  # the sum over model
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res = {"seconds": secs, "collectives": {str(k): v for k, v in
                                                comm.get_comm_counts().items()}}
        if device == "cuda":
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
        want = torch.load(Path(ref_dir) / f"{label}.pt", mmap=True)
        got = {"out": o, **grads}
        res["errs"] = {"aux": abs(float(aux.full_tensor()) - float(want["aux"])) / abs(
            float(want["aux"]))}
        for k, t in got.items():
            sl = _local_slices(t)
            local = t.to_local().float()
            rows = want[k][sl[:-1]].to(local.device).float()  # whole rows, for their rms
            rms = rows.square().mean(dim=-1, keepdim=True).sqrt().clamp_min(1e-30)
            w = rows[..., sl[-1]]
            res["errs"][k] = ((local - w).abs() / (w.abs() + rms)).max().item()
        out[label] = res
        del p, x, c, o, grads, got, want
    return out


def moe_layer_phase(smi: str, reference: tuple) -> dict:
    """Phase 10 (d): the expert-parallel MoE layer alone at full width, in 8
    ranks over the card's host-staged gloo groups, each case of
    ``MOE_LAYER_CASES`` held to the one-rank layer run first in a process
    of its own (``moe_layer_reference``; ``reference``: its result and
    seconds, from ``phase10_references``): every rank's every quantity within
    ``MOE_LAYER_TOL`` in ``ref.scaled_err``, a limit that must part the
    reference's two readings (another order within half of it, a dropped
    ``model`` partial at twice it or more).  Each rank's peak memory is
    printed beside the bytes the replicated layer would need."""
    import torch

    from repro_torch.launch import ranks

    d = OUT_DIR / "moe_layer"
    one, ref_s = reference
    for label, r in one.items():
        o, f = max(r["order"].values()), max(r["fault"].values())
        print(f"[moe layer] {label}: the one-rank layer in {r['seconds']:.2f} s; the limit's "
              f"two readings: another order {o:.4g} (worst of {r['order']}), a dropped model "
              f"partial {f:.4g} (tol {MOE_LAYER_TOL} in ref.scaled_err)")
        if not (o <= MOE_LAYER_TOL / 2 and f >= 2 * MOE_LAYER_TOL):
            raise AssertionError(f"{label}: phase 10 (d)'s limit does not part another order "
                                 f"{r['order']} from a dropped partial {r['fault']}")
    world = math.prod(MOE_LAYER_MESH)
    t0 = time.perf_counter()
    with _expandable_segments():
        got = ranks.run("chip_smoke:moe_layer_job", world, timeout_s=600,
                        kwargs={"ref_dir": str(d), "cases": MOE_LAYER_CASES})
    job_s = time.perf_counter() - t0
    out = {"one_rank": one, "ranks": got, "reference_seconds": ref_s, "job_seconds": job_s}
    for label, arch, groups in MOE_LAYER_CASES:
        cfg = _moe_layer_config(arch, groups)
        e = cfg.moe
        replicated = 2 * 3 * e.num_experts * cfg.d_model * e.d_ff_expert * 2
        errs = {k: max(r[label]["errs"][k] for r in got) for k in got[0][label]["errs"]}
        mem = [r[label]["peak_bytes"] / 1e9 for r in got]
        print(f"[moe layer] {label}: {world} ranks as (pod, data, model) = {MOE_LAYER_MESH}, x "
              f"[{MOE_LAYER_BATCH}, {MOE_LAYER_SEQ}, {cfg.d_model}] bf16, moe_groups {groups}: "
              f"worst over ranks {errs} (tol {MOE_LAYER_TOL}); peak memory per rank "
              f"{min(mem):.2f}-{max(mem):.2f} GB (the replicated layer: at least "
              f"{replicated / 1e9:.2f} GB a rank for every expert's weights and gradients); "
              f"forward and backward {got[0][label]['seconds']:.2f} s on rank 0 (host clock, "
              f"{HOST_STAGED}); collectives (CommDebugMode) {got[0][label]['collectives']}; "
              f"{smi}")
        if max(errs.values()) > MOE_LAYER_TOL:
            raise AssertionError(f"{label}: the expert-parallel layer is off the one-rank "
                                 f"layer: {errs}")
    print(f"[moe layer] one-rank layers in {ref_s:.1f} s, the ranks' job in {job_s:.1f} s "
          f"(start-up included)")
    shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_sharded_config(arch: str, smoke: bool = False):
    """Phase 10 (f)'s config: ``arch`` at full width and 2 layers (its smoke
    config, a rehearsal's)."""
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch) if smoke else _config(arch, 2)


def _serve_sharded_tokens(cfg, batch: int, n: int, seed: int, device: str):
    """(f)'s seeded tokens [batch, n] (int32): the prompt, then each decode
    step's token, the same in every process."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed + 17)
    return torch.randint(0, cfg.vocab_size, (batch, n), generator=g, device=device,
                         dtype=torch.int32)


def _serve_sharded_run(cfg, params, tokens, prompt: int, capacity: int, act=None, place=None):
    """(f)'s workload: a prefill of ``tokens[:, :prompt]`` into
    ``capacity``, then a decode step on each next token.
    Returns (logits after the prefill and after each step, the cache after
    the prefill (a copy), the cache, and the collectives of the prefill
    and of the first step, by kind, from ``costanalysis.CollectiveBytes``)."""
    from repro_torch.launch.costanalysis import CollectiveBytes
    from repro_torch.models import lm
    from repro_torch.models.params import map_tree

    place = place or (lambda t: t)
    rec = CollectiveBytes()
    with rec:
        lg, cache = lm.prefill(cfg, params, {"tokens": place(tokens[:, :prompt])},
                               capacity=capacity, act_shard=act)
    colls = {"prefill": (dict(rec.bytes), dict(rec.counts))}
    logits = [lg]
    filled = map_tree(lambda _, t: t.clone(), cache)
    for i in range(tokens.shape[1] - prompt):
        rec = CollectiveBytes()
        with rec:
            lg, cache = lm.decode_step(cfg, params, place(tokens[:, prompt + i:prompt + i + 1]),
                                       cache, prompt + i, act_shard=act)
        if i == 0:
            colls["decode"] = (dict(rec.bytes), dict(rec.counts))
        logits.append(lg)
    return logits, filled, cache, colls


def _cache_err(got, want, leaf_rms: float) -> float:
    """(f)'s measure of a cache shard: the rms of its error over the shard,
    relative to the one-rank leaf's rms."""
    return ((got.float() - want.float()).square().mean().sqrt().item()
            / max(leaf_rms, 1e-30))


def serve_sharded_reference(ref_dir: str, smoke: bool = False, device: str = "cuda",
                            batch: int = SERVE_SHARDED_BATCH,
                            prompt: int = SERVE_SHARDED_PROMPT,
                            capacity: int = SERVE_SHARDED_CAPACITY,
                            steps: int = SERVE_SHARDED_STEPS, seed: int = 0) -> dict:
    """Phase 10 (f) (a), in a process of its own: for each config of
    ``SERVE_SHARDED``, the one-rank path through the kernels from the
    seeded parameters (``lm.init_model``) and tokens, its logits, caches
    and each cache leaf's rms saved to ``<ref_dir>/<arch>.pt``; then the
    same path through the plain versions, a reading that must pass (f)'s
    check: its worst logits error and cache error against the kernels'
    path."""
    import torch

    from repro_torch.kernels.ref import scaled_err
    from repro_torch.models import lm

    if device == "cuda":
        torch.cuda.set_device(0)
    out = {}
    for arch, _ in SERVE_SHARDED:
        cfg = _serve_sharded_config(arch, smoke)
        params = lm.init_model(cfg, torch.Generator(device=device).manual_seed(seed),
                               device=device)
        tokens = _serve_sharded_tokens(cfg, batch, prompt + steps, seed, device)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, filled, cache, _ = _serve_sharded_run(cfg, params, tokens, prompt, capacity)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        want = {"logits": logits, "prefill_cache": dict(_leaf_paths(filled)),
                "cache": dict(_leaf_paths(cache))}
        rms = {w: {k: t.float().square().mean().sqrt().item() for k, t in want[w].items()}
               for w in ("prefill_cache", "cache")}
        torch.save({**{k: ([t.cpu() for t in v] if isinstance(v, list) else
                           {n: t.cpu() for n, t in v.items()}) for k, v in want.items()},
                    "rms": rms}, Path(ref_dir) / f"{arch}.pt")
        with plain_kernels():
            logits_p, filled_p, cache_p, _ = _serve_sharded_run(cfg, params, tokens, prompt,
                                                               capacity)
        plain = {"logits": max(scaled_err(a, b) for a, b in zip(logits_p, want["logits"])),
                 "cache": max([_cache_err(t, want["cache"][k], rms["cache"][k])
                               for k, t in _leaf_paths(cache_p)]
                              + [_cache_err(t, want["prefill_cache"][k],
                                            rms["prefill_cache"][k])
                                 for k, t in _leaf_paths(filled_p)])}
        out[arch] = {"seconds": secs, "plain": plain,
                     "param_bytes": sum(t.numel() * t.element_size() for _, t in
                                        _leaf_paths(params)),
                     "cache_bytes": sum(t.numel() * t.element_size() for t in
                                        want["cache"].values())}
        del params, logits_p, filled_p, cache_p, want, logits, filled, cache
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _drawn_shards(cfg, mesh, seed: int, device: str) -> dict:
    """``lm.init_model(cfg)``'s parameters from ``seed`` (the same draws, leaf
    by leaf in its order) placed by ``param_pspecs`` on ``mesh``: each rank
    draws every leaf on ``device`` and keeps its shard, the ranks in turn,
    so that one whole leaf at a time is drawn on the card."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.models import lm
    from repro_torch.models.params import _init_one, map_tree, placements, torch_dtype
    from repro_torch.training.train_step import param_pspecs

    def one(_, meta, spec):
        local = _init_one(meta, gen, torch.device(device), torch_dtype(cfg.dtype))
        pl = placements(spec, mesh)
        coord = mesh.get_coordinate()
        for d, q in enumerate(pl):
            if q.is_shard():
                local = local.chunk(mesh.size(d), q.dim)[coord[d]]
        return DTensor.from_local(local.clone(memory_format=torch.contiguous_format), mesh,
                                  pl, run_check=False)

    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            gen = torch.Generator(device=device).manual_seed(seed)
            out = map_tree(one, lm.model_meta(cfg), param_pspecs(cfg, mesh))
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return out


@contextlib.contextmanager
def _dropped_partial(rank_drops: bool):
    """A planted fault: on a rank where ``rank_drops``, each attention and
    Mamba mixer's output has this rank's local part zeroed, so that its
    share of the sum over ``model`` is left out."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import lm

    saved = (lm.attn_mod.attention, lm.mamba_mod.mamba)

    def zeroed(t):
        return DTensor.from_local(t.to_local() * 0, t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape, stride=t.stride())

    def attention(*a, **k):
        res = saved[0](*a, **k)
        return res._replace(out=zeroed(res.out))

    def mamba(*a, **k):
        y, cache = saved[1](*a, **k)
        return zeroed(y), cache

    if rank_drops:
        lm.attn_mod.attention, lm.mamba_mod.mamba = attention, mamba
    try:
        yield
    finally:
        lm.attn_mod.attention, lm.mamba_mod.mamba = saved


def serve_sharded_job(ref_dir: str, smoke: bool = False, device: str = "cuda",
                      batch: int = SERVE_SHARDED_BATCH, prompt: int = SERVE_SHARDED_PROMPT,
                      capacity: int = SERVE_SHARDED_CAPACITY,
                      steps: int = SERVE_SHARDED_STEPS, seed: int = 0,
                      gate: str | None = None) -> dict:
    """Phase 10 (f) (b), the body of one rank: for each config of
    ``SERVE_SHARDED`` on its mesh (the last, DeepSeek-V2's ~4 GB a rank,
    once the file ``gate`` exists, where one is given), the parameters placed by
    ``param_pspecs`` (each rank cuts its shards from the saved ones), the
    prompt and tokens by ``batch_pspecs``, (f)'s workload sharded with
    ``make_act_shard``'s hook; each rank's logits (replicated) and cache
    shards held to the one-rank path's (``ref.scaled_err``, each shard
    against the same slice of the one-rank cache, none gathered), how many
    greedy tokens agree, the bytes it holds, its peak memory, the
    collectives (``CommDebugMode`` by op; ``CollectiveBytes`` by kind for
    the prefill and the first step), the bytes staged through the host,
    the launches and the host-clock seconds.  Then the planted fault: the
    prefill again with the last ``model`` rank's mixer outputs dropped
    from the sum over ``model`` (``_dropped_partial``), its logits'
    error."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core.groups import MeshAxes
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import scaled_err
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.params import placements, shard_tensor
    from repro_torch.training import train_step as T

    if device == "cuda":
        torch.cuda.set_device(0)
    rank = dist.get_rank()
    out = {"rank": rank}
    for arch, shape in SERVE_SHARDED:
        if gate is not None and arch == SERVE_SHARDED[-1][0]:
            while not Path(gate).exists():
                time.sleep(0.5)
        cfg = _serve_sharded_config(arch, smoke)
        mesh = make_device_mesh(shape, ("pod", "data", "model"), device)
        view = MeshAxes(mesh)
        params = _drawn_shards(cfg, mesh, seed, device)
        act = T.make_act_shard(cfg, mesh)

        def place(t):
            return shard_tensor(t, mesh, placements(SP.batch_pspecs(mesh, t), mesh))

        tokens = _serve_sharded_tokens(cfg, batch, prompt + steps, seed, device)
        gc.collect()
        start = 0
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
        staged0 = view.staged_bytes()
        ops.reset_launches()  # this run's counts start here
        dist.barrier()
        t0 = time.perf_counter()
        with CommDebugMode() as comm:
            logits, filled, cache, colls = _serve_sharded_run(cfg, params, tokens, prompt,
                                                              capacity, act, place)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
        want = torch.load(Path(ref_dir) / f"{arch}.pt", mmap=True)
        lg_errs = [scaled_err(g.to_local(), w.to(g.to_local().device))
                   for g, w in zip(logits, want["logits"])]
        agree = sum(int((g.to_local().argmax(-1).cpu() == w.argmax(-1)).sum())
                    for g, w in zip(logits[1:], want["logits"][1:]))

        def shard_errs(tree, when):
            return {k: _cache_err(t.to_local(), want[when][k][_local_slices(t)].to(
                t.to_local().device), want["rms"][when][k]) for k, t in _leaf_paths(tree)}

        res = {"logits_errs": lg_errs, "greedy_agree": agree,
               "greedy_total": (len(logits) - 1) * batch,
               "prefill_cache_errs": shard_errs(filled, "prefill_cache"),
               "cache_errs": shard_errs(cache, "cache"),
               "bytes": {"params": sum(t.to_local().numel() * t.to_local().element_size()
                                       for _, t in _leaf_paths(params)),
                         "cache": sum(t.to_local().numel() * t.to_local().element_size()
                                      for _, t in _leaf_paths(cache)),
                         "tokens": place(tokens[:, :prompt]).to_local().numel() * 4},
               "seconds": secs, "launches": launches, "allocated_at_start": start,
               "collectives": {str(k): v for k, v in comm.get_comm_counts().items()},
               "recorded": colls, "mesh": list(shape),
               "staged_bytes": {k: v - staged0.get(k, 0)
                                for k, v in view.staged_bytes().items()}}
        if device == "cuda":
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
        del filled, cache, want
        # the planted fault: the last model rank's mixer outputs left out of the sum
        drops = mesh.get_coordinate()[2] == shape[2] - 1
        with _dropped_partial(drops):
            lg_f, _, _, _ = _serve_sharded_run(cfg, params, tokens[:, :prompt], prompt,
                                               capacity, act, place)
        want = torch.load(Path(ref_dir) / f"{arch}.pt", mmap=True)
        res["fault_err"] = scaled_err(lg_f[0].to_local(),
                                      want["logits"][0].to(lg_f[0].to_local().device))
        out[arch] = res
        del params, logits, lg_f, want
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def serve_sharded_phase(smi: str, reference: tuple, beside=None) -> dict:
    """Phase 10 (f): sharded serving at full width on this card.  (a) The
    one-rank path of each config of ``SERVE_SHARDED`` through the kernels,
    and through the plain versions (a reading that must pass), in a
    process of its own (``reference``: its result and seconds, from
    ``phase10_references``); (b) ``serve_sharded_job`` in 8 ranks, with
    ``beside()`` run in a thread beside them (its result in ``"beside"``),
    the last config (DeepSeek-V2, ~4 GB a rank) served once ``beside`` is
    done (another job's ranks on the card, whose peaks met DeepSeek-V2's
    once, out of memory): every rank's
    logits and cache shards within ``SERVE_SHARDED_TOL`` of the one-rank
    path's, the planted dropped partial at twice it or more, the path's
    kernels each launched on every rank.  Prints per rank the bytes held,
    peak memory, collectives, bytes staged through the host and seconds."""
    import torch

    from repro_torch.launch import ranks

    d = OUT_DIR / "serve_sharded"
    one, ref_s = reference
    world = math.prod(SERVE_SHARDED[0][1])
    t0 = time.perf_counter()
    gate = d / "beside_done"
    gate.unlink(missing_ok=True)
    with _expandable_segments():
        side = None
        if beside is not None:
            side = _in_background(beside)
            side.add_done_callback(lambda _: gate.touch())  # done or failed
        got = ranks.run("chip_smoke:serve_sharded_job", world, timeout_s=900,
                        kwargs={"ref_dir": str(d), "gate": str(gate) if side else None})
        side = side.result() if side is not None else None
    job_s = time.perf_counter() - t0
    out = {"one_rank": one, "ranks": got, "reference_seconds": ref_s, "job_seconds": job_s,
           "beside": side}
    for arch, shape in SERVE_SHARDED:
        cfg = _serve_sharded_config(arch)
        r0 = got[0][arch]
        errs = max(max(r[arch]["logits_errs"]) for r in got)
        cache_errs = max(max(list(r[arch]["prefill_cache_errs"].values())
                             + list(r[arch]["cache_errs"].values())) for r in got)
        fault = max(r[arch]["fault_err"] for r in got)
        mem = [r[arch]["peak_bytes"] / 1e9 for r in got]
        kinds = [k for k in ("rmsnorm", "flash_attention", "mamba_scan_fused")
                 if (k != "mamba_scan_fused" or cfg.mamba is not None)
                 and (k != "flash_attention" or cfg.attn is not None)]
        unlaunched = {r["rank"]: [k for k in kinds if r[arch]["launches"][k] == 0] for r in got}
        print(f"[serve sharded] {arch} at full width, 2 layers, {world} ranks as (pod, data, "
              f"model) = {tuple(shape)}: {SERVE_SHARDED_BATCH} prompts of "
              f"{SERVE_SHARDED_PROMPT} into {SERVE_SHARDED_CAPACITY}, "
              f"{SERVE_SHARDED_STEPS} decode steps: worst over ranks logits {errs:.4g}, cache "
              f"shards {cache_errs:.4g} (tol {SERVE_SHARDED_TOL}: logits in ref.scaled_err, "
              f"cache shards by the rms of the error over the one-rank leaf's; the one-rank "
              f"path through the plain versions {one[arch]['plain']}; one model rank's mixer "
              f"partial dropped: logits {fault:.4g}); greedy tokens agreeing "
              f"{r0['greedy_agree']} of {r0['greedy_total']}; launches on rank 0 "
              f"{r0['launches']}")
        for r in got:
            x = r[arch]
            print(f"[serve sharded] {arch} rank {r['rank']}: holds parameters "
                  f"{x['bytes']['params'] / 1e9:.3f} GB (the replica's "
                  f"{one[arch]['param_bytes'] / 1e9:.3f} GB), cache "
                  f"{x['bytes']['cache'] / 1e6:.2f} MB (the one-rank cache's "
                  f"{one[arch]['cache_bytes'] / 1e6:.2f} MB); peak memory "
                  f"{x['peak_bytes'] / 1e9:.2f} GB; collectives (CommDebugMode) "
                  f"{x['collectives']}; staged through the host {x['staged_bytes']}; prefill "
                  f"and {SERVE_SHARDED_STEPS} steps in {x['seconds']:.2f} s (host clock, "
                  f"{HOST_STAGED}); {smi}")
        print(f"[serve sharded] {arch}: peak memory per rank {min(mem):.2f}-{max(mem):.2f} GB")
        if not (max(one[arch]["plain"].values()) <= SERVE_SHARDED_TOL
                and fault >= 2 * SERVE_SHARDED_TOL):
            raise AssertionError(f"{arch}: (f)'s limit does not part the plain versions' "
                                 f"path {one[arch]['plain']} from a dropped partial {fault}")
        if errs > SERVE_SHARDED_TOL or cache_errs > SERVE_SHARDED_TOL or any(
                unlaunched.values()):
            raise AssertionError(f"{arch}: sharded serving is off the one-rank path: logits "
                                 f"{errs}, caches {cache_errs}; kernels not launched "
                                 f"{unlaunched}")
    print(f"[serve sharded] one-rank paths in {ref_s:.1f} s, the ranks' job in {job_s:.1f} s "
          f"(start-up included)")
    shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def one_rank_cell(arch: str, layers: int, seq: int) -> dict:
    """The dry-run's record of a run of phase 8 (c) (``arch`` at ``layers``
    layers, ``TRAIN_BATCH`` x ``seq``) on a (1, 1) mesh: the one-card step
    (``step="shardmap"``: ``grad_and_metrics`` and ``adamw_update`` on
    whole parameters, as ``make_train_step`` runs them), on the meta
    device."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    return dryrun.measure_cell(_config(arch, layers),
                               ShapeSpec("phase 8 (c)", "train", seq, TRAIN_BATCH),
                               make_test_mesh((1, 1), ("data", "model")), step="shardmap")


def dryrun_cells(out_path: str) -> None:
    """The dry-run side of phase 9 (a) and (c), in a process that sees no
    card (``launch/dryrun.measure_cell``), to ``out_path``: (a) each run of
    phase 8 (c) (``one_rank_cell``); (c) the sharded cells of the programs
    phase 10 (b) and (f) run, each at that phase's config, shape and mesh,
    as rank 0 over a fake group of device type ``cuda``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    one_rank = {f"{arch} x{layers}": one_rank_cell(arch, layers, seq)
                for arch, layers, _, seq in TRAIN_FULL_WIDTH}
    cells = {}
    for arch in SHARDED_ARCHS + SHARDED_MOE_ARCHS:
        cfg = _sharded_config(arch)  # phase 10 (b) builds its AdamW with float32 moments
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, optimizer_dtype="float32"))
        cells[f"{arch} train"] = dryrun.measure_cell(
            cfg, ShapeSpec("phase 10 (b)", "train", SHARDED_SEQ, SHARDED_BATCH),
            make_test_mesh(SHARDED_MESH))
    for arch, shape in SERVE_SHARDED:
        cfg = _serve_sharded_config(arch)
        cells[f"{arch} prefill"] = dryrun.measure_cell(
            cfg, ShapeSpec("phase 10 (f)", "prefill", SERVE_SHARDED_PROMPT,
                           SERVE_SHARDED_BATCH), make_test_mesh(shape),
            capacity=SERVE_SHARDED_CAPACITY)
        cells[f"{arch} decode"] = dryrun.measure_cell(
            cfg, ShapeSpec("phase 10 (f)", "decode", SERVE_SHARDED_CAPACITY,
                           SERVE_SHARDED_BATCH), make_test_mesh(shape))
    Path(out_path).write_text(json.dumps({"one_rank_cells": one_rank, "cells": cells}))


def dryrun_against_runs(cells: dict, sharded: dict, served: dict, smi: str) -> dict:
    """Phase 9 (c): each sharded cell of the dry-run (``dryrun_cells``)
    against rank 0 of the real run: argument bytes per rank equal to what
    it holds (phase 10 (b): its parameters and AdamW moments; (f): its
    parameters, its cache and its tokens), and the collectives by kind,
    bytes and counts, equal to what it issued (``CollectiveBytes``; a
    train step's: one microbatch's, cut from the batch and through its
    gradients, times their number, and the update).  The check that the
    fake group counts the real program.  And the peaks (``peak_check``):
    the cell's arguments plus ``peak_bytes`` against every rank's
    ``max_memory_allocated`` over (b)'s sharded step, or over (f)'s prefill
    and decode steps (each of its two cells), less what the rank held
    beside its parameters (and AdamW state) when the peak was reset."""
    out, bad = {}, []
    for key, rec in cells.items():
        arch, kind = key.rsplit(" ", 1)
        parts = rec["memory"]["argument_bytes_by_part"]
        if kind == "train":
            r0 = sharded["ranks"][arch][f"{arch} xla"][0]
            held = {"params": r0["bytes"]["params"],
                    "opt_state": r0["bytes"]["m"] + r0["bytes"]["v"] + 4}  # + the step
            want = {k: parts[k] for k in held}
            coll = r0["recorded"]
        else:
            r0 = served["ranks"][0][arch]
            held = {"params": r0["bytes"]["params"]}
            if kind == "prefill":
                held["batch"] = r0["bytes"]["tokens"]
            else:
                held["cache"] = r0["bytes"]["cache"]
            want = {k: parts[k] for k in held}
            coll = r0["recorded"][kind]
        same = (held == want and rec["collective_bytes_per_device"] == coll[0]
                and rec["collective_counts_per_device"] == coll[1])
        out[key] = {"held": held, "dryrun": want, "real_collectives": coll,
                    "dryrun_collectives": [rec["collective_bytes_per_device"],
                                           rec["collective_counts_per_device"]], "same": same}
        print(f"[dryrun] (c) {key}: argument bytes on rank 0 {held}, the dry-run's {want}; "
              f"collectives by kind (bytes, counts) issued {coll}, the dry-run's "
              f"{out[key]['dryrun_collectives']}: {'equal' if same else 'DIFFERENT'} "
              f"(a fake group of {rec['num_devices']} ranks on meta shards; {smi})")
        if not same:
            bad.append(key)
    if bad:
        raise AssertionError(f"phase 9 (c): the dry-run's count differs from the run's for {bad}")
    rows = []
    for arch in SHARDED_ARCHS + SHARDED_MOE_ARCHS:
        m = cells[f"{arch} train"]["memory"]
        ranks = sharded["ranks"][arch][f"{arch} xla"]
        rows += peak_rows("train", f"(c) {arch} train, (b)'s sharded step", {
            "arguments": m["argument_bytes"], "peak_bytes": m["peak_bytes"]},
            dict(enumerate(r["peak_bytes"] for r in ranks)),
            dict(enumerate(r["allocated_at_start"] - sum(r["bytes"].values()) for r in ranks)))
    for arch, _ in SERVE_SHARDED:
        for kind in ("prefill", "decode"):  # (f)'s run holds both programs' peaks
            m = cells[f"{arch} {kind}"]["memory"]
            rows += peak_rows(
                "serve", f"(c) {arch} {kind}, (f)'s prefill and {SERVE_SHARDED_STEPS} decode steps",
                {"arguments": m["argument_bytes"], "peak_bytes": m["peak_bytes"]},
                {r["rank"]: r[arch]["peak_bytes"] for r in served["ranks"]},
                {r["rank"]: r[arch]["allocated_at_start"] - r[arch]["bytes"]["params"]
                 for r in served["ranks"]})
    out["peaks"] = peak_check(rows, smi)
    return out


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
    fus = fused_cases(gen, fault_libs)
    for name, cases, tol in (("rmsnorm", rms, TOL_BF16), ("flash_attention", fla, TOL_BF16),
                             ("mamba_scan", mam, TOL_F32), ("mamba_scan_fused", fus, TOL_F32)):
        _print_cases(name, cases, tol)
    done("kernels")

    def free() -> None:
        """The last model's memory, on the card and the pinned host memory
        its float32 check may have staged its layers in (PyTorch's host
        allocator keeps pinned blocks until told)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch._C._host_emptyCache()

    served = {}
    for arch in SERVED:  # one model on the card at a time
        free()
        served[arch] = (serve(arch, smi=smi) if get_config(arch).embed_inputs
                        else drive_embeds(arch))
        done(f"serve {arch}")
    free()

    pack = pack_cases(gen, fault_libs)
    _print_cases("a2a_pack", pack, 0)
    done("a2a_pack")
    references = _in_background(phase10_references)  # beside phase 7's host-bound ranks
    ranks = collectives_phase()
    done("collectives")
    references = references.result()  # phase 8 times kernels with the card to itself
    done("sharded references")

    gc.collect()
    torch.cuda.empty_cache()
    dry_started = dryrun_start()  # phase 9 (b) on the host, beside phase 8 on the card
    fwd_train, bwd_train = flash_train_cases(gen, fault_libs)
    rms_train = rmsnorm_train_cases(gen, fault_libs)
    scan_train = scan_train_cases(gen, fault_libs)
    fus_train = fused_train_cases(gen, fault_libs)
    for name, cases, tol in (("flash_attention (training forward)", fwd_train, TOL_BF16),
                             ("flash_attention_bwd", bwd_train, TOL_BF16),
                             ("rmsnorm_bwd", rms_train, TOL_BF16),
                             ("mamba_scan_bwd", scan_train, TOL_F32),
                             ("mamba_scan_fused_bwd", fus_train, TOL_F32)):
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
    gc.collect()
    torch.cuda.empty_cache()
    dry = dryrun_phase(smi, dry_started)
    dry["one_rank_peaks"] = peak_check(dryrun_one_rank(dry["one_rank_cells"],
                                                       train["full_width"]), smi)
    done("dryrun")
    gc.collect()
    torch.cuda.empty_cache()
    sharded = sharded_phase(smi, references["sharded"])
    done("sharded")
    sharded["moe_layer"] = moe_layer_phase(smi, references["moe_layer"])
    done("sharded moe layer")
    gc.collect()
    torch.cuda.empty_cache()
    # (c)'s 8 ranks beside (f)'s Yi-6B and Falcon-Mamba-7B: host-bound
    sharded["serve"] = serve_sharded_phase(smi, references["serve_sharded"], beside=sharded_cli)
    sharded["cli"] = sharded["serve"].pop("beside")
    done("sharded serve and cli")
    dry["against_runs"] = dryrun_against_runs(dry["cells"], sharded, sharded["serve"], smi)
    done("dryrun against runs")
    runs = {run: r["launches"] for run, r in train["full_width"].items()}
    for arch, by_key in sharded["ranks"].items():  # rank 0's; each rank's are equal
        runs.update({f"{key} rank 0": rs[0]["launches"] for key, rs in by_key.items()})
    for arch, _ in SERVE_SHARDED:
        runs[f"serve sharded {arch} rank 0"] = sharded["serve"]["ranks"][0][arch]["launches"]

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
        kernel_entry("mamba_scan_fused", "src/repro_torch/kernels/csrc/mamba_scan_fused.cu",
                     "src/repro/kernels/mamba_scan.py:60", fus, by_model("mamba_scan_fused"),
                     tolerance=TOL_F32),
        kernel_entry("mamba_scan_fused_bwd",
                     "src/repro_torch/kernels/csrc/mamba_scan_fused_bwd.cu",
                     "src/repro/models/mamba.py:112", fus_train,
                     {run: n["mamba_scan_fused_bwd"] for run, n in runs.items()},
                     tolerance=TOL_F32),
    ]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "kernels": kernels, "serve": served, "collectives": ranks,
         "train": train, "dryrun": dry, "sharded": sharded}, indent=1))
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
