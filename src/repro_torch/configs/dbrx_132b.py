"""DBRX 132B [hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) vocab=100352; fine-grained MoE: 16 experts
top-4, expert d_ff=10752, every layer MoE.

The port serves it at its published widths on one H100 with the depth cut
to 8 of its 40 layers (the weights of all 40 would not fit one card).
"""

from repro_torch.configs.base import (
    AttnConfig, LayerSpec, ModelConfig, MoEConfig, ParallelConfig,
)

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    d_ff=10752,
    vocab_size=100352,
    attn=AttnConfig(
        kind="gqa", num_heads=48, num_kv_heads=8, head_dim=128,
        rope_theta=500_000.0,
    ),
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
    layer_pattern=(LayerSpec("attn", "moe"),),
    parallel=ParallelConfig(microbatches=16),
)

SMOKE = ModelConfig(
    name="dbrx-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    d_ff=96,
    vocab_size=256,
    attn=AttnConfig(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=96),
    layer_pattern=(LayerSpec("attn", "moe"),),
    parallel=ParallelConfig(remat=False, attn_chunk_q=64, attn_chunk_kv=64),
)
