"""DeepSeek-V2 236B [arXiv:2405.04434; hf].

60L d_model=5120 128H MLA(kv_lora=512, q_lora=1536) vocab=102400;
MoE: 160 routed experts top-6 + 2 shared, expert d_ff=1536, first layer dense
(dense d_ff=12288).  Total params ~236B, active ~21B.

The port serves it at its published widths on one H100 with the depth cut
to 8 of its 60 layers: the dense prelude layer and 7 MoE layers.
"""

from repro_torch.configs.base import (
    AttnConfig, LayerSpec, ModelConfig, MoEConfig, ParallelConfig,
)

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    d_ff=12288,
    vocab_size=102400,
    attn=AttnConfig(
        kind="mla",
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        rope_theta=10_000.0,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160, top_k=6, d_ff_expert=1536, num_shared_experts=2
    ),
    layer_pattern=(LayerSpec("attn", "moe"),),
    first_k_dense=1,
    parallel=ParallelConfig(microbatches=16, optimizer_dtype="bfloat16"),
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    d_ff=128,
    vocab_size=256,
    attn=AttnConfig(
        kind="mla",
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        q_lora_rank=32,
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    ),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, num_shared_experts=1),
    layer_pattern=(LayerSpec("attn", "moe"),),
    first_k_dense=1,
    parallel=ParallelConfig(remat=False, attn_chunk_q=64, attn_chunk_kv=64),
)
