"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B; hf].

62L d_model=2560 40H MLA (q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32,
v=64), d_ff=6400, vocab=73448 (padded to 73472 for TP divisibility)."""

from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    d_ff=6400,
    vocab_size=73448,
    attn=AttnConfig(
        kind="mla",
        num_heads=40,
        num_kv_heads=40,
        head_dim=64,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    layer_pattern=(LayerSpec("attn", "dense"),),
    parallel=ParallelConfig(microbatches=8),
)

SMOKE = ModelConfig(
    name="minicpm3-smoke",
    family="dense",
    num_layers=4,
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
    layer_pattern=(LayerSpec("attn", "dense"),),
    parallel=ParallelConfig(remat=False, attn_chunk_q=64, attn_chunk_kv=64),
)
