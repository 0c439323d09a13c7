"""Qwen2-VL-7B [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) head_dim=128, d_ff=18944, vocab=152064,
M-RoPE sections (16, 24, 24).  The vision frontend (dynamic-resolution ViT)
is not modelled, as in the reference: callers give precomputed patch/text
embeddings [B, S, D] and 3-component positions [B, S, 3] (``lm.prefill``'s
``{"embeds", "positions"}`` batch)."""

from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab_size=152064,
    attn=AttnConfig(
        kind="gqa", num_heads=28, num_kv_heads=4, head_dim=128,
        rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
    ),
    layer_pattern=(LayerSpec("attn", "dense"),),
    embed_inputs=False,
    parallel=ParallelConfig(microbatches=8),
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    num_layers=3,
    d_model=64,
    d_ff=160,
    vocab_size=256,
    attn=AttnConfig(
        kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
        mrope_sections=(2, 3, 3),
    ),
    layer_pattern=(LayerSpec("attn", "dense"),),
    embed_inputs=False,
    parallel=ParallelConfig(remat=False, attn_chunk_q=64, attn_chunk_kv=64),
)
