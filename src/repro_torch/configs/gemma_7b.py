"""Gemma 7B [arXiv:2403.08295; hf].

28L d_model=3072 16H (MQA-free variant: kv=16) head_dim=256, GeGLU
d_ff=24576, vocab=256000, tied embeddings, embeddings scaled by sqrt(d)."""

from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    d_ff=24576,
    vocab_size=256000,
    attn=AttnConfig(kind="gqa", num_heads=16, num_kv_heads=16, head_dim=256),
    layer_pattern=(LayerSpec("attn", "dense"),),
    act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    parallel=ParallelConfig(microbatches=8),
)

SMOKE = ModelConfig(
    name="gemma-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    d_ff=192,
    vocab_size=512,
    attn=AttnConfig(kind="gqa", num_heads=4, num_kv_heads=4, head_dim=32),
    layer_pattern=(LayerSpec("attn", "dense"),),
    act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    parallel=ParallelConfig(remat=False, attn_chunk_q=64, attn_chunk_kv=64),
)
