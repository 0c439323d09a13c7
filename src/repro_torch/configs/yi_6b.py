"""Yi-6B [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) head_dim=128, d_ff=11008, vocab=64000,
llama-architecture SwiGLU."""

from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=64000,
    attn=AttnConfig(
        kind="gqa", num_heads=32, num_kv_heads=4, head_dim=128,
        rope_theta=5_000_000.0,
    ),
    layer_pattern=(LayerSpec("attn", "dense"),),
    parallel=ParallelConfig(microbatches=8),
)

SMOKE = ModelConfig(
    name="yi-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    d_ff=160,
    vocab_size=256,
    attn=AttnConfig(kind="gqa", num_heads=8, num_kv_heads=2, head_dim=16),
    layer_pattern=(LayerSpec("attn", "dense"),),
    parallel=ParallelConfig(remat=False, attn_chunk_q=64, attn_chunk_kv=64),
)
