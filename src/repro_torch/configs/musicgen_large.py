"""MusicGen-Large 3.3B [arXiv:2306.05284; hf].

48L d_model=2048 32H (MHA, kv=32, head_dim=64) d_ff=8192, decoder-only over
EnCodec tokens: 4 codebooks, vocab 2048 each (parallel codebook heads; the
EnCodec frontend is not modelled — token ids are the interface).  GELU MLP (no gating).
"""

from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab_size=2048,
    attn=AttnConfig(kind="gqa", num_heads=32, num_kv_heads=32, head_dim=64),
    layer_pattern=(LayerSpec("attn", "dense"),),
    act="gelu",
    num_codebooks=4,
    parallel=ParallelConfig(microbatches=8),
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    num_layers=3,
    d_model=64,
    d_ff=128,
    vocab_size=64,
    attn=AttnConfig(kind="gqa", num_heads=4, num_kv_heads=4, head_dim=16),
    layer_pattern=(LayerSpec("attn", "dense"),),
    act="gelu",
    num_codebooks=2,
    parallel=ParallelConfig(remat=False, attn_chunk_q=64, attn_chunk_kv=64),
)
