"""H2O-Danube3-4B [arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) head_dim=120, d_ff=10240, vocab=32000,
llama+mistral mix with sliding-window attention (window 4096) — the SWA
makes this arch sub-quadratic and long_500k-eligible."""

from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    d_ff=10240,
    vocab_size=32000,
    attn=AttnConfig(
        kind="gqa", num_heads=32, num_kv_heads=8, head_dim=120,
        sliding_window=4096,
    ),
    layer_pattern=(LayerSpec("attn", "dense"),),
    parallel=ParallelConfig(microbatches=8),
)

SMOKE = ModelConfig(
    name="h2o-danube-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    d_ff=160,
    vocab_size=256,
    attn=AttnConfig(
        kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
        sliding_window=64,
    ),
    layer_pattern=(LayerSpec("attn", "dense"),),
    parallel=ParallelConfig(remat=False, attn_chunk_q=32, attn_chunk_kv=32),
)
