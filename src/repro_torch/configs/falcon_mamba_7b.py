"""Falcon-Mamba-7B [arXiv:2410.05355; unverified].

64L d_model=4096, attention-free mamba-1 architecture: d_state=16,
expand=2 (d_inner=8192), d_conv=4, vocab=65024.  Decode state is O(1)
per token — the canonical long_500k architecture."""

from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    d_ff=0,
    vocab_size=65024,
    attn=None,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    layer_pattern=(LayerSpec("mamba", "none"),),
    parallel=ParallelConfig(microbatches=8),
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    d_ff=0,
    vocab_size=256,
    attn=None,
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=8),
    layer_pattern=(LayerSpec("mamba", "none"),),
    parallel=ParallelConfig(remat=False, mamba_chunk=32),
)
