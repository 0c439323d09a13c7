"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf].

72L d_model=8192, hybrid Mamba+attention 1:7 interleave (1 attn per 8-layer
period), GQA 64H kv=8, d_ff=24576, MoE 16 experts top-2 on every other
layer, vocab=65536, mamba d_state=16 expand=2 (d_inner=16384).

One MoE layer alone is 16 x 3 x 8192 x 24576 = 9.66 B parameters (19.3 GB
in bf16), and its smallest whole period (8 layers, 4 of them MoE) is 45.18 B
(90.4 GB): a whole period, and training at full width (AdamW state), need 4
cards.  Served on one card, it is cut to its first 4 layers
(``configs.first_layers``: attention + MoE, Mamba + dense, Mamba + MoE, Mamba
+ dense; 22.996 B parameters, 46.0 GB in bf16).
"""

from repro_torch.configs.base import (
    AttnConfig, LayerSpec, MambaConfig, ModelConfig, MoEConfig, ParallelConfig,
)

_PERIOD = (
    LayerSpec("attn", "moe"),
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab_size=65536,
    attn=AttnConfig(kind="gqa", num_heads=64, num_kv_heads=8, head_dim=128),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    layer_pattern=_PERIOD,
    parallel=ParallelConfig(microbatches=16, optimizer_dtype="bfloat16"),
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    d_ff=128,
    vocab_size=256,
    attn=AttnConfig(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=8),
    layer_pattern=(
        LayerSpec("attn", "moe"),
        LayerSpec("mamba", "dense"),
        LayerSpec("mamba", "moe"),
        LayerSpec("mamba", "dense"),
    ),
    parallel=ParallelConfig(
        remat=False, attn_chunk_q=64, attn_chunk_kv=64, mamba_chunk=32
    ),
)
