"""Model / parallelism configuration system (the port's own copy of the
reference's ``repro/configs/base.py``).

Every assigned architecture is expressed as a :class:`ModelConfig`; hybrid
stacks (Jamba) use a repeating ``layer_pattern`` of :class:`LayerSpec`s, and
parameters are stacked on a leading pattern-period axis so that weights map
one to one onto the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = [
    "AttnConfig",
    "MoEConfig",
    "MambaConfig",
    "LayerSpec",
    "ModelConfig",
    "ParallelConfig",
    "ShapeSpec",
    "SHAPES",
]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    kind: Literal["gqa", "mla"] = "gqa"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 10_000.0
    sliding_window: int | None = None  # SWA (h2o-danube)
    mrope_sections: tuple[int, ...] | None = None  # M-RoPE (qwen2-vl)
    # MLA (deepseek-v2, minicpm3)
    q_lora_rank: int | None = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        if self.kind == "mla":
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim

    @property
    def out_head_dim(self) -> int:
        return self.v_head_dim if self.kind == "mla" else self.head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0  # deepseek: always-on experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None  # default: ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Literal["attn", "mamba"] = "attn"
    ffn: Literal["dense", "moe", "none"] = "dense"


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a model is laid out on the mesh.  Axis names follow
    launch/mesh.py: ("pod",) "data", "model"."""

    fsdp: bool = True  # additionally shard params' d_model dim over "data"
    remat: bool = True  # activation checkpointing on the layer scan
    microbatches: int = 1  # gradient accumulation steps inside train_step
    collective_backend: Literal["xla", "fulllane", "kported"] = "xla"
    optimizer_dtype: str = "float32"  # bf16 moments for >=200B models
    grad_dtype: str = "float32"  # accumulation dtype (bf16 saves HBM at scale)
    # MoE dispatch groups.  The step factories leave it as the config sets
    # it; only launch/dryrun.optimized_config sets it to the DP size, as in
    # the reference.  A multiple of the DP size that splits the batch keeps
    # each rank's routing to its own groups (models/moe.moe)
    moe_groups: int = 1
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 512
    mamba_chunk: int = 256
    causal_skip: bool = True  # skip fully-masked KV chunks (beyond-paper opt)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: AttnConfig | None = None
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    layer_pattern: tuple[LayerSpec, ...] = (LayerSpec("attn", "dense"),)
    act: Literal["silu", "geglu", "gelu"] = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    num_codebooks: int = 1  # musicgen: 4 EnCodec codebooks
    embed_inputs: bool = True  # False: frontend stub provides embeddings (vlm)
    first_k_dense: int = 0  # deepseek: leading dense layers before MoE
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    dtype: str = "bfloat16"
    parallel: ParallelConfig = ParallelConfig()

    def __post_init__(self):
        if self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"pattern period {len(self.layer_pattern)}"
            )
        needs_attn = any(s.mixer == "attn" for s in self.layer_pattern)
        if needs_attn and self.attn is None:
            raise ValueError(f"{self.name}: pattern has attention, attn=None")
        needs_moe = any(s.ffn == "moe" for s in self.layer_pattern)
        if needs_moe and self.moe is None:
            raise ValueError(f"{self.name}: pattern has MoE, moe=None")
        needs_mamba = any(s.mixer == "mamba" for s in self.layer_pattern)
        if needs_mamba and self.mamba is None:
            raise ValueError(f"{self.name}: pattern has mamba, mamba=None")

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so TP sharding over 16/32-wide axes divides."""
        return -(-self.vocab_size // 256) * 256

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape: SSM/hybrid, or SWA."""
        if all(s.mixer == "mamba" for s in self.layer_pattern):
            return True
        if any(s.mixer == "mamba" for s in self.layer_pattern):
            return True  # hybrid: attention minority + O(1) mamba state
        if self.attn is not None and self.attn.sliding_window is not None:
            return True
        return False

    # ------------------------------------------------------------------
    # Parameter count (for roofline MODEL_FLOPS = 6*N*D).
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d = self.d_model
        total = self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            total += self.padded_vocab * d * self.num_codebooks
        if self.num_codebooks > 1:
            total += (self.num_codebooks - 1) * self.padded_vocab * d
        per_pattern = 0
        for i, spec in enumerate(self.layer_pattern):
            per_pattern += self._mixer_params(spec)
            per_pattern += self._ffn_params(spec, active_only)
            per_pattern += 2 * d  # 2 RMSNorm scales
        total += per_pattern * self.num_periods
        # first_k_dense replaces MoE with dense in the first k layers
        if self.first_k_dense and self.moe is not None:
            e = self.moe
            moe_p = e.num_experts * 3 * d * e.d_ff_expert
            if active_only:
                moe_p = e.top_k * 3 * d * e.d_ff_expert
            dense_p = 3 * d * self.d_ff
            total += self.first_k_dense * (dense_p - moe_p)
        total += d  # final norm
        return int(total)

    def _mixer_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        if spec.mixer == "mamba":
            m = self.mamba
            di = m.expand * d
            r = m.resolved_dt_rank(d)
            return (
                d * 2 * di  # in_proj
                + di * m.d_conv + di  # conv
                + di * (r + 2 * m.d_state)  # x_proj
                + r * di + di  # dt_proj
                + di * m.d_state + di  # A_log, D
                + di * d  # out_proj
            )
        a = self.attn
        if a.kind == "mla":
            q_in = a.q_lora_rank or d
            p = 0
            if a.q_lora_rank:
                p += d * a.q_lora_rank + a.q_lora_rank
            p += q_in * a.num_heads * a.qk_head_dim
            p += d * (a.kv_lora_rank + a.qk_rope_head_dim) + a.kv_lora_rank
            p += a.kv_lora_rank * a.num_heads * (a.qk_nope_head_dim + a.v_head_dim)
            p += a.num_heads * a.v_head_dim * d
            return p
        return (
            d * a.num_heads * a.head_dim
            + 2 * d * a.num_kv_heads * a.head_dim
            + a.num_heads * a.head_dim * d
        )

    def _ffn_params(self, spec: LayerSpec, active_only: bool) -> int:
        d = self.d_model
        if spec.ffn == "none":
            return 0
        if spec.ffn == "dense":
            mult = 3 if self.act in ("silu", "geglu") else 2
            return mult * d * self.d_ff
        e = self.moe
        n_e = e.top_k if active_only else e.num_experts
        p = (n_e + e.num_shared_experts) * 3 * d * e.d_ff_expert
        p += d * e.num_experts  # router
        return p


# ---------------------------------------------------------------------------
# Assigned input shapes (the dry-run's cells: ``launch/dryrun.py``).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
