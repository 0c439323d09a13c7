"""Architecture registry of the port.

``get_config(name)`` returns the exact published configuration;
``get_smoke_config(name)`` returns the reduced same-family variant the CPU
parity tests use.  The registry knows every architecture the reference
knows, and the port runs every one of them.  ``first_layers(cfg, n)`` cuts
a config to its first ``n`` layers at its published widths (the CLIs'
``--layers``).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    AttnConfig,
    LayerSpec,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    ParallelConfig,
)

__all__ = [
    "ARCH_IDS",
    "AttnConfig",
    "LayerSpec",
    "MambaConfig",
    "ModelConfig",
    "MoEConfig",
    "ParallelConfig",
    "first_layers",
    "get_config",
    "get_smoke_config",
]

ARCH_IDS = [
    "deepseek_v2_236b",
    "dbrx_132b",
    "jamba_1_5_large_398b",
    "musicgen_large",
    "gemma_7b",
    "yi_6b",
    "minicpm3_4b",
    "h2o_danube_3_4b",
    "qwen2_vl_7b",
    "falcon_mamba_7b",
]

# canonical dashed ids (CLI --arch) -> module name
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def first_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    """``cfg`` cut to its first ``n`` layers, every width as it is: ``n`` a
    multiple of the ``layer_pattern``'s period keeps whole periods; ``n``
    below the period keeps the pattern's first ``n`` slots as the pattern,
    so the layers kept are the model's layers 0 to n - 1 in order (Jamba's
    first 4 hold an attention, a Mamba, a dense and a MoE layer).  Any
    other ``n`` raises ``ValueError``."""
    period = len(cfg.layer_pattern)
    if not 1 <= n <= cfg.num_layers:
        raise ValueError(f"{cfg.name}: cannot keep {n} of its {cfg.num_layers} layers")
    if n % period == 0:
        return dataclasses.replace(cfg, num_layers=n)
    if n < period:
        return dataclasses.replace(cfg, num_layers=n, layer_pattern=cfg.layer_pattern[:n])
    raise ValueError(f"{cfg.name}: {n} layers are neither a multiple of its pattern's period "
                     f"{period} nor fewer than it")
