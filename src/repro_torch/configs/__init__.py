"""Architecture registry of the port.

``get_config(name)`` returns the exact published configuration;
``get_smoke_config(name)`` returns the reduced same-family variant the CPU
parity tests use.  The registry knows every architecture the reference
knows, and the port runs every one of them.
"""

from __future__ import annotations

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
