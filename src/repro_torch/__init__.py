"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and keeps its own copies of what it needs.  Module names follow the
reference's, so each module's counterpart is found under the same path.
The four TPU kernels (RMSNorm, flash attention and the Mamba selective
scan on the serving paths; the full-lane alltoall's block regroup on the
collectives' path) are CUDA C++ kernels under ``kernels/csrc``; everything
else is plain PyTorch, and the collectives run on ``torch.distributed``.

Two paths use them: serving (``launch/serve.py`` -> ``serving/engine.py``
-> ``models/lm.prefill`` / ``decode_step``) and training
(``launch/train.py`` -> ``training/train_step.py`` -> ``models/lm.loss_fn``,
AdamW in ``training/optimizer.py``, checkpoints in
``training/checkpoint.py``).  Training differentiates the flash attention
(``models/flash.py``, the reference's custom VJP), the selective scan
with its terms (``models/mamba.selective_scan_fused``, the other custom
VJP) and RMSNorm through three more CUDA kernels, their backwards
(``csrc/flash_attention_bwd.cu``, ``csrc/mamba_scan_fused_bwd.cu``,
``csrc/rmsnorm_bwd.cu``); on one card it syncs
no gradients, in ranks (``launch/ranks.py``) the train step takes the
reference's flat or full-lane (``hierarchical_psum``) data-parallel sync.

Entry points take an explicit ``device`` that defaults to ``"cuda"``: they
raise when CUDA is absent, unless the caller asked for ``"cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.  Raises rather than
    falling back to the CPU when CUDA is asked for and absent.  ``"meta"``
    gives shapes and dtypes only, with no storage (the dry-run's pass,
    ``launch/dryrun.py``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda', 'cpu' or 'meta'")
    return dev
