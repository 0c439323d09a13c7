"""Schedule-as-a-service persistence layer.

The paper's product is a *tuned choice* of collective schedule per
``(op, algorithm, topology, k, payload regime)``; this package makes those
choices survive the process that derived them.  :class:`ArtifactStore`
serializes compiled schedules and payload-independent optimizer recipes to
a versioned on-disk directory and warm-starts the process-wide cache in
``repro_torch.core.schedule_ir`` so a fresh server answers the selector's load
without recompiling anything the store already holds.
"""

from repro_torch.store.artifacts import (
    STORE_SCHEMA_VERSION,
    ArtifactStore,
    c_regime,
    default_store_root,
)

__all__ = [
    "ArtifactStore",
    "STORE_SCHEMA_VERSION",
    "c_regime",
    "default_store_root",
]
