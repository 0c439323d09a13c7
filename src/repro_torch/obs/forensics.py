"""Failure forensics: dump the flight recorder + metrics snapshot to a
``*.forensics.json`` artifact.

Two entry points:

* :func:`dump` — unconditional; used by harnesses that *know* they are
  at a failure boundary (bench-gate failure, chaos contract breach).
* :func:`auto_dump` — fires only when forensics is **armed** (via
  :func:`enable` or the ``REPRO_FORENSICS`` environment variable naming
  an output directory; ``REPRO_FORENSICS=1`` means the current
  directory).  The data-flow oracle's ``raise_if_invalid`` calls this on
  every violation — armed runs (chaos, CI smokes) get a post-mortem
  artifact, while the test suite's many *intentional* corruption checks
  stay silent.

Artifact shape::

    {"reason": str, "generated_at": iso8601, "pid": int,
     "extra": {...},                 # caller context (report fields, ...)
     "trace": {"dropped": int, "records": [flight-recorder records]},
     "metrics": {name: snapshot}}

File name: ``<reason>.forensics.json`` in the armed directory (or the
``dir``/``path`` arguments); repeated dumps for the same reason get a
``-2``, ``-3``, ... suffix so a chaos sweep keeps every incident.  When
nothing is armed, unconditional dumps land in the git-ignored
``artifacts/`` directory rather than littering the repo root;
``REPRO_FORENSICS=1`` keeps the legacy current-directory behavior.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

from repro_torch.obs import metrics, trace

__all__ = ["enable", "disable", "enabled_dir", "dump", "auto_dump"]

_LOCK = threading.Lock()
_DIR: str | None = None

#: Where unconditional dumps go when no directory is armed or passed.
DEFAULT_DIR = "artifacts"


def enable(directory: str = ".") -> None:
    """Arm auto-dumps, writing artifacts into ``directory``."""
    global _DIR
    with _LOCK:
        _DIR = directory


def disable() -> None:
    global _DIR
    with _LOCK:
        _DIR = None


def enabled_dir() -> str | None:
    """The armed output directory, or None.  ``REPRO_FORENSICS`` in the
    environment arms it too (``1`` → current directory)."""
    with _LOCK:
        if _DIR is not None:
            return _DIR
    env = os.environ.get("REPRO_FORENSICS", "")
    if env and env != "0":
        return "." if env == "1" else env
    return None


def _unique_path(directory: str, reason: str) -> str:
    safe = "".join(ch if (ch.isalnum() or ch in "-_.") else "_"
                   for ch in reason) or "failure"
    path = os.path.join(directory, f"{safe}.forensics.json")
    n = 2
    while os.path.exists(path):
        path = os.path.join(directory, f"{safe}-{n}.forensics.json")
        n += 1
    return path


def dump(reason: str, extra: dict[str, Any] | None = None, *,
         dir: str | None = None, path: str | None = None) -> str:
    """Write a forensics artifact unconditionally; returns its path."""
    if path is None:
        directory = dir if dir is not None else (enabled_dir() or DEFAULT_DIR)
        os.makedirs(directory, exist_ok=True)
        path = _unique_path(directory, reason)
    doc = {
        "reason": reason,
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "pid": os.getpid(),
        "extra": extra or {},
        "trace": {
            "dropped": trace.TRACER.dropped,
            "records": trace.TRACER.records(),
        },
        "metrics": metrics.snapshot(),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=trace.json_default)
    return path


def auto_dump(reason: str, extra: dict[str, Any] | None = None) -> str | None:
    """Write a forensics artifact iff armed; returns the path or None.
    Never raises — a forensics failure must not mask the original error."""
    directory = enabled_dir()
    if directory is None:
        return None
    try:
        return dump(reason, extra, dir=directory)
    except Exception:  # pragma: no cover - best-effort by contract
        return None
