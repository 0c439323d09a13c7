"""Straggler detection: ``StragglerMonitor``, copied from the reference's
``repro/training/elastic.py`` (pure Python), for ``launch/train.py``.

The rest of that module (fault events and elastic re-meshing plans) comes
with the planner's numpy layers (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

__all__ = ["StragglerMonitor"]


class StragglerMonitor:
    """EMA-based per-step deadline.  ``observe`` returns an action:
    "ok", "warn" (late but under hard limit), or "evict" (the host exceeded
    the hard multiple ``evict_factor`` times in a row)."""

    def __init__(self, *, ema_decay: float = 0.9, warn_factor: float = 1.5,
                 evict_factor: float = 3.0, patience: int = 3):
        self.ema_decay = ema_decay
        self.warn_factor = warn_factor
        self.evict_factor = evict_factor
        self.patience = patience
        self.ema: float | None = None
        self.strikes = 0
        self.warnings = 0

    def deadline(self) -> float | None:
        return None if self.ema is None else self.ema * self.warn_factor

    def observe(self, step_seconds: float) -> str:
        if self.ema is None:
            self.ema = step_seconds
            return "ok"
        action = "ok"
        if step_seconds > self.ema * self.evict_factor:
            self.strikes += 1
            action = "evict" if self.strikes >= self.patience else "warn"
        elif step_seconds > self.ema * self.warn_factor:
            self.warnings += 1
            self.strikes = 0
            action = "warn"
        else:
            self.strikes = 0
        # stragglers must not poison the baseline: clamp EMA update
        obs = min(step_seconds, self.ema * self.warn_factor)
        self.ema = self.ema * self.ema_decay + obs * (1 - self.ema_decay)
        return action
