"""Displacement-overflow guard: act on fields that the warp's clamp saturates.

Counterpart of ``deepatlas_tpu/train/guard.py``, with the same semantics.
The warp clamps each axis of the displacement to +-``max_disp`` voxels and a
registration step reports the clamped fraction of voxels as
``disp_overflow``.  Persistent overflow means the registration net wants
larger deformations than the bound lets through, and training would
optimize a saturated surrogate of the unbounded warp.  The guard watches the
metric and, after ``patience`` consecutive offending steps, either warns or
asks the experiment to widen the bound or to warp unclamped.
"""
from __future__ import annotations

from typing import Optional


class DispOverflowGuard:
    """Threshold/patience monitor over the ``disp_overflow`` metric.

    Args:
      threshold: offending overflow fraction (clipped voxels / voxels).
      patience: consecutive offending steps before action.
      mode: ``"warn"`` -- print only; ``"escalate"`` -- multiply
        ``max_disp`` by ``factor`` up to ``limit``, then warn (the joint
        experiment's default); ``"xla"`` -- request the unbounded warp (the
        name is the JAX package's, kept so that configs carry over).
      factor / limit: escalation step and cap for ``mode="escalate"``.
    """

    def __init__(self, threshold: float = 0.05, patience: int = 10,
                 mode: str = "warn", factor: int = 2, limit: int = 32):
        if mode not in ("warn", "escalate", "xla"):
            raise ValueError(f"mode must be warn|escalate|xla, got {mode!r}")
        self.threshold = float(threshold)
        self.patience = int(patience)
        self.mode = mode
        self.factor = int(factor)
        self.limit = int(limit)
        self.count = 0
        self.warned = False

    def update(self, overflow: float,
               current_max_disp: int) -> Optional[dict]:
        """Feed one step's overflow fraction.

        Returns ``None`` (keep training), or an action dict:
        ``{"action": "warn"}``, ``{"action": "escalate", "max_disp": n}``,
        or ``{"action": "xla"}``.  The caller acts on it; the guard resets
        its patience counter either way.
        """
        if overflow is None:
            return None
        if float(overflow) > self.threshold:
            self.count += 1
        else:
            self.count = 0
            return None
        if self.count < self.patience:
            return None
        self.count = 0
        if self.mode == "escalate":
            new_md = min(current_max_disp * self.factor, self.limit)
            if new_md > current_max_disp:
                return {"action": "escalate", "max_disp": new_md}
            # already at the cap: degrade to warning
        if self.mode == "xla":
            return {"action": "xla"}
        if not self.warned:
            self.warned = True
        return {"action": "warn"}


def make_guard(config: dict,
               default_mode: str = "warn") -> Optional[DispOverflowGuard]:
    """Build a guard from the experiment config's ``overflow_guard`` key (a
    dict of ``DispOverflowGuard`` kwargs; ``False``/``None`` disables,
    ``True`` or ``{}`` uses the defaults).  ``default_mode`` sets the mode
    when the config names none: the joint experiment passes
    ``"escalate"``."""
    cfg = config.get("overflow_guard", True)
    if not cfg:
        return None
    if cfg is True:
        cfg = {}
    cfg = dict(cfg)
    cfg.setdefault("mode", default_mode)
    return DispOverflowGuard(**cfg)
