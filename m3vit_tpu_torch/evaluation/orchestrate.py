"""Evaluation orchestration (counterpart of
m3vit_tpu/evaluation/orchestrate.py).  Its first piece: the guard that
holds an eval pass to the reference's no-drop routing.  The online
evaluation loop and its meters come with the port's evaluation host code
(ROADMAP queue 1 item 5)."""

from __future__ import annotations

from typing import Dict, Optional

import torch


class _DropGuard:
    """Accumulates the MoE dropped-slot fraction over an eval pass and
    enforces the reference's no-drop semantics (fastmoe's ragged dispatch,
    ckpt/custom_moe_layer.py:263-265; orchestrate.py:41-69): any token the
    static capacity dropped at eval is a deviation, and ``check`` raises,
    pointing at ``moe_eval_capacity_factor: nodrop``, unless the config
    sets ``allow_eval_drops``.  The sum stays on the device until
    ``check`` reads it once."""

    def __init__(self, p: Dict):
        self.total: Optional[torch.Tensor] = None
        self.allow = bool(p.get("allow_eval_drops", False))

    def update(self, stats: Optional[Dict[str, torch.Tensor]]) -> None:
        if stats and "dropped_slot_fraction" in stats:
            d = stats["dropped_slot_fraction"]
            self.total = d if self.total is None else self.total + d

    def check(self) -> None:
        if self.total is None:
            return
        total = float(self.total)
        if total > 0 and not self.allow:
            raise RuntimeError(
                f"eval dropped MoE routing slots (sum of per-block dropped "
                f"fractions = {total:.3e}); the reference never drops. Set "
                f"moe_eval_capacity_factor: nodrop (guaranteed-sufficient "
                f"capacity) or allow_eval_drops: true to override.")
