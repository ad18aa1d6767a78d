"""Optimizers and the per-epoch LR schedules (counterpart of
m3vit_tpu/train/optim.py:16-86; reference utils/common_config.py:858-924).

optax's ``chain(add_decayed_weights(wd), sgd(lr, momentum))`` is
``torch.optim.SGD(momentum, weight_decay, dampening=0, nesterov=False)``
over one parameter group: both add wd * param to the gradient before the
momentum buffer (buf = momentum * buf + g, the first buf = g) and step by
-lr * buf.  ``optax.adam(lr)`` is ``torch.optim.Adam`` with b1 0.9, b2
0.999, eps 1e-8 and no weight decay (the JAX package's adam ignores the
config's weight_decay); ``optax.adamw(lr, weight_decay=wd)`` is
``torch.optim.AdamW`` with the same moments and decoupled decay
p -= lr * wd * p.

Gradient accumulation (``accumulation_steps`` k > 1, ``optax.MultiSteps``
there) is the train step's part (train/step.py): it applies the update
to the mean of k micro-batch gradients every k-th call.  The schedule
built here counts optimizer steps, max(steps_per_epoch // k, 1) per
epoch.

``share_pred_temperature`` is the token variant's per-epoch Gumbel
temperature of its shareability heads.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch


def poly_lr(base_lr: float, epochs: int,
            steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step) = base_lr * (1 - epoch / epochs) ** 0.9, constant within an
    epoch (reference adjust_learning_rate, common_config.py:914-916)."""

    def schedule(step: int) -> float:
        frac = 1.0 - (step // steps_per_epoch) / float(epochs)
        return base_lr * max(frac, 0.0) ** 0.9

    return schedule


def step_lr(base_lr: float, steps_per_epoch: int,
            decay_epochs: Sequence[float],
            decay_rate: float) -> Callable[[int], float]:
    """lr(step) = base_lr * decay_rate ** n, n the decay epochs the current
    epoch is strictly past (optim.py:28-38)."""
    decay_epochs = [float(e) for e in decay_epochs]

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return base_lr * decay_rate ** sum(epoch > e for e in decay_epochs)

    return schedule


def build_schedule(p: Dict, steps_per_epoch: int) -> Callable[[int], float]:
    """The config's per-step lr: "poly" or "step" (optim.py:41-52)."""
    kw = p.get("optimizer_kwargs") or {}
    base_lr = float(kw.get("lr", 1e-3))
    name = p.get("scheduler", "poly")
    if name == "poly":
        return poly_lr(base_lr, int(p["epochs"]), steps_per_epoch)
    if name == "step":
        skw = p.get("scheduler_kwargs") or {}
        return step_lr(base_lr, steps_per_epoch,
                       skw.get("lr_decay_epochs", []),
                       float(skw.get("lr_decay_rate", 0.1)))
    raise ValueError(name)


def build_optimizer(params: Iterable[torch.nn.Parameter], p: Dict,
                    steps_per_epoch: int):
    """(optimizer, schedule) from the JAX config keys ({"optimizer":
    "sgd" | "adam" | "adamw", "optimizer_kwargs": {lr, momentum,
    weight_decay, nesterov}, "scheduler": "poly" | "step",
    "scheduler_kwargs", "epochs", "accumulation_steps"}; optim.py:55-86).
    The train step sets each optimizer step's lr from the schedule, and
    takes ``accumulation_steps`` itself."""
    kw = dict(p.get("optimizer_kwargs") or {})
    accum = max(int(p.get("accumulation_steps", 1)), 1)
    schedule = build_schedule(p, max(steps_per_epoch // accum, 1))
    base_lr = float(kw.get("lr", 1e-3))
    wd = float(kw.get("weight_decay", 0.0))
    name = p.get("optimizer", "sgd")
    if name == "sgd":
        opt = torch.optim.SGD(
            params, lr=base_lr, momentum=float(kw.get("momentum", 0.0)),
            weight_decay=wd, dampening=0.0,
            nesterov=bool(kw.get("nesterov", False)))
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=0.0)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=wd)
    else:
        raise ValueError(f"Invalid optimizer {name}")
    return opt, schedule


def share_pred_temperature(p: Dict, epoch: int) -> Optional[float]:
    """The shareability heads' Gumbel temperature in `epoch`, or None
    without a schedule (optim.py:88-115; reference
    compute_share_pred_temperature, common_config.py:927-957): keys
    share_pred_temp_schedule (none | linear | cosine),
    share_pred_temp_start / _end and share_pred_temp_warmup_epochs; the
    start value through the warm-up, then from start to end over the
    remaining epochs."""
    schedule = str(p.get("share_pred_temp_schedule", "none")).lower()
    if schedule in ("none", "off", "false", ""):
        return None
    t_start = float(p.get("share_pred_temp_start", 1.0))
    t_end = float(p.get("share_pred_temp_end", 1.0))
    warmup = int(p.get("share_pred_temp_warmup_epochs", 0))
    total = int(p.get("epochs", 1))
    if total <= 1 or epoch < warmup:
        return t_start
    progress = min(1.0, max(0.0, (epoch - warmup)
                            / float(max(1, total - warmup - 1))))
    if schedule == "linear":
        return t_start + (t_end - t_start) * progress
    if schedule == "cosine":
        return t_end + 0.5 * (t_start - t_end) * (
            1.0 + math.cos(math.pi * progress))
    raise ValueError(f"Invalid share_pred_temp_schedule: {schedule}")
