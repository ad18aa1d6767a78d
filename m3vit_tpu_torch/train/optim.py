"""SGD and the per-epoch poly schedule (counterpart of
m3vit_tpu/train/optim.py:16-26, 55-86; reference
utils/common_config.py:858-924).

optax's ``chain(add_decayed_weights(wd), sgd(lr, momentum))`` is
``torch.optim.SGD(momentum, weight_decay, dampening=0, nesterov=False)``
over one parameter group: both add wd * param to the gradient before the
momentum buffer (buf = momentum * buf + g, the first buf = g) and step by
-lr * buf.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch


def poly_lr(base_lr: float, epochs: int,
            steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step) = base_lr * (1 - epoch / epochs) ** 0.9, constant within an
    epoch (reference adjust_learning_rate, common_config.py:914-916)."""

    def schedule(step: int) -> float:
        frac = 1.0 - (step // steps_per_epoch) / float(epochs)
        return base_lr * max(frac, 0.0) ** 0.9

    return schedule


def build_optimizer(params: Iterable[torch.nn.Parameter], p: Dict,
                    steps_per_epoch: int):
    """(torch.optim.SGD, schedule) from the JAX config keys
    ({"optimizer": "sgd", "optimizer_kwargs": {lr, momentum, weight_decay,
    nesterov}, "scheduler": "poly", "epochs"}).  The train step sets each
    step's lr from the schedule.  Gradient accumulation (the JAX package's
    optax.MultiSteps, with the schedule counted in optimizer steps) is not
    ported: ``accumulation_steps`` > 1 raises rather than train with another
    update rule."""
    if p.get("optimizer", "sgd") != "sgd" or p.get("scheduler",
                                                    "poly") != "poly":
        raise NotImplementedError("only SGD with the poly schedule is ported")
    if int(p.get("accumulation_steps", 1)) > 1:
        raise NotImplementedError(
            "accumulation_steps > 1 (optax.MultiSteps in the JAX package) is "
            "not ported")
    kw = dict(p.get("optimizer_kwargs") or {})
    base_lr = float(kw.get("lr", 1e-3))
    opt = torch.optim.SGD(
        params, lr=base_lr, momentum=float(kw.get("momentum", 0.0)),
        weight_decay=float(kw.get("weight_decay", 0.0)), dampening=0.0,
        nesterov=bool(kw.get("nesterov", False)))
    return opt, poly_lr(base_lr, int(p["epochs"]), steps_per_epoch)
