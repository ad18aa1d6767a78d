#!/usr/bin/env python3
"""How far a CNN model's f32 gradients sit from f64 ones, on the CPU.

    python3 scripts/cnn_grad_precision.py nyud/resnet50/nddr_cnn.yml \
        [--batch 2 --hw 128]

Builds the config (configs/<CONFIG>, full widths) with the port's
factory on the CPU, runs one train forward and backward of its loss
scheme on a synthetic batch in f32, then the same on an f64 copy of the
model with the f32 run's ReLU and dropout masks replayed (so both take
the same branches), and prints one JSON line: the loss of each and, per
parameter group (the top module's leading word, as chip_smoke.py groups
them), |g32 - g64| / |g64|.  That is the f32 step's own rounding error,
the yardstick for comparing two f32 summation orders (the card's cuDNN
against the CPU's, chip_smoke.py's cnn_vs_cpu).

The port computes BatchNorm and the MTL methods' own layers in f32 by
design; for the f64 run the script widens those helpers.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from m3vit_tpu_torch.config import create_config  # noqa: E402
from m3vit_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from m3vit_tpu_torch.losses.schemes import (  # noqa: E402
    build_loss_fns,
    loss_scheme_of,
)
from m3vit_tpu_torch.models import (  # noqa: E402
    build_model,
    cnn_heads,
    hrnet,
    mobilenetv3,
    mtl_methods,
    resnet,
)
from m3vit_tpu_torch.models.heads import batch_norm  # noqa: E402
from m3vit_tpu_torch.ops import dropout as dropout_ops  # noqa: E402


def widen_to_f64(model: torch.nn.Module) -> torch.nn.Module:
    """An f64 copy of `model`, its f32 helpers widened to the input's
    dtype."""
    for mod in (resnet, hrnet, mobilenetv3, cnn_heads, mtl_methods):
        mod.apply_bn = lambda b, x: batch_norm(b, x, b.training)
    mtl_methods.F32 = torch.float64
    torch.Tensor.float = lambda self: self
    m = copy.deepcopy(model).double()
    for sub in m.modules():
        if hasattr(sub, "dtype"):
            sub.dtype = torch.float64
    return m


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", help="path under configs/")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--hw", type=int, default=128)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = create_config(None, os.path.join(root, "configs", args.config), {})
    names = list(p["TASK_NAMES"])
    model, _ = build_model(p, device="cpu")
    loss_fns = build_loss_fns(p)
    weights = dict(p["loss_kwargs"]["loss_weights"])
    scheme = loss_scheme_of(p, names, loss_fns, weights)
    batch = synthetic_batch(torch.Generator().manual_seed(1), p["ALL_TASKS"],
                            args.batch, (args.hw, args.hw))
    relus, drops = [], []
    orig_mask = dropout_ops._mask

    def record_relu(v):
        relus.append(v > 0)
        return torch.where(relus[-1], v, torch.zeros((), dtype=v.dtype))

    def record_mask(shape, keep, rng, device):
        drops.append(orig_mask(shape, keep, rng, device))
        return drops[-1]

    def step(m, b):
        m.train()
        pred = m(b["image"], noise=torch.Generator().manual_seed(2))[0]
        losses = scheme(pred, b)
        losses["total"].backward()
        return float(losses["total"].detach())

    model64 = copy.deepcopy(model)
    F.relu, dropout_ops._mask = record_relu, record_mask
    loss32 = step(model, batch)
    model64 = widen_to_f64(model64)
    F.relu = lambda v: torch.where(relus.pop(0), v,
                                   torch.zeros((), dtype=v.dtype))
    dropout_ops._mask = lambda shape, keep, rng, device: drops.pop(0)
    loss64 = step(model64, {k: v.double() for k, v in batch.items()})
    g32 = {n: q.grad for n, q in model.named_parameters()}
    groups = {}
    for n, q in model64.named_parameters():
        g = re.match(r"[a-z]+", n).group()
        d, r = groups.get(g, (0.0, 0.0))
        groups[g] = (d + float((g32[n].double() - q.grad).square().sum()),
                     r + float(q.grad.square().sum()))
    print(json.dumps({"config": args.config, "batch": args.batch,
                      "hw": args.hw, "loss_f32": loss32, "loss_f64": loss64,
                      "grad_rel_err_f32_vs_f64": {
                          g: (d / r) ** 0.5 for g, (d, r) in groups.items()}}))


if __name__ == "__main__":
    main()
