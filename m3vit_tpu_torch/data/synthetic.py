"""Synthetic multi-task batches with the reference's label encodings
(counterpart of m3vit_tpu/data/synthetic.py:16-53), NCHW, drawn from a
torch.Generator: ImageNet-normalised-like images, ignore label 255,
unit-norm normals, binary edge/sal maps."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def synthetic_batch(gen: torch.Generator, tasks, batch_size: int,
                    img_size: Tuple[int, int], ignore_fraction: float = 0.1,
                    device=None) -> Dict[str, torch.Tensor]:
    """{"image": [B, 3, H, W], task: [B, C, H, W]} f32 on `device` (the
    generator's device when None)."""
    H, W = img_size
    dev = gen.device if device is None else torch.device(device)
    kw = dict(generator=gen, device=dev)
    batch = {"image": torch.randn((batch_size, 3, H, W), **kw)}
    ignore = torch.rand((batch_size, 1, H, W), **kw) < ignore_fraction
    for t in tasks:
        if t.loss_kind == "softmax_ce":
            lab = torch.randint(0, t.num_output, (batch_size, 1, H, W),
                                **kw).float()
            lab = torch.where(ignore, 255.0, lab)
        elif t.loss_kind in ("balanced_bce", "bce"):
            lab = (torch.rand((batch_size, 1, H, W), **kw) > 0.9).float()
        elif t.loss_kind == "normals_l1":
            v = torch.randn((batch_size, 3, H, W), **kw)
            lab = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True)
                       + 1e-12)
            lab = torch.where(ignore, 255.0, lab)
        else:
            raise NotImplementedError(t.loss_kind)
        batch[t.name] = lab
    return batch
