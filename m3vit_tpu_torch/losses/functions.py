"""Per-task loss functions (counterpart of m3vit_tpu/losses/functions.py
:26-128, 145-158; reference losses/loss_functions.py), NCHW.

Predictions are [B, C, H, W] and labels [B, C_label, H, W]; every loss is
computed in f32 and returns a scalar.  The ignore label is 255.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

IGNORE = 255.0


def softmax_ce_loss(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Cross entropy with ignore label 255, the mean over valid pixels; 0
    when every pixel is ignored (functions.py:26-48).  label [B, 1, H, W]."""
    lab = label[:, 0].long()
    nll = F.cross_entropy(logits.float(), lab, ignore_index=255,
                          reduction="none")
    n_valid = (lab != 255).sum().clamp(min=1)
    return nll.sum() / n_valid


def _stable_bce_terms(output: torch.Tensor, labels: torch.Tensor):
    """Elementwise stable BCE-with-logits terms in the reference's form
    (functions.py:51-64)."""
    output = output.float()
    out_gt_zero = (output >= 0).float()
    loss_val = output * (labels - out_gt_zero) - torch.log1p(
        torch.exp(output - 2.0 * output * out_gt_zero))
    return -labels * loss_val, -(1.0 - labels) * loss_val


def balanced_bce_loss(output: torch.Tensor, label: torch.Tensor,
                      pos_weight: Optional[float] = None,
                      size_average: bool = True) -> torch.Tensor:
    """HED-style class-balanced BCE (functions.py:67-88): edge gets the
    config's pos_weight, sal the dynamic negative fraction."""
    labels = (label.float() >= 0.5).float()
    if pos_weight is None:
        num_total = float(labels.numel())
        w = (num_total - labels.sum()) / num_total
    else:
        w = pos_weight
    loss_pos_pix, loss_neg_pix = _stable_bce_terms(output, labels)
    final = w * loss_pos_pix.sum() + (1.0 - w) * loss_neg_pix.sum()
    return final / float(labels.numel() if size_average else labels.shape[0])


def normals_l1_loss(output: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """L2-normalise the prediction over channels, then the L1 over
    elements whose label is not 255, divided by max(n_valid, 1e-6)
    (functions.py:114-127)."""
    label = label.float()
    out = output.float()
    out = out / (torch.linalg.vector_norm(out, dim=1, keepdim=True) + 1e-12)
    mask = label != IGNORE
    diff = torch.where(mask, (out - label).abs(), 0.0)
    return diff.sum() / mask.sum().float().clamp(min=1e-6)


def loss_fn_for_task(task_name: str, p) -> Callable:
    """Task-name factory (functions.py:145-158): edge gets the config's
    pos_weight, sal uses dynamic HED weighting."""
    if task_name == "edge":
        return functools.partial(balanced_bce_loss,
                                 pos_weight=float(p["edge_w"]))
    if task_name in ("semseg", "human_parts"):
        return softmax_ce_loss
    if task_name == "normals":
        return normals_l1_loss
    if task_name == "sal":
        return balanced_bce_loss
    raise NotImplementedError(f"loss for task {task_name!r} is not ported")
