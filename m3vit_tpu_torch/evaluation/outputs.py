"""Per-task prediction post-processing (counterpart of
m3vit_tpu/evaluation/outputs.py, reference utils/utils.py:60-79).

``get_output`` gives the JAX package's host conventions (outputs.py:39-51)
for evaluation: f32 maps, nothing rounded.  Only the class maps' argmax
runs on the device, so that [B, H, W] indices cross to the host instead of
the 21- or 7-channel logits; every other task's map has as many channels
as its result and is post-processed on the host with the same numpy
expressions, for the same bits.  ``get_output_device`` is the serving
form: compact uint8 wire dtypes, rounded.
"""

from __future__ import annotations

import numpy as np
import torch


def get_output(output: torch.Tensor, task: str) -> np.ndarray:
    """NCHW model output [B, C, H, W] (any device) -> host numpy in the
    reference's value conventions: int64 class maps [B, H, W] (first
    maximum on ties, as numpy), f32 normals in [0, 255] [B, H, W, 3],
    255 * sigmoid for edge / sal and raw depth [B, H, W]."""
    if task in ("semseg", "human_parts"):
        return output.argmax(dim=1).cpu().numpy()
    if task not in ("normals", "edge", "sal", "depth"):
        raise ValueError(f"Select one of the valid tasks, got {task}")
    out = output.float().permute(0, 2, 3, 1).contiguous().cpu().numpy()
    if task == "normals":
        norm = np.linalg.norm(out, ord=2, axis=3, keepdims=True)
        out = out / np.maximum(norm, 1e-12)
        return (out + 1.0) * 255.0 / 2.0
    if task in ("edge", "sal"):
        return np.squeeze(255.0 / (1.0 + np.exp(-out)), axis=3)
    return np.squeeze(out, axis=3)


def get_output_device(output: torch.Tensor, task: str) -> torch.Tensor:
    """NHWC model output -> the reference's value conventions in compact
    dtypes: uint8 class maps and [0, 255]-scaled maps, f32 depth."""
    out = output.float()  # [B, H, W, C]
    if task == "normals":
        norm = torch.linalg.vector_norm(out, ord=2, dim=3, keepdim=True)
        out = (out / torch.clamp(norm, min=1e-12) + 1.0) * 255.0 / 2.0
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    if task in ("semseg", "human_parts"):
        idx = torch.argmax(out, dim=3)
        return idx.to(torch.uint8 if out.shape[3] <= 256 else torch.int32)
    if task in ("edge", "sal"):
        v = 255.0 * torch.sigmoid(out[..., 0])
        return torch.clamp(torch.round(v), 0, 255).to(torch.uint8)
    if task == "depth":
        return out[..., 0]
    raise ValueError(f"Select one of the valid tasks, got {task}")
