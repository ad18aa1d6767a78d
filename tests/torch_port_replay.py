"""Replaying the JAX package's ReLU masks of the PUP heads in the port.

A head's BatchNorm output can fall within f32 rounding of zero; the two
frameworks then round it to opposite signs, its ReLU keeps the element on
one side and drops it on the other, and that one element moves the head's
gradient by up to ~1e-2 of its largest magnitude (ROADMAP.md queue 3).  A
parity test that holds gradients across such an element replays the
masks, as the backbone checks replay routing: the JAX side captures each
head's BatchNorm outputs (``capture_bn``, an argument of flax's
``Module.apply``), ``head_masks`` reads their signs, and
``replay_head_masks`` makes the port's heads apply those signs in place
of their own.
"""

import contextlib

import numpy as np
import torch
from flax import linen as nn

from m3vit_tpu_torch.models.heads import VisionTransformerUpHead, batch_norm


def capture_bn(mdl, _method_name) -> bool:
    """flax capture_intermediates filter: the BatchNorms' outputs."""
    return isinstance(mdl, nn.BatchNorm)


def head_masks(intermediates, names):
    """{task: [4 NCHW bool tensors]}: where each head's BatchNorm output
    (syncbn_fc_0..3, captured by ``capture_bn``) is positive."""
    out = {}
    for n in names:
        head = intermediates[f"decoders_{n}"]
        out[n] = [torch.from_numpy(np.ascontiguousarray(
            np.asarray(head[f"syncbn_fc_{i}"]["__call__"][0])
            .transpose(0, 3, 1, 2) > 0)) for i in range(4)]
    return out


@contextlib.contextmanager
def replay_head_masks(model, masks):
    """Within the block every head of `model` (its ``decoders``) keeps the
    elements of its BatchNorm outputs that `masks` keeps (``head_masks``)
    instead of those its own ReLU keeps; the gradient flows as through a
    ReLU with that mask."""
    task_of = {id(m): t for t, m in model.decoders.items()}
    orig = VisionTransformerUpHead._bn_relu

    def bn_relu(self, i, x):
        y = batch_norm(getattr(self, f"syncbn_fc_{i}"), x,
                       self.training).to(self.dtype)
        keep = masks[task_of[id(self)]][i].to(y.device)
        return torch.where(keep, y, torch.zeros((), dtype=y.dtype))

    VisionTransformerUpHead._bn_relu = bn_relu
    try:
        yield
    finally:
        VisionTransformerUpHead._bn_relu = orig
