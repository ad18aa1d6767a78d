"""Dropout and drop-path (stochastic depth) as the JAX package applies them
(flax nn.Dropout; m3vit_tpu/models/vit.py:drop_path :277-286): a kept
element is scaled by 1 / keep, a dropped one is 0.

Masks are drawn from an explicit ``torch.Generator`` (the train step's, on
the tensor's device), kept where a uniform draw is below keep, as
``jax.random.bernoulli`` keeps; a caller may pass the mask instead, since
torch cannot reproduce JAX's draws.  Under data parallelism a rank keeps
its rows of the global batch's mask.  Plain PyTorch, no kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from m3vit_tpu_torch import parallel


def _mask(shape, keep: float, rng: Optional[torch.Generator],
          device) -> torch.Tensor:
    if rng is None:
        raise ValueError("dropout and drop-path in training need a "
                         "torch.Generator to draw their masks from")
    return torch.rand(shape, generator=rng, device=device) < keep


def _rank_mask(shape, keep: float, rng: Optional[torch.Generator], device,
               batch_dim: Optional[int] = 0) -> torch.Tensor:
    """The keep mask of `shape`.  Under data parallelism (a ``parallel``
    layout in force) it is this rank's slice, along `batch_dim`, of the
    global batch's mask, as JAX's one program draws it; with batch_dim
    None (a tensor not laid out by batch, such as an expert buffer) the
    rank draws its own."""
    lay = parallel.active()
    if lay is None or batch_dim is None:
        return _mask(shape, keep, rng, device)
    n = shape[batch_dim]
    full = list(shape)
    full[batch_dim] = n * lay.world
    return _mask(full, keep, rng, device).narrow(batch_dim, lay.rank * n, n)


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator],
            mask: Optional[torch.Tensor] = None,
            batch_dim: Optional[int] = 0) -> torch.Tensor:
    """where(mask, x / keep, 0) with keep = 1 - rate and a mask of x's
    shape (``_rank_mask``: x's batch along `batch_dim`); x itself at rate 0.
    keep is rounded to x's dtype before the division, as JAX rounds a
    Python scalar to a bf16 operand's type.  Call it in training only."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = _rank_mask(x.shape, keep, rng, x.device, batch_dim)
    return torch.where(mask, x / torch.tensor(keep, dtype=x.dtype,
                                              device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, rng: Optional[torch.Generator],
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample stochastic depth: dropout with one mask entry per sample
    (shape [B, 1, ..., 1]); x itself at rate 0.  Call it in training
    only."""
    if rate <= 0.0:
        return x
    if mask is None:
        mask = _rank_mask((x.shape[0],) + (1,) * (x.ndim - 1), 1.0 - rate,
                          rng, x.device)
    return dropout(x, rate, rng, mask)
