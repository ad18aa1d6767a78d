"""Expert pruning (counterpart of m3vit_tpu/moe/pruning.py; reference
utils/moe_utils.py:251-298): average each MoE block's gate activation over
some batches, keep the top experts of each block, then either mask the
routing to them (the model's ``expert_mask`` input) or cut the expert
banks and gate columns down to them and load the result into a model built
with that many experts: a smaller single-task pathway with the same
routing among the kept experts.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from m3vit_tpu_torch.models import vit_moe


def collect_expert_usage(apply_gates_fn: Callable, batches,
                         num_blocks: int) -> List[np.ndarray]:
    """Mean gate activation per expert of each MoE block over `batches`
    (pruning.py:22-39): apply_gates_fn(batch) -> one [T, E] array of gate
    probabilities a MoE block (``dense_gates`` gives them)."""
    sums: Optional[List[np.ndarray]] = None
    count = 0
    for batch in batches:
        gates = apply_gates_fn(batch)
        assert len(gates) == num_blocks
        g = [np.asarray(x).sum(0) for x in gates]
        sums = g if sums is None else [a + b for a, b in zip(sums, g)]
        count += np.asarray(gates[0]).shape[0]
    return [s / max(count, 1) for s in sums]


def select_top_experts(usage: List[np.ndarray], keep: int
                       ) -> List[np.ndarray]:
    """The `keep` experts of highest mean activation of each block, in
    ascending id order (pruning.py:42-45)."""
    return [np.sort(np.argsort(-u)[:keep]) for u in usage]


def usage_to_masks(select: List[np.ndarray], num_experts: int
                   ) -> List[torch.Tensor]:
    """[E] bool routing masks of the selected experts (pruning.py:48-54)."""
    masks = []
    for idx in select:
        m = torch.zeros(num_experts, dtype=torch.bool)
        m[torch.as_tensor(np.asarray(idx), dtype=torch.long)] = True
        masks.append(m)
    return masks


@contextlib.contextmanager
def recorded_gates(model: torch.nn.Module):
    """Within the block, every noisy-VMoE gate of `model` appends its
    output to the list this yields, in call order."""
    seen: list = []
    orig = vit_moe.noisy_vmoe_gate

    def record(*args, **kw):
        seen.append(orig(*args, **kw))
        return seen[-1]

    vit_moe.noisy_vmoe_gate = record
    try:
        yield seen
    finally:
        vit_moe.noisy_vmoe_gate = orig


def dense_gates(model: torch.nn.Module, task: str,
                **inputs) -> Callable:
    """apply_gates_fn for ``collect_expert_usage``: one eval forward of
    `task`'s pathway on a batch's images, returning each MoE block's dense
    [T, E] gate probabilities (the top-k scores at their experts, zeros
    elsewhere)."""

    def fn(batch):
        model.eval()
        with torch.no_grad(), recorded_gates(model) as seen:
            model(batch["image"], single_task=task, **inputs)
        return [torch.zeros_like(g.clean_logits).scatter(
            1, g.top_k_indices, g.top_k_gates).cpu().numpy() for g in seen]

    return fn


_BANK = re.compile(r"(?:^|\.)blocks\.(\d+)\.mlp\.(experts\..+|gate\..*w_"
                   r"(?:gate|noise)|regu_sem_head\.weight)$")


def prune_experts_in_state_dict(state_dict: Dict[str, torch.Tensor],
                                select_per_block: Dict[int, Iterable[int]]
                                ) -> Dict[str, torch.Tensor]:
    """The state dict of a model built with moe_experts = len(kept
    experts), from a full model's (pruning.py:57-83): for each block index
    in select_per_block, ``blocks.{i}.mlp.experts.*`` (float or int8
    banks, their scales and biases) taken on dim 0 and the routers'
    ``w_gate`` / ``w_noise`` ([d, E]) and ``regu_sem_head.weight``
    ([classes, E]) on their expert columns; every other entry as it is.
    (The JAX package cuts ``w_gate`` alone, which leaves a learned-noise
    gate's ``w_noise`` and the regu_sem head at the full width.)"""
    out = {}
    for k, v in state_dict.items():
        m = _BANK.search(k)
        sel = None if m is None else select_per_block.get(int(m.group(1)))
        if sel is None:
            out[k] = v
            continue
        idx = torch.as_tensor(np.asarray(list(sel)), dtype=torch.long,
                              device=v.device)
        dim = 0 if m.group(2).startswith("experts.") else -1
        out[k] = v.index_select(dim, idx)
    return out
