"""Noisy-VMoE top-k gating and its balance loss (counterpart of
m3vit_tpu/moe/gating.py).

Softmax over the (noisy) logits first, then top-(k+1); routing uses the
top-k, and the gate scores are the raw top-k softmax probabilities, not
renormalised (reference noisy_gate_vmoe.py:196-204).  Gate noise is a
tensor argument, never drawn here, so a caller can feed the same noise to
both frameworks (the MoE block draws it from a ``torch.Generator``).  In
training the loss is cv^2(importance) +
cv^2(load), with the smooth load estimator while noise is active
(``moe_aux_loss``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

class GateOutput(NamedTuple):
    """Everything the MoE block needs from one gate evaluation
    (m3vit_tpu/moe/gating.py:25-34)."""

    top_k_indices: torch.Tensor  # [T, K] int64 — global expert ids
    top_k_gates: torch.Tensor  # [T, K] f32 — raw softmax probs (not renorm.)
    clean_logits: torch.Tensor  # [T, E] pre-noise logits
    noisy_logits: torch.Tensor  # [T, E] post-noise logits
    noise_stddev: torch.Tensor  # scalar, 0-dim on the CPU (a constant)
    top_logits: torch.Tensor  # [T, min(K+1, E)] softmax probs of top-(k+1)


def small_topk(x: torch.Tensor, m: int):
    """top-m of x [T, E] along the last axis: descending values, ties to the
    lower index, as m3vit_tpu's small_topk (gating.py:37-62) and lax.top_k.
    torch.topk does not promise that tie order; a stable descending sort
    does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :m], idx[:, :m]


def noisy_vmoe_gate(
    gate_inp: torch.Tensor,
    w_gate: torch.Tensor,
    *,
    top_k: int,
    noise_std: float = 1.0,
    noise: Optional[torch.Tensor] = None,
) -> GateOutput:
    """NoisyGate_VMoE forward (m3vit_tpu/moe/gating.py:77-152).

    gate_inp [T, d_gate], w_gate [d_gate, E]; logits in f32.  `noise`
    ([T, E] standard normal) is added scaled by noise_std / E, as in
    training; None is the eval path (no noise).  Differentiable in gate_inp
    and w_gate."""
    num_experts = w_gate.shape[-1]
    clean_logits = gate_inp.float() @ w_gate.float()
    if noise is None:
        noise_stddev = torch.zeros(())
        noisy_logits = clean_logits
    else:
        noise_stddev = torch.tensor(noise_std / num_experts)
        noisy_logits = clean_logits + noise.float() * noise_stddev
    probs = torch.softmax(noisy_logits, dim=-1)
    top_logits, top_indices = small_topk(probs, min(top_k + 1, num_experts))
    return GateOutput(
        top_k_indices=top_indices[:, :top_k],
        top_k_gates=top_logits[:, :top_k],
        clean_logits=clean_logits,
        noisy_logits=noisy_logits,
        noise_stddev=noise_stddev,
        top_logits=top_logits,
    )


def _normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def prob_in_top_k(clean_values, noisy_values, noise_stddev,
                  noisy_top_values, top_k: int) -> torch.Tensor:
    """Smooth P[value in top-k] under re-drawn noise (gating.py:159-178),
    with the reference's mix of logit-space values and probability-space
    thresholds kept for parity."""
    threshold_if_in = noisy_top_values[:, top_k][:, None]
    is_in = noisy_values > threshold_if_in
    threshold_if_out = noisy_top_values[:, top_k - 1][:, None]
    prob_if_in = _normal_cdf((clean_values - threshold_if_in) / noise_stddev)
    prob_if_out = _normal_cdf((clean_values - threshold_if_out)
                              / noise_stddev)
    return torch.where(is_in, prob_if_in, prob_if_out)


def cv_squared(x: torch.Tensor) -> torch.Tensor:
    """Squared coefficient of variation, unbiased variance, eps 1e-10
    (gating.py:186-192)."""
    x = x.float().reshape(-1)
    if x.shape[0] <= 1:
        return torch.zeros((), device=x.device)
    return x.var(correction=1) / (x.mean() ** 2 + 1e-10)


def _onehot_accumulate(idx: torch.Tensor, w: torch.Tensor,
                       banks: int) -> torch.Tensor:
    """sum of w into bank idx as a one-hot product (gating.py:251-264): a
    fixed summation order, unlike an atomic scatter-add on the card."""
    oh = (idx[:, None] == torch.arange(banks, device=idx.device)[None, :])
    return w.float() @ oh.float()


def gate_importance(gate: GateOutput) -> torch.Tensor:
    """Per-expert sum of the top-k gate probabilities, [E]
    (gating.py:270-286)."""
    E = gate.clean_logits.shape[-1]
    return _onehot_accumulate(gate.top_k_indices.reshape(-1),
                              gate.top_k_gates.reshape(-1), E)


def gate_load_counts(gate: GateOutput) -> torch.Tensor:
    """Per-expert routed-token counts, [E] f32 (gating.py:288-297)."""
    E = gate.clean_logits.shape[-1]
    sel = (gate.top_k_gates.reshape(-1) > 0).float()
    return _onehot_accumulate(gate.top_k_indices.reshape(-1), sel, E)


def moe_aux_loss(gate: GateOutput, top_k: int, num_experts: int,
                 train: bool) -> torch.Tensor:
    """cv^2(importance) + cv^2(load) for one MoE block (gating.py:195-244,
    one segment).  Load is the smooth estimator while the noise is active
    (stddev > 1e-6), else the hard count; 0 outside training."""
    if not train:
        return torch.zeros((), device=gate.clean_logits.device)
    importance = gate_importance(gate)
    if top_k < num_experts and float(gate.noise_stddev) > 1e-6:
        load = prob_in_top_k(gate.clean_logits, gate.noisy_logits,
                             gate.noise_stddev, gate.top_logits,
                             top_k).sum(0)
    else:
        load = gate_load_counts(gate)
    return cv_squared(importance) + cv_squared(load)
