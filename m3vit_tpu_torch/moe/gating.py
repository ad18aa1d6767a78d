"""Top-k gating and its balance losses (counterpart of
m3vit_tpu/moe/gating.py).

Two gates.  The noisy-VMoE gate (``noisy_vmoe_gate``) takes a softmax over
the (noisy) logits first, then top-(k+1); routing uses the top-k, and the
gate scores are the raw top-k softmax probabilities, not renormalised
(reference noisy_gate_vmoe.py:196-204).  The learned-noise gate
(``noisy_gate``, ``moe_gate_type="noisy"``) scales its noise per element by
softplus(x @ w_noise) + 1e-2, takes the top-(k+1) of the raw logits and
renormalises the selected k by a softmax (reference gates.py:195-280).
Gate noise is a tensor argument of standard normals, never drawn here, so a
caller can feed the same noise to both frameworks (the MoE block draws it
from a ``torch.Generator``).  Either gate takes an expert mask (routing
restricted to some experts, ids kept global).  In training the loss is
cv^2(importance) + cv^2(load), with the smooth load estimator while noise
is active (``moe_aux_loss``, ``moe_aux_loss_noisy``), per task segment of
a stacked pass.
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
    # noisy_vmoe: a scalar, 0-dim on the CPU (a constant); noisy: [T, E]
    noise_stddev: torch.Tensor
    # [T, min(K+1, E)] top-(k+1) softmax probs (noisy_vmoe) or logits (noisy)
    top_logits: torch.Tensor
    gates: Optional[torch.Tensor] = None  # [T, E] dense scores (noisy only)


def small_topk(x: torch.Tensor, m: int):
    """top-m of x [T, E] along the last axis: descending values, ties to the
    lower index, as m3vit_tpu's small_topk (gating.py:37-62) and lax.top_k.
    torch.topk does not promise that tie order; a stable descending sort
    does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :m], idx[:, :m]


def noisy_vmoe_gate(
    gate_inp: Optional[torch.Tensor],
    w_gate: torch.Tensor,
    *,
    top_k: int,
    noise_std: float = 1.0,
    noise: Optional[torch.Tensor] = None,
    clean_logits: Optional[torch.Tensor] = None,
    expert_mask: Optional[torch.Tensor] = None,
) -> GateOutput:
    """NoisyGate_VMoE forward (m3vit_tpu/moe/gating.py:77-152).

    gate_inp [T, d_gate], w_gate [d_gate, E]; logits in f32.  `noise`
    ([T, E] standard normal) is added scaled by noise_std / E, as in
    training; None is the eval path (no noise).  clean_logits, when given
    ([T, E], computed by the caller: the stacked multi-gate pass's per-row
    logits, the token variant's batched gates), replaces the product, and
    gate_inp is not read.  expert_mask ([E] bool): routing restricted to
    the True experts, the others' noisy logits set to -1e30 after the
    noise, so ids stay global (gating.py:116-119).  Differentiable in
    gate_inp and w_gate (or clean_logits)."""
    num_experts = w_gate.shape[-1]
    clean_logits = gate_inp.float() @ w_gate.float() if clean_logits is None \
        else clean_logits.float()
    if noise is None:
        noise_stddev = torch.zeros(())
        noisy_logits = clean_logits
    else:
        noise_stddev = torch.tensor(noise_std / num_experts)
        noisy_logits = clean_logits + noise.float() * noise_stddev
    noisy_logits = _masked(noisy_logits, expert_mask)
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


def _masked(logits: torch.Tensor,
            expert_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """logits with the columns expert_mask ([E] bool) leaves out at -1e30
    (gating.py:117-119, :343-344); logits itself without a mask."""
    if expert_mask is None:
        return logits
    return torch.where(expert_mask.to(logits.device)[None, :], logits,
                       torch.full((), -1e30, device=logits.device))


def _normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def prob_in_top_k(clean_values, noisy_values, noise_stddev,
                  noisy_top_values, top_k: int) -> torch.Tensor:
    """Smooth P[value in top-k] under re-drawn noise (gating.py:159-178),
    with the noisy-VMoE gate's mix of logit-space values and
    probability-space thresholds kept for parity.  noise_stddev is a
    scalar (noisy_vmoe) or the per-element [T, E] stddev (noisy); it
    broadcasts against the [T, E] values."""
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


def _segment_ids(gate: GateOutput, segments: int) -> torch.Tensor:
    """Expert ids offset into per-segment banks: a token of segment s
    (task-major equal groups of tokens) counts into row s
    (gating.py:247-253)."""
    T = gate.top_k_indices.shape[0]
    E = gate.clean_logits.shape[-1]
    seg = torch.arange(segments, device=gate.top_k_indices.device
                       ).repeat_interleave(T // segments)
    return gate.top_k_indices + seg[:, None] * E


def _per_expert(gate: GateOutput, w: torch.Tensor,
                segments: int) -> torch.Tensor:
    E = gate.clean_logits.shape[-1]
    if segments == 1:
        return _onehot_accumulate(gate.top_k_indices.reshape(-1), w, E)
    return _onehot_accumulate(_segment_ids(gate, segments).reshape(-1), w,
                              segments * E).reshape(segments, E)


def gate_importance(gate: GateOutput, segments: int = 1) -> torch.Tensor:
    """Per-expert sum of the top-k gate probabilities, [E], or [segments,
    E] per task-major group of tokens (gating.py:270-286)."""
    return _per_expert(gate, gate.top_k_gates.reshape(-1), segments)


def gate_load_counts(gate: GateOutput, segments: int = 1) -> torch.Tensor:
    """Per-expert routed-token counts, [E] f32, or [segments, E]
    (gating.py:288-297)."""
    return _per_expert(gate, (gate.top_k_gates.reshape(-1) > 0).float(),
                       segments)


def _cv_sum(importance: torch.Tensor, load: torch.Tensor,
            reduce) -> torch.Tensor:
    """cv^2(importance) + cv^2(load), of [E] vectors, or summed over the
    rows of [segments, E] ones."""
    if reduce is not None:   # one reduction for both
        importance, load = reduce(torch.stack([importance.float(),
                                               load.float()])).unbind()
    if importance.dim() == 1:
        return cv_squared(importance) + cv_squared(load)
    return sum(cv_squared(i) + cv_squared(l)
               for i, l in zip(importance, load))


def moe_aux_loss(gate: GateOutput, top_k: int, num_experts: int,
                 train: bool, reduce=None,
                 row_mask: Optional[torch.Tensor] = None,
                 segments: int = 1) -> torch.Tensor:
    """cv^2(importance) + cv^2(load) for one MoE block (gating.py:195-244).
    Load is the smooth estimator while the noise is active (stddev >
    1e-6), else the hard count; 0 outside training.  The statistics span
    the gate's width (the logits' columns: a task's expert window under
    regu_experts_fromtask).  segments > 1: the tokens are `segments` equal
    task-major groups (the stacked multi-gate pass), and the loss is the
    sum of each group's, as the per-task passes would give it.  `reduce`
    (differentiable) turns this rank's importance and load into the
    global batch's before cv^2 (data parallelism; gating.py:200-242 sees
    the whole batch).  row_mask ([T] f32 of 0/1): only those tokens count
    (the token variant's computed tokens; its caller also zeroes the other
    rows' top_k_gates, which takes them out of the importance and the hard
    count)."""
    if not train:
        return torch.zeros((), device=gate.clean_logits.device)
    importance = gate_importance(gate, segments)
    if top_k < num_experts and float(gate.noise_stddev) > 1e-6:
        smooth = prob_in_top_k(gate.clean_logits, gate.noisy_logits,
                               gate.noise_stddev, gate.top_logits, top_k)
        if row_mask is not None:
            smooth = smooth * row_mask[:, None]
        load = smooth.sum(0) if segments == 1 else smooth.reshape(
            segments, -1, smooth.shape[-1]).sum(1)
    else:
        load = gate_load_counts(gate, segments)
    return _cv_sum(importance, load, reduce)


def noisy_gate_init(d_gate: int, num_experts: int, gen: torch.Generator):
    """(w_gate, w_noise) [d_gate, E] f32 for the learned-noise gate, drawn
    in that order from `gen` (gating.py:300-304; reference gates.py:68-90:
    both kaiming_uniform(a=sqrt(5)) on [d, E], bound 1/sqrt(E))."""
    bound = num_experts ** -0.5
    return tuple(torch.empty(d_gate, num_experts).uniform_(
        -bound, bound, generator=gen) for _ in range(2))


def noisy_gate(
    gate_inp: torch.Tensor,
    w_gate: torch.Tensor,
    w_noise: torch.Tensor,
    *,
    top_k: int,
    noise: Optional[torch.Tensor] = None,
    noise_epsilon: float = 1e-2,
    expert_mask: Optional[torch.Tensor] = None,
) -> GateOutput:
    """NoisyGate forward, ``moe_gate_type="noisy"`` (gating.py:307-365).

    gate_inp [T, d_gate], w_gate and w_noise [d_gate, E]; logits in f32.
    `noise` ([T, E] standard normal) is scaled per element by
    softplus(x @ w_noise) + noise_epsilon, as in training; None is the eval
    path (no noise, a zero stddev).  expert_mask ([E] bool) as
    noisy_vmoe_gate's.  Top-(k+1) of the raw noisy logits;
    the k selected scores are their softmax, also scattered into the dense
    ``gates`` [T, E].  Differentiable in gate_inp, w_gate and w_noise."""
    num_experts = w_gate.shape[-1]
    x = gate_inp.float()
    clean_logits = x @ w_gate.float()
    if noise is None:
        noise_stddev = torch.zeros_like(clean_logits)
        noisy_logits = clean_logits
    else:
        noise_stddev = torch.nn.functional.softplus(x @ w_noise.float()) \
            + noise_epsilon
        noisy_logits = clean_logits + noise.float() * noise_stddev
    noisy_logits = _masked(noisy_logits, expert_mask)
    top_logits, top_indices = small_topk(noisy_logits,
                                         min(top_k + 1, num_experts))
    top_k_indices = top_indices[:, :top_k]
    top_k_gates = torch.softmax(top_logits[:, :top_k], dim=-1)
    gates = torch.zeros_like(noisy_logits).scatter(1, top_k_indices,
                                                   top_k_gates)
    return GateOutput(
        top_k_indices=top_k_indices,
        top_k_gates=top_k_gates,
        clean_logits=clean_logits,
        noisy_logits=noisy_logits,
        noise_stddev=noise_stddev,
        top_logits=top_logits,
        gates=gates,
    )


def moe_aux_loss_noisy(gate: GateOutput, top_k: int, num_experts: int,
                       train: bool, reduce=None) -> torch.Tensor:
    """cv^2(importance) + cv^2(load) for the learned-noise gate
    (gating.py:368-382; reference gates.py:249-262): importance is the
    dense gates' column sum; load the smooth estimator with the
    per-element stddev (clamped at 1e-20) when top_k < E, else the count
    of nonzero gates per expert; 0 outside training.  `reduce` as
    moe_aux_loss's."""
    if not train:
        return torch.zeros((), device=gate.clean_logits.device)
    importance = gate.gates.sum(0)
    if top_k < num_experts:
        load = prob_in_top_k(gate.clean_logits, gate.noisy_logits,
                             gate.noise_stddev.clamp(min=1e-20),
                             gate.top_logits, top_k).sum(0)
    else:
        load = (gate.gates > 0).sum(0).float()
    return _cv_sum(importance, load, reduce)
