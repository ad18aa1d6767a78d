"""Static-capacity MoE dispatch / expert FFN / combine, single device.

Counterpart of m3vit_tpu/moe/dispatch.py: a sort-derived dispatch plan
(stable sort by expert id; per-expert slots are contiguous runs of the
sorted order), dispatch and combine as row gathers whose backwards are row
gathers too (autograd Functions, as the JAX custom_vjps), and the
per-expert FFN through the fused kernels (ops/expert_ffn.py): K3/K4 on
float banks, K7 on int8 banks (``MoEFfnParamsQ``, inference only).  Slot
assignment is bitwise the JAX package's: over-capacity slots drop in slot
order t*K+k, and ids >= E count as dropped before they take capacity.
Expert parallelism (dispatch.py:543) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from m3vit_tpu_torch.ops.expert_ffn import (
    dequantize_weight,
    fused_expert_ffn,
    fused_expert_ffn_plain,
    quantized_expert_ffn,
)


class MoEFfnParams(NamedTuple):
    """Per-expert two-layer MLP weights, expert-major, torch [out, in] layout
    (the JAX package keeps [E, in, out]).

    w1: [E, d_hidden, d_model]   (reference FMoELinear htoh4)
    b1: [E, d_hidden]
    w2: [E, d_model, d_hidden]   (reference FMoELinear h4toh)
    b2: [E, d_model]
    """

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


class MoEFfnParamsQ(NamedTuple):
    """Weight-only int8 expert banks (serving; dispatch.py:58-71), torch
    [out, in] layout, with symmetric per-(expert, out channel) f32 scales:
    w = w_q * s.  Biases stay float.  Inference only.

    w1: [E, d_hidden, d_model] int8,  s1: [E, d_hidden]
    w2: [E, d_model, d_hidden] int8,  s2: [E, d_model]
    """

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor


def dequantize_ffn_params(q: MoEFfnParamsQ, dtype) -> MoEFfnParams:
    """Float expert weights from an int8 pack, rounded to `dtype`
    (dispatch.py:74-82; K7 widens the banks itself, into a scratch that
    lives for one call)."""
    return MoEFfnParams(w1=dequantize_weight(q.w1, q.s1).to(dtype), b1=q.b1,
                        w2=dequantize_weight(q.w2, q.s2).to(dtype), b2=q.b2)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


#: capacity factor that can never drop a token (capacity == token count)
NO_DROP = float("inf")


def parse_capacity_factor(value) -> float:
    """A capacity factor from a config or the command line: a number, or
    "nodrop" / "no_drop" / "inf" for NO_DROP (dispatch.py:115-122)."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ("nodrop", "no_drop", "inf"):
            return NO_DROP
        return float(v)
    return float(value)


def compute_capacity(num_tokens: int, top_k: int, num_experts: int,
                     capacity_factor: float) -> int:
    """Static per-expert capacity, rounded up to 8 (dispatch.py:99-112)."""
    if capacity_factor != capacity_factor or capacity_factor == NO_DROP:
        return max(8, round_up(num_tokens, 8))
    c = int(capacity_factor * num_tokens * top_k / num_experts) + 1
    c = min(c, num_tokens)
    return max(8, round_up(c, 8))


class DispatchPlan(NamedTuple):
    """Index vectors tying routing slots to expert-buffer slots.

    src_flat: [E*C] — routing slot (t*K+k) feeding each expert slot; S when
              the expert slot is empty.
    w_slot:   [E*C] f32 — gate weight of that routing slot (0 when empty).
    dst:      [S] — expert-buffer slot (e*C + rank) of each routing slot;
              E*C when the slot was dropped (over capacity or masked).
    """

    src_flat: torch.Tensor
    w_slot: torch.Tensor
    dst: torch.Tensor


def make_dispatch_plan(flat_e: torch.Tensor, num_experts: int, capacity: int,
                       scores_flat: Optional[torch.Tensor] = None
                       ) -> DispatchPlan:
    """src/dst from the per-slot expert ids with one stable sort
    (dispatch.py:156-212).  Expert ids >= num_experts are dropped."""
    S = flat_e.shape[0]
    E, C = num_experts, capacity
    dev = flat_e.device
    flat_e = flat_e.long()
    if scores_flat is None:
        scores_flat = torch.zeros(S, device=dev)
    sorted_e, order = torch.sort(flat_e, stable=True)
    sorted_w = scores_flat.float()[order]
    starts = torch.searchsorted(sorted_e,
                                torch.arange(E + 1, device=dev), right=False)
    counts = starts[1:] - starts[:-1]

    # expert slot (e, c) <- sorted position starts[e] + c: a contiguous run
    slot = torch.arange(C, device=dev)
    pos = starts[:E, None] + slot[None, :]
    order_pad = torch.cat([order, torch.full((C,), S, device=dev)])
    w_pad = torch.cat([sorted_w, torch.zeros(C, device=dev)])
    valid = slot[None, :] < torch.clamp(counts, max=C)[:, None]
    src_flat = torch.where(valid, order_pad[pos], S).reshape(-1)
    w_slot = torch.where(valid, w_pad[pos], 0.0).reshape(-1)

    rank_sorted = torch.arange(S, device=dev) - starts[torch.clamp(sorted_e,
                                                                   max=E)]
    keep = (rank_sorted < C) & (sorted_e < E)
    dst_sorted = torch.where(keep, sorted_e * C + rank_sorted, E * C)
    dst = torch.empty_like(dst_sorted)
    dst[order] = dst_sorted
    return DispatchPlan(src_flat=src_flat, w_slot=w_slot, dst=dst)


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """x [R, d] with one zero row appended (the target of empty indices)."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])])


class _DispatchGather(torch.autograd.Function):
    """h[slot] = x[src_tok[slot]]; the backward gathers the slot gradients
    back through dst and sums each token's K slots in f32
    (dispatch.py:220-244).  No scatter, so no atomics: deterministic."""

    @staticmethod
    def forward(ctx, x, src_tok, dst):
        ctx.save_for_backward(dst)
        ctx.num_tokens = x.shape[0]
        return _pad_row(x)[src_tok]

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        T = ctx.num_tokens
        gk = _pad_row(g)[dst.reshape(T, -1)]                 # [T, K, d]
        return gk.sum(dim=1, dtype=torch.float32).to(g.dtype), None, None


class _CombineGather(torch.autograd.Function):
    """out[t] = sum_k scores[t, k] * y[dst[t, k]] in f32; the backward is
    two row gathers (dispatch.py:247-297): grad_y[slot] = w_slot[slot] *
    g[src_tok[slot]] at y's dtype, grad_scores[t, k] = sum_d y[dst[t, k]]
    g[t] in f32."""

    @staticmethod
    def forward(ctx, y, scores, dst, src_tok, w_slot):
        T, K = scores.shape
        ctx.save_for_backward(y, dst, src_tok, w_slot)
        ys = _pad_row(y)[dst].reshape(T, K, -1)
        return (scores.float()[..., None] * ys.float()).sum(dim=1)

    @staticmethod
    def backward(ctx, g):
        y, dst, src_tok, w_slot = ctx.saved_tensors
        T = g.shape[0]
        gc = g.to(y.dtype)
        grad_y = w_slot.to(y.dtype)[:, None] * _pad_row(gc)[src_tok]
        ys = _pad_row(y)[dst].reshape(T, -1, y.shape[1])
        grad_scores = (ys.float() * gc.float()[:, None]).sum(-1)
        return grad_y, grad_scores, None, None, None


def dispatch_gather(x: torch.Tensor, src_tok: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """h[slot] = x[src_tok[slot]], 0 for empty slots (src_tok == T)
    (dispatch.py:221-228).  x [T, d] -> [E*C, d]; dst (the plan's inverse
    map) carries the backward."""
    return _DispatchGather.apply(x, src_tok, dst)


def combine_gather(y: torch.Tensor, scores: torch.Tensor, dst: torch.Tensor,
                   src_tok: torch.Tensor, w_slot: torch.Tensor
                   ) -> torch.Tensor:
    """out[t] = sum_k scores[t, k] * y[dst[t, k]] in f32; dropped slots
    (dst == E*C) contribute 0 (dispatch.py:248-267).  Returns f32 [T, d];
    src_tok and w_slot (the plan's forward map) carry the backward."""
    return _CombineGather.apply(y, scores, dst, src_tok, w_slot)


def expert_ffn_dense(h: torch.Tensor,
                     params: Union[MoEFfnParams, MoEFfnParamsQ],
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain reference of the batched per-expert FFN (dispatch.py:300-342);
    an int8 pack is dequantized first (dispatch.py:322)."""
    cd = compute_dtype
    if isinstance(params, MoEFfnParamsQ):
        params = dequantize_ffn_params(params, cd)
    return fused_expert_ffn_plain(h.to(cd), params.w1.to(cd), params.b1,
                                  params.w2.to(cd), params.b2)


def moe_ffn_local(x: torch.Tensor, top_k_indices: torch.Tensor,
                  top_k_gates: torch.Tensor,
                  params: Union[MoEFfnParams, MoEFfnParamsQ], *,
                  capacity: int, use_kernels: bool = True) -> torch.Tensor:
    """Single-shard MoE FFN: gather-dispatch -> per-expert FFN -> combine
    (dispatch.py:367-412).  The FFN runs in x's dtype; with float banks it
    is differentiable in x, top_k_gates and the expert weights, an int8
    pack runs the inference-only quantized FFN."""
    T, d = x.shape
    K = top_k_indices.shape[-1]
    E = params.w1.shape[0]
    scores = top_k_gates.float()
    plan = make_dispatch_plan(top_k_indices.reshape(-1), E, capacity,
                              scores.reshape(-1))
    src_tok = torch.div(plan.src_flat, K, rounding_mode="floor")
    h = dispatch_gather(x, src_tok, plan.dst).reshape(E, capacity, d)
    if isinstance(params, MoEFfnParamsQ):
        y = quantized_expert_ffn(h, params.w1, params.s1, params.b1,
                                 params.w2, params.s2, params.b2,
                                 use_kernels=use_kernels)
    else:
        y = fused_expert_ffn(h, params.w1, params.b1, params.w2, params.b2,
                             use_kernels=use_kernels)
    out = combine_gather(y.reshape(E * capacity, d), scores, plan.dst,
                         src_tok, plan.w_slot)
    return out.to(x.dtype)


def moe_ffn(x: torch.Tensor, top_k_indices: torch.Tensor,
            top_k_gates: torch.Tensor,
            params: Union[MoEFfnParams, MoEFfnParamsQ], *,
            capacity_factor: float = 2.0,
            use_kernels: bool = True) -> torch.Tensor:
    """MoE FFN over [B, N, d] or [T, d] on one device (the single-device
    branch of dispatch.py:moe_ffn, :585-604)."""
    d = x.shape[-1]
    it = top_k_indices.reshape(-1, top_k_indices.shape[-1])
    T, K = it.shape
    cap = compute_capacity(T, K, params.w1.shape[0], capacity_factor)
    out = moe_ffn_local(x.reshape(-1, d), it,
                        top_k_gates.reshape(-1, K), params, capacity=cap,
                        use_kernels=use_kernels)
    return out.reshape(x.shape)
