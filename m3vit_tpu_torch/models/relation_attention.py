"""Task-conditioned attention with relation-conditioned expert projections
(counterpart of m3vit_tpu/models/relation_attention.py:40-172; reference
models/moe/token/relation_conditioned_attention.py).

Branch 0 is the neutral (shared) branch, branch t+1 task t.  For a
relation (a -> b) a per-head router over the two branches' embeddings
mixes ``attn_expert_top_k`` of ``attn_num_experts`` expert projections
into the Q, K and V weights of that relation.  A task's private queries
attend to its private keys (t -> t) and to its neutral keys (t -> 0); the
neutral queries attend, once, to the neutral keys (0 -> 0) and to every
participating task's private keys (0 -> t).  Every product is a plain f32
einsum, as in the JAX package (no kernel of its own); masked scores are
-1e30, and a softmax row that is masked whole is zeroed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from m3vit_tpu_torch.models.vit import fill_normal, fill_uniform, linear


class TaskConditionedAttention(nn.Module):
    def __init__(self, num_tasks: int, dim: int, num_heads: int,
                 attn_num_experts: int = 4, attn_expert_top_k: int = 2,
                 branch_embed_dim: int = 32, dtype=torch.float32):
        super().__init__()
        H, E = num_heads, attn_num_experts
        dk = dim // num_heads
        self.num_tasks, self.num_heads, self.dtype = num_tasks, H, dtype
        self.top_k = min(attn_expert_top_k, E)
        self.scale = dk ** -0.5
        self.branch_embed = nn.Parameter(torch.zeros(num_tasks + 1,
                                                     branch_embed_dim))
        self.router_w = nn.Parameter(torch.zeros(3, H, 2 * branch_embed_dim,
                                                 E))
        self.router_b = nn.Parameter(torch.zeros(3, H, E))
        self.expert_pools = nn.Parameter(torch.zeros(3, H, E, dim, dk))
        self.q_bias = nn.Parameter(torch.zeros(H, dk))
        self.k_bias = nn.Parameter(torch.zeros(H, dk))
        self.v_bias = nn.Parameter(torch.zeros(H, dk))
        self.proj = nn.Linear(dim, dim)

    def init_weights(self, gen: torch.Generator) -> None:
        """relation_attention.py:66-85: embeddings N(0, 0.02), routers
        U(+-1/sqrt(E)), each pool matrix xavier-uniform, biases 0."""
        fill_normal(self.branch_embed, 0.02, gen)
        fill_uniform(self.router_w, self.router_w.shape[-1] ** -0.5, gen)
        d, dk = self.expert_pools.shape[-2:]
        fill_uniform(self.expert_pools, (6.0 / (d + dk)) ** 0.5, gen)
        fill_normal(self.proj.weight, 0.02, gen)
        for b in (self.router_b, self.q_bias, self.k_bias, self.v_bias,
                  self.proj.bias):
            nn.init.zeros_(b)

    def effective_w(self, a: int, b: int) -> Tuple[torch.Tensor, ...]:
        """(W_Q, W_K, W_V) of relation a -> b, each [H, D, dk]: the top-k
        experts' softmax weights, renormalised, ties kept
        (relation_attention.py:87-100)."""
        f = torch.cat([self.branch_embed[a], self.branch_embed[b]])
        logits = torch.einsum("c,phce->phe", f, self.router_w) \
            + self.router_b
        dense = torch.softmax(logits, dim=-1)
        if self.top_k < dense.shape[-1]:
            topv = torch.topk(dense, self.top_k, dim=-1).values[..., -1:]
            sparse = torch.where(dense >= topv, dense, 0.0)
            dense = sparse / (sparse.sum(-1, keepdim=True) + 1e-9)
        w = torch.einsum("phe,phedk->phdk", dense, self.expert_pools)
        return w[0], w[1], w[2]

    @staticmethod
    def _project(x, w, bias):
        """x [..., D] by w [H, D, dk] -> [..., H, dk], in f32."""
        return torch.einsum("...d,hdk->...hk", x.float(), w) + bias

    def forward(self, outs: torch.Tensor,
                prev_share_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """outs [T, B, N, D] normed task streams, prev_share_mask [T, B, N]
        bool (the previous block's sharing; None: nothing shared) ->
        [T, B, N, D] f32 (relation_attention.py:49-172)."""
        T, B, N, D = outs.shape
        H = self.num_heads
        proj = self._project
        if prev_share_mask is None:
            prev_share_mask = torch.zeros((T, B, N), dtype=torch.bool,
                                          device=outs.device)
        neutral_global = prev_share_mask.any(dim=0)            # [B, N]
        neg = torch.tensor(-1e30, device=outs.device)
        out = []
        for t in range(T):                 # task branches: t -> t, t -> 0
            wq_tt, wk_tt, wv_tt = self.effective_w(t + 1, t + 1)
            wq_t0, wk_t0, wv_t0 = self.effective_w(t + 1, 0)
            x = outs[t]
            t_neutral = prev_share_mask[t]
            t_private = ~t_neutral
            q_tt = proj(x, wq_tt, self.q_bias).transpose(1, 2)
            q_t0 = proj(x, wq_t0, self.q_bias).transpose(1, 2)
            k_tt = proj(x, wk_tt, self.k_bias).transpose(1, 2)
            k_t0 = proj(x, wk_t0, self.k_bias).transpose(1, 2)
            s_pp = torch.einsum("bhnd,bhmd->bhnm", q_tt, k_tt) * self.scale
            s_pn = torch.einsum("bhnd,bhmd->bhnm", q_t0, k_t0) * self.scale
            attn = torch.where(t_private[:, None, None, :], s_pp, s_pn)
            valid = (t_private | t_neutral)[:, None, None, :]
            attn = torch.softmax(torch.where(valid, attn, neg), dim=-1)
            v = torch.where(t_private[..., None, None],
                            proj(x, wv_tt, self.v_bias),
                            proj(x, wv_t0, self.v_bias)).transpose(1, 2)
            o = torch.einsum("bhnm,bhmd->bhnd", attn, v)
            out.append(o.transpose(1, 2).reshape(B, N, D)
                       * t_private[..., None])
        out = torch.stack(out)

        # the neutral branch, once: 0 -> 0 and 0 -> t
        neutral_x = outs[0]
        wq_00, wk_00, wv_00 = self.effective_w(0, 0)
        q00 = proj(neutral_x, wq_00, self.q_bias).transpose(1, 2)
        k00 = proj(neutral_x, wk_00, self.k_bias).transpose(1, 2)
        scores = [torch.einsum("bhnd,bhmd->bhnm", q00, k00) * self.scale]
        vs = [proj(neutral_x, wv_00, self.v_bias)]
        masks = [neutral_global[:, None, None, :].expand(B, 1, N, N)]
        for t in range(T):
            wq_0t, wk_0t, wv_0t = self.effective_w(0, t + 1)
            q0t = proj(neutral_x, wq_0t, self.q_bias).transpose(1, 2)
            kt = proj(outs[t], wk_0t, self.k_bias).transpose(1, 2)
            vs.append(proj(outs[t], wv_0t, self.v_bias))
            scores.append(torch.einsum("bhnd,bhmd->bhnm", q0t, kt)
                          * self.scale)
            participates = prev_share_mask[t][:, :, None]        # [B, N, 1]
            key_private = (~prev_share_mask[t])[:, None, :]      # [B, 1, N]
            masks.append((participates & key_private)[:, None])
        attn = torch.where(torch.cat(masks, dim=-1), torch.cat(scores, -1),
                           neg)
        attn = torch.where(neutral_global[:, None, :, None], attn, neg)
        attn = torch.nan_to_num(torch.softmax(attn, dim=-1), nan=0.0)
        v_all = torch.cat(vs, dim=1).transpose(1, 2)
        o = torch.einsum("bhnm,bhmd->bhnd", attn, v_all)
        neutral_out = o.transpose(1, 2).reshape(B, N, D) \
            * neutral_global[..., None]
        out = out + neutral_out[None] * prev_share_mask[..., None]
        return linear(self.proj, out, self.dtype).float()
