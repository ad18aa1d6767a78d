"""The token persistent-sharing MoE ViT (counterpart of
m3vit_tpu/models/token_moe.py; reference models/moe/token/*).

Every task has a token stream of its own, [T, B, N, C], and all streams
advance block by block.  In each block, after the attention (one pass over
the T*B streams, or the task-conditioned attention), a shareability head
scores each token of each stream (Gumbel-softmax in training, an argmax
one-hot in eval); positions where at least two tasks score >= gamma
become shared, and the participating tasks' tokens are overwritten by
their score-weighted mix, the representative (Merge-Maintain-Split).  The
FFN sublayer then runs the task-specific tokens through the block's MLP
(dense blocks: all streams at once, K3/K4 at E=1) or the tasks' MoE
pathways (MoE blocks: shared tokens take expert id E and never take a
capacity slot; one K3/K4 launch a task, or one for all tasks with
``batched_dispatch``), and the representative through the dense MLP
(dense blocks, its own K3 launch) or the shared FFN (MoE blocks: plain
products, bf16 with f32 accumulation, as the JAX package's einsums).

Noise: the Gumbel uniforms and the gate noise are drawn from the
``torch.Generator`` handed to forward, per task in the JAX package's order
(the shareability heads', then the gates'), by ``gumbel_uniform`` and
``gate_normal``, which a test may replace to feed the JAX package's draws.
Parameters are named as the reference token model's
(``blocks.{i}.share_pred.w_gate``, ``blocks.{i}.gate.{t}.w_gate``,
``blocks.{i}.mlp.experts.htoh4.weight``, ``blocks.{i}.shared_ffn.fc1.
weight``, ``gate_task_represent.fc1.weight``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from m3vit_tpu_torch import parallel
from m3vit_tpu_torch.models.heads import resize_bilinear
from m3vit_tpu_torch.models.multitask import _prediction
from m3vit_tpu_torch.models.relation_attention import TaskConditionedAttention
from m3vit_tpu_torch.models.vit import (
    Attention,
    DenseParams,
    MlpBlock,
    PatchEmbed,
    embed_tokens,
    fill_normal,
    fill_uniform,
    layer_norm,
    run_block,
)
from m3vit_tpu_torch.models.vit_moe import Experts, NoisyGate, \
    TaskRepresentMlp
from m3vit_tpu_torch.moe.dispatch import compute_capacity, moe_ffn, \
    moe_ffn_streams
from m3vit_tpu_torch.moe.gating import moe_aux_loss, noisy_vmoe_gate


def gumbel_uniform(shape, gen: torch.Generator, device) -> torch.Tensor:
    """U[1e-10, 1) draws for the Gumbel noise of a shareability head
    (token_moe.py:80-82)."""
    u = torch.rand(shape, generator=gen, device=device)
    return u * (1.0 - 1e-10) + 1e-10


def gate_normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard normal gate noise of one task's router (token_moe.py:355;
    gating.py:112)."""
    return torch.randn(shape, generator=gen, device=device)


class ShareabilityPredictor(nn.Module):
    """Shared/private score per token, w_gate [C + d_task, 2]
    (token_moe.py:52-92; reference shareability.py:14-85)."""

    def __init__(self, dim: int, d_task_emb: int = 0):
        super().__init__()
        self.d_task_emb = max(int(d_task_emb), 0)
        self.w_gate = nn.Parameter(torch.zeros(dim + self.d_task_emb, 2))

    def init_weights(self, gen: torch.Generator) -> None:
        fill_uniform(self.w_gate, 2 ** -0.5, gen)   # gate_init at E = 2

    def forward(self, x: torch.Tensor, task_emb: Optional[torch.Tensor],
                uniforms: Optional[torch.Tensor] = None,
                temperature: Optional[float] = None) -> torch.Tensor:
        """x [B, N, C] -> the shared score [B, N] f32: with `uniforms`
        ([B*N, 2], training) softmax((logits + Gumbel) / temperature)[1]
        (temperature 1.0 when None), else the argmax one-hot's (first
        maximum on ties)."""
        B, N, C = x.shape
        inp = x.reshape(-1, C).float()
        if self.d_task_emb > 0:
            inp = torch.cat([inp, task_emb.float().expand(B * N, -1)], -1)
        logits = inp @ self.w_gate
        if uniforms is not None:
            g = -torch.log(-torch.log(uniforms.float()))
            tau = 1.0 if temperature is None else temperature
            y = torch.softmax((logits + g) / tau, dim=-1)
        else:
            y = F.one_hot(logits.argmax(-1), 2).float()
        return y[:, 1].reshape(B, N)


def transition_stage(outs: torch.Tensor, g_shared: torch.Tensor,
                     gamma: float, eps: float = 1e-6):
    """Merge-Maintain-Split (token_moe.py:95-117): outs [T, B, N, C],
    scores [T, B, N] -> (share_mask [T, B, N] bool, valid [B, N] bool, the
    representative [B, N, C] f32, stats).  A position is shared where at
    least two tasks score >= gamma; the representative is their
    score-weighted mean."""
    m = g_shared >= gamma
    valid = m.sum(dim=0) >= 2
    m = m & valid[None]
    gm = g_shared * m.to(g_shared.dtype)
    w = gm / (gm.sum(dim=0, keepdim=True) + eps)
    shared_x = torch.einsum("tbn,tbnc->bnc", w, outs.float())
    stats = {"shared_positions": valid.sum().float(),
             "shared_tasktoken_count": m.sum().float()}
    return m, valid, shared_x, stats


def apply_shared_broadcast(outs: torch.Tensor, share_mask: torch.Tensor,
                           shared_x: torch.Tensor) -> torch.Tensor:
    """outs[t, b, n] <- shared_x[b, n] where task t takes part
    (token_moe.py:120-124)."""
    return torch.where(share_mask[..., None],
                       shared_x[None].to(outs.dtype), outs)


def sharing_regularization_loss(share_mask: torch.Tensor,
                                lam: float) -> torch.Tensor:
    """lam * max(0, S^2 - sum_t S_t^2), S the shared positions, S_t task
    t's shared tokens (token_moe.py:127-135; reference
    sharing_loss.py:27-56)."""
    if lam <= 0:
        return torch.zeros((), device=share_mask.device)
    s = share_mask.any(dim=0).sum().float()
    s_t = share_mask.sum(dim=(1, 2)).float()
    return lam * torch.clamp(s * s - (s_t ** 2).sum(), min=0.0)


class SharedFfn(nn.Module):
    """The MoE blocks' shared FFN on the representative, fc1 [4C, C] and
    fc2 [C, 4C] (the dense MLP ratio; token_moe.py:438-463)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = DenseParams(dim, hidden)
        self.fc2 = DenseParams(hidden, dim)

    def init_weights(self, gen: torch.Generator) -> None:
        for lin in (self.fc1, self.fc2):
            fill_normal(lin.weight, 0.02, gen)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """x [..., C] -> f32: the products on dtype-rounded operands with
        f32 accumulation, bias and exact GELU in f32, the hidden rounded to
        dtype (token_moe.py:453-462)."""
        a = F.linear(x.to(dtype).float(), self.fc1.weight.to(dtype).float(),
                     self.fc1.bias)
        a = F.gelu(a).to(dtype).float()
        return F.linear(a, self.fc2.weight.to(dtype).float(), self.fc2.bias)


class TokenExperts(nn.Module):
    """Holds the MoE block's expert banks as ``mlp.experts``, the
    reference's names."""

    def __init__(self, num_experts: int, dim: int, hidden: int):
        super().__init__()
        self.experts = Experts(num_experts, dim, hidden)


class TokenBlock(nn.Module):
    """One persistent-sharing block over the stacked task streams
    (token_moe.py:138-468)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, moe: bool = False,
                 moe_hidden_dim: int = 384, moe_experts: int = 16,
                 moe_top_k: int = 4, vmoe_noisy_std: float = 1.0,
                 multi_gate: bool = False, num_tasks: int = 2,
                 gate_task_specific_dim: int = 64,
                 capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 4.0,
                 batched_dispatch: bool = False, dtype=torch.float32,
                 use_task_conditioned_attn: bool = False,
                 attn_num_experts: int = 4, attn_expert_top_k: int = 2,
                 branch_embed_dim: int = 32):
        super().__init__()
        self.dtype = dtype
        self.moe = moe
        self.num_tasks = num_tasks
        self.multi_gate = multi_gate
        self.num_experts, self.top_k = moe_experts, moe_top_k
        self.vmoe_noisy_std = vmoe_noisy_std
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.batched_dispatch = batched_dispatch
        self.d_task = max(int(gate_task_specific_dim), 0)
        self.use_kernels = True
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        if use_task_conditioned_attn:
            self.attn = TaskConditionedAttention(
                num_tasks, dim, num_heads, attn_num_experts,
                attn_expert_top_k, branch_embed_dim, dtype)
        else:
            self.attn = Attention(dim, num_heads, qkv_bias, dtype=dtype)
        self.share_pred = ShareabilityPredictor(dim, self.d_task)
        hidden = int(dim * mlp_ratio)
        if not moe:
            self.mlp = MlpBlock(dim, hidden)
            return
        # per-task routers see the raw tokens; the one shared router also
        # the task embedding (token_moe.py:250-266)
        d_gate = dim if multi_gate else dim + self.d_task
        self.gate = nn.ModuleList(
            NoisyGate(d_gate, moe_experts) for _ in range(num_tasks)) \
            if multi_gate else NoisyGate(d_gate, moe_experts)
        self.mlp = TokenExperts(moe_experts, dim, moe_hidden_dim)
        self.shared_ffn = SharedFfn(dim, hidden)

    def _draw(self, fn, shape, noise, device):
        if noise is None:
            raise ValueError("training the token variant needs noise: pass "
                             "a torch.Generator as `noise`")
        return fn(shape, noise, device)

    def forward(self, outs: torch.Tensor, task_emb: Optional[torch.Tensor],
                share_gamma: float, noise: Optional[torch.Generator] = None,
                prev_share_mask: Optional[torch.Tensor] = None,
                reuse_bits: Optional[torch.Tensor] = None,
                share_temp: Optional[float] = None):
        """outs [T, B, N, C]; task_emb [T, d_task] or None; reuse_bits
        [B, N] int task bitmask of the MoE blocks' reuse cache.  Returns
        (outs, share_mask [T, B, N], valid [B, N], cv loss, stats)."""
        T, B, N, C = outs.shape
        dev = outs.device
        train = self.training
        if isinstance(self.attn, TaskConditionedAttention):
            normed = layer_norm(self.norm1, outs.reshape(T * B, N, C))
            outs = outs + self.attn(normed.reshape(T, B, N, C),
                                    prev_share_mask)
        else:
            h = layer_norm(self.norm1, outs.reshape(T * B, N, C))
            outs = outs + self.attn(h.to(self.dtype)).reshape(T, B, N, C)

        # shareability per task, then merge-maintain-split
        g = []
        for t in range(T):
            u = self._draw(gumbel_uniform, (B * N, 2), noise, dev) \
                if train else None
            g.append(self.share_pred(
                outs[t], None if task_emb is None else task_emb[t], u,
                share_temp))
        share_mask, valid, shared_x, stats = transition_stage(
            outs, torch.stack(g), share_gamma)
        outs = apply_shared_broadcast(outs, share_mask, shared_x)
        ts_mask = ~share_mask
        cv_total = torch.zeros((), device=dev)

        if not self.moe:
            normed = layer_norm(self.norm2, outs.reshape(T * B, N, C))
            delta = self.mlp(normed.to(self.dtype)).reshape(T, B, N, C)
            outs = outs + delta * ts_mask[..., None].to(delta.dtype)
            # the shared FFN once, on the representative, through the
            # same MLP
            sh = shared_x + self.mlp(layer_norm(self.norm2, shared_x).to(
                self.dtype)).float()
            outs = apply_shared_broadcast(outs, share_mask, sh)
            return outs, share_mask, valid, cv_total, stats

        E, K = self.num_experts, self.top_k
        cf = self.capacity_factor if train else self.eval_capacity_factor
        params = self.mlp.experts.ffn_params()
        normed_all = layer_norm(self.norm2, outs.reshape(T * B, N, C)
                                ).reshape(T, B, N, C)
        # exact dropped-slot accounting against the capacity; ids == E
        # (shared or reused tokens) never count (token_moe.py:279-293)
        drop_cap = compute_capacity(B * N, K, E, cf)
        drop_overflow = torch.zeros((), device=dev)
        computed = torch.zeros((), device=dev)
        reused = torch.zeros((), device=dev)
        # the reuse cache: the first task whose bit is set computes a
        # token's expert output, later ones read it (token_moe.py:302-318)
        reuse = None if reuse_bits is None else reuse_bits.reshape(-1).long()
        if reuse is not None:
            if reuse.shape[0] != B * N:
                raise ValueError(f"reuse_bits must be [B, N] = {(B, N)}, "
                                 f"got {tuple(reuse_bits.shape)}")
            cache = torch.zeros((B * N, C), device=dev)
            cache_valid = torch.zeros(B * N, dtype=torch.bool, device=dev)
        batched = self.batched_dispatch and reuse is None
        idx_all, gates_all, upd = [], [], []
        gate_inp = normed_all.reshape(T, B * N, C).float()
        if not self.multi_gate:
            gate_inp = torch.cat([gate_inp, task_emb.float()[:, None].expand(
                T, B * N, -1)], dim=-1)
        w_gates = [(self.gate[t] if self.multi_gate else self.gate).w_gate
                   for t in range(T)]
        # batched: the tasks' gate logits in one product, the noise still
        # drawn a task at a time (token_moe.py:327-340)
        clean_all = torch.bmm(gate_inp, torch.stack(w_gates).float()) \
            if batched else None
        for t in range(T):
            gn = self._draw(gate_normal, (B * N, E), noise, dev) \
                if train else None
            gate = noisy_vmoe_gate(
                None if batched else gate_inp[t], w_gates[t], top_k=K,
                noise_std=self.vmoe_noisy_std, noise=gn,
                clean_logits=None if clean_all is None else clean_all[t])
            tsm = ts_mask[t].reshape(-1)
            if reuse is not None:
                in_reuse = ((reuse >> t) & 1).bool()
                can_reuse = in_reuse & tsm & cache_valid
                compute = tsm & ~can_reuse
            else:
                can_reuse = torch.zeros_like(tsm)
                compute = tsm
            idx = torch.where(compute[:, None], gate.top_k_indices, E)
            hist = torch.zeros(E + 1, device=dev).scatter_add_(
                0, idx.reshape(-1), torch.ones(idx.numel(), device=dev))[:E]
            drop_overflow = drop_overflow + torch.clamp(hist - drop_cap,
                                                        min=0.0).sum()
            if batched:
                idx_all.append(idx)
                gates_all.append(gate.top_k_gates)
            else:
                delta = moe_ffn(normed_all[t].to(self.dtype),
                                idx.reshape(B, N, K),
                                gate.top_k_gates.reshape(B, N, K), params,
                                capacity_factor=cf,
                                use_kernels=self.use_kernels)
                dflat = delta.reshape(B * N, C).float()
                if reuse is not None:
                    dflat = torch.where(can_reuse[:, None], cache, dflat)
                    fill = in_reuse & tsm & ~cache_valid
                    cache = torch.where(fill[:, None], dflat, cache)
                    cache_valid = cache_valid | fill
                upd.append((dflat.reshape(B, N, C) * ts_mask[t][..., None]
                            ).to(outs.dtype))
            computed = computed + compute.sum()
            reused = reused + can_reuse.sum()
            # the balance loss over the computed tokens only
            # (token_moe.py:407-418)
            cmf = compute.float()
            cv_total = cv_total + moe_aux_loss(
                gate._replace(top_k_gates=gate.top_k_gates * cmf[:, None]),
                K, E, train, row_mask=cmf)
        if batched:
            delta = moe_ffn_streams(
                normed_all.reshape(T, B * N, C).to(self.dtype),
                torch.stack(idx_all), torch.stack(gates_all), params,
                capacity_factor=cf, use_kernels=self.use_kernels)
            outs = outs + (delta.reshape(T, B, N, C).float()
                           * ts_mask[..., None]).to(outs.dtype)
        else:
            outs = outs + torch.stack(upd)
        stats["computed_tokens"] = computed.float()
        stats["reused_tokens"] = reused.float()
        stats["dropped_slot_fraction"] = drop_overflow / torch.clamp(
            computed.float() * K, min=1.0)
        stats["moe_stat_count"] = torch.ones((), device=dev)
        sh = shared_x + self.shared_ffn(layer_norm(self.norm2, shared_x),
                                        self.dtype)
        outs = apply_shared_broadcast(outs, share_mask, sh)
        return outs, share_mask, valid, cv_total, stats


class TokenVisionTransformerMoE(nn.Module):
    """Per-task token streams with persistent sharing
    (token_moe.py:471-588): patch embed, cls token and position embedding
    once, the streams broadcast from them, `depth` TokenBlocks (even
    dense, odd MoE), the bootstrap gamma at the first MoE block, each
    block rematerialised in training with use_checkpointing.  Returns
    ({task index: tokens [B, 1+N, C]}, cv loss plus, in training, the
    sharing loss of every block, stats summed over blocks)."""

    def __init__(self, img_size=(512, 512), patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 moe_mlp_ratio: float = -1.0, moe_experts: int = 16,
                 moe_top_k: int = 4, vmoe_noisy_std: float = 1.0,
                 multi_gate: bool = False, num_tasks: int = 2,
                 gate_task_specific_dim: int = 64, share_gamma: float = 0.5,
                 bootstrap_share_gamma: float = 0.3,
                 bootstrap_first_moe: bool = True,
                 share_reg_lambda: float = 0.01,
                 use_task_conditioned_attn: bool = False,
                 attn_num_experts: int = 4, attn_expert_top_k: int = 2,
                 branch_embed_dim: int = 32, capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 4.0,
                 batched_dispatch: bool = False, dtype=torch.float32,
                 use_checkpointing: bool = False):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = 0.0
        self.num_tasks = num_tasks
        self.share_gamma = share_gamma
        self.bootstrap_share_gamma = bootstrap_share_gamma
        self.bootstrap_first_moe = bootstrap_first_moe
        self.share_reg_lambda = share_reg_lambda
        self.use_checkpointing = use_checkpointing
        num_patches = (img_size[0] // patch_size) * (img_size[1] // patch_size)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1,
                                                  embed_dim))
        d_task = max(int(gate_task_specific_dim), 0)
        self.gate_task_represent = TaskRepresentMlp(
            num_tasks, d_task, d_task) if d_task > 0 else None
        moe_hidden = int(embed_dim * (moe_mlp_ratio if moe_mlp_ratio > 0
                                      else mlp_ratio))
        self.blocks = nn.ModuleList(
            TokenBlock(embed_dim, num_heads, mlp_ratio, qkv_bias,
                       moe=i % 2 == 1, moe_hidden_dim=moe_hidden,
                       moe_experts=moe_experts, moe_top_k=moe_top_k,
                       vmoe_noisy_std=vmoe_noisy_std, multi_gate=multi_gate,
                       num_tasks=num_tasks, gate_task_specific_dim=d_task,
                       capacity_factor=capacity_factor,
                       eval_capacity_factor=eval_capacity_factor,
                       batched_dispatch=batched_dispatch, dtype=dtype,
                       use_task_conditioned_attn=use_task_conditioned_attn,
                       attn_num_experts=attn_num_experts,
                       attn_expert_top_k=attn_expert_top_k,
                       branch_embed_dim=branch_embed_dim)
            for i in range(depth))

    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.zeros_(self.cls_token)
        fill_normal(self.pos_embed, 0.02, gen)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Generator] = None,
                share_temp: Optional[float] = None,
                reuse_bits: Optional[torch.Tensor] = None):
        """x [B, 3, H, W]; noise: the generator of the Gumbel and gate
        noise in training; share_temp: the Gumbel temperature of this
        epoch (None: 1.0); reuse_bits [B, 1+N] int (the MoE blocks' reuse
        cache)."""
        if parallel.active() is not None:
            raise NotImplementedError(
                "the token variant under torch.distributed is not ported to "
                "m3vit_tpu_torch (ROADMAP.md queue 1 item 7b)")
        tokens = embed_tokens(self, x)
        T = self.num_tasks
        task_emb = None if self.gate_task_represent is None else \
            self.gate_task_represent(list(range(T)))
        outs = tokens[None].expand((T,) + tokens.shape)
        total = torch.zeros((), device=x.device)
        stats: Dict[str, torch.Tensor] = {}
        prev = None
        first_moe = 1 if len(self.blocks) > 1 else None
        for i, blk in enumerate(self.blocks):
            gamma = self.bootstrap_share_gamma if (
                self.bootstrap_first_moe and i == first_moe) \
                else self.share_gamma
            outs, prev, _, cv, st = run_block(
                self, blk, noise, outs, task_emb, gamma, noise, prev,
                reuse_bits, share_temp)
            total = total + cv
            if self.training and self.share_reg_lambda > 0:
                total = total + sharing_regularization_loss(
                    prev, self.share_reg_lambda)
            for k, v in st.items():
                stats[k] = stats[k] + v if k in stats else v
        return {t: outs[t] for t in range(T)}, total, stats


class TokenMultiTaskModel(nn.Module):
    """The token backbone's streams decoded by per-task heads
    (token_moe.py:591-614): every forward runs all the streams; with
    single_task only that task's head decodes.  Same calls and returns as
    MultiTaskModel, plus share_temp and reuse_bits for the backbone."""

    def __init__(self, backbone: TokenVisionTransformerMoE,
                 decoders: Dict[str, nn.Module], tasks: List[str]):
        super().__init__()
        self.backbone = backbone
        self.decoders = nn.ModuleDict(decoders)
        self.tasks = list(tasks)

    def forward(self, x: torch.Tensor, single_task: Optional[str] = None,
                noise: Optional[torch.Generator] = None,
                share_temp: Optional[float] = None,
                reuse_bits: Optional[torch.Tensor] = None
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Dict]:
        out_size = tuple(x.shape[-2:])
        streams, aux, stats = self.backbone(x, noise, share_temp, reuse_bits)
        names = [single_task] if single_task is not None else self.tasks
        out = {task: resize_bilinear(_prediction(self.decoders[task](
            streams[self.tasks.index(task)])), out_size) for task in names}
        return out, aux, stats
