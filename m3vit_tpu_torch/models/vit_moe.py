"""MoE Vision Transformer backbone, eval and train (counterpart of
m3vit_tpu/models/vit_moe.py: MoEMlp :169-464, MoEBlock :467-636,
VisionTransformerMoE :734-1105).

Even blocks are dense, odd blocks MoE; with multi_gate each task has its
own router (``mlp.gate.{task}.w_gate``) and a forward runs one task's
routing.  The gate reads the bf16-rounded post-norm2 tokens cast to f32
(vit_moe.py:230, :572), so routing matches the JAX package's.  The module's
training flag selects the train path: the capacity factor for training,
gate noise (drawn from the ``torch.Generator`` handed to forward) and the
per-block cv balance loss.  ``shared_prefix`` runs block 0 and block 1's
attention once for all tasks and the rest once per task
(vit_moe.py:1057-1101).

``expert_weights_int8`` (vit_moe.py:201-203, :360-372) keeps the expert
banks as int8 buffers with f32 per-out-channel scales
(``serve/quantize.py`` makes them from a float model) and runs them through
the quantized FFN; such a model serves only and raises in ``train()``
mode.  ``ln_mlp`` is the JAX package's ``use_pallas_ln_mlp``: the dense
blocks' LayerNorm + MLP + residual run as one fused sublayer
(``ops/ln_mlp.py``) on the same parameters.

With ``gate_task_specific_dim`` > 0 and one shared router (not
multi_gate) the router is task-conditioned (vit_moe.py:152-166, :232-240,
:882-892): ``gate_task_represent`` (``TaskRepresentMlp``) maps the task's
one-hot to a feature that is concatenated to every token's gate input, so
a forward still takes the task id whose pathway it runs.

Under data and expert parallelism (``parallel.shard_experts`` sets an MoE
block's ``layout``) a block holds its rank's expert shard and exchanges
tokens over the expert group; its gate noise is the rank's rows of the
global batch's noise, and its balance loss and statistics are those of
the global batch (the importance and load summed over the world before
cv^2; the statistics summed over the world by the step).

With ``M3VIT_LOG_GATE_INTERNALS`` set (1 / true / yes / on) the gates'
analysis statistics also carry the full-softmax entropy of the noisy
logits, its maximum and the number of distinct groups of 4 experts the
top-k hits (vit_moe.py:599-640).
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from m3vit_tpu_torch import parallel
from m3vit_tpu_torch.models.vit import (
    Attention,
    DenseBlock,
    DenseParams,
    PatchEmbed,
    drop_path_rates,
    embed_tokens,
    fill_normal,
    fill_uniform,
    layer_norm,
    reject_left_out,
    run_block,
)
from m3vit_tpu_torch.ops.dropout import dropout, drop_path
from m3vit_tpu_torch.moe.dispatch import (
    MoEFfnParams,
    MoEFfnParamsQ,
    compute_capacity,
    moe_ffn,
)
from m3vit_tpu_torch.moe.gating import (
    GateOutput,
    gate_load_counts,
    moe_aux_loss,
    moe_aux_loss_noisy,
    noisy_gate,
    noisy_gate_init,
    noisy_vmoe_gate,
)

#: the gates of vit_moe.py:MoEMlp (gate_type / moe_gate_type)
GATE_TYPES = ("noisy_vmoe", "noisy")

#: the environment variable that adds the gate internals to the analysis
#: statistics (vit_moe.py:599-640; reference noisy_gate_vmoe.py:209-244)
GATE_INTERNALS_ENV = "M3VIT_LOG_GATE_INTERNALS"


def gate_internals_on() -> bool:
    return str(os.environ.get(GATE_INTERNALS_ENV, "0")).lower() in (
        "1", "true", "yes", "on")


def add_stats(acc: Dict[str, torch.Tensor], st: Dict[str, torch.Tensor]):
    """Per-key sum of two MoE stats dicts ({} is the empty sum)."""
    return st if not acc else {k: acc[k] + st[k] for k in st}


@contextlib.contextmanager
def collect_gate_stats(model: nn.Module):
    """Within the block, every MoE block of `model` also returns its gates'
    analysis statistics (MoEMlp.forward); restored on exit."""
    mlps = [m for m in model.modules() if isinstance(m, MoEMlp)]
    before = [m.gate_stats for m in mlps]
    for m in mlps:
        m.gate_stats = True
    try:
        yield
    finally:
        for m, flag in zip(mlps, before):
            m.gate_stats = flag


class TaskRepresentMlp(nn.Module):
    """Task one-hot -> gate feature: fc1 -> exact GELU -> fc2 -> LayerNorm
    (eps 1e-6), all in f32 (vit_moe.py:152-166; reference new_Mlp,
    vision_transformer_moe.py:263-281)."""

    def __init__(self, num_tasks: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.num_tasks = num_tasks
        self.fc1 = nn.Linear(num_tasks, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)
        self.norm = nn.LayerNorm(out_dim, eps=1e-6)

    def init_weights(self, gen: torch.Generator) -> None:
        for lin in (self.fc1, self.fc2):
            fill_normal(lin.weight, 0.02, gen)
            nn.init.zeros_(lin.bias)

    def forward(self, task_ids) -> torch.Tensor:
        """Features [len(task_ids), out_dim] of the tasks `task_ids` (ids
        clipped into range, as jnp.clip does), or [out_dim] of one id."""
        ids = torch.as_tensor(task_ids, device=self.fc1.weight.device)
        one_hot = torch.nn.functional.one_hot(
            ids.clamp(0, self.num_tasks - 1), self.num_tasks).float()
        h = torch.nn.functional.gelu(self.fc1(one_hot))
        return layer_norm(self.norm, self.fc2(h))


class NoisyGate(nn.Module):
    """One router: w_gate [d, E] f32 (reference noisy_gate_vmoe.py), and
    with learned_noise the noise weights w_noise [d, E] of the
    learned-noise gate (reference gates.py:68-90)."""

    def __init__(self, dim: int, num_experts: int,
                 learned_noise: bool = False):
        super().__init__()
        self.w_gate = nn.Parameter(torch.zeros(dim, num_experts))
        self.w_noise = nn.Parameter(torch.zeros(dim, num_experts)) \
            if learned_noise else None

    def init_weights(self, gen: torch.Generator) -> None:
        if self.w_noise is None:
            # kaiming_uniform(a=sqrt(5)) on [d, E]: bound 1/sqrt(E)
            fill_uniform(self.w_gate, self.w_gate.shape[1] ** -0.5, gen)
            return
        with torch.no_grad():
            for p, w in zip((self.w_gate, self.w_noise),
                            noisy_gate_init(*self.w_gate.shape, gen)):
                p.copy_(w)


class QuantDenseParams(nn.Module):
    """An int8 expert bank: buffers ``weight_q`` [E, out, in] int8 and
    ``weight_scale`` [E, out] f32 (one scale per out channel), and the f32
    parameter ``bias`` [E, out] (vit_moe.py:360-372; zeros and ones until a
    quantized state dict is loaded)."""

    def __init__(self, in_features: int, out_features: int, experts: int):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(
            (experts, out_features, in_features), dtype=torch.int8))
        self.register_buffer("weight_scale",
                             torch.ones((experts, out_features)))
        self.bias = nn.Parameter(torch.zeros((experts, out_features)))


class Experts(nn.Module):
    """Expert banks in the reference FMoELinear names and [E, out, in]
    layout: htoh4 [E, hidden, d], h4toh [E, d, hidden]; all f32, or with
    int8=True int8 banks with f32 scales and biases."""

    def __init__(self, num_experts: int, dim: int, hidden: int,
                 int8: bool = False):
        super().__init__()
        self.int8 = int8
        bank = QuantDenseParams if int8 else DenseParams
        self.htoh4 = bank(dim, hidden, experts=num_experts)
        self.h4toh = bank(hidden, dim, experts=num_experts)

    def init_weights(self, gen: torch.Generator) -> None:
        for lin in (self.htoh4, self.h4toh):
            if not self.int8:
                # FMoELinear kaiming_uniform(a=sqrt(5)) on the 3-D bank
                fill_uniform(lin.weight, (lin.weight.shape[1]
                                          * lin.weight.shape[2]) ** -0.5, gen)
            nn.init.zeros_(lin.bias)

    def ffn_params(self):
        a, b = self.htoh4, self.h4toh
        if self.int8:
            return MoEFfnParamsQ(a.weight_q, a.bias, b.weight_q, b.bias,
                                 a.weight_scale, b.weight_scale)
        return MoEFfnParams(a.weight, a.bias, b.weight, b.bias)


class MoEMlp(nn.Module):
    """gate -> dispatch -> experts -> combine (vit_moe.py:169-464).
    gate_type "noisy_vmoe" is the VMoE gate with noise std
    vmoe_noisy_std / E, "noisy" the learned-noise gate.  In training with
    drop > 0 the experts' hidden activation is dropped, which runs the
    plain expert FFN instead of the kernels, as the JAX package does
    (vit_moe.py:384-408; dispatch.py:305-337)."""

    def __init__(self, dim: int, num_experts: int, d_hidden: int,
                 top_k: int = 2, multi_gate: bool = False, num_tasks: int = 0,
                 vmoe_noisy_std: float = 1.0, capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 4.0,
                 expert_weights_int8: bool = False,
                 gate_type: str = "noisy_vmoe", drop: float = 0.0,
                 gate_task_specific_dim: int = -1):
        super().__init__()
        if gate_type not in GATE_TYPES:
            raise ValueError(f"gate_type {gate_type!r} is not one of "
                             f"{GATE_TYPES}")
        self.gate_type = gate_type
        self.gate_stats = False
        self.num_experts = num_experts
        self.top_k = top_k
        self.multi_gate = multi_gate
        self.num_tasks = num_tasks
        self.vmoe_noisy_std = vmoe_noisy_std
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.drop = drop
        learned = gate_type == "noisy"
        if multi_gate:
            if num_tasks <= 0:
                raise ValueError("multi_gate requires num_tasks > 0")
            self.gate = nn.ModuleList(
                NoisyGate(dim, num_experts, learned)
                for _ in range(num_tasks))
        else:
            # the task-conditioned router reads the task feature too
            d_task = max(int(gate_task_specific_dim), 0)
            self.gate = NoisyGate(dim + d_task, num_experts, learned)
        self.experts = Experts(num_experts, dim, d_hidden,
                               int8=expert_weights_int8)
        self.use_kernels = True
        # set by parallel.shard_experts: the rank's layout, the exchange's
        # chunk count
        self.layout = None
        self.a2a_chunks = 1

    def forward(self, x: torch.Tensor, task_id: Optional[int],
                noise: Optional[torch.Generator] = None,
                task_feature: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, GateOutput, Dict[str, torch.Tensor]]:
        """task_feature ([d_task]): the task-conditioned router's feature,
        concatenated to every token's gate input (vit_moe.py:234-240)."""
        B, N, C = x.shape
        E, K = self.num_experts, self.top_k
        if self.multi_gate:
            if task_id is None:
                raise ValueError("multi_gate routing needs a task_id")
            gate_mod = self.gate[min(max(int(task_id), 0), self.num_tasks - 1)]
        else:
            gate_mod = self.gate
        learned = self.gate_type == "noisy"
        gate_noise = None
        if self.training and (learned or self.vmoe_noisy_std > 0):
            if noise is None:
                raise ValueError("training the noisy gate needs gate noise: "
                                 "pass a torch.Generator as `noise`")
            # the JAX package draws it with jax.random.normal (gating.py:112);
            # a rank takes its rows of the global batch's noise
            lay = self.layout
            world = 1 if lay is None else lay.world
            gate_noise = torch.randn((world * B * N, E), generator=noise,
                                     device=x.device)
            if lay is not None:
                gate_noise = gate_noise[lay.rank * B * N:
                                        (lay.rank + 1) * B * N]
        gate_inp = x.reshape(-1, C).float()
        if task_feature is not None:
            gate_inp = torch.cat([gate_inp, task_feature.float().expand(
                B * N, -1)], dim=-1)
        if learned:
            gate = noisy_gate(gate_inp, gate_mod.w_gate,
                              gate_mod.w_noise, top_k=K, noise=gate_noise)
        else:
            gate = noisy_vmoe_gate(gate_inp, gate_mod.w_gate,
                                   top_k=K, noise_std=self.vmoe_noisy_std,
                                   noise=gate_noise)
        top_idx = gate.top_k_indices.reshape(B, N, K)
        top_gates = gate.top_k_gates.reshape(B, N, K)
        cf = self.capacity_factor if self.training else \
            self.eval_capacity_factor
        drop = self.drop if self.training else 0.0
        lay = self.layout
        out = moe_ffn(x, top_idx, top_gates, self.experts.ffn_params(),
                      capacity_factor=cf, use_kernels=self.use_kernels,
                      dropout_rate=drop, rng=noise,
                      group=None if lay is None else lay.expert_group,
                      num_experts_global=E, a2a_chunks=self.a2a_chunks)

        # exact dropped-slot accounting against the dispatch capacity
        # (vit_moe.py:419-439), per rank: the step sums the ranks' shares
        # of the global fraction; ids >= E are intentional non-compute
        T = B * N
        cap = compute_capacity(T, K, E, cf)
        ids = top_idx.reshape(-1).clamp(max=E)
        hist = torch.zeros(E + 1, device=x.device).scatter_add_(
            0, ids, torch.ones(ids.shape, device=x.device))[:E]
        overflow = torch.clamp(hist - cap, min=0.0).sum()
        world = 1 if lay is None else lay.world
        stats = {
            "dropped_slot_fraction": overflow / (world * T * K),
            "moe_stat_count": torch.ones((), device=x.device),
        }
        if self.gate_stats:
            stats.update(self.analysis_stats(gate))
        return out.to(x.dtype), gate, stats

    def aux_loss(self, gate: GateOutput) -> torch.Tensor:
        """The block's cv balance loss for its gate type
        (vit_moe.py:577-582); 0 outside training."""
        loss = moe_aux_loss_noisy if self.gate_type == "noisy" \
            else moe_aux_loss
        return loss(gate, self.top_k, self.num_experts, self.training,
                    reduce=None if self.layout is None
                    else parallel.world_sum_grad)

    @staticmethod
    @torch.no_grad()
    def analysis_stats(gate: GateOutput) -> Dict[str, torch.Tensor]:
        """The gates' entropy and top-1 sums over tokens, the token count
        and the per-expert load histogram, detached (vit_moe.py:584-598;
        the top-k scores carry what the dense gates do)."""
        tk = gate.top_k_gates.float()
        ent = -(tk * torch.log(tk.clamp(min=1e-12))).sum(-1)
        stats = {
            "gate_entropy_sum": ent.sum(),
            "top1_prob_sum": tk.max(-1).values.sum(),
            "gate_token_count": torch.tensor(float(tk.shape[0]),
                                             device=tk.device),
            "expert_load_hist": gate_load_counts(gate),
        }
        if gate_internals_on():
            stats.update(MoEMlp.gate_internals(gate))
        return stats

    @staticmethod
    @torch.no_grad()
    def gate_internals(gate: GateOutput) -> Dict[str, torch.Tensor]:
        """The full softmax of the noisy logits: its entropy and maximum
        summed over tokens, and the number of distinct groups of 4
        experts each token's top-k hits, summed (vit_moe.py:604-640).
        With E % 4 != 0 the groups are single experts, with the JAX
        package's warning."""
        E = gate.noisy_logits.shape[-1]
        p = torch.softmax(gate.noisy_logits.float(), -1).clamp(min=1e-9)
        group = 4 if E % 4 == 0 else 1
        if group == 1:
            warnings.warn(
                f"{GATE_INTERNALS_ENV}: moe_experts={E} not divisible by 4; "
                "falling back to group_size=1 -- topk_group_count is not "
                "comparable to reference logs (which assert divisibility)",
                stacklevel=2)
        gids = torch.sort(torch.div(gate.top_k_indices, group,
                                    rounding_mode="floor"), -1).values
        distinct = (gids[:, 1:] != gids[:, :-1]).sum(-1) + 1
        return {
            "gate_full_entropy_sum": -(p * torch.log(p)).sum(-1).sum(),
            "gate_pmax_sum": p.max(-1).values.sum(),
            "topk_group_count_sum": distinct.float().sum(),
        }


class MoEBlock(nn.Module):
    """Transformer block with an MoE FFN (vit_moe.py:467-636).  `stage`
    "attn" runs only the attention sublayer, "moe" only the MoE sublayer
    (the shared_prefix split, vit_moe.py:521-526).  In training: dropout
    of rate drop in the attention and the experts and on the MoE output,
    and drop-path of rate drop_path_rate on both residual branches
    (vit_moe.py:526-577)."""

    def __init__(self, dim: int, num_heads: int, moe_hidden_dim: int,
                 moe_experts: int = 16, moe_top_k: int = 4,
                 multi_gate: bool = False, num_tasks: int = 0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 vmoe_noisy_std: float = 1.0, capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 4.0, dtype=torch.float32,
                 expert_weights_int8: bool = False,
                 gate_type: str = "noisy_vmoe", drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0,
                 gate_task_specific_dim: int = -1):
        super().__init__()
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, dtype,
                              attn_drop, drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MoEMlp(dim, moe_experts, moe_hidden_dim, moe_top_k,
                          multi_gate, num_tasks, vmoe_noisy_std,
                          capacity_factor, eval_capacity_factor,
                          expert_weights_int8, gate_type, drop,
                          gate_task_specific_dim)

    def _drop_path(self, h, rng):
        return drop_path(h, self.drop_path_rate, rng) if self.training \
            else h

    def forward(self, x: torch.Tensor, task_id: Optional[int],
                noise: Optional[torch.Generator] = None, stage: str = "full",
                task_feature: Optional[torch.Tensor] = None):
        """Returns (tokens, cv loss, stats); cv is 0 outside training.
        task_feature: the task-conditioned router's feature, or None."""
        if stage != "moe":
            x = x + self._drop_path(self.attn(
                layer_norm(self.norm1, x).to(self.dtype), noise), noise)
            if stage == "attn":
                return x, torch.zeros((), device=x.device), {}
        h = layer_norm(self.norm2, x).to(self.dtype)
        moe_out, gate, stats = self.mlp(h, task_id, noise, task_feature)
        if self.training:
            moe_out = dropout(moe_out, self.mlp.drop, noise)
        return x + self._drop_path(moe_out, noise), self.mlp.aux_loss(gate), \
            stats


class VisionTransformerMoE(nn.Module):
    """MoE ViT backbone: even blocks dense, odd blocks MoE
    (vit_moe.py:734-1105).  Takes images [B, 3, H, W]; returns
    (tokens [B, 1+N, C], cv loss summed over blocks, stats summed over
    blocks).  drop_rate, attn_drop_rate and drop_path_rate act in
    training, their masks drawn from the forward's generator;
    use_checkpointing rematerialises each block in training
    (vit_moe.py:904-908).  gate_task_specific_dim > 0 without multi_gate
    conditions the shared router on the task (``gate_task_represent``)."""

    def __init__(self, img_size=(512, 512), patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, moe_mlp_ratio: float = -1.0,
                 moe_experts: int = 16, moe_top_k: int = 4,
                 multi_gate: bool = False, num_tasks: int = 0,
                 vmoe_noisy_std: float = 1.0, capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 4.0, dtype=torch.float32,
                 expert_weights_int8: bool = False, ln_mlp: bool = False,
                 moe_gate_type: str = "noisy_vmoe", drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 use_checkpointing: bool = False,
                 gate_task_specific_dim: int = -1, **left_out):
        super().__init__()
        reject_left_out(left_out)
        self.dtype = dtype
        d_task = int(gate_task_specific_dim) if not multi_gate else -1
        if d_task > 0 and num_tasks <= 0:
            raise ValueError("the task-conditioned router needs num_tasks")
        # the task-conditioned shared router's task feature
        # (vit_moe.py:882-892)
        self.gate_task_represent = TaskRepresentMlp(
            num_tasks, d_task, d_task) if d_task > 0 else None
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate
        self.drop_path_rate = drop_path_rate
        self.use_checkpointing = use_checkpointing
        self.expert_weights_int8 = expert_weights_int8
        num_patches = (img_size[0] // patch_size) * (img_size[1] // patch_size)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1,
                                                  embed_dim))
        moe_hidden = int(embed_dim * (moe_mlp_ratio if moe_mlp_ratio > 0
                                      else mlp_ratio))
        self.blocks = nn.ModuleList(
            DenseBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale,
                       dtype, ln_mlp, drop_rate, attn_drop_rate, dpr)
            if i % 2 == 0 else
            MoEBlock(embed_dim, num_heads, moe_hidden, moe_experts, moe_top_k,
                     multi_gate, num_tasks, qkv_bias, qk_scale,
                     vmoe_noisy_std, capacity_factor, eval_capacity_factor,
                     dtype, expert_weights_int8, moe_gate_type, drop_rate,
                     attn_drop_rate, dpr, d_task)
            for i, dpr in enumerate(drop_path_rates(drop_path_rate, depth)))

    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.zeros_(self.cls_token)
        fill_normal(self.pos_embed, 0.02, gen)

    def train(self, mode: bool = True):
        if mode and self.expert_weights_int8:
            raise RuntimeError(
                "a model with int8 expert banks serves only: the quantized "
                "expert FFN has no backward (build it without "
                "expert_weights_int8 to train)")
        return super().train(mode)

    def _task_feature(self, task_id):
        """The task-conditioned router's feature of task_id (an int, or a
        sequence of ids: one row each), or None without that router."""
        if self.gate_task_represent is None:
            return None
        if task_id is None:
            raise ValueError("the task-conditioned router needs a task_id")
        return self.gate_task_represent(task_id)

    def _run_blocks(self, tokens, task_id, start: int, start_stage: str,
                    noise, task_feature=None):
        total_cv = torch.zeros((), device=tokens.device)
        stats: Dict[str, torch.Tensor] = {}
        for i in range(start, len(self.blocks)):
            blk = self.blocks[i]
            if isinstance(blk, MoEBlock):
                stage = start_stage if i == start else "full"
                tokens, cv, st = run_block(self, blk, noise, tokens, task_id,
                                           noise, stage, task_feature)
                total_cv = total_cv + cv
                stats = add_stats(stats, st)
            else:
                tokens = run_block(self, blk, noise, tokens, noise)
        return tokens, total_cv, stats

    def forward(self, x: torch.Tensor, task_id=None,
                noise: Optional[torch.Generator] = None,
                shared_prefix: bool = False):
        """task_id: the task whose routers route, or with shared_prefix a
        sequence of task ids; then the prefix (patch embed, the leading
        dense block and the first MoE block's attention) runs once and the
        rest once per task, and the tokens come back task-major
        [T*B, 1+N, C] (vit_moe.py:1057-1101); so does the task-conditioned
        router's (each branch with its task's feature).  Training with
        dropout would
        share the prefix's masks across tasks, so it raises; with
        drop-path the first MoE block's attention runs per task."""
        if shared_prefix and self.training and (self.drop_rate > 0
                                                or self.attn_drop_rate > 0):
            raise ValueError("shared_prefix would share the prefix's "
                             "dropout masks across tasks; train with "
                             "dropout without it (vit_moe.py:860-864)")
        tokens = embed_tokens(self, x, noise)
        task_feature = self._task_feature(task_id)
        if not shared_prefix:
            return self._run_blocks(tokens, task_id, 0, "full", noise,
                                    task_feature)
        task_ids: Sequence[int] = task_id
        n_prefix = 0
        while n_prefix < len(self.blocks) and n_prefix % 2 == 0:
            tokens = run_block(self, self.blocks[n_prefix], noise, tokens,
                               noise)
            n_prefix += 1
        start_stage = "full"
        if n_prefix < len(self.blocks) and not (self.training
                                                and self.drop_path_rate > 0):
            tokens, _, _ = run_block(self, self.blocks[n_prefix], noise,
                                     tokens, None, noise, "attn")
            start_stage = "moe"
        feats, total_cv, stats = [], torch.zeros((), device=x.device), {}
        for t, tid in enumerate(task_ids):
            f, cv, st = self._run_blocks(
                tokens, tid, n_prefix, start_stage, noise,
                None if task_feature is None else task_feature[t])
            feats.append(f)
            total_cv = total_cv + cv
            stats = add_stats(stats, st)
        return torch.cat(feats, dim=0), total_cv, stats
