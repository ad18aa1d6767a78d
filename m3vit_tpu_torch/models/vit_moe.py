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
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from m3vit_tpu_torch.models.vit import (
    Attention,
    DenseBlock,
    DenseParams,
    PatchEmbed,
    embed_tokens,
    fill_normal,
    fill_uniform,
    layer_norm,
    reject_left_out,
)
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
    vmoe_noisy_std / E, "noisy" the learned-noise gate."""

    def __init__(self, dim: int, num_experts: int, d_hidden: int,
                 top_k: int = 2, multi_gate: bool = False, num_tasks: int = 0,
                 vmoe_noisy_std: float = 1.0, capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 4.0,
                 expert_weights_int8: bool = False,
                 gate_type: str = "noisy_vmoe"):
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
        learned = gate_type == "noisy"
        if multi_gate:
            if num_tasks <= 0:
                raise ValueError("multi_gate requires num_tasks > 0")
            self.gate = nn.ModuleList(
                NoisyGate(dim, num_experts, learned)
                for _ in range(num_tasks))
        else:
            self.gate = NoisyGate(dim, num_experts, learned)
        self.experts = Experts(num_experts, dim, d_hidden,
                               int8=expert_weights_int8)
        self.use_kernels = True

    def forward(self, x: torch.Tensor, task_id: Optional[int],
                noise: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, GateOutput, Dict[str, torch.Tensor]]:
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
            # the JAX package draws it with jax.random.normal (gating.py:112)
            gate_noise = torch.randn((B * N, E), generator=noise,
                                     device=x.device)
        if learned:
            gate = noisy_gate(x.reshape(-1, C).float(), gate_mod.w_gate,
                              gate_mod.w_noise, top_k=K, noise=gate_noise)
        else:
            gate = noisy_vmoe_gate(x.reshape(-1, C).float(), gate_mod.w_gate,
                                   top_k=K, noise_std=self.vmoe_noisy_std,
                                   noise=gate_noise)
        top_idx = gate.top_k_indices.reshape(B, N, K)
        top_gates = gate.top_k_gates.reshape(B, N, K)
        cf = self.capacity_factor if self.training else \
            self.eval_capacity_factor
        out = moe_ffn(x, top_idx, top_gates, self.experts.ffn_params(),
                      capacity_factor=cf, use_kernels=self.use_kernels)

        # exact dropped-slot accounting against the dispatch capacity
        # (vit_moe.py:419-439); ids >= E are intentional non-compute
        T = B * N
        cap = compute_capacity(T, K, E, cf)
        ids = top_idx.reshape(-1).clamp(max=E)
        hist = torch.zeros(E + 1, device=x.device).scatter_add_(
            0, ids, torch.ones(ids.shape, device=x.device))[:E]
        overflow = torch.clamp(hist - cap, min=0.0).sum()
        stats = {
            "dropped_slot_fraction": overflow / (T * K),
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
        return loss(gate, self.top_k, self.num_experts, self.training)

    @staticmethod
    @torch.no_grad()
    def analysis_stats(gate: GateOutput) -> Dict[str, torch.Tensor]:
        """The gates' entropy and top-1 sums over tokens, the token count
        and the per-expert load histogram, detached (vit_moe.py:584-598;
        the top-k scores carry what the dense gates do)."""
        tk = gate.top_k_gates.float()
        ent = -(tk * torch.log(tk.clamp(min=1e-12))).sum(-1)
        return {
            "gate_entropy_sum": ent.sum(),
            "top1_prob_sum": tk.max(-1).values.sum(),
            "gate_token_count": torch.tensor(float(tk.shape[0]),
                                             device=tk.device),
            "expert_load_hist": gate_load_counts(gate),
        }


class MoEBlock(nn.Module):
    """Transformer block with an MoE FFN (vit_moe.py:467-636).  `stage`
    "attn" runs only the attention sublayer, "moe" only the MoE sublayer
    (the shared_prefix split, vit_moe.py:521-526)."""

    def __init__(self, dim: int, num_heads: int, moe_hidden_dim: int,
                 moe_experts: int = 16, moe_top_k: int = 4,
                 multi_gate: bool = False, num_tasks: int = 0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 vmoe_noisy_std: float = 1.0, capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 4.0, dtype=torch.float32,
                 expert_weights_int8: bool = False,
                 gate_type: str = "noisy_vmoe"):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MoEMlp(dim, moe_experts, moe_hidden_dim, moe_top_k,
                          multi_gate, num_tasks, vmoe_noisy_std,
                          capacity_factor, eval_capacity_factor,
                          expert_weights_int8, gate_type)

    def forward(self, x: torch.Tensor, task_id: Optional[int],
                noise: Optional[torch.Generator] = None, stage: str = "full"):
        """Returns (tokens, cv loss, stats); cv is 0 outside training."""
        if stage != "moe":
            x = x + self.attn(layer_norm(self.norm1, x).to(self.dtype))
            if stage == "attn":
                return x, torch.zeros((), device=x.device), {}
        h = layer_norm(self.norm2, x).to(self.dtype)
        moe_out, gate, stats = self.mlp(h, task_id, noise)
        return x + moe_out, self.mlp.aux_loss(gate), stats


class VisionTransformerMoE(nn.Module):
    """MoE ViT backbone: even blocks dense, odd blocks MoE
    (vit_moe.py:734-1105).  Takes images [B, 3, H, W]; returns
    (tokens [B, 1+N, C], cv loss summed over blocks, stats summed over
    blocks)."""

    def __init__(self, img_size=(512, 512), patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, moe_mlp_ratio: float = -1.0,
                 moe_experts: int = 16, moe_top_k: int = 4,
                 multi_gate: bool = False, num_tasks: int = 0,
                 vmoe_noisy_std: float = 1.0, capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 4.0, dtype=torch.float32,
                 expert_weights_int8: bool = False, ln_mlp: bool = False,
                 moe_gate_type: str = "noisy_vmoe", **left_out):
        super().__init__()
        reject_left_out(left_out)
        self.dtype = dtype
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
                       dtype, ln_mlp) if i % 2 == 0 else
            MoEBlock(embed_dim, num_heads, moe_hidden, moe_experts, moe_top_k,
                     multi_gate, num_tasks, qkv_bias, qk_scale,
                     vmoe_noisy_std, capacity_factor, eval_capacity_factor,
                     dtype, expert_weights_int8, moe_gate_type)
            for i in range(depth))

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

    def _run_blocks(self, tokens, task_id, start: int, start_stage: str,
                    noise):
        total_cv = torch.zeros((), device=tokens.device)
        stats: Dict[str, torch.Tensor] = {}
        for i in range(start, len(self.blocks)):
            blk = self.blocks[i]
            if isinstance(blk, MoEBlock):
                stage = start_stage if i == start else "full"
                tokens, cv, st = blk(tokens, task_id, noise, stage)
                total_cv = total_cv + cv
                stats = add_stats(stats, st)
            else:
                tokens = blk(tokens)
        return tokens, total_cv, stats

    def forward(self, x: torch.Tensor, task_id=None,
                noise: Optional[torch.Generator] = None,
                shared_prefix: bool = False):
        """task_id: the task whose routers route, or with shared_prefix a
        sequence of task ids; then the prefix (patch embed, the leading
        dense block and the first MoE block's attention) runs once and the
        rest once per task, and the tokens come back task-major
        [T*B, 1+N, C] (vit_moe.py:1057-1101)."""
        tokens = embed_tokens(self, x)
        if not shared_prefix:
            return self._run_blocks(tokens, task_id, 0, "full", noise)
        task_ids: Sequence[int] = task_id
        n_prefix = 0
        while n_prefix < len(self.blocks) and n_prefix % 2 == 0:
            tokens = self.blocks[n_prefix](tokens)
            n_prefix += 1
        start_stage = "full"
        if n_prefix < len(self.blocks):
            tokens, _, _ = self.blocks[n_prefix](tokens, None, None, "attn")
            start_stage = "moe"
        feats, total_cv, stats = [], torch.zeros((), device=x.device), {}
        for tid in task_ids:
            f, cv, st = self._run_blocks(tokens, tid, n_prefix, start_stage,
                                         noise)
            feats.append(f)
            total_cv = total_cv + cv
            stats = add_stats(stats, st)
        return torch.cat(feats, dim=0), total_cv, stats
