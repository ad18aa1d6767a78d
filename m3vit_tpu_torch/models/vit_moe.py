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

The research knobs (vit_moe.py:55-140, :188-200, :275-360, :441-463):
``expert_mask`` (routing restricted to some experts: one [E] mask, or one
a MoE block), ``expert_prune`` (scores at or below prune_threshold
zeroed), ``regu_experts_fromtask`` (task t routes over a window of
num_experts_pertask experts, its statistics over the window), and, given
the semseg labels ``sem``, ``sem_force`` (a patch's majority class forces
its routing to a group's expert pair, SEM_FORCE_GROUPS), ``regu_sem`` (an
NLL of the patch classes from the gate logits through
``mlp.regu_sem_head``) and ``regu_subimage`` (a KL between each token's
routing and its 5x5 subimage's top-2 consensus); the two regularisers
come back in the stats as ``semregu_loss`` and ``regu_subimage_loss``.
``stacked_tasks`` runs every task's routing in one pass over a task-major
[T*B] stack of the tokens (vit_moe.py:847-877), ``gate_input_ahead``
routes on each MoE block's input, ``distilled`` adds the ``dist_token``,
and ``gate_dim`` sizes the routers for a decoupled gate input
(``gate_inp``: ``models/gate_vit.py``'s features).  Under a
``torch.distributed`` layout the knobs raise (ROADMAP.md queue 1 item
7b).
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
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
from m3vit_tpu_torch.models.resnet import lecun_normal_

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


#: semantic class -> expert group of sem_force routing: group j forces
#: experts 2j and 2j+1 (vit_moe.py:55-61; reference custom_moe_layer.py
#: :112-113, 8 groups of the NYUD-40 classes)
SEM_FORCE_GROUPS = [
    [0], [1, 17, 18, 19, 20], [2, 12, 13, 14, 15, 16], [3, 9, 10, 11],
    [4, 5], [6, 7, 8, 38], [21, 22, 23, 24, 25, 26, 39],
    [27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37],
]


def patch_majority_labels(sem: torch.Tensor, patch_size: int,
                          num_classes: int = 41) -> torch.Tensor:
    """Each patch's majority class where it covers more than
    int(0.4 P^2) of the patch's pixels, else 255 (vit_moe.py:64-84;
    reference get_groundtruth_sem, ckpt/vision_transformer_moe.py
    :762-778).  sem: labels [B, 1, H, W] or [B, H, W], 255 ignored (never
    counted); labels clipped to [0, num_classes]; ties go to the lowest
    class.  Returns [B, H/P, W/P] int64."""
    if sem.dim() == 4:
        sem = sem[:, 0]
    B, H, W = sem.shape
    P = patch_size
    h, w = H // P, W // P
    patches = sem[:, :h * P, :w * P].reshape(B, h, P, w, P).permute(
        0, 1, 3, 2, 4).reshape(B, h, w, P * P)
    labels = patches.long().clamp(0, num_classes)
    counts = torch.zeros((B, h, w, num_classes + 1), dtype=torch.long,
                         device=sem.device).scatter_add_(
        3, labels, (patches != 255).long())
    best = counts.max(-1)   # the first of tied classes
    return torch.where(best.values > int(0.4 * P * P), best.indices, 255)


def build_sem_force_routing(patch_labels: torch.Tensor, top_k: int,
                            num_prefix: int):
    """(ids [B, num_prefix + n, K], forced [B, num_prefix + n] bool) of
    patch labels [B, n] (255: not forced): a class of group j routes to
    experts 2j + (k % 2) in slot k, other classes and the prefix tokens
    are not forced (vit_moe.py:87-111; reference custom_moe_layer.py
    :225-241)."""
    lut = torch.full((256,), -1, dtype=torch.long)
    for j, classes in enumerate(SEM_FORCE_GROUPS):
        lut[classes] = j
    g = lut.to(patch_labels.device)[patch_labels.long().clamp(0, 255)]
    forced = g >= 0
    base = torch.where(forced, 2 * g, 0)
    pattern = torch.arange(top_k, device=g.device) % 2
    idx = base[..., None] + pattern
    B = patch_labels.shape[0]
    return (torch.cat([idx.new_zeros((B, num_prefix, top_k)), idx], 1),
            torch.cat([forced.new_zeros((B, num_prefix)), forced], 1))


def regu_subimage_loss(patch_logits: torch.Tensor, sub: int,
                       side_h: int = 0, side_w: int = 0) -> torch.Tensor:
    """KL(each token's routing || its sub x sub subimage's top-2
    consensus), averaged over tokens and summed over subimages over
    B x subimages (vit_moe.py:114-141; reference noisy_gate_vmoe.py
    :139-162).  patch_logits [B, Np, E] on the (side_h, side_w) patch grid
    (a square one when not given); the subimages tile the grid from its
    corner, and a grid smaller than one gives 0.  The consensus is the
    softmax of the subimage's summed logits with every sum below the
    second largest set to 0 (ties keep more than two)."""
    B, Np, E = patch_logits.shape
    if side_h <= 0 or side_w <= 0:
        side_h = int(round(Np ** 0.5))
        side_w = Np // side_h
    usable_h, usable_w = side_h // sub * sub, side_w // sub * sub
    if usable_h == 0 or usable_w == 0:
        return torch.zeros((), device=patch_logits.device)
    g = patch_logits[:, :side_h * side_w].reshape(B, side_h, side_w, E)
    g = g[:, :usable_h, :usable_w]
    gh, gw = usable_h // sub, usable_w // sub
    groups = g.reshape(B, gh, sub, gw, sub, E).permute(0, 1, 3, 2, 4, 5)
    groups = groups.reshape(B, gh * gw, sub * sub, E).float()
    sums = groups.sum(2)
    second = torch.topk(sums, 2, dim=-1).values[..., -1:]
    p = torch.softmax(torch.where(sums >= second, sums, 0.0), -1)[:, :, None]
    logq = torch.log_softmax(groups, -1)
    kl = (p * (torch.log(p.clamp(min=1e-12)) - logq)).sum(-1).mean(-1)
    return kl.sum() / (B * gh * gw)


def expert_windows(num_experts: int, num_tasks: int, per_task: int):
    """[(start, clamped start)] of each task's expert window under
    regu_experts_fromtask (vit_moe.py:275-303): the starts are cumulative,
    s += int(t (E - n) / (T - 1)); the reference's slice narrows a window
    past E, which the clamped start E - n with the columns before the
    true start masked reproduces (a window can be masked whole)."""
    if per_task <= 0 or num_tasks <= 1:
        raise ValueError("regu_experts_fromtask needs num_experts_pertask "
                         "> 0 and more than one task")
    out, s = [], 0
    for t in range(num_tasks):
        s += int(t * (num_experts - per_task) / (num_tasks - 1))
        out.append((s, min(s, num_experts - per_task)))
    return out


def prune_scores(top_gates: torch.Tensor, threshold: float) -> torch.Tensor:
    """expert_prune: the routing scores at or below `threshold` zeroed
    (vit_moe.py:348-351; reference custom_moe_layer.py:221-224)."""
    return torch.where(top_gates > threshold, top_gates, 0.0)


class KnobInputs(NamedTuple):
    """A MoE block's per-forward knob inputs: the [E] routing mask, the
    forced routing (ids [B, N, K], mask [B, N]), the gate's input tokens
    [B, N, C_g] (a decoupled gate's, or the block's input with
    gate_input_ahead), the patches' labels [B, n_patches] of the
    regularisers, and the task segments of a stacked pass."""

    expert_mask: Optional[torch.Tensor] = None
    sem_force_idx: Optional[torch.Tensor] = None
    sem_force_mask: Optional[torch.Tensor] = None
    gate_inp: Optional[torch.Tensor] = None
    sem_patch: Optional[torch.Tensor] = None
    segments: int = 1


NO_KNOBS = KnobInputs()


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
    (vit_moe.py:384-408; dispatch.py:305-337).  gate_dim: the width of
    the gate's input tokens (-1: dim).  The research knobs as the module
    docstring says; with regu_sem the block owns ``regu_sem_head``
    (Linear(gate width -> regu_sem_num_classes))."""

    def __init__(self, dim: int, num_experts: int, d_hidden: int,
                 top_k: int = 2, multi_gate: bool = False, num_tasks: int = 0,
                 vmoe_noisy_std: float = 1.0, capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 4.0,
                 expert_weights_int8: bool = False,
                 gate_type: str = "noisy_vmoe", drop: float = 0.0,
                 gate_task_specific_dim: int = -1, gate_dim: int = -1,
                 expert_prune: bool = False, prune_threshold: float = 0.1,
                 regu_experts_fromtask: bool = False,
                 num_experts_pertask: int = -1, regu_sem: bool = False,
                 regu_sem_num_classes: int = 40, regu_subimage: bool = False,
                 subimage_tokens: int = 5, patch_grid=(0, 0)):
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
        self.expert_prune = expert_prune
        self.prune_threshold = prune_threshold
        self.windows = None
        if regu_experts_fromtask:
            if gate_type != "noisy_vmoe":
                # the JAX learned-noise gate keeps w_noise at E columns
                # beside the window's logits, a shape it cannot add
                raise ValueError("regu_experts_fromtask takes the "
                                 "noisy_vmoe gate")
            self.windows = expert_windows(num_experts, num_tasks,
                                          num_experts_pertask)
            self.per_task = num_experts_pertask
        self.regu_sem = regu_sem
        self.regu_subimage = regu_subimage
        self.subimage_tokens = subimage_tokens
        self.patch_grid = tuple(patch_grid)
        # the gate's width: a task's window under regu_experts_fromtask
        e_gate = num_experts_pertask if regu_experts_fromtask else num_experts
        self.regu_sem_head = nn.Linear(e_gate, regu_sem_num_classes) \
            if regu_sem else None
        learned = gate_type == "noisy"
        d_gate = dim if gate_dim <= 0 else int(gate_dim)
        if multi_gate:
            if num_tasks <= 0:
                raise ValueError("multi_gate requires num_tasks > 0")
            self.gate = nn.ModuleList(
                NoisyGate(d_gate, num_experts, learned)
                for _ in range(num_tasks))
        else:
            # the task-conditioned router reads the task feature too
            d_task = max(int(gate_task_specific_dim), 0)
            self.gate = NoisyGate(d_gate + d_task, num_experts, learned)
        self.experts = Experts(num_experts, dim, d_hidden,
                               int8=expert_weights_int8)
        self.use_kernels = True
        # set by parallel.shard_experts: the rank's layout, the exchange's
        # chunk count
        self.layout = None
        self.a2a_chunks = 1

    def init_weights(self, gen: torch.Generator) -> None:
        if self.regu_sem_head is not None:   # flax Dense's init
            lecun_normal_(self.regu_sem_head.weight, gen)
            nn.init.zeros_(self.regu_sem_head.bias)

    @property
    def has_knobs(self) -> bool:
        """Whether a research knob of the block is set."""
        return bool(self.expert_prune or self.windows or self.regu_sem
                    or self.regu_subimage)

    def _weights(self, task_id, stacked: bool):
        """(w_gate, w_noise or None) of the routing for task_id: the task's
        router [d, E]; for a stacked pass each row's [B, d, E]."""
        if not self.multi_gate:
            return self.gate.w_gate, self.gate.w_noise
        if task_id is None:
            raise ValueError("multi_gate routing needs a task_id")
        if stacked:
            ids = task_id.clamp(0, self.num_tasks - 1)
            return torch.stack([g.w_gate for g in self.gate])[ids], None
        g = self.gate[min(max(int(task_id), 0), self.num_tasks - 1)]
        return g.w_gate, g.w_noise

    def forward(self, x: torch.Tensor, task_id,
                noise: Optional[torch.Generator] = None,
                task_feature: Optional[torch.Tensor] = None,
                knobs: KnobInputs = NO_KNOBS
                ) -> Tuple[torch.Tensor, GateOutput, Dict[str, torch.Tensor]]:
        """task_id: the task whose router routes, or for a stacked pass a
        [B] tensor of each row's task; task_feature ([d_task]): the
        task-conditioned router's feature, concatenated to every token's
        gate input (vit_moe.py:234-240); knobs: the knob inputs, in the JAX
        package's order of use (vit_moe.py:221-463)."""
        B, N, C = x.shape
        E, K = self.num_experts, self.top_k
        stacked = torch.is_tensor(task_id) and task_id.dim() == 1
        if stacked and not (self.multi_gate and self.windows is None
                            and self.gate_type == "noisy_vmoe"
                            and task_id.shape[0] == B):
            raise ValueError("a stacked pass needs multi_gate, the "
                             "noisy_vmoe gate, no regu_experts_fromtask and "
                             "a task id a row (vit_moe.py:241-252)")
        gi = knobs.gate_inp
        gate_inp = (x if gi is None else gi).reshape(B * N, -1).float()
        if task_feature is not None:
            gate_inp = torch.cat([gate_inp, task_feature.float().expand(
                B * N, -1)], dim=-1)
        w_gate, w_noise = self._weights(task_id, stacked)
        expert_mask = knobs.expert_mask
        offset = None
        if self.windows is not None and task_id is not None:
            # the task's window of experts (vit_moe.py:275-303)
            start, offset = self.windows[
                min(max(int(task_id), 0), self.num_tasks - 1)]
            n = self.per_task
            w_gate = w_gate[:, offset:offset + n]
            window = torch.arange(offset, offset + n,
                                  device=x.device) >= start
            expert_mask = window if expert_mask is None else \
                expert_mask.to(x.device)[offset:offset + n] & window
        width = w_gate.shape[-1]
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
            gate_noise = torch.randn((world * B * N, width), generator=noise,
                                     device=x.device)
            if lay is not None:
                gate_noise = gate_noise[lay.rank * B * N:
                                        (lay.rank + 1) * B * N]
        if learned:
            gate = noisy_gate(gate_inp, w_gate, w_noise, top_k=K,
                              noise=gate_noise, expert_mask=expert_mask)
        elif stacked:
            # each row's logits against its task's router, in f32
            # (vit_moe.py:323-332)
            logits = torch.bmm(gate_inp.reshape(B, N, -1), w_gate.float())
            gate = noisy_vmoe_gate(None, w_gate[0], top_k=K,
                                   noise_std=self.vmoe_noisy_std,
                                   noise=gate_noise,
                                   clean_logits=logits.reshape(B * N, E),
                                   expert_mask=expert_mask)
        else:
            gate = noisy_vmoe_gate(gate_inp, w_gate,
                                   top_k=K, noise_std=self.vmoe_noisy_std,
                                   noise=gate_noise, expert_mask=expert_mask)
        top_idx = gate.top_k_indices.reshape(B, N, K)
        top_gates = gate.top_k_gates.reshape(B, N, K)
        if self.expert_prune:
            top_gates = prune_scores(top_gates, self.prune_threshold)
        if offset is not None:
            top_idx = top_idx + offset
        if knobs.sem_force_idx is not None:
            m = knobs.sem_force_mask[..., None]
            top_idx = torch.where(m, knobs.sem_force_idx, top_idx)
            top_gates = torch.where(m, 0.5, top_gates)
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
        if knobs.sem_patch is not None and (self.regu_sem
                                            or self.regu_subimage):
            stats.update(self.regularisers(gate, knobs.sem_patch, B, N))
        if self.gate_stats:
            stats.update(self.analysis_stats(gate))
        return out.to(x.dtype), gate, stats

    def regularisers(self, gate: GateOutput, sem_patch: torch.Tensor,
                     B: int, N: int) -> Dict[str, torch.Tensor]:
        """The gate-logit regularisers on the patch tokens' clean logits
        (vit_moe.py:441-462): ``semregu_loss``, the NLL of the patches'
        labels (255 left out) under regu_sem_head's classes, and
        ``regu_subimage_loss``."""
        logits = gate.clean_logits.reshape(B, N, -1)
        patch_logits = logits[:, N - sem_patch.shape[1]:]
        out = {}
        if self.regu_sem:
            prior = F.linear(patch_logits, self.regu_sem_head.weight,
                             self.regu_sem_head.bias)
            lab = sem_patch.long()
            valid = lab != 255
            nll = -torch.log_softmax(prior, -1).gather(
                -1, torch.where(valid, lab, 0)[..., None])[..., 0]
            out["semregu_loss"] = torch.where(valid, nll, 0.0).sum() \
                / valid.sum().clamp(min=1)
        if self.regu_subimage:
            out["regu_subimage_loss"] = regu_subimage_loss(
                patch_logits, self.subimage_tokens, *self.patch_grid)
        return out

    def aux_loss(self, gate: GateOutput, segments: int = 1) -> torch.Tensor:
        """The block's cv balance loss for its gate type
        (vit_moe.py:577-582), summed over the task segments of a stacked
        pass; 0 outside training."""
        reduce = None if self.layout is None else parallel.world_sum_grad
        if self.gate_type == "noisy":
            return moe_aux_loss_noisy(gate, self.top_k, self.num_experts,
                                      self.training, reduce=reduce)
        return moe_aux_loss(gate, self.top_k, self.num_experts,
                            self.training, reduce=reduce, segments=segments)

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
    (vit_moe.py:526-577).  `knobs` (MoEMlp's options of the research
    knobs) go to the MoE layer."""

    def __init__(self, dim: int, num_heads: int, moe_hidden_dim: int,
                 moe_experts: int = 16, moe_top_k: int = 4,
                 multi_gate: bool = False, num_tasks: int = 0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 vmoe_noisy_std: float = 1.0, capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 4.0, dtype=torch.float32,
                 expert_weights_int8: bool = False,
                 gate_type: str = "noisy_vmoe", drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0,
                 gate_task_specific_dim: int = -1, **knobs):
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
                          gate_task_specific_dim, **knobs)

    def _drop_path(self, h, rng):
        return drop_path(h, self.drop_path_rate, rng) if self.training \
            else h

    def forward(self, x: torch.Tensor, task_id,
                noise: Optional[torch.Generator] = None, stage: str = "full",
                task_feature: Optional[torch.Tensor] = None,
                knobs: KnobInputs = NO_KNOBS):
        """Returns (tokens, cv loss, stats); cv is 0 outside training.
        task_feature: the task-conditioned router's feature, or None;
        knobs: the MoE layer's knob inputs."""
        if stage != "moe":
            x = x + self._drop_path(self.attn(
                layer_norm(self.norm1, x).to(self.dtype), noise), noise)
            if stage == "attn":
                return x, torch.zeros((), device=x.device), {}
        h = layer_norm(self.norm2, x).to(self.dtype)
        moe_out, gate, stats = self.mlp(h, task_id, noise, task_feature,
                                        knobs)
        if self.training:
            moe_out = dropout(moe_out, self.mlp.drop, noise)
        return x + self._drop_path(moe_out, noise), \
            self.mlp.aux_loss(gate, knobs.segments), stats


class VisionTransformerMoE(nn.Module):
    """MoE ViT backbone: even blocks dense, odd blocks MoE
    (vit_moe.py:734-1105).  Takes images [B, 3, H, W]; returns
    (tokens [B, P+N, C], cv loss summed over blocks, stats summed over
    blocks), P = 2 prefix tokens when distilled (cls, dist), else 1.
    drop_rate, attn_drop_rate and drop_path_rate act in training, their
    masks drawn from the forward's generator; use_checkpointing
    rematerialises each block in training (vit_moe.py:904-908).
    gate_task_specific_dim > 0 without multi_gate conditions the shared
    router on the task (``gate_task_represent``).  The research knobs
    (expert_prune, prune_threshold, regu_experts_fromtask,
    num_experts_pertask, sem_force, regu_sem, regu_subimage,
    gate_input_ahead, gate_dim) as the module docstring says."""

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
                 gate_task_specific_dim: int = -1, distilled: bool = False,
                 gate_dim: int = -1, expert_prune: bool = False,
                 prune_threshold: float = 0.1,
                 regu_experts_fromtask: bool = False,
                 num_experts_pertask: int = -1, sem_force: bool = False,
                 regu_sem: bool = False, regu_subimage: bool = False,
                 gate_input_ahead: bool = False, **left_out):
        super().__init__()
        reject_left_out(left_out)
        self.dtype = dtype
        d_task = int(gate_task_specific_dim) if not multi_gate else -1
        if d_task > 0 and num_tasks <= 0:
            raise ValueError("the task-conditioned router needs num_tasks")
        if gate_input_ahead and gate_dim > 0:
            raise ValueError("gate_input_ahead routes on the blocks' own "
                             "tokens: no gate_dim")
        # the task-conditioned shared router's task feature
        # (vit_moe.py:882-892)
        self.gate_task_represent = TaskRepresentMlp(
            num_tasks, d_task, d_task) if d_task > 0 else None
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate
        self.drop_path_rate = drop_path_rate
        self.use_checkpointing = use_checkpointing
        self.expert_weights_int8 = expert_weights_int8
        self.multi_gate = multi_gate
        self.patch_size = patch_size
        self.top_k = moe_top_k
        self.sem_force = sem_force
        self.gate_input_ahead = gate_input_ahead
        self.gate_dim = gate_dim
        self.num_prefix = 2 if distilled else 1
        grid = (img_size[0] // patch_size, img_size[1] // patch_size)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) \
            if distilled else None
        self.pos_embed = nn.Parameter(torch.zeros(
            1, grid[0] * grid[1] + self.num_prefix, embed_dim))
        moe_hidden = int(embed_dim * (moe_mlp_ratio if moe_mlp_ratio > 0
                                      else mlp_ratio))
        knobs = dict(gate_dim=gate_dim, expert_prune=expert_prune,
                     prune_threshold=prune_threshold,
                     regu_experts_fromtask=regu_experts_fromtask,
                     num_experts_pertask=num_experts_pertask,
                     regu_sem=regu_sem, regu_subimage=regu_subimage,
                     patch_grid=grid)
        self.blocks = nn.ModuleList(
            DenseBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale,
                       dtype, ln_mlp, drop_rate, attn_drop_rate, dpr)
            if i % 2 == 0 else
            MoEBlock(embed_dim, num_heads, moe_hidden, moe_experts, moe_top_k,
                     multi_gate, num_tasks, qkv_bias, qk_scale,
                     vmoe_noisy_std, capacity_factor, eval_capacity_factor,
                     dtype, expert_weights_int8, moe_gate_type, drop_rate,
                     attn_drop_rate, dpr, d_task, **knobs)
            for i, dpr in enumerate(drop_path_rates(drop_path_rate, depth)))

    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.zeros_(self.cls_token)
        fill_normal(self.pos_embed, 0.02, gen)
        if self.dist_token is not None:
            fill_normal(self.dist_token, 0.02, gen)

    def train(self, mode: bool = True):
        if mode and self.expert_weights_int8:
            raise RuntimeError(
                "a model with int8 expert banks serves only: the quantized "
                "expert FFN has no backward (build it without "
                "expert_weights_int8 to train)")
        return super().train(mode)

    @property
    def has_knobs(self) -> bool:
        """Whether a research knob of the model is set."""
        return bool(self.sem_force or self.gate_input_ahead
                    or self.dist_token is not None or self.gate_dim > 0
                    or any(isinstance(b, MoEBlock) and b.mlp.has_knobs
                           for b in self.blocks))

    def _task_feature(self, task_id):
        """The task-conditioned router's feature of task_id (an int, or a
        sequence of ids: one row each), or None without that router."""
        if self.gate_task_represent is None:
            return None
        if task_id is None:
            raise ValueError("the task-conditioned router needs a task_id")
        return self.gate_task_represent(task_id)

    def _block_masks(self, expert_mask):
        """Each MoE block's routing mask: None, the one [E] mask for every
        block, or a sequence of one [E] mask a MoE block, in order."""
        n = sum(isinstance(b, MoEBlock) for b in self.blocks)
        if expert_mask is None or (torch.is_tensor(expert_mask)
                                   and expert_mask.dim() == 1):
            return [expert_mask] * n
        masks = list(expert_mask)
        if len(masks) != n:
            raise ValueError(f"{len(masks)} expert masks for {n} MoE blocks")
        return masks

    def _run_blocks(self, tokens, task_id, start: int, start_stage: str,
                    noise, task_feature, knobs: KnobInputs, masks,
                    start_gate_inp=None):
        """Blocks `start`.. (vit_moe.py:1029-1055).  With
        gate_input_ahead each MoE block routes on its own input, and block
        `start` run from its "moe" stage on start_gate_inp, the input its
        attention took."""
        total_cv = torch.zeros((), device=tokens.device)
        stats: Dict[str, torch.Tensor] = {}
        for i in range(start, len(self.blocks)):
            blk = self.blocks[i]
            if isinstance(blk, MoEBlock):
                stage = start_stage if i == start else "full"
                gi = knobs.gate_inp
                if self.gate_input_ahead:
                    gi = start_gate_inp if stage == "moe" else tokens
                tokens, cv, st = run_block(
                    self, blk, noise, tokens, task_id, noise, stage,
                    task_feature, knobs._replace(expert_mask=masks[i // 2],
                                                 gate_inp=gi))
                total_cv = total_cv + cv
                stats = add_stats(stats, st)
            else:
                tokens = run_block(self, blk, noise, tokens, noise)
        return tokens, total_cv, stats

    def forward(self, x: torch.Tensor, task_id=None,
                noise: Optional[torch.Generator] = None,
                shared_prefix: bool = False, stacked_tasks: bool = False,
                sem: Optional[torch.Tensor] = None, expert_mask=None,
                gate_inp: Optional[torch.Tensor] = None):
        """task_id: the task whose routers route, or with shared_prefix or
        stacked_tasks a sequence of task ids.  shared_prefix: the prefix
        (patch embed, the leading dense block and the first MoE block's
        attention) runs once and the rest once per task, and the tokens
        come back task-major [T*B, P+N, C] (vit_moe.py:1057-1101); so does
        the task-conditioned router's (each branch with its task's
        feature).  Training with dropout would share the prefix's masks
        across tasks, so it raises; with drop-path the first MoE block's
        attention runs per task.  stacked_tasks (multi_gate): the tokens
        embedded once at B, then every block over the task-major
        [T*B, P+N, C] stack, each row routed by its task and the cv loss
        summed over the task segments (vit_moe.py:847-877).  sem: semseg
        labels [B, 1, H, W] for sem_force / regu_sem / regu_subimage;
        expert_mask: an [E] bool routing mask, or one a MoE block;
        gate_inp: the gates' input tokens [B, P+N, gate_dim]."""
        if parallel.active() is not None and (
                self.has_knobs or stacked_tasks or sem is not None
                or expert_mask is not None or gate_inp is not None):
            raise NotImplementedError(
                "the research knobs, stacked tasks and the decoupled gate "
                "under torch.distributed are not ported to m3vit_tpu_torch "
                "(ROADMAP.md queue 1 item 7b)")
        if shared_prefix and stacked_tasks:
            raise ValueError("shared_prefix and stacked_tasks are separate "
                             "execution strategies; pick one")
        if shared_prefix and self.training and (self.drop_rate > 0
                                                or self.attn_drop_rate > 0):
            raise ValueError("shared_prefix would share the prefix's "
                             "dropout masks across tasks; train with "
                             "dropout without it (vit_moe.py:860-864)")
        n_stack = 1
        if stacked_tasks:
            if not self.multi_gate:
                raise ValueError("stacked_tasks needs multi_gate and a "
                                 "sequence of task ids")
            n_stack = len(task_id)
            task_id = torch.as_tensor(list(task_id), device=x.device
                                      ).repeat_interleave(x.shape[0])
        tokens = embed_tokens(self, x, noise, repeat=n_stack)
        task_feature = self._task_feature(task_id)
        knobs = KnobInputs(gate_inp=gate_inp, segments=n_stack)
        if sem is not None and (self.sem_force or any(
                isinstance(b, MoEBlock) and (b.mlp.regu_sem
                                             or b.mlp.regu_subimage)
                for b in self.blocks)):
            # sem-guided routing and regularisers (vit_moe.py:910-922)
            patch = patch_majority_labels(sem, self.patch_size).reshape(
                sem.shape[0], -1)
            knobs = knobs._replace(sem_patch=patch)
            if self.sem_force:
                knobs = knobs._replace(**dict(zip(
                    ("sem_force_idx", "sem_force_mask"),
                    build_sem_force_routing(patch, self.top_k,
                                            self.num_prefix))))
        if n_stack > 1:   # the per-image inputs tiled task-major
            knobs = knobs._replace(**{
                k: torch.cat([v] * n_stack) for k, v in knobs._asdict().items()
                if torch.is_tensor(v)})
        masks = self._block_masks(expert_mask)
        if not shared_prefix:
            return self._run_blocks(tokens, task_id, 0, "full", noise,
                                    task_feature, knobs, masks)
        task_ids: Sequence[int] = task_id
        n_prefix = 0
        while n_prefix < len(self.blocks) and n_prefix % 2 == 0:
            tokens = run_block(self, self.blocks[n_prefix], noise, tokens,
                               noise)
            n_prefix += 1
        start_stage, start_gate_inp = "full", None
        if n_prefix < len(self.blocks) and not (self.training
                                                and self.drop_path_rate > 0):
            start_gate_inp = tokens   # the attention's input
            tokens, _, _ = run_block(self, self.blocks[n_prefix], noise,
                                     tokens, None, noise, "attn")
            start_stage = "moe"
        feats, total_cv, stats = [], torch.zeros((), device=x.device), {}
        for t, tid in enumerate(task_ids):
            f, cv, st = self._run_blocks(
                tokens, tid, n_prefix, start_stage, noise,
                None if task_feature is None else task_feature[t], knobs,
                masks, start_gate_inp)
            feats.append(f)
            total_cv = total_cv + cv
            stats = add_stats(stats, st)
        return torch.cat(feats, dim=0), total_cv, stats
