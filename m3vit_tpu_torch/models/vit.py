"""Dense ViT building blocks and the dense backbone (counterpart of
m3vit_tpu/models/vit.py).

Parameters are named like the torch reference model
(``attn.qkv.weight``, ``mlp.fc1.weight``, ...), so reference state dicts and
those made by ``utils/convert.py`` load with ``strict=True``.  Every
parameter is f32 (the master weights an optimizer updates); each forward
casts the matmul and conv weights to the compute dtype at use, as the JAX
package's flax modules do (param_dtype f32, dtype bf16; vit.py:252-257).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from m3vit_tpu_torch.ops.dropout import dropout, drop_path
from m3vit_tpu_torch.ops.expert_ffn import (
    fused_dense_mlp,
    fused_expert_ffn_plain,
)
from m3vit_tpu_torch.ops.flash_attention import (
    flash_attention_qkv,
    flash_attention_qkv_plain,
)
from m3vit_tpu_torch.ops.ln_mlp import fused_dense_ln_mlp


#: options of the JAX package this port leaves out; asking for one raises.
#: They are lax.scan compile strategies (one traced program for the
#: blocks or the task passes), which eager PyTorch has no use for
LEFT_OUT = ("scan_blocks", "scan_tasks")


def reject_left_out(knobs: Dict) -> None:
    for k, v in knobs.items():
        if k not in LEFT_OUT:
            raise TypeError(f"unexpected argument {k!r}")
        if v:
            raise NotImplementedError(
                f"{k} is a lax.scan compile strategy of the JAX package, "
                f"which ROADMAP.md lists as not to port to m3vit_tpu_torch")


@torch.no_grad()
def fill_normal(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=gen))


@torch.no_grad()
def fill_uniform(p: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))


def _hooked(mod: nn.Module, x: torch.Tensor, out: torch.Tensor):
    """`out` after `mod`'s forward hooks, which a module applied through
    the functions below would skip (utils/tracing.py hooks every module)."""
    for hook in mod._forward_hooks.values():
        hook(mod, (x,), out)
    return out


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 whatever x's dtype (flax LayerNorm(dtype=f32))."""
    return _hooked(norm, x, F.layer_norm(x.float(), norm.normalized_shape,
                                         norm.weight, norm.bias, norm.eps))


def linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """nn.Linear on x with its f32 weight and bias cast to `dtype`."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return _hooked(lin, x, F.linear(x.to(dtype), lin.weight.to(dtype), bias))


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """nn.Conv2d on x with its f32 weight and bias (if any) cast to
    `dtype`."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return _hooked(conv, x, F.conv2d(x.to(dtype), conv.weight.to(dtype),
                                     bias, conv.stride, conv.padding,
                                     conv.dilation, conv.groups))


def set_use_kernels(model: nn.Module, flag: bool) -> None:
    """Route every kernel call site in `model` to its hand-written kernel
    (True) or to its plain PyTorch version (False).  CPU tensors always take
    the plain version."""
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = flag


class DenseParams(nn.Module):
    """f32 weight [out, in] and bias [out] of a dense layer whose product
    runs in a fused kernel (m3vit_tpu/models/vit.py:_DenseParams)."""

    def __init__(self, in_features: int, out_features: int,
                 experts: Optional[int] = None):
        super().__init__()
        lead = () if experts is None else (experts,)
        self.weight = nn.Parameter(
            torch.zeros(lead + (out_features, in_features)))
        self.bias = nn.Parameter(torch.zeros(lead + (out_features,)))


class PatchEmbed(nn.Module):
    """Image [B, 3, H, W] -> patch tokens [B, h*w, C] via a strided conv
    (vit.py:25-44; kernel = stride, so flax's SAME padding pads nothing)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def init_weights(self, gen: torch.Generator) -> None:
        fill_normal(self.proj.weight, 0.02, gen)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self.proj, x, self.dtype).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self attention with a fused qkv projection (vit.py:47-137).
    The O(N^2) part is ops.flash_attention_qkv: the hand-written kernel on
    CUDA (vit.py:99-108), the plain f32-softmax version on the CPU or with
    use_kernels=False (vit.py:114-131).  In training, attn_drop > 0 drops
    attention probabilities, which takes the plain path as the JAX package
    does (vit.py:89-99, :128-129), and proj_drop drops the projection's
    output (:136)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, dtype=torch.float32,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.scale = qk_scale if qk_scale is not None else \
            (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.use_kernels = True

    def init_weights(self, gen: torch.Generator) -> None:
        for lin in (self.qkv, self.proj):
            fill_normal(lin.weight, 0.02, gen)
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        qkv = linear(self.qkv, x, self.dtype)
        if self.training and self.attn_drop > 0:
            out = flash_attention_qkv_plain(qkv, self.num_heads, self.scale,
                                            dropout_rate=self.attn_drop,
                                            rng=rng)
        else:
            out = flash_attention_qkv(qkv, self.num_heads, self.scale,
                                      use_kernels=self.use_kernels)
        out = linear(self.proj, out, self.dtype)
        return dropout(out, self.proj_drop, rng) if self.training else out


class MlpBlock(nn.Module):
    """Dense transformer MLP fc1 -> exact GELU -> fc2 (vit.py:211-274)
    through the fused FFN (ops.fused_dense_mlp, the expert kernels at E=1):
    the [tokens, hidden] activation never reaches device memory, in the
    forward or the backward.  In training with drop > 0 it runs the plain
    products with dropout after the GELU and after fc2, as the JAX package
    leaves its kernel there (vit.py:236-240, :268-273)."""

    def __init__(self, dim: int, hidden_dim: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = DenseParams(dim, hidden_dim)
        self.fc2 = DenseParams(hidden_dim, dim)
        self.drop = drop
        self.use_kernels = True

    def init_weights(self, gen: torch.Generator) -> None:
        for lin in (self.fc1, self.fc2):
            fill_normal(lin.weight, 0.02, gen)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if not (self.training and self.drop > 0):
            return fused_dense_mlp(x.contiguous(), self.fc1.weight,
                                   self.fc1.bias, self.fc2.weight,
                                   self.fc2.bias,
                                   use_kernels=self.use_kernels)
        cd = x.dtype
        out = fused_expert_ffn_plain(
            x.reshape(1, -1, x.shape[-1]), self.fc1.weight.to(cd)[None],
            self.fc1.bias[None], self.fc2.weight.to(cd)[None],
            self.fc2.bias[None], self.drop, rng, token_major=True)
        return dropout(out, self.drop, rng, batch_dim=1).reshape(x.shape)


class DenseBlock(nn.Module):
    """Pre-norm transformer block x + dp(attn(ln(x))); x + dp(mlp(ln(x)))
    (vit.py:289-355), dp the per-sample drop-path of rate drop_path_rate in
    training, two independent masks a block.  LayerNorm eps 1e-6 in f32,
    its output cast to the compute dtype; the residual stream stays in the
    compute dtype.  With ln_mlp (the JAX use_pallas_ln_mlp, vit.py:323-350)
    the second sublayer runs as one fused LayerNorm + MLP + residual
    (ops.fused_dense_ln_mlp) on the same norm2 and mlp parameters, wherever
    the residual stream is in the compute dtype and neither dropout nor
    drop-path is active."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 dtype=torch.float32, ln_mlp: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.ln_mlp = ln_mlp
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, dtype,
                              attn_drop, drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), drop)

    def _drop_path(self, h, rng):
        return drop_path(h, self.drop_path_rate, rng) if self.training \
            else h

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self._drop_path(
            self.attn(layer_norm(self.norm1, x).to(self.dtype), rng), rng)
        stochastic = self.training and (self.drop_path_rate > 0
                                        or self.mlp.drop > 0)
        if self.ln_mlp and x.dtype == self.dtype and not stochastic:
            fc1, fc2 = self.mlp.fc1, self.mlp.fc2
            return fused_dense_ln_mlp(
                x, self.norm2.weight, self.norm2.bias, fc1.weight, fc1.bias,
                fc2.weight, fc2.bias, eps=self.norm2.eps,
                use_kernels=self.mlp.use_kernels)
        return x + self._drop_path(
            self.mlp(layer_norm(self.norm2, x).to(self.dtype), rng), rng)


def remat(fn, rng: Optional[torch.Generator], *args):
    """fn(*args) under torch.utils.checkpoint (non-reentrant): only its
    inputs are kept for the backward, which runs it again (the JAX
    nn.remat, vit.py:419-420).  The recompute draws the same gate noise
    and dropout masks: `rng`'s state is set back to the one the first run
    started from, and restored after it, so draws after the block are not
    disturbed either (checkpoint restores only the default generators)."""
    if rng is None:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    start = rng.get_state()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        now = rng.get_state()
        rng.set_state(start)
        try:
            return fn(*a)
        finally:
            rng.set_state(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def run_block(backbone: nn.Module, blk: nn.Module, rng, *args):
    """blk(*args), rematerialised when the backbone trains with
    use_checkpointing."""
    if backbone.use_checkpointing and backbone.training \
            and torch.is_grad_enabled():
        return remat(blk, rng, *args)
    return blk(*args)


def drop_path_rates(rate: float, depth: int):
    """Block i's drop-path rate, rising linearly to `rate` (vit.py:413)."""
    return [rate * i / max(depth - 1, 1) for i in range(depth)]


def embed_tokens(backbone: nn.Module, x: torch.Tensor,
                 rng: Optional[torch.Generator] = None,
                 repeat: int = 1) -> torch.Tensor:
    """Patch tokens of images x [B, 3, H, W] behind the cls token (and the
    dist token of a distilled backbone), plus the position embedding, in
    the backbone's compute dtype, with the token dropout of rate drop_rate
    in training (vit.py:384-412).  repeat > 1: the tokens tiled
    task-major to [repeat * B, ...] before the dropout, which draws a mask
    a row (vit_moe.py:868-879)."""
    tokens = backbone.patch_embed(x)
    prefix = [backbone.cls_token]
    if getattr(backbone, "dist_token", None) is not None:
        prefix.append(backbone.dist_token)
    prefix = [t.to(backbone.dtype).expand(x.shape[0], -1, -1) for t in prefix]
    tokens = torch.cat(prefix + [tokens], dim=1) + backbone.pos_embed.to(
        backbone.dtype)
    if repeat > 1:
        tokens = tokens.repeat(repeat, 1, 1)
    if backbone.training:
        tokens = dropout(tokens, backbone.drop_rate, rng)
    return tokens


class VisionTransformer(nn.Module):
    """Dense ViT backbone: patch embed, cls token, position embedding and
    `depth` DenseBlocks; returns the final tokens [B, 1+N, C]
    (vit.py:358-430; reference models/backbones/vit.py:344-501).  Its MLPs
    run through the fused FFN (K3/K4 at E=1), or with ln_mlp the whole
    LayerNorm + MLP + residual through K5/K6, as the MoE backbone's dense
    blocks do.  drop_rate, attn_drop_rate and drop_path_rate act in
    training; use_checkpointing rematerialises each block in training.
    distilled adds the ``dist_token`` after the cls token."""

    def __init__(self, img_size=(512, 512), patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, dtype=torch.float32,
                 ln_mlp: bool = False, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 use_checkpointing: bool = False, distilled: bool = False,
                 **left_out):
        super().__init__()
        reject_left_out(left_out)
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.use_checkpointing = use_checkpointing
        num_patches = (img_size[0] // patch_size) * (img_size[1] // patch_size)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) \
            if distilled else None
        self.pos_embed = nn.Parameter(torch.zeros(
            1, num_patches + (2 if distilled else 1), embed_dim))
        self.blocks = nn.ModuleList(
            DenseBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale,
                       dtype, ln_mlp, drop_rate, attn_drop_rate, dpr)
            for dpr in drop_path_rates(drop_path_rate, depth))

    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.zeros_(self.cls_token)
        fill_normal(self.pos_embed, 0.02, gen)
        if self.dist_token is not None:
            fill_normal(self.dist_token, 0.02, gen)

    def forward(self, x: torch.Tensor, task_id=None,
                noise: Optional[torch.Generator] = None) -> torch.Tensor:
        """task_id is accepted and ignored, for one call shape with the MoE
        backbone (vit.py:380); noise is the generator of the dropout and
        drop-path masks in training."""
        tokens = embed_tokens(self, x, noise)
        for blk in self.blocks:
            tokens = run_block(self, blk, noise, tokens, noise)
        return tokens
