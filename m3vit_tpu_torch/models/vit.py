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

from m3vit_tpu_torch.ops.expert_ffn import fused_dense_mlp
from m3vit_tpu_torch.ops.flash_attention import flash_attention_qkv
from m3vit_tpu_torch.ops.ln_mlp import fused_dense_ln_mlp


#: options of the JAX package this port leaves out; asking for one raises
LEFT_OUT = (
    "scan_blocks", "stacked_tasks", "scan_tasks", "expert_prune",
    "regu_experts_fromtask", "sem_force", "regu_sem", "regu_subimage",
    "distilled",
    "gate_input_ahead", "drop_rate", "attn_drop_rate", "drop_path_rate",
)


def reject_left_out(knobs: Dict) -> None:
    for k, v in knobs.items():
        if k not in LEFT_OUT:
            raise TypeError(f"unexpected argument {k!r}")
        if v:
            raise NotImplementedError(
                f"{k} is not ported to m3vit_tpu_torch (JAX package only)")


@torch.no_grad()
def fill_normal(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=gen))


@torch.no_grad()
def fill_uniform(p: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 whatever x's dtype (flax LayerNorm(dtype=f32))."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


def linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """nn.Linear on x with its f32 weight and bias cast to `dtype`."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """nn.Conv2d on x with its f32 weight and bias cast to `dtype`."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    conv.stride, conv.padding)


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
    use_kernels=False (vit.py:114-131)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = linear(self.qkv, x, self.dtype)
        out = flash_attention_qkv(qkv, self.num_heads, self.scale,
                                  use_kernels=self.use_kernels)
        return linear(self.proj, out, self.dtype)


class MlpBlock(nn.Module):
    """Dense transformer MLP fc1 -> exact GELU -> fc2 (vit.py:211-274),
    always through the fused FFN (ops.fused_dense_mlp, the expert kernels at
    E=1): the [tokens, hidden] activation never reaches device memory, in
    the forward or the backward."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = DenseParams(dim, hidden_dim)
        self.fc2 = DenseParams(hidden_dim, dim)
        self.use_kernels = True

    def init_weights(self, gen: torch.Generator) -> None:
        for lin in (self.fc1, self.fc2):
            fill_normal(lin.weight, 0.02, gen)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_dense_mlp(x.contiguous(), self.fc1.weight, self.fc1.bias,
                               self.fc2.weight, self.fc2.bias,
                               use_kernels=self.use_kernels)


class DenseBlock(nn.Module):
    """Pre-norm transformer block x + attn(ln(x)); x + mlp(ln(x))
    (vit.py:289-355; drop-path and dropout are not ported, the flagship's
    rates are 0).  LayerNorm eps 1e-6 in f32, its output cast to the compute
    dtype; the residual stream stays in the compute dtype.  With ln_mlp
    (the JAX use_pallas_ln_mlp, vit.py:323-350) the second sublayer runs
    as one fused LayerNorm + MLP + residual (ops.fused_dense_ln_mlp) on the
    same norm2 and mlp parameters, wherever the residual stream is in the
    compute dtype."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 dtype=torch.float32, ln_mlp: bool = False):
        super().__init__()
        self.dtype = dtype
        self.ln_mlp = ln_mlp
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.norm1, x).to(self.dtype))
        if self.ln_mlp and x.dtype == self.dtype:
            fc1, fc2 = self.mlp.fc1, self.mlp.fc2
            return fused_dense_ln_mlp(
                x, self.norm2.weight, self.norm2.bias, fc1.weight, fc1.bias,
                fc2.weight, fc2.bias, eps=self.norm2.eps,
                use_kernels=self.mlp.use_kernels)
        return x + self.mlp(layer_norm(self.norm2, x).to(self.dtype))


def embed_tokens(backbone: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Patch tokens of images x [B, 3, H, W] behind the cls token, plus the
    position embedding, in the backbone's compute dtype
    (vit.py:384-407)."""
    tokens = backbone.patch_embed(x)
    cls = backbone.cls_token.to(backbone.dtype).expand(x.shape[0], -1, -1)
    return torch.cat([cls, tokens], dim=1) + backbone.pos_embed.to(
        backbone.dtype)


class VisionTransformer(nn.Module):
    """Dense ViT backbone: patch embed, cls token, position embedding and
    `depth` DenseBlocks; returns the final tokens [B, 1+N, C]
    (vit.py:358-430; reference models/backbones/vit.py:344-501).  Its MLPs
    run through the fused FFN (K3/K4 at E=1), or with ln_mlp the whole
    LayerNorm + MLP + residual through K5/K6, as the MoE backbone's dense
    blocks do."""

    def __init__(self, img_size=(512, 512), patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, dtype=torch.float32,
                 ln_mlp: bool = False, **left_out):
        super().__init__()
        reject_left_out(left_out)
        self.dtype = dtype
        num_patches = (img_size[0] // patch_size) * (img_size[1] // patch_size)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1,
                                                  embed_dim))
        self.blocks = nn.ModuleList(
            DenseBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale,
                       dtype, ln_mlp) for _ in range(depth))

    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.zeros_(self.cls_token)
        fill_normal(self.pos_embed, 0.02, gen)

    def forward(self, x: torch.Tensor, task_id=None,
                noise: Optional[torch.Generator] = None) -> torch.Tensor:
        """task_id and noise are accepted and ignored, for one call shape
        with the MoE backbone (vit.py:380)."""
        tokens = embed_tokens(self, x)
        for blk in self.blocks:
            tokens = blk(tokens)
        return tokens
