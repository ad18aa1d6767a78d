"""The decoupled gate network: a small ViT whose token features drive the MoE
routers (counterpart of m3vit_tpu/models/gate_vit.py; reference
models/backbones/vits_gate.py).

``GateViT`` embeds the image like the backbone, adds fixed 2-D sin-cos
position embeddings (a zero one for the cls token), runs its dense blocks
(the port's attention and fused MLP: K1 and K3 at E=1 on the card, their
backward kernels in training) and returns every token through a final f32
LayerNorm.  ``MoEViTWithGate`` hands those features to the MoE backbone as
the gates' input (``gate_inp``), so every router has the gate network's
width (the backbone's ``gate_dim``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from m3vit_tpu_torch.models.vit import (
    DenseBlock,
    PatchEmbed,
    fill_normal,
    layer_norm,
)


def sincos_2d_pos_embed(h: int, w: int, dim: int,
                        temperature: float = 10000.0) -> np.ndarray:
    """Fixed 2-D sin-cos position embedding [1, h*w, dim] f32: sin and cos
    of the column, then of the row, at dim / 4 frequencies each
    (gate_vit.py:24-39; reference vits_gate.py:69-85)."""
    assert dim % 4 == 0
    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32),
                                 np.arange(h, dtype=np.float32))
    pos_dim = dim // 4
    omega = 1.0 / temperature ** (
        np.arange(pos_dim, dtype=np.float32) / pos_dim)
    out_w = np.einsum("m,d->md", grid_w.flatten(), omega)
    out_h = np.einsum("m,d->md", grid_h.flatten(), omega)
    pos = np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)],
        axis=1)[None]
    return pos.astype(np.float32)


class GateViT(nn.Module):
    """A ViT producing per-token gate features [B, 1+N, embed_dim] f32
    (gate_vit.py:42-77): patch embed, a cls token, the fixed position
    embedding, `depth` dense blocks with qkv bias, a final LayerNorm."""

    def __init__(self, img_size=(512, 512), patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embed_dim = embed_dim
        h, w = img_size[0] // patch_size, img_size[1] // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        pos = np.concatenate([np.zeros((1, 1, embed_dim), np.float32),
                              sincos_2d_pos_embed(h, w, embed_dim)], 1)
        self.register_buffer("pos_embed", torch.from_numpy(pos),
                             persistent=False)
        self.blocks = nn.ModuleList(
            DenseBlock(embed_dim, num_heads, mlp_ratio, True, None, dtype)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def init_weights(self, gen: torch.Generator) -> None:
        fill_normal(self.cls_token, 1e-6, gen)   # flax normal(1e-6)

    def forward(self, x: torch.Tensor,
                noise: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(self.dtype).expand(x.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], 1) + self.pos_embed.to(self.dtype)
        for blk in self.blocks:
            tokens = blk(tokens, noise)
        return layer_norm(self.norm, tokens.float())


def vit_gate_small(img_size: Tuple[int, int] = (512, 512),
                   dtype=torch.float32) -> GateViT:
    """d 384, 12 blocks, 12 heads of 32 (gate_vit.py:80-82)."""
    return GateViT(img_size=img_size, embed_dim=384, depth=12, num_heads=12,
                   dtype=dtype)


def vit_gate_base(img_size: Tuple[int, int] = (512, 512),
                  dtype=torch.float32) -> GateViT:
    """d 768, 12 blocks, 12 heads of 64 (gate_vit.py:85-87)."""
    return GateViT(img_size=img_size, embed_dim=768, depth=12, num_heads=12,
                   dtype=dtype)


class MoEViTWithGate(nn.Module):
    """The MoE backbone routed by a gate network's features
    (gate_vit.py:90-101; reference VisionTransformerMoCoWithGate,
    vits_gate.py:24-37): the gate model runs once a call, and every other
    argument goes to the backbone (``backbone``, ``gate_model`` name the
    two in the state dict)."""

    def __init__(self, backbone: nn.Module, gate_model: GateViT):
        super().__init__()
        self.backbone = backbone
        self.gate_model = gate_model

    def forward(self, x: torch.Tensor, task_id=None,
                noise: Optional[torch.Generator] = None, **kw):
        return self.backbone(x, task_id, noise,
                             gate_inp=self.gate_model(x, noise), **kw)
