"""The flagship model: ViT-small-MoE, multi-gate, 5 PASCAL tasks
(defaults of __graft_entry__.py:build_flagship :32-81: train capacity
factor 1.25, eval 2.0, gate noise std 1.0)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from m3vit_tpu_torch.models.heads import VisionTransformerUpHead
from m3vit_tpu_torch.models.multitask import MultiTaskModel
from m3vit_tpu_torch.models.vit_moe import VisionTransformerMoE
from m3vit_tpu_torch.tasks import TaskSpec, parse_task_dictionary
from m3vit_tpu_torch.utils.device import resolve_device

PASCAL_TASK_DICT = {
    "include_semseg": True,
    "include_human_parts": True,
    "include_sal": True,
    "include_edge": True,
    "include_normals": True,
    "edge_w": 0.95,
}


def init_weights(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded init of every module that defines ``init_weights``."""
    for m in model.modules():
        if m is not model and hasattr(m, "init_weights"):
            m.init_weights(gen)


def build_flagship(img: int = 512, embed: int = 384, depth: int = 12,
                   heads: int = 6, experts: int = 16, top_k: int = 4,
                   tasks: Optional[List[TaskSpec]] = None,
                   dtype=torch.bfloat16, capacity_factor: float = 1.25,
                   eval_capacity_factor: float = 2.0,
                   vmoe_noisy_std: float = 1.0, shared_prefix: bool = False,
                   expert_weights_int8: bool = False, ln_mlp: bool = False,
                   device=None, seed: int = 0,
                   **left_out) -> Tuple[MultiTaskModel, List[TaskSpec]]:
    """ViT-small-MoE multi-gate multi-task model with f32 weights drawn
    from `seed`, computing in `dtype`, returned in eval mode (``.train()``
    for the train path).  expert_weights_int8 builds int8 expert banks
    (load them with ``serve.quantize.quantize_expert_state_dict``; serving
    only); ln_mlp fuses the dense blocks' LayerNorm + MLP + residual (the
    JAX use_pallas_ln_mlp).  Runs on CUDA unless device="cpu" is passed;
    raises when CUDA is absent and no device was given."""
    dev = resolve_device(device)
    tasks = tasks or parse_task_dictionary("PASCALContext",
                                           PASCAL_TASK_DICT)[0]
    backbone = VisionTransformerMoE(
        img_size=(img, img), patch_size=16, embed_dim=embed, depth=depth,
        num_heads=heads, mlp_ratio=4.0, qkv_bias=True, moe_mlp_ratio=1.0,
        moe_experts=experts, moe_top_k=top_k, multi_gate=True,
        num_tasks=len(tasks), vmoe_noisy_std=vmoe_noisy_std,
        capacity_factor=capacity_factor,
        eval_capacity_factor=eval_capacity_factor, dtype=dtype,
        expert_weights_int8=expert_weights_int8, ln_mlp=ln_mlp, **left_out)
    decoders = {
        t.name: VisionTransformerUpHead(
            img_size=(img, img), patch_size=16, embed_dim=embed,
            num_classes=t.num_output, dtype=dtype)
        for t in tasks
    }
    model = MultiTaskModel(backbone, decoders, [t.name for t in tasks],
                           multi_gate=True, shared_prefix=shared_prefix)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), tasks
