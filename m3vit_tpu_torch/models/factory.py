"""Models from a config, and the flagship.

``build_model(p)`` is the counterpart of m3vit_tpu/models/factory.py
(build_backbone :53-121, build_head :146-167, build_model :248): it reads
the plain dict a reference-schema YAML holds and builds the ``baseline``
model on the dense or the MoE ViT with PUP heads, single- or multi-task.
``build_flagship`` is ViT-small-MoE, multi-gate, 5 PASCAL tasks (defaults
of __graft_entry__.py:build_flagship :32-81: train capacity factor 1.25,
eval 2.0, gate noise std 1.0).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from m3vit_tpu_torch.models.heads import VisionTransformerUpHead
from m3vit_tpu_torch.models.multitask import MultiTaskModel, SingleTaskModel
from m3vit_tpu_torch.models.vit import VisionTransformer
from m3vit_tpu_torch.models.vit_moe import VisionTransformerMoE
from m3vit_tpu_torch.moe.dispatch import parse_capacity_factor
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


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _img_size(kw) -> Tuple[int, int]:
    v = kw.get("img_size", (512, 512))
    return (v, v) if isinstance(v, int) else tuple(v)


def build_backbone(p: Dict, num_tasks: int):
    """The backbone of config `p` (factory.py:53-121): the MoE ViT for
    "VisionTransformer_moe", the dense ViT for "VisionTransformer" /
    "VisionTransformer_dense"."""
    kw = dict(p.get("backbone_kwargs") or {})
    name = p["backbone"]
    common = dict(
        img_size=_img_size(kw),
        patch_size=int(kw.get("patch_size", 16)),
        embed_dim=int(kw.get("embed_dim", 384)),
        depth=int(kw.get("depth", 12)),
        num_heads=int(kw.get("num_heads", 6)),
        mlp_ratio=float(kw.get("mlp_ratio", 4.0)),
        qkv_bias=bool(kw.get("qkv_bias", True)),
        drop_rate=float(kw.get("drop_rate", 0.0)),
        attn_drop_rate=float(kw.get("attn_drop_rate", 0.0)),
        drop_path_rate=float(kw.get("drop_path_rate", 0.0)),
        distilled=bool(kw.get("distilled", False)),
        dtype=_DTYPES[p.get("compute_dtype", "bfloat16")],
        ln_mlp=bool(p.get("use_pallas_ln_mlp", False)),
        use_checkpointing=bool(p.get("use_checkpointing", False)),
    )
    if name == "VisionTransformer_moe":
        if int(p.get("gate_task_specific_dim", -1)) > 0:
            raise NotImplementedError(
                "gate_task_specific_dim (the task-conditioned gate) is not "
                "ported to m3vit_tpu_torch (ROADMAP queue 1 item 7)")
        gate_dim = int(kw.get("gate_dim", -1))
        n = int(p.get("moe_num_tasks", gate_dim - common["embed_dim"]
                      if gate_dim > 0 else 0))
        return VisionTransformerMoE(
            moe_mlp_ratio=float(kw.get("moe_mlp_ratio",
                                       p.get("moe_mlp_ratio", -1))),
            moe_experts=int(p.get("moe_experts", kw.get("moe_experts", 16))),
            moe_top_k=int(p.get("moe_top_k", kw.get("moe_top_k", 4))),
            vmoe_noisy_std=float(p.get("vmoe_noisy_std",
                                       kw.get("vmoe_noisy_std", 1.0))),
            multi_gate=bool(p.get("multi_gate", False)),
            num_tasks=n if n > 0 else (num_tasks or 1),
            capacity_factor=parse_capacity_factor(
                p.get("moe_capacity_factor", 2.0)),
            eval_capacity_factor=parse_capacity_factor(
                p.get("moe_eval_capacity_factor", 4.0)),
            moe_gate_type=str(p.get("moe_gate_type", "noisy_vmoe")),
            expert_weights_int8=bool(p.get("expert_weights_int8", False)),
            **{k: p.get(k, False) for k in (
                "scan_blocks", "expert_prune", "regu_experts_fromtask",
                "sem_force", "regu_sem", "regu_subimage",
                "gate_input_ahead")},
            **common)
    if name in ("VisionTransformer", "VisionTransformer_dense"):
        return VisionTransformer(**common)
    raise NotImplementedError(
        f"backbone {name!r} is not ported to m3vit_tpu_torch (CNN backbones "
        f"and the token variant come with ROADMAP queue 1 items 7 and 8)")


def build_head(p: Dict, num_output: int) -> VisionTransformerUpHead:
    """The PUP head of config `p` for a task with `num_output` channels
    (factory.py:146-167, its VisionTransformerUpHead branch: four 3x3
    convs and four upsamplings), returning TAM's features in training when
    model_kwargs.tam is set."""
    name = p.get("head", "VisionTransformerUpHead")
    if name != "VisionTransformerUpHead":
        raise NotImplementedError(
            f"head {name!r} is not ported to m3vit_tpu_torch (the token, "
            f"deeplab and hrnet heads come with ROADMAP queue 1 items 7 and "
            f"8)")
    kw = dict(p.get("head_kwargs") or {})
    shape = (int(kw.get("num_conv", 4)), int(kw.get(
        "num_upsampe_layer", kw.get("num_upsample_layer", 4))),
        bool(kw.get("conv3x3_conv1x1", True)))
    if shape != (4, 4, True):
        raise NotImplementedError(
            f"PUP head (num_conv, num_upsample_layer, conv3x3_conv1x1) = "
            f"{shape} is not ported; m3vit_tpu_torch has (4, 4, True)")
    return VisionTransformerUpHead(
        img_size=_img_size(kw), patch_size=int(kw.get("patch_size", 16)),
        embed_dim=int(kw.get("embed_dim", 384)), num_classes=num_output,
        dtype=_DTYPES[p.get("compute_dtype", "bfloat16")],
        return_tam_features=bool((p.get("model_kwargs") or {}).get(
            "tam", False)))


def build_model(p: Dict, device=None, seed: int = 0
                ) -> Tuple[torch.nn.Module, List[TaskSpec]]:
    """The ``baseline`` model of config `p` (factory.py:248-361): a
    multi-task model (multi-gate or one shared router) for setup
    multi_task; for setup single_task, the first task's SingleTaskModel on
    the dense ViT, or a MultiTaskModel of the config's tasks on the MoE
    ViT, as the JAX package builds them; model_kwargs.tam adds TAM at the
    levels tam_level{0,1,2} (each on unless set false; factory.py:341-352).
    use_checkpointing rematerialises the backbone's blocks in training.
    Weights are f32, drawn from `seed`; the model is returned in eval mode
    on the card unless device="cpu" (raises when CUDA is absent and no
    device was given)."""
    dev = resolve_device(device)
    model_name = p.get("model", "baseline")
    if model_name != "baseline":
        item, what = (7, "the token variant") if model_name.startswith(
            "token") else (8, "the MTL methods and mixture_baseline")
        raise NotImplementedError(
            f"model {model_name!r} is not ported to m3vit_tpu_torch ({what}: "
            f"ROADMAP queue 1 item {item})")
    tasks = parse_task_dictionary(p["train_db_name"], p["task_dictionary"])[0]
    names = [t.name for t in tasks]
    backbone = build_backbone(p, len(tasks))
    decoders = {t.name: build_head(p, t.num_output) for t in tasks}
    multi_gate = bool(p.get("multi_gate", False))
    if p["setup"] == "single_task" and isinstance(backbone,
                                                  VisionTransformer):
        model = SingleTaskModel(backbone, decoders[names[0]], names[0])
    elif p["setup"] in ("single_task", "multi_task"):
        mk = p.get("model_kwargs") or {}
        model = MultiTaskModel(
            backbone, decoders, names, multi_gate=multi_gate,
            shared_prefix=bool(p.get("shared_prefix", False)),
            tam=bool(mk.get("tam", False)) and p["setup"] == "multi_task",
            tam_levels=[bool(mk.get(f"tam_level{i}", True))
                        for i in range(3)],
            num_outputs={t.name: t.num_output for t in tasks},
            stacked_tasks=p.get("stacked_tasks", False),
            scan_tasks=p.get("scan_tasks", False))
    else:
        raise ValueError(f"setup {p['setup']!r}")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), tasks
