"""Models from a config, and the flagship.

``build_model(p)`` is the counterpart of m3vit_tpu/models/factory.py
(build_backbone :53-121, build_head :146-167, build_model :248): it reads
the plain dict a reference-schema YAML holds and builds the ``baseline``
model on the dense or the MoE ViT with PUP heads, single- or multi-task,
the task-conditioned model (gate_task_specific_dim > 0, one shared
router), or the token persistent-sharing model (its backbone names,
factory.py:276-318); on the CNN backbones (ResNet-18/50, HRNet-W18,
MobileNetV3; factory.py:124-142) with the DeepLab or HRNet heads
(:165-171), the baseline and the MTL methods Cross-Stitch, NDDR-CNN, MTAN,
PAD-Net and MTI-Net (_build_mtl_method, :176-238).
``build_flagship`` is ViT-small-MoE, multi-gate, 5 PASCAL tasks (defaults
of __graft_entry__.py:build_flagship :32-81: train capacity factor 1.25,
eval 2.0, gate noise std 1.0).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from m3vit_tpu_torch.models.cnn_heads import DeepLabHead, HighResolutionHead
from m3vit_tpu_torch.models.gate_vit import (
    MoEViTWithGate,
    vit_gate_base,
    vit_gate_small,
)
from m3vit_tpu_torch.models.heads import VisionTransformerUpHead
from m3vit_tpu_torch.models.hrnet import HighResolutionNet, hrnet_w18
from m3vit_tpu_torch.models.mobilenetv3 import MobileNetV3
from m3vit_tpu_torch.models.mtl_methods import (
    MTAN,
    MTINet,
    NDDRCNN,
    CrossStitchNetwork,
    PADNet,
)
from m3vit_tpu_torch.models.multitask import (
    MultiTaskModel,
    SingleTaskModel,
)
from m3vit_tpu_torch.models.token_moe import (
    TokenMultiTaskModel,
    TokenVisionTransformerMoE,
)
from m3vit_tpu_torch.models.resnet import ResNet, resnet18, resnet50
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
                   device=None, seed: int = 0, stacked_tasks: bool = False,
                   gate_model: Optional[str] = None,
                   **knobs) -> Tuple[MultiTaskModel, List[TaskSpec]]:
    """ViT-small-MoE multi-gate multi-task model with f32 weights drawn
    from `seed`, computing in `dtype`, returned in eval mode (``.train()``
    for the train path).  expert_weights_int8 builds int8 expert banks
    (load them with ``serve.quantize.quantize_expert_state_dict``; serving
    only); ln_mlp fuses the dense blocks' LayerNorm + MLP + residual (the
    JAX use_pallas_ln_mlp); stacked_tasks runs the task passes as one
    stacked pass; gate_model "small" / "base" routes on a decoupled gate
    ViT's features (``MoEViTWithGate``, models/gate_vit.py); `knobs` go to
    the backbone (the research knobs, distilled, dropout, remat).  Runs on
    CUDA unless device="cpu" is passed; raises when CUDA is absent and no
    device was given."""
    dev = resolve_device(device)
    tasks = tasks or parse_task_dictionary("PASCALContext",
                                           PASCAL_TASK_DICT)[0]
    gate_vit = None
    if gate_model is not None:
        gate_vit = GATE_MODELS[gate_model]((img, img), dtype)
        knobs["gate_dim"] = gate_vit.embed_dim
    backbone = VisionTransformerMoE(
        img_size=(img, img), patch_size=16, embed_dim=embed, depth=depth,
        num_heads=heads, mlp_ratio=4.0, qkv_bias=True, moe_mlp_ratio=1.0,
        moe_experts=experts, moe_top_k=top_k, multi_gate=True,
        num_tasks=len(tasks), vmoe_noisy_std=vmoe_noisy_std,
        capacity_factor=capacity_factor,
        eval_capacity_factor=eval_capacity_factor, dtype=dtype,
        expert_weights_int8=expert_weights_int8, ln_mlp=ln_mlp, **knobs)
    if gate_vit is not None:
        backbone = MoEViTWithGate(backbone, gate_vit)
    decoders = {
        t.name: VisionTransformerUpHead(
            img_size=(img, img), patch_size=16, embed_dim=embed,
            num_classes=t.num_output, dtype=dtype)
        for t in tasks
    }
    model = MultiTaskModel(backbone, decoders, [t.name for t in tasks],
                           multi_gate=True, shared_prefix=shared_prefix,
                           stacked_tasks=stacked_tasks)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), tasks


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: build_flagship's decoupled gate ViTs (gate_vit.py:80-89)
GATE_MODELS = {"small": vit_gate_small, "base": vit_gate_base}

#: the backbone names of the token variant (factory.py:276-277)
TOKEN_BACKBONES = ("TokenVisionTransformer_moe", "Token_VisionTransformer_moe",
                   "token_moe")

#: the MTL methods of the CNN configs, by the JAX factory's names
#: (factory.py:253-255; ``pad_net`` is the configs' spelling of padnet)
MTL_METHODS = ("cross_stitch", "nddr_cnn", "mtan", "padnet", "mti_net")

_ITEM8B = "ROADMAP queue 1 item 8b"


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
            gate_task_specific_dim=int(p.get("gate_task_specific_dim", -1)),
            scan_blocks=p.get("scan_blocks", False),
            # the research knobs (factory.py:100-111)
            expert_prune=bool(p.get("expert_prune", False)),
            prune_threshold=float(p.get("prune_threshold", 0.1)),
            regu_experts_fromtask=bool(p.get("regu_experts_fromtask", False)),
            num_experts_pertask=int(p.get("num_experts_pertask", -1)),
            **{k: bool(p.get(k, False)) for k in (
                "sem_force", "regu_sem", "regu_subimage",
                "gate_input_ahead")},
            **common)
    if name in ("VisionTransformer", "VisionTransformer_dense"):
        return VisionTransformer(**common)
    # the CNN backbones (factory.py:124-142); backbone_kwargs.pretrained
    # is ignored, as there: they start from the seeded init
    dtype = common["dtype"]
    if name in ("resnet18", "resnet50"):
        return (resnet18 if name == "resnet18" else resnet50)(
            dilated=bool(kw.get("dilated", False)), dtype=dtype)
    if name == "hrnet_w18":
        return hrnet_w18(dtype=dtype)
    if name in ("mobilenetv3", "mobilenetv3_large", "mobilenetv3_small"):
        # backbone_kwargs.mode picks the variant, which the JAX factory
        # ignores (it reads the name alone, factory.py:141)
        return MobileNetV3(kw.get("mode") or (
            "small" if name.endswith("small") else "large"), dtype=dtype)
    raise NotImplementedError(
        f"backbone {name!r} is not ported to m3vit_tpu_torch")


#: the CNN backbones (factory.py:124-142), by class and by config name
CNN_BACKBONES = (ResNet, HighResolutionNet, MobileNetV3)
CNN_NAMES = ("resnet18", "resnet50", "hrnet_w18", "mobilenetv3",
             "mobilenetv3_large", "mobilenetv3_small")


def is_cnn_model(model: torch.nn.Module) -> bool:
    return any(isinstance(m, CNN_BACKBONES) for m in model.modules())


def feature_channels(backbone: torch.nn.Module) -> int:
    """The channels a head reads from a CNN backbone: the last stage's, or
    HRNet's four streams concatenated."""
    if isinstance(backbone, ResNet):
        return backbone.stage_channels[-1]
    if isinstance(backbone, HighResolutionNet):
        return sum(backbone.channels)
    if isinstance(backbone, MobileNetV3):
        return backbone.out_channels
    raise TypeError(f"{type(backbone).__name__} is not a CNN backbone")


def build_token_backbone(p: Dict, num_tasks: int) -> TokenVisionTransformerMoE:
    """The token persistent-sharing backbone of config `p`
    (factory.py:278-309), with its own defaults: moe_mlp_ratio 1.0,
    gate_task_specific_dim 64, use_checkpointing off."""
    kw = dict(p.get("backbone_kwargs") or {})
    return TokenVisionTransformerMoE(
        img_size=_img_size(kw), patch_size=int(kw.get("patch_size", 16)),
        embed_dim=int(kw.get("embed_dim", 384)),
        depth=int(kw.get("depth", 12)), num_heads=int(kw.get("num_heads", 6)),
        mlp_ratio=float(kw.get("mlp_ratio", 4.0)),
        moe_mlp_ratio=float(kw.get("moe_mlp_ratio", 1.0)),
        moe_experts=int(p.get("moe_experts", 16)),
        moe_top_k=int(p.get("moe_top_k", 4)),
        multi_gate=bool(p.get("multi_gate", False)), num_tasks=num_tasks,
        gate_task_specific_dim=int(p.get("gate_task_specific_dim", 64)),
        share_gamma=float(p.get("share_gamma", 0.5)),
        bootstrap_share_gamma=float(p.get("bootstrap_share_gamma", 0.3)),
        bootstrap_first_moe=bool(p.get("bootstrap_first_moe", True)),
        share_reg_lambda=float(p.get("share_reg_lambda", 0.01)),
        capacity_factor=parse_capacity_factor(
            p.get("moe_capacity_factor", 2.0)),
        eval_capacity_factor=parse_capacity_factor(
            p.get("moe_eval_capacity_factor", 4.0)),
        batched_dispatch=bool(p.get("batched_dispatch", False)),
        dtype=_DTYPES[p.get("compute_dtype", "bfloat16")],
        use_checkpointing=bool(p.get("use_checkpointing", False)))


def build_head(p: Dict, num_output: int, in_channels: int = 0
               ) -> torch.nn.Module:
    """The head of config `p` for a task with `num_output` channels
    (factory.py:146-171): the PUP head (its VisionTransformerUpHead
    branch: four 3x3 convs and four upsamplings), returning TAM's
    features in training when model_kwargs.tam is set; or, on a CNN
    backbone's `in_channels`, the ``deeplab`` (ASPP) or ``hrnet`` head."""
    name = p.get("head", "VisionTransformerUpHead")
    dtype = _DTYPES[p.get("compute_dtype", "bfloat16")]
    if name == "deeplab":
        return DeepLabHead(in_channels, num_output, dtype=dtype)
    if name == "hrnet":
        return HighResolutionHead(in_channels, num_output, dtype=dtype)
    # the reference's token head is the same PUP head (factory.py:151-153)
    if name not in ("VisionTransformerUpHead",
                    "TokenVisionTransformerUpHead"):
        raise NotImplementedError(
            f"head {name!r} is not ported to m3vit_tpu_torch")
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
        dtype=dtype,
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
    A multi-task config with gate_task_specific_dim > 0 and no multi_gate
    runs one backbone pass a task, each with its task feature on the one
    router (the TaskConditionedMultiTaskModel, factory.py:334-338); a token
    backbone name the TokenMultiTaskModel, whatever `model` says
    (factory.py:276-318).  use_checkpointing rematerialises the backbone's
    blocks in training.  On a CNN backbone (CNN_NAMES) the baseline and
    the MTL methods (MTL_METHODS, ``_build_mtl_method``).
    Weights are f32, drawn from `seed`; the model is returned in eval mode
    on the card unless device="cpu" (raises when CUDA is absent and no
    device was given).  A CNN model is built on the device and drawn there
    by a generator of that device, so its weights depend on the device's
    generator as well as on the seed; the other models are drawn on the
    CPU."""
    dev = resolve_device(device)
    model_name = p.get("model", "baseline")
    # the configs' spelling of padnet (factory.py:253)
    model_name = {"pad_net": "padnet"}.get(model_name, model_name)
    tasks = parse_task_dictionary(p["train_db_name"], p["task_dictionary"])[0]
    if model_name not in ("baseline", "token_moe") + MTL_METHODS:
        raise NotImplementedError(
            f"model {model_name!r} is not ported to m3vit_tpu_torch "
            f"(papnet_vit, jtrl and mixture_baseline: {_ITEM8B})")
    if model_name in MTL_METHODS or p.get("backbone") in CNN_NAMES:
        # built and drawn on the device: a CNN config holds up to 160M
        # parameters, which the CPU takes seconds to draw
        with torch.device(dev):
            model = _build_mtl_method(p, model_name, tasks) \
                if model_name in MTL_METHODS else _compose(p, tasks)
        init_weights(model, torch.Generator(device=dev).manual_seed(seed))
        return model.eval(), tasks
    model = _compose(p, tasks)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), tasks


def _compose(p: Dict, tasks: List[TaskSpec]) -> torch.nn.Module:
    """The backbone, a head a task and the single- or multi-task model
    around them (build_model's cases but the MTL methods)."""
    names = [t.name for t in tasks]
    if p.get("backbone") in TOKEN_BACKBONES:
        decoders = {t.name: build_head(p, t.num_output) for t in tasks}
        return TokenMultiTaskModel(build_token_backbone(p, len(tasks)),
                                   decoders, names)
    backbone = build_backbone(p, len(tasks))
    vit = isinstance(backbone, (VisionTransformer, VisionTransformerMoE))
    cin = 0 if vit else feature_channels(backbone)
    decoders = {t.name: build_head(p, t.num_output, cin) for t in tasks}
    multi_gate = bool(p.get("multi_gate", False))
    conditioned = p["setup"] == "multi_task" and int(
        p.get("gate_task_specific_dim", -1)) > 0
    if conditioned and not multi_gate:
        # the JAX TaskConditionedMultiTaskModel has no stacked form
        return MultiTaskModel(
            backbone, decoders, names, multi_gate=True,
            shared_prefix=bool(p.get("shared_prefix", False)),
            scan_tasks=p.get("scan_tasks", False))
    if p["setup"] == "single_task" and not isinstance(
            backbone, VisionTransformerMoE):
        return SingleTaskModel(backbone, decoders[names[0]], names[0])
    if p["setup"] not in ("single_task", "multi_task"):
        raise ValueError(f"setup {p['setup']!r}")
    mk = p.get("model_kwargs") or {}
    return MultiTaskModel(
        backbone, decoders, names, multi_gate=multi_gate,
        shared_prefix=bool(p.get("shared_prefix", False)),
        tam=bool(mk.get("tam", False)) and p["setup"] == "multi_task",
        tam_levels=[bool(mk.get(f"tam_level{i}", True)) for i in range(3)],
        num_outputs={t.name: t.num_output for t in tasks},
        # the stacked pass is a multi-gate form (multitask.py:157)
        stacked_tasks=bool(p.get("stacked_tasks", False)) and multi_gate,
        scan_tasks=p.get("scan_tasks", False))


def _build_mtl_method(p: Dict, model_name: str,
                      tasks: List[TaskSpec]) -> torch.nn.Module:
    """The MTL method `model_name` of config `p` (factory.py:176-238):
    Cross-Stitch and NDDR-CNN on one ResNet a task, MTAN on one shared
    ResNet (its 2x2 max-pools after stages 0-2, or after stage 0 alone
    when dilated), PAD-Net on a ResNet, MTI-Net on HRNet-W18 with HRNet
    heads.  The ResNet is ResNet-50 when the backbone's name has "50",
    else ResNet-18, dilated unless backbone_kwargs.dilated is false (so
    PAD-Net on an hrnet_w18 config runs on an undilated ResNet-18, as the
    JAX factory builds it).  The auxiliary tasks are those of
    auxilary_task_dictionary, else the tasks."""
    names = [t.name for t in tasks]
    aux = tasks
    if "auxilary_task_dictionary" in p:
        aux = parse_task_dictionary(p["train_db_name"],
                                    p["auxilary_task_dictionary"])[0]
    aux_names = [t.name for t in aux]
    num_outputs = {t.name: t.num_output for t in list(aux) + list(tasks)}
    dtype = _DTYPES[p.get("compute_dtype", "bfloat16")]
    dilated = bool((p.get("backbone_kwargs") or {}).get("dilated", True))

    def resnet_bb() -> ResNet:
        make = resnet50 if "50" in str(p.get("backbone", "resnet18")) \
            else resnet18
        return make(dilated=dilated, dtype=dtype)

    if model_name in ("cross_stitch", "nddr_cnn"):
        backbones = {t: resnet_bb() for t in names}
        channels = backbones[names[0]].stage_channels
        heads = {t.name: build_head(p, t.num_output, channels[-1])
                 for t in tasks}
        cls = CrossStitchNetwork if model_name == "cross_stitch" else NDDRCNN
        return cls(backbones, heads, names, channels)
    if model_name == "mtan":
        bb = resnet_bb()
        heads = {t.name: build_head(p, t.num_output, bb.stage_channels[-1])
                 for t in tasks}
        return MTAN(bb, heads, names, bb.stage_channels,
                    downsample=(True, False, False, False) if dilated
                    else (True, True, True, False))
    if model_name == "padnet":
        bb = resnet_bb()
        return PADNet(bb, bb.stage_channels[-1], names, aux_names,
                      num_outputs)
    bb = hrnet_w18(dtype=dtype)
    heads = {t.name: HighResolutionHead(sum(bb.channels), t.num_output,
                                        dtype=dtype) for t in tasks}
    return MTINet(bb, heads, names, aux_names, num_outputs)
