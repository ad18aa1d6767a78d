"""Model zoo of the port: the dense and MoE ViT backbones, PUP heads, the
single- and multi-task wrappers, and the config-driven factory."""

from m3vit_tpu_torch.models.factory import build_flagship, build_model
from m3vit_tpu_torch.models.heads import VisionTransformerUpHead
from m3vit_tpu_torch.models.multitask import MultiTaskModel, SingleTaskModel
from m3vit_tpu_torch.models.vit import VisionTransformer, set_use_kernels
from m3vit_tpu_torch.models.vit_moe import VisionTransformerMoE

__all__ = [
    "MultiTaskModel", "SingleTaskModel", "VisionTransformer",
    "VisionTransformerMoE", "VisionTransformerUpHead", "build_flagship",
    "build_model", "set_use_kernels",
]
