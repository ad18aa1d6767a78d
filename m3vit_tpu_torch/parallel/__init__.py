"""Data and expert parallelism over torch.distributed (parallel/mesh.py)."""

from m3vit_tpu_torch.parallel.mesh import (
    Layout,
    active,
    full_state,
    init_distributed,
    is_expert_param,
    make_layout,
    mesh_position,
    reduce_stats,
    set_layout,
    shard_experts,
    shard_state,
    sync_grads,
    world_size,
    world_sum,
    world_sum_grad,
)

__all__ = [
    "Layout", "active", "full_state", "init_distributed", "is_expert_param",
    "make_layout", "mesh_position", "reduce_stats", "set_layout",
    "shard_experts", "shard_state", "sync_grads", "world_size", "world_sum",
    "world_sum_grad",
]
