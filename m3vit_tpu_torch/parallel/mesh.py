"""Data and expert parallelism over ``torch.distributed`` (counterpart of
m3vit_tpu/parallel/mesh.py, and of the JAX CLI's ('data', 'expert') mesh).

The world is ``n_data x n_expert`` processes.  Rank r sits at mesh
position ``(r // n_expert, r % n_expert)``, the order of the JAX
package's ``make_mesh`` device array, so the images a rank holds are the
contiguous shard JAX's ``P(('data', 'expert'))`` gives that device:

  * the batch is sharded over every rank (pure data parallelism);
  * each rank holds ``E / n_expert`` experts of every MoE block, those of
    its position in its expert group (the ranks of its data row), and
    exchanges tokens with them by all-to-all (``moe/dispatch.py``);
  * every other parameter, and the optimizer's state of it, is
    replicated.

Where the JAX package's single global program sees the whole batch, the
port reduces across the world: the losses' pixel counts, the heads'
BatchNorm statistics, the MoE balance loss's importance and load, and the
MoE statistics.  Each rank's loss is its share of the global loss (its
sum over the global count), so gradients are summed, not averaged:
non-expert gradients over the world, expert gradients over the data group
(the ranks of one expert column), as GSPMD does for JAX's shardings.

The layout in force is module state (``set_layout``), read by the losses,
the heads and the MoE blocks; with none set every reduction is the
identity and nothing here touches ``torch.distributed``.  On the card the
backend is NCCL, one rank per card (``cuda:LOCAL_RANK``); on the CPU,
Gloo.  ``init_distributed`` reads ``torchrun``'s environment.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

#: the expert banks' parameter names (``Experts``: htoh4 / h4toh weight and
#: bias), the ones sharded over the expert group
EXPERT_MARK = ".mlp.experts."


def mesh_position(rank: int, n_expert: int) -> Tuple[int, int]:
    """(data row, expert column) of `rank`."""
    return rank // n_expert, rank % n_expert


@dataclass
class Layout:
    """A rank's place in the ('data', 'expert') mesh and its groups."""

    n_data: int
    n_expert: int
    rank: int
    device: torch.device
    expert_group: object   # the ranks of this rank's data row
    data_group: object     # the ranks of this rank's expert column
    # the flat gradient buffers of sync_grads, kept from step to step
    buffers: Dict = field(default_factory=dict, repr=False)

    @property
    def world(self) -> int:
        return self.n_data * self.n_expert

    @property
    def data_rank(self) -> int:
        return mesh_position(self.rank, self.n_expert)[0]

    @property
    def expert_rank(self) -> int:
        return mesh_position(self.rank, self.n_expert)[1]


_ACTIVE: Optional[Layout] = None


def set_layout(layout: Optional[Layout]) -> None:
    """Make `layout` the one the losses, heads and MoE blocks reduce over
    (None: a single process, no reduction)."""
    global _ACTIVE
    _ACTIVE = layout


def active() -> Optional[Layout]:
    return _ACTIVE


def make_layout(n_data: int, n_expert: int,
                device: Optional[torch.device] = None) -> Layout:
    """The layout of this rank in an initialised world of exactly
    n_data * n_expert ranks.  Every rank must call it, in the same order
    as every other group it makes (``dist.new_group`` is collective)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_expert != world:
        raise ValueError(f"n_data {n_data} x n_expert {n_expert} != world "
                         f"size {world}")
    rows = [dist.new_group(list(range(r * n_expert, (r + 1) * n_expert)))
            for r in range(n_data)]
    cols = [dist.new_group(list(range(c, world, n_expert)))
            for c in range(n_expert)]
    row, col = mesh_position(rank, n_expert)
    if device is None:
        device = torch.device("cpu")
    return Layout(n_data, n_expert, rank, torch.device(device), rows[row],
                  cols[col])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(n_data: int, n_expert: int,
                     device: Optional[str] = None) -> Layout:
    """Joins the process group ``torchrun`` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and returns
    this rank's layout, also made active.  Without that environment a
    one-rank world is made on a local port.  NCCL with the card
    ``cuda:LOCAL_RANK`` unless `device` is "cpu" (Gloo); raises when CUDA
    is asked for and absent."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device is None or str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: a parallel run uses NCCL on the "
                "card; pass --device cpu for Gloo on the CPU")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    if not dist.is_initialized():
        if "RANK" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    device_id=dev if backend == "nccl"
                                    else None)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                rank=0, world_size=1,
                device_id=dev if backend == "nccl" else None)
    layout = make_layout(n_data, n_expert, dev)
    set_layout(layout)
    return layout


# ---- reductions across the world ----------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over `group`; the backward sums the gradients over it too (each
    rank's output is the sum of every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def world_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active layout's world, without gradient; x itself
    with no layout."""
    if _ACTIVE is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def world_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active layout's world, differentiably; x itself
    with no layout."""
    return x if _ACTIVE is None else _AllReduceSum.apply(x, None)


def world_size() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.world


def reduce_stats(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The MoE statistics summed over the world (one all-reduce of their
    concatenation): the per-rank sums and histograms become the global
    batch's.  ``moe_stat_count`` counts blocks, not tokens, and stays."""
    keys = [k for k in stats if k != "moe_stat_count"]
    if _ACTIVE is None or not keys:
        return stats
    flat = torch.cat([stats[k].detach().float().reshape(-1) for k in keys])
    dist.all_reduce(flat)
    out, i = dict(stats), 0
    for k in keys:
        n = stats[k].numel()
        out[k] = flat[i:i + n].reshape(stats[k].shape)
        i += n
    return out


# ---- parameters: expert banks sharded, the rest replicated --------------

def is_expert_param(name: str) -> bool:
    return EXPERT_MARK in name


def shard_experts(model: torch.nn.Module, layout: Layout,
                  a2a_chunks: int = 1) -> None:
    """Keeps this rank's slice of every MoE block's expert banks (its
    position in the expert group; call before building the optimizer) and
    points the blocks at the layout, so that their forward exchanges
    tokens over the expert group in `a2a_chunks` pieces."""
    from m3vit_tpu_torch.models.vit_moe import MoEMlp

    for mod in model.modules():
        if not isinstance(mod, MoEMlp):
            continue
        E = mod.num_experts
        if E % layout.n_expert:
            raise ValueError(f"{E} experts do not divide over n_expert "
                             f"{layout.n_expert}")
        lo, n = layout.expert_rank * (E // layout.n_expert), \
            E // layout.n_expert
        for name, prm in list(mod.experts.named_parameters()):
            owner = mod.experts.get_submodule(name.rsplit(".", 1)[0])
            setattr(owner, name.rsplit(".", 1)[1], torch.nn.Parameter(
                prm.detach()[lo:lo + n].clone(),
                requires_grad=prm.requires_grad))
        mod.layout = layout
        mod.a2a_chunks = int(a2a_chunks)


def _flat_all_reduce(grads: List[torch.Tensor], group,
                     buffers: Dict) -> None:
    """All-reduce `grads` in place through one flat buffer a dtype, kept
    in `buffers` (a buffer allocated anew every step makes the caching
    allocator call cudaMalloc, which waits for the card)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for dt, gs in by_dtype.items():
        key = (id(group), dt, sum(g.numel() for g in gs))
        flat = buffers.get(key)
        if flat is None:
            flat = buffers[key] = torch.empty(key[2], dtype=dt,
                                              device=gs[0].device)
        torch.cat([g.reshape(-1) for g in gs], out=flat)
        dist.all_reduce(flat, group=group)
        i = 0
        for g in gs:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


def sync_grads(model: torch.nn.Module, layout: Layout) -> None:
    """Sums the gradients across ranks in place: the experts' over the
    data group, every other parameter's over the world.  A parameter with
    no gradient has none on every rank (all run the same graph) and is
    left alone."""
    expert, rest = [], []
    for name, prm in model.named_parameters():
        if prm.grad is not None:
            (expert if is_expert_param(name) else rest).append(prm.grad)
    if rest:
        _flat_all_reduce(rest, None, layout.buffers)
    if expert:
        _flat_all_reduce(expert, layout.data_group, layout.buffers)


def gather_experts(t: torch.Tensor, layout: Layout) -> torch.Tensor:
    """A rank's expert-major shard concatenated with its expert group's
    into the whole bank (dim 0)."""
    parts = [torch.empty_like(t) for _ in range(layout.n_expert)]
    dist.all_gather(parts, t.contiguous(), group=layout.expert_group)
    return torch.cat(parts, dim=0)


def shard_of(t: torch.Tensor, layout: Layout) -> torch.Tensor:
    """This rank's slice of a whole expert bank (dim 0)."""
    n = t.shape[0] // layout.n_expert
    return t[layout.expert_rank * n:(layout.expert_rank + 1) * n].clone()


def _map_expert_state(model: torch.nn.Module, optimizer, osd, fn):
    """`osd` (an optimizer state dict of `model`'s parameters) with fn
    applied to every non-scalar tensor of the expert banks' states."""
    ids = {id(p) for n, p in model.named_parameters() if is_expert_param(n)}
    expert_index = {i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])
        if id(p) in ids}
    state = {i: ({k: (fn(v) if torch.is_tensor(v) and v.ndim else v)
                  for k, v in st.items()} if int(i) in expert_index else st)
             for i, st in osd["state"].items()}
    return {**osd, "state": state}


def full_state(model: torch.nn.Module, optimizer, layout: Layout):
    """(state dict, optimizer state dict) in the one-card layout: every
    expert bank, and the optimizer's state of it, gathered whole over the
    expert group.  Collective: every rank calls it."""
    sd = {k: (gather_experts(v, layout) if is_expert_param(k) else v)
          for k, v in model.state_dict().items()}
    if optimizer is None:
        return sd, None
    return sd, _map_expert_state(model, optimizer, optimizer.state_dict(),
                                 lambda t: gather_experts(t, layout))


def shard_state(model: torch.nn.Module, optimizer, sd, osd,
                layout: Layout):
    """A one-card (state dict, optimizer state dict) cut to this rank's
    expert shard, for ``load_state_dict``."""
    sd = {k: (shard_of(v, layout) if is_expert_param(k) else v)
          for k, v in sd.items()}
    if osd is None or optimizer is None:
        return sd, osd
    return sd, _map_expert_state(model, optimizer, osd,
                                 lambda t: shard_of(t, layout))
