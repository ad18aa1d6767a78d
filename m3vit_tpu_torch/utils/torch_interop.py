"""Reference and DeiT checkpoints into the port (counterpart of
m3vit_tpu/utils/torch_interop.py; reference utils/helpers.py:329-713 and
utils/moe_utils.py).

- ``load_torch_state_dict`` / ``load_reference_checkpoint`` read a ``.pth``
  file, or a reference rank-sharded directory of ``{rank}.pth`` files whose
  expert tensors are concatenated on dim 0 in rank order;
  ``validate_reference_moe_checkpoint`` refuses rank-local expert banks;
  ``save_reference_sharded_checkpoint`` writes such a directory.
- ``interpolate_pos_embed`` resizes a position-embedding grid as
  ``jax.image.resize(..., "bilinear")`` does: half-pixel centres, and a
  triangle kernel widened by the scale when downscaling (antialiasing),
  which ``F.interpolate`` does not do.
- ``upcycle_dense_mlp_to_experts`` turns a DeiT dense MLP into an expert
  bank: every expert a copy (replicate mode), or the MLP split into
  G = dense hidden / expert hidden chunks tiled across the experts (split
  mode), optionally scaled by sqrt(E*G^2/K).
- ``deit_to_backbone_params`` maps a DeiT state dict onto the backbone's
  parameters.
- ``load_reference_token_state_dict`` loads a reference token-model state
  dict (models/moe/token/*) with ``strict=True``: the counterpart of
  ``reference_token_sd_to_params`` (interop :471-539).

The port names its parameters like the reference model and keeps torch
layouts, so a reference MTL state dict needs no renaming:
``load_into_model`` copies every tensor whose name and shape the model has
and returns the parameters it left at their initial values.  Arrays are
numpy, as in the JAX package; torch only unpickles and writes ``.pth``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: expert-parameter key markers (reference utils/moe_utils.py:15)
EXPERT_KEYWORDS = ("mlp.experts.htoh4", "mlp.experts.h4toh")


def _unwrap(ckpt):
    """The state dict inside a checkpoint dict (its "model", "state_dict"
    or "model_state" entry), or the dict itself."""
    if isinstance(ckpt, dict):
        for key in ("model", "state_dict", "model_state"):
            if key in ckpt and isinstance(ckpt[key], dict):
                return ckpt[key]
    return ckpt


def _numpy(v) -> np.ndarray:
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a ``.pth`` file (interop :26-36)."""
    sd = _unwrap(torch.load(path, map_location="cpu", weights_only=False))
    return {k: _numpy(v) for k, v in sd.items()}


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of jax.image.resize's bilinear kernel along one
    axis (jax/_src/image/scale.py:compute_weight_mat), in f32 as there."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def interpolate_pos_embed(pos: np.ndarray, num_prefix: int,
                          target_hw: Tuple[int, int]) -> np.ndarray:
    """pos [1, num_prefix + h*w, C] with its square h x w grid resized
    bilinearly to target_hw (align_corners=False, antialiased when
    downscaling: jax.image.resize; interop :39-58, reference
    helpers.py:414-440)."""
    prefix = pos[:, :num_prefix]
    grid = pos[:, num_prefix:]
    n, hw, c = grid.shape
    h = w = int(round(hw ** 0.5))
    grid = grid.reshape(n, h, w, c).astype(np.float64)
    wh = _resize_weights(h, target_hw[0]).astype(np.float64)
    ww = _resize_weights(w, target_hw[1]).astype(np.float64)
    if (h, w) != tuple(target_hw):
        grid = np.einsum("nhwc,hH,wW->nHWc", grid, wh, ww)
    grid = grid.astype(pos.dtype).reshape(n, target_hw[0] * target_hw[1], c)
    return np.concatenate([prefix, grid], axis=1)


def upcycle_dense_mlp_to_experts(
    fc1_w: np.ndarray, fc1_b: np.ndarray, fc2_w: np.ndarray,
    fc2_b: np.ndarray, num_experts: int, expert_hidden: int,
    top_k: int = 4, use_weight_scaling: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """DeiT MLP (fc1 [hidden, embed], fc2 [embed, hidden], torch layout) ->
    the expert bank in the port's layout: htoh4 weight [E, h, embed] and
    bias [E, h], h4toh weight [E, embed, h] and bias [E, embed]
    (interop :61-104; reference helpers.py:481-713).  h == hidden
    replicates the MLP into every expert; otherwise the MLP splits into
    G = hidden / h chunks (a template group of G experts) tiled E / G
    times, fc1 and fc2 weights and fc1's bias scaled by sqrt(E*G^2/K) with
    use_weight_scaling."""
    hidden = fc1_w.shape[0]
    E = num_experts
    if expert_hidden == hidden:
        return (np.repeat(fc1_w[None], E, 0), np.repeat(fc1_b[None], E, 0),
                np.repeat(fc2_w[None], E, 0), np.repeat(fc2_b[None], E, 0))
    if hidden % expert_hidden:
        raise ValueError(f"dense hidden {hidden} is not a multiple of the "
                         f"expert hidden {expert_hidden}")
    G = hidden // expert_hidden
    if E % G:
        raise ValueError(f"experts {E} must be divisible by granularity {G}")
    scale = ((E // G) * G * G / float(max(top_k, 1))) ** 0.5 \
        if use_weight_scaling else 1.0
    fc1_w = fc1_w * scale
    fc2_w = fc2_w * scale
    fc1_b = fc1_b * scale
    reps = E // G
    w1 = np.tile(np.stack(np.split(fc1_w, G, axis=0)), (reps, 1, 1))
    b1 = np.tile(np.stack(np.split(fc1_b, G, axis=0)), (reps, 1))
    w2 = np.tile(np.stack(np.split(fc2_w, G, axis=1)), (reps, 1, 1))
    return w1, b1, w2, np.repeat(fc2_b[None], E, 0)


def deit_to_backbone_params(
    sd: Dict[str, np.ndarray], *, depth: int,
    num_experts: Optional[int] = None, expert_hidden: Optional[int] = None,
    top_k: int = 4, use_weight_scaling: bool = False,
    target_grid: Optional[Tuple[int, int]] = None, num_prefix: int = 1,
) -> Dict[str, np.ndarray]:
    """A DeiT-style state dict as the backbone's state dict (names without
    the ``backbone.`` prefix; interop :111-186): the position embedding
    resized to target_grid with the backbone's num_prefix prefix tokens
    (the cls token's embedding repeated where the checkpoint has another
    count: a distilled checkpoint's second token dropped for a backbone
    with one, the cls one doubled for a distilled backbone), a distilled
    checkpoint's ``dist_token`` for a distilled backbone
    (interop :142-143), and with num_experts the odd blocks' dense MLPs
    upcycled into expert banks.  The gates are absent (they keep their
    initial values)."""
    out: Dict[str, np.ndarray] = {}
    pos = sd["pos_embed"]
    src_prefix = pos.shape[1] - int(round((pos.shape[1] - 1) ** 0.5)) ** 2
    if src_prefix not in (1, 2):
        src_prefix = 1
    if target_grid is not None:
        pos = interpolate_pos_embed(pos, src_prefix, target_grid)
    if src_prefix != num_prefix:
        pos = np.concatenate([np.repeat(pos[:, :1], num_prefix, axis=1),
                              pos[:, src_prefix:]], axis=1)
    out["pos_embed"] = pos
    out["cls_token"] = sd["cls_token"]
    if num_prefix == 2 and "dist_token" in sd:
        out["dist_token"] = sd["dist_token"]
    for k in ("patch_embed.proj.weight", "patch_embed.proj.bias"):
        out[k] = sd[k]
    for i in range(depth):
        pre = f"blocks.{i}."
        for k in ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                  "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
                  "attn.proj.bias"):
            out[pre + k] = sd[pre + k]
        mlp = [sd[pre + f"mlp.{k}"] for k in ("fc1.weight", "fc1.bias",
                                             "fc2.weight", "fc2.bias")]
        if num_experts is not None and i % 2 == 1:
            banks = upcycle_dense_mlp_to_experts(
                *mlp, num_experts, expert_hidden, top_k, use_weight_scaling)
            names = ("experts.htoh4.weight", "experts.htoh4.bias",
                     "experts.h4toh.weight", "experts.h4toh.bias")
        else:
            banks = mlp
            names = ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")
        for n, v in zip(names, banks):
            out[pre + "mlp." + n] = v
    return out


def strip_checkpoint_prefixes(key: str) -> str:
    """Drop DDP / pretraining wrappers (reference utils/moe_utils.py:18-23)."""
    if key.startswith("module."):
        key = key[len("module."):]
    if key.startswith("encoder."):
        key = key[len("encoder."):]
    return key


def _is_expert_key(key: str) -> bool:
    return any(p in strip_checkpoint_prefixes(key) for p in EXPERT_KEYWORDS)


def load_reference_checkpoint(path: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """(checkpoint, {name: array}) of a reference checkpoint: one ``.pth``
    file, or a rank-sharded directory of ``0.pth`` .. ``N.pth`` (rank 0
    the full state dict, every other rank its slice of the expert tensors;
    reference save_moe_model_to_dir, moe_utils.py:164-178) merged by
    concatenating each rank's expert tensors on dim 0 in rank order
    (train_fastmoe.py:525-545).  Names lose their DDP / pretraining
    prefixes; a merged checkpoint's meta says ``expert_format: global``
    (interop :213-273)."""
    if not os.path.isdir(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = _unwrap(ckpt)
    else:
        ranks = sorted(int(f[:-4]) for f in os.listdir(path)
                       if f.endswith(".pth") and f[:-4].isdigit())
        if not ranks or ranks != list(range(len(ranks))):
            raise FileNotFoundError(
                f"{path}: expected contiguous 0.pth..N.pth rank shards, "
                f"found ranks {ranks}")
        ckpt = torch.load(os.path.join(path, "0.pth"), map_location="cpu",
                          weights_only=False)
        sd = dict(ckpt["state_dict"])
        for r in ranks[1:]:
            shard = torch.load(os.path.join(path, f"{r}.pth"),
                               map_location="cpu", weights_only=False)
            for key, item in shard["state_dict"].items():
                sd[key] = torch.cat([sd[key], item], dim=0)
        ckpt = dict(ckpt, state_dict=sd,
                    meta=dict(ckpt.get("meta") or {}, expert_format="global"))
    return ckpt, {strip_checkpoint_prefixes(k): _numpy(v)
                  for k, v in sd.items()}


def validate_reference_moe_checkpoint(checkpoint: Dict,
                                      state_dict: Dict[str, np.ndarray],
                                      num_global_experts: int,
                                      path: str = "<in-memory>") -> None:
    """Raise when a checkpoint holds rank-local expert banks (interop
    :276-331; reference validate_single_file_moe_checkpoint_or_raise,
    moe_utils.py:34-106): meta ``expert_format: local`` always, ``global``
    with another expert count, and without meta the ``args`` world-size
    heuristic, then the expected count."""
    dim0 = next((int(v.shape[0]) for k, v in state_dict.items()
                 if _is_expert_key(k)), None)
    if dim0 is None:
        return
    expected = int(num_global_experts)
    meta = checkpoint.get("meta", {}) if isinstance(checkpoint, dict) else {}
    fmt = meta.get("expert_format") if isinstance(meta, dict) else None
    if fmt == "global":
        if dim0 != expected:
            raise ValueError(
                "Checkpoint meta says global experts but tensor shape is "
                f"inconsistent. expected dim0={expected}, got {dim0}. "
                f"path={path}")
        return
    if fmt == "local":
        raise ValueError(
            "Checkpoint meta indicates rank-local experts only. "
            f"path={path}\nLoad the full rank-shard DIRECTORY instead "
            "(load_reference_checkpoint merges it), or export a global "
            "checkpoint first.")
    args = checkpoint.get("args", {}) if isinstance(checkpoint, dict) else {}
    if isinstance(args, dict):
        world, total = args.get("world_size"), args.get("moe_experts")
        if (world is not None and total is not None and int(world) > 1
                and dim0 * int(world) == int(total)):
            raise ValueError(
                "Checkpoint appears to contain rank-local experts only "
                f"(expert_dim0={dim0}, ckpt_world_size={world}, "
                f"ckpt_global_experts={total}). path={path}\n"
                "Load the full rank-shard DIRECTORY instead.")
    if dim0 != expected:
        raise ValueError(
            "Cannot verify global expert format for MoE checkpoint. "
            f"expert_dim0={dim0}, expected_global={expected}, path={path}")


def save_reference_sharded_checkpoint(sd: Dict, dirname: str, num_ranks: int,
                                      extra: Optional[Dict] = None) -> None:
    """Write `sd` (arrays or tensors, on any device) as a reference-format
    rank-sharded directory: ``0.pth`` the full state dict with rank 0's
    expert slices, ``r.pth`` rank r's expert slices only, each file's meta
    ``expert_format: local`` (interop :653-689; reference moe_utils.py
    :128-178 without torch.distributed)."""
    os.makedirs(dirname, exist_ok=True)
    expert_keys = [k for k in sd if _is_expert_key(k)]
    e_global = int(sd[expert_keys[0]].shape[0]) if expert_keys else 0
    if expert_keys and e_global % num_ranks:
        raise ValueError(f"{e_global} experts not divisible into "
                         f"{num_ranks} ranks")
    e_local = e_global // num_ranks

    def tensor(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().contiguous()
        return torch.as_tensor(np.array(v, order="C"))

    for rank in range(num_ranks):
        lo, hi = rank * e_local, (rank + 1) * e_local
        keys = sd if rank == 0 else expert_keys
        state = dict(extra or {})
        state["state_dict"] = {
            k: tensor(sd[k][lo:hi] if k in expert_keys else sd[k])
            for k in keys}
        state["meta"] = dict(state.get("meta") or {}, expert_format="local")
        torch.save(state, os.path.join(dirname, f"{rank}.pth"))


def load_into_model(model: torch.nn.Module, sd: Dict[str, np.ndarray],
                    prefix: str = "") -> List[str]:
    """Copy every entry of `sd` whose name (after `prefix`) the model's
    state dict has into it, in place, cast to the model's dtype (a shape
    that differs raises, but a one-element entry fills a scalar, as the
    JAX package's writer stores one), and return the names of the
    parameters under `prefix` that `sd` did not hold, which keep their
    initial values.  Names in `sd` the model lacks are ignored: the
    non-strict counterpart of the JAX package's merge_into (interop
    :692-717)."""
    own = model.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            key = prefix + k
            if key not in own:
                continue
            t = own[key]
            if np.size(v) == t.numel() == 1:
                v = np.reshape(v, tuple(t.shape))
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{key}: loaded {tuple(v.shape)} != "
                                 f"model {tuple(t.shape)}")
            t.copy_(torch.as_tensor(np.asarray(v)).to(t.dtype))
    return [n for n, _ in model.named_parameters()
            if n.startswith(prefix) and n[len(prefix):] not in sd]


def load_reference_token_state_dict(model: torch.nn.Module,
                                    sd: Dict[str, np.ndarray]) -> None:
    """Load a reference token multi-task state dict (``backbone.*``: the
    token backbone's ``blocks.{i}.share_pred.w_gate``,
    ``blocks.{i}.gate.{t}.w_gate``, ``blocks.{i}.mlp.experts.*``,
    ``blocks.{i}.shared_ffn.*``, ``gate_task_represent.*``; and
    ``decoders.{task}.*``) into the port's TokenMultiTaskModel with
    ``strict=True`` (interop :471-539 maps the same names onto the JAX
    tree).  Only the BatchNorms' ``num_batches_tracked`` counters, which a
    state dict written by the JAX package lacks, keep the model's own
    values; any other missing or unexpected name raises."""
    own = model.state_dict()
    tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    for k, v in own.items():
        if k.endswith("num_batches_tracked") and k not in tensors:
            tensors[k] = v
    model.load_state_dict(tensors, strict=True)
