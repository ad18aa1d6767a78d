"""Weights carried across from the JAX package.

``jax_variables_to_state_dict`` maps a flax ``{"params", "batch_stats"}``
tree (numpy leaves) onto the port's ``state_dict``.  The port names its
modules like the torch reference model, so the keys are those of
m3vit_tpu/utils/torch_interop.py:params_to_reference_sd (:548-650), and the
port also loads reference-format MTL checkpoints.  This is the port's own
copy of that mapping (flax [in, out] kernels -> torch [out, in] weights),
plus the ``num_batches_tracked`` buffers that ``nn.BatchNorm2d`` carries,
the int8 expert banks of a quantized model (``experts_w1_q`` ->
``htoh4.weight_q`` transposed, kept int8; ``experts_w1_scale`` ->
``htoh4.weight_scale``, per out channel in either layout), the
learned-noise gate's ``w_noise`` beside ``w_gate``, the dense ViT (its
blocks have no MoE layer), a SingleTaskModel's one ``decoder``, the TAM
modules ``tam_model{lvl}`` with their BatchNorm statistics (flax
ConvTranspose kernels [kh, kw, in, out], spatially flipped, to torch
[in, out, kh, kw]; reference models/models.py:11-134), the
task-conditioned router's ``gate_task_represent``, and the token model's
blocks (models/token_moe.py: ``share_pred``, the block-level routers,
expert banks and shared FFN, the task-conditioned attention's
parameters), named as m3vit_tpu/utils/torch_interop.py:
reference_token_sd_to_params (:471-539) reads them.  Also the research
knobs' parameters: a distilled backbone's ``dist_token``, each MoE
block's ``mlp.regu_sem_head`` (the JAX package makes it only when the
model was initialised with ``sem``, so a tree may lack it: the port's head
then keeps its initial values, and such a state dict loads with
strict=False, missing those keys alone), and the decoupled gate ViT of a
``MoEViTWithGate`` (``gate_model``; its position embedding is fixed, not
a parameter), alone or as a multi-task model's backbone.

A tree with no ViT in it (the CNN backbones, heads and MTL methods) goes
through ``cnn_variables_to_state_dict``: the port names those modules as
the JAX package does, but for torchvision's ResNet names.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable

import numpy as np
import torch

#: flax module names -> the port's (torchvision's ResNet names, ModuleDicts)
_CNN_RENAMES = (
    (re.compile(r"^layer(\d+)_(\d+)$"), r"layer\1.\2"),
    (re.compile(r"^ds_conv$"), "downsample.0"),
    (re.compile(r"^ds_bn$"), "downsample.1"),
    (re.compile(r"^(backbones|heads|decoders)_(.+)$"), r"\1.\2"),
)


def _cnn_name(flax_name: str) -> str:
    for pat, rep in _CNN_RENAMES:
        if pat.match(flax_name):
            return pat.sub(rep, flax_name)
    return flax_name


def cnn_variables_to_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax variables of a CNN model (m3vit_tpu/models/resnet.py, hrnet.py,
    mobilenetv3.py, cnn_heads.py, mtl_methods.py and the Single- /
    MultiTaskModel around them) -> the port's state dict: conv kernels
    [kh, kw, in, out] -> [out, in, kh, kw], dense kernels transposed,
    BatchNorm scale / bias / batch_stats mean / var -> weight / bias /
    running_mean / running_var with num_batches_tracked 0, and a bare
    array (a Cross-Stitch weight) as it is; module names through
    ``_CNN_RENAMES`` (``layer1_0`` -> ``layer1.0``, ``ds_conv`` ->
    ``downsample.0``, ``heads_{task}`` -> ``heads.{task}``, ...)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, v):
        sd[key] = torch.from_numpy(np.array(v, dtype=np.float32))

    def walk(prefix: str, p: Dict, stats: Dict) -> None:
        if "kernel" in p:
            k = np.asarray(p["kernel"])
            put(prefix + "weight",
                k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T)
            if "bias" in p:
                put(prefix + "bias", p["bias"])
            return
        if "scale" in p:
            put(prefix + "weight", p["scale"])
            put(prefix + "bias", p["bias"])
            scale = np.asarray(p["scale"])
            put(prefix + "running_mean",
                stats.get("mean", np.zeros_like(scale)))
            put(prefix + "running_var", stats.get("var", np.ones_like(scale)))
            sd[prefix + "num_batches_tracked"] = torch.tensor(0)
            return
        for name, v in p.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(prefix + _cnn_name(name) + ".", v,
                     stats.get(name, {}))
            else:
                put(prefix + name, v)

    walk("", variables["params"], variables.get("batch_stats") or {})
    return sd


def jax_variables_to_state_dict(variables: Dict, tasks: Iterable,
                                multi_gate_tasks: int = 0
                                ) -> Dict[str, torch.Tensor]:
    """flax variables -> the port's state dict (f32 tensors; load_state_dict
    casts each to its parameter's dtype).  `tasks`: task names or TaskSpecs
    whose decoders to carry (``decoders.{task}``; a SingleTaskModel's tree
    holds one ``decoder`` instead, carried whatever `tasks` says);
    `multi_gate_tasks`: number of per-task routers (0 = one shared
    router)."""
    params = variables["params"]
    batch_stats = variables.get("batch_stats") or {}
    sd: Dict[str, torch.Tensor] = {}

    def put(key, v):
        sd[key] = torch.from_numpy(np.array(v, dtype=np.float32))

    def dense(prefix, p):
        put(prefix + ".weight", np.asarray(p["kernel"]).T)
        put(prefix + ".bias", p["bias"])

    def conv(prefix, p):
        put(prefix + ".weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        put(prefix + ".bias", p["bias"])

    def norm(prefix, p):
        put(prefix + ".weight", p["scale"])
        put(prefix + ".bias", p["bias"])

    def gates(prefix, w):
        v = np.asarray(w)
        if multi_gate_tasks > 0:
            for t in range(multi_gate_tasks):
                put(prefix + f".{t}.w_gate", v[t])
        else:
            put(prefix + ".w_gate", v[0])

    bb = params.get("backbone", params)
    pre_bb, gate_tree, pre_gate = "backbone.", None, None
    if "gate_model" in params:     # a MoEViTWithGate alone
        gate_tree, pre_gate = params["gate_model"], "gate_model."
    elif "gate_model" in bb:       # ... as a multi-task model's backbone
        gate_tree, pre_gate = bb["gate_model"], "backbone.gate_model."
        bb, pre_bb = bb["backbone"], "backbone.backbone."
    if "pos_embed" not in bb:
        return cnn_variables_to_state_dict(variables)
    if "gate_task_represent" in bb:
        g = bb["gate_task_represent"]
        dense(pre_bb + "gate_task_represent.fc1", g["fc1"])
        dense(pre_bb + "gate_task_represent.fc2", g["fc2"])
        norm(pre_bb + "gate_task_represent.norm", g["norm"])
    put(pre_bb + "pos_embed", bb["pos_embed"])
    put(pre_bb + "cls_token", bb["cls_token"])
    if "dist_token" in bb:
        put(pre_bb + "dist_token", bb["dist_token"])
    conv(pre_bb + "patch_embed.proj", bb["patch_embed"]["proj"])
    depth = 1 + max((int(k.split("_")[1]) for k in bb
                     if k.startswith("block_")), default=-1)
    for i in range(depth):
        blk = bb[f"block_{i}"]
        pre = f"{pre_bb}blocks.{i}."
        norm(pre + "norm1", blk["norm1"])
        norm(pre + "norm2", blk["norm2"])
        attn = blk["attn"]
        dense(pre + "attn.proj", attn["proj"])
        if "qkv" in attn:
            dense(pre + "attn.qkv", attn["qkv"])
        else:   # the token model's task-conditioned attention
            for k in ("branch_embed", "router_w", "router_b",
                      "expert_pools", "q_bias", "k_bias", "v_bias"):
                put(pre + "attn." + k, attn[k])
        if "share_pred" in blk:
            put(pre + "share_pred.w_gate", blk["share_pred"]["w_gate"])
        if "experts_b1" in blk:   # a token model's MoE block
            gates(pre + "gate", blk["w_gate"])
            for n, bank in (("1", "htoh4"), ("2", "h4toh")):
                put(pre + f"mlp.experts.{bank}.weight",
                    np.asarray(blk[f"experts_w{n}"]).transpose(0, 2, 1))
                put(pre + f"mlp.experts.{bank}.bias", blk[f"experts_b{n}"])
                put(pre + f"shared_ffn.fc{n}.weight",
                    np.asarray(blk[f"shared_ffn_fc{n}"]).T)
                put(pre + f"shared_ffn.fc{n}.bias", blk[f"shared_ffn_b{n}"])
            continue
        mlp = blk["mlp"]
        if "experts_b1" in mlp:  # MoE block
            if "regu_sem_head" in mlp:
                dense(pre + "mlp.regu_sem_head", mlp["regu_sem_head"])
            for w in ("w_gate", "w_noise"):
                if w not in mlp:
                    continue
                v = np.asarray(mlp[w])
                if multi_gate_tasks > 0:
                    for t in range(multi_gate_tasks):
                        put(pre + f"mlp.gate.{t}.{w}", v[t])
                else:
                    put(pre + f"mlp.gate.{w}", v[0])
            for n, bank in (("1", "htoh4"), ("2", "h4toh")):
                key = pre + f"mlp.experts.{bank}."
                put(key + "bias", mlp[f"experts_b{n}"])
                if f"experts_w{n}_q" in mlp:   # int8 bank (serve/quantize)
                    sd[key + "weight_q"] = torch.from_numpy(np.array(
                        np.asarray(mlp[f"experts_w{n}_q"]).transpose(0, 2, 1),
                        dtype=np.int8))
                    put(key + "weight_scale", mlp[f"experts_w{n}_scale"])
                else:
                    put(key + "weight", np.asarray(
                        mlp[f"experts_w{n}"]).transpose(0, 2, 1))
        else:
            dense(pre + "mlp.fc1", mlp["fc1"])
            dense(pre + "mlp.fc2", mlp["fc2"])

    if gate_tree is not None:   # the GateViT (models/gate_vit.py)
        conv(pre_gate + "patch_embed.proj", gate_tree["patch_embed"]["proj"])
        put(pre_gate + "cls_token", gate_tree["cls_token"])
        norm(pre_gate + "norm", gate_tree["norm"])
        for i in range(sum(k.startswith("block_") for k in gate_tree)):
            blk, pre = gate_tree[f"block_{i}"], f"{pre_gate}blocks.{i}."
            for n in ("norm1", "norm2"):
                norm(pre + n, blk[n])
            for n in ("qkv", "proj"):
                dense(pre + "attn." + n, blk["attn"][n])
            for n in ("fc1", "fc2"):
                dense(pre + "mlp." + n, blk["mlp"][n])

    if "decoder" in params:     # SingleTaskModel
        heads = [("decoder.", params["decoder"],
                  batch_stats.get("decoder", {}))]
    else:
        heads = [(f"decoders.{n}.", params[f"decoders_{n}"],
                  batch_stats.get(f"decoders_{n}", {}))
                 for n in (getattr(t, "name", t) for t in tasks)]
    for pre, hp, hb in heads:
        norm(pre + "norm", hp["norm"])
        for i in range(5):
            conv(pre + f"conv_{i}", hp[f"conv_{i}"])
        for i in range(4):
            bn = f"syncbn_fc_{i}"
            norm(pre + bn, hp[bn])
            stats = hb.get(bn, {})
            scale = np.asarray(hp[bn]["scale"])
            put(pre + bn + ".running_mean",
                stats.get("mean", np.zeros_like(scale)))
            put(pre + bn + ".running_var",
                stats.get("var", np.ones_like(scale)))
            sd[pre + bn + ".num_batches_tracked"] = torch.tensor(0)

    def bn_with_stats(prefix, p, stats):
        norm(prefix, p)
        put(prefix + ".running_mean",
            stats.get("mean", np.zeros_like(np.asarray(p["scale"]))))
        put(prefix + ".running_var",
            stats.get("var", np.ones_like(np.asarray(p["scale"]))))
        sd[prefix + ".num_batches_tracked"] = torch.tensor(0)

    for name in sorted(k for k in params if k.startswith("tam_model")):
        tp, ts = params[name], batch_stats.get(name, {})
        stages = [(f"layers{i}", "conv") for i in range(3)] + [
            (f"{kind}{i}", kind) for kind in ("encoder", "decoder")
            for i in range(2)] + [
            (f"layers3.{k[len('layers3_'):-len('_conv')]}", "conv")
            for k in tp if k.startswith("layers3_") and k.endswith("_conv")]
        for stage, kind in stages:
            src = stage.replace(".", "_")
            pre = f"{name}.{stage}."
            if kind == "decoder":
                k = np.asarray(tp[src + "_conv"]["kernel"])
                put(pre + "0.weight", k[::-1, ::-1].transpose(2, 3, 0, 1))
                put(pre + "0.bias", tp[src + "_conv"]["bias"])
            else:
                conv(pre + "0", tp[src + "_conv"])
            bn_with_stats(pre + "1", tp[src + "_bn"],
                          ts.get(src + "_bn", {}))
        for k in tp:
            if k.startswith("layers4_"):
                conv(f"{name}.layers4.{k[len('layers4_'):]}.0", tp[k])
    return sd
