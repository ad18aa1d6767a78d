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
blocks have no MoE layer), a SingleTaskModel's one ``decoder`` and the TAM
modules ``tam_model{lvl}`` with their BatchNorm statistics (flax
ConvTranspose kernels [kh, kw, in, out], spatially flipped, to torch
[in, out, kh, kw]; reference models/models.py:11-134).
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch


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

    bb = params.get("backbone", params)
    put("backbone.pos_embed", bb["pos_embed"])
    put("backbone.cls_token", bb["cls_token"])
    conv("backbone.patch_embed.proj", bb["patch_embed"]["proj"])
    depth = 1 + max((int(k.split("_")[1]) for k in bb
                     if k.startswith("block_")), default=-1)
    for i in range(depth):
        blk = bb[f"block_{i}"]
        pre = f"backbone.blocks.{i}."
        norm(pre + "norm1", blk["norm1"])
        norm(pre + "norm2", blk["norm2"])
        dense(pre + "attn.qkv", blk["attn"]["qkv"])
        dense(pre + "attn.proj", blk["attn"]["proj"])
        mlp = blk["mlp"]
        if "experts_b1" in mlp:  # MoE block
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
