"""Post-training weight-only int8 quantization of the MoE expert banks
(counterpart of m3vit_tpu/serve/quantize.py).

Symmetric per (expert, out channel), in the port's [E, out, in] layout:

    scale[e, o] = max_i |w[e, o, i]| / 127;   q = round(w / scale)

so the reduction runs over the last axis (the JAX package's [E, in, out]
layout reduces over axis -2), and the same (q, scale) come out as there.
``torch.round`` rounds half to even, like ``np.rint``.

``quantize_expert_state_dict`` turns a float model's state dict into the
one a model built with ``expert_weights_int8=True`` loads with
``strict=True`` (``...htoh4.weight`` -> ``...htoh4.weight_q`` +
``...htoh4.weight_scale``, likewise ``h4toh``); everything else is left
as it is.  The quantized model serves only: it has no backward.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from m3vit_tpu_torch.ops.expert_ffn import dequantize_weight

_QMAX = 127.0
#: state-dict suffixes of the expert banks (reference FMoELinear names)
EXPERT_WEIGHTS = (".mlp.experts.htoh4.weight", ".mlp.experts.h4toh.weight")

__all__ = ["dequantize_weight", "expert_quantization_error",
           "quantize_expert_state_dict", "quantize_weight"]


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., out, in] float -> (int8 of the same shape, f32 scale
    [..., out]); an all-zero channel gets scale 1."""
    w = w.detach().float()
    amax = w.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / _QMAX, torch.ones_like(amax))
    q = torch.round(w / scale[..., None]).clamp(-_QMAX, _QMAX)
    return q.to(torch.int8), scale


def quantize_expert_state_dict(state_dict: Dict[str, torch.Tensor],
                               with_error: bool = False):
    """A new state dict with every expert bank replaced by its int8 bank
    (``weight_q``) and f32 scales (``weight_scale``).  with_error=True also
    returns the largest relative dequantization error, from the same
    quantization."""
    out, worst = {}, 0.0
    for k, v in state_dict.items():
        if not k.endswith(EXPERT_WEIGHTS):
            out[k] = v
            continue
        q, s = quantize_weight(v)
        out[k + "_q"], out[k + "_scale"] = q, s
        if with_error:   # max |deq - w| / max |w| over the bank
            w = v.detach().float()
            worst = max(worst, (dequantize_weight(q, s) - w).abs().max().item()
                        / (w.abs().max().item() or 1.0))
    return (out, worst) if with_error else out


def expert_quantization_error(state_dict: Dict[str, torch.Tensor]) -> float:
    """Largest relative dequantization error (max |deq - w| / max |w| per
    bank) over the expert banks of a float state dict."""
    return quantize_expert_state_dict(state_dict, with_error=True)[1]
