"""Fused dense-block MLP sublayer, out = x + MLP(LayerNorm(x)): forward (K5)
and backward (K6).

Counterpart of ``m3vit_tpu/ops/ln_mlp.py`` (``fused_ln_mlp_residual`` :300
and its ``custom_vjp`` :313-330, ``_ln_rows`` :118, ``_fwd_kernel`` :129,
``_bwd_kernel`` :183 and ``fused_dense_ln_mlp`` :48, whose shard_map
collapses here to a reshape to [S, d]: there is one device).  Weights take
the torch layout: w1 [H, d], w2 [d, H] (the JAX package keeps [d, H] and
[H, d]).  ``fused_ln_mlp_residual`` is a ``torch.autograd.Function``: on a
CUDA tensor its forward launches ``csrc/ln_mlp_fwd.cu`` and its backward
``csrc/ln_mlp_bwd.cu``, which recomputes the LayerNorm and the hidden
activations from x (nothing else is saved); on a CPU tensor, or with
``use_kernels=False``, both run the plain versions here.  A shape the
kernels do not take raises.

Rounding points are the TPU kernel's: LayerNorm statistics in f32 (eps
1e-6), the normalised tokens rounded to the compute dtype before the first
product, the MLP output rounded to the stream dtype before the residual
add (ln_mlp.py:144-145), which is f32 and rounded again; in the backward
``dx = gr + dx_ln`` in f32, then rounded.  The Function takes the f32
master weights, casts w1 and w2 to x's dtype for the products, and returns
f32 gradients for every parameter.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from m3vit_tpu_torch.ops import _build
from m3vit_tpu_torch.ops.expert_ffn import (_check, _f32_aligned, _scratch,
                                            _scratch_bytes, bwd_plan,
                                            ffn_flops)

NAME = "ln_mlp_fwd"
BWD_NAME = "ln_mlp_bwd"
EPS = 1e-6


def _ln_rows(xf, gamma, beta, eps: float):
    """f32 LayerNorm over the last axis of [S, d]; returns (h_pre, xhat,
    rstd), all f32 (ln_mlp.py:118-126)."""
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    return xhat * gamma.float() + beta.float(), xhat, rstd


def ln_mlp_residual_plain(x, gamma, beta, w1, b1, w2, b2,
                          eps: float = EPS) -> torch.Tensor:
    """Plain forward with the TPU kernel's rounding points (ln_mlp.py:129-145,
    exact erf); w1/w2 in the compute dtype, output in x's dtype."""
    cd = w1.dtype
    xf = x.float()
    h = _ln_rows(xf, gamma, beta, eps)[0].to(cd)
    a = F.gelu(h.float() @ w1.float().t() + b1.float()).to(cd)
    o = (a.float() @ w2.float().t() + b2.float()).to(x.dtype)
    return (xf + o.float()).to(x.dtype)


def ln_mlp_residual_bwd_plain(x, gamma, beta, w1, b1, w2, gr,
                              eps: float = EPS):
    """Plain backward with the TPU kernel's numerics (ln_mlp.py:183-242,
    exact erf).  Returns (dx in x's dtype, dgamma, dbeta, dw1 [H, d], db1,
    dw2 [d, H], db2 in f32)."""
    cd = w1.dtype
    xf = x.float()
    h_pre, xhat, rstd = _ln_rows(xf, gamma, beta, eps)
    h = h_pre.to(cd).float()
    a_pre = h @ w1.float().t() + b1.float()
    cdf = 0.5 * (1.0 + torch.erf(a_pre * (0.5 ** 0.5)))
    pdf = torch.exp(-0.5 * a_pre * a_pre) / math.sqrt(2.0 * math.pi)
    a = (a_pre * cdf).to(cd).float()
    gc = gr.to(cd).float()
    da_f = (gc @ w2.float()) * (cdf + a_pre * pdf)
    da = da_f.to(cd).float()
    dh = da @ w1.float()
    dhg = dh * gamma.float()
    m1 = dhg.mean(-1, keepdim=True)
    m2 = (dhg * xhat).mean(-1, keepdim=True)
    dx = (gr.float() + rstd * (dhg - m1 - xhat * m2)).to(x.dtype)
    return (dx, (dh * xhat).sum(0), dh.sum(0), da.t() @ h, da_f.sum(0),
            gc.t() @ a, gr.float().sum(0))


class _FusedLnMlp(torch.autograd.Function):
    """Forward K5 (or plain), backward K6 (or plain), as the JAX custom_vjp
    :313-330; LayerNorm and hidden activations are recomputed."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps, use_kernels):
        kernels = x.is_cuda and use_kernels
        w1c = w1.to(x.dtype).contiguous()
        w2c = w2.to(x.dtype).contiguous()
        fwd = ln_mlp_fwd if kernels else ln_mlp_residual_plain
        out = fwd(x, gamma, beta, w1c, b1, w2c, b2, eps)
        ctx.save_for_backward(x, gamma, beta, w1c, b1, w2c)
        ctx.eps, ctx.kernels = eps, kernels
        return out

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w1c, b1, w2c = ctx.saved_tensors
        bwd = ln_mlp_bwd if ctx.kernels else ln_mlp_residual_bwd_plain
        grads = bwd(x, gamma, beta, w1c, b1, w2c, g.to(x.dtype).contiguous(),
                    ctx.eps)
        return (*grads, None, None)


def fused_ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2, eps: float = EPS,
                          *, use_kernels: bool = True) -> torch.Tensor:
    """x + (gelu(LN(x; gamma, beta) @ w1^T + b1) @ w2^T + b2) over x [S, d]
    (the stream dtype); w1 [H, d], w2 [d, H] in any float dtype (cast to
    x's for the products), gamma/beta/b1/b2 f32.  Differentiable in all
    seven."""
    return _FusedLnMlp.apply(x, gamma, beta, w1, b1, w2, b2, eps,
                             use_kernels)


def fused_dense_ln_mlp(x, gamma, beta, w1, b1, w2, b2, *, eps: float = EPS,
                       use_kernels: bool = True) -> torch.Tensor:
    """x + MLP(LN(x)) on [..., d] tokens (ln_mlp.py:48-107 on one device)."""
    out = fused_ln_mlp_residual(x.reshape(-1, x.shape[-1]).contiguous(),
                                gamma, beta, w1, b1, w2, b2, eps,
                                use_kernels=use_kernels)
    return out.reshape(x.shape)


def _check_ln(name, x, tensors):
    """Raises on what the kernels do not take; returns (S, d, H)."""
    if x.dim() != 2:
        raise ValueError(f"{name} takes x [S, d], got {tuple(x.shape)}")
    norm = {k: tensors.pop(k) for k in ("gamma", "beta")}
    _, S, d, H = _check(name, x[None], {k: v[None] for k, v in
                                        tensors.items()})
    for k, t in norm.items():
        if tuple(t.shape) != (d,) or t.device != x.device:
            raise ValueError(f"{name}: {k} {tuple(t.shape)} on {t.device}, "
                             f"expected ({d},) on {x.device}")
    return S, d, H


def ln_mlp_fwd(x, gamma, beta, w1, b1, w2, b2, eps: float = EPS):
    """Launches the CUDA forward; raises on a tensor or shape it does not
    take.  gamma, beta and the biases are read in f32.  On the two-pass
    route (expert_ffn.ffn_route) h = bf16(LN(x)) and the hidden activation
    live in a scratch for this call."""
    S, d, H = _check_ln(NAME, x, {"w1": w1, "b1": b1, "w2": w2, "b2": b2,
                                  "gamma": gamma, "beta": beta})
    gamma, beta, b1, b2 = (_f32_aligned(t) for t in (gamma, beta, b1, b2))
    out = torch.empty_like(x)
    if S == 0:
        return out
    scratch, ptr = _scratch(NAME, x.device, S, d, H)
    fn = _build.bind(NAME, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                           + [ctypes.c_float, ctypes.c_void_p])
    err = _build.call(
        fn, x.device, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), ptr, S, d, H, eps)
    _build.check(err, NAME, f"x {tuple(x.shape)}, hidden {H}")
    _build.count_launch(NAME, ffn_flops(1, S, d, H))
    return out


def ln_mlp_bwd(x, gamma, beta, w1, b1, w2, gr, eps: float = EPS):
    """Launches the CUDA backward: returns (dx [S, d] in x's dtype, dgamma,
    dbeta [d], dw1 [H, d], db1 [H], dw2 [d, H], db2 [d], f32).  Raises on a
    tensor or shape it does not take."""
    S, d, H = _check_ln(BWD_NAME, x, {"w1": w1, "b1": b1, "w2": w2,
                                      "g": gr, "gamma": gamma, "beta": beta})
    gamma, beta, b1 = (t.float().contiguous() for t in (gamma, beta, b1))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, d), **f32)
    dw1 = torch.empty((H, d), **f32)
    db1 = torch.empty((H,), **f32)
    dw2 = torch.empty((d, H), **f32)
    db2 = torch.empty((d,), **f32)
    if S == 0:
        for t in (dgb, dw1, db1, dw2, db2):
            t.zero_()
        return dx, dgb[0], dgb[1], dw1, db1, dw2, db2
    sms = _build.sm_count(x.device.index)
    plan = bwd_plan(1, S, d, H, sms)
    # h = bf16(LN(x)), its row statistics, a, da, the f32 dh and the
    # partials, carved by the kernel
    scratch = torch.empty(_scratch_bytes(BWD_NAME, S, d, H, plan.splits),
                          dtype=torch.uint8, device=x.device)
    fn = _build.bind(BWD_NAME, [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                               + [ctypes.c_float, ctypes.c_void_p])
    err = _build.call(
        fn, x.device, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), gr.data_ptr(),
        dx.data_ptr(), dgb.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), scratch.data_ptr(), S, d, H,
        plan.splits, *plan.grids, sms, eps)
    _build.check(err, BWD_NAME, f"x {tuple(x.shape)}, hidden {H}")
    _build.count_launch(BWD_NAME, ffn_flops(1, S, d, H, True))
    return dx, dgb[0], dgb[1], dw1, db1, dw2, db2
