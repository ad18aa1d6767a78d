"""Multi-head softmax attention on the fused qkv projection (K1 forward,
K2 backward).

Counterpart of ``m3vit_tpu/ops/flash_attention.py`` (``flash_attention_qkv``
:281 and its ``custom_vjp`` :299-311, ``_fwd`` :199, ``_fwd_kernel`` :103,
``_bwd`` :236, ``_bwd_kernel`` :125).  ``flash_attention_qkv`` is a
``torch.autograd.Function``: on a CUDA tensor its forward launches the
hand-written kernel in ``csrc/flash_attention_fwd.cu`` and its backward the
one in ``csrc/flash_attention_bwd.cu``; on a CPU tensor, or with
``use_kernels=False``, both directions run the plain PyTorch versions here.
A shape the kernels do not take raises; nothing falls back to the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from m3vit_tpu_torch.ops import _build
from m3vit_tpu_torch.ops.dropout import dropout

NAME = "flash_attention_fwd"
BWD_NAME = "flash_attention_bwd"
HEAD_DIMS = (32, 64, 128)
_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                          ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def _split(qkv: torch.Tensor, num_heads: int):
    """q, k, v of the fused projection, each [B, N, H, d]."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    return tuple(qkv[..., i * C:(i + 1) * C].reshape(B, N, num_heads, -1)
                 for i in range(3))


def _scores(q, k, scale, valid_len):
    """f32 scores [B, H, N, N] with keys >= valid_len masked to -inf."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if valid_len is not None and valid_len < s.shape[-1]:
        s[..., valid_len:] = float("-inf")
    return s


def flash_attention_qkv_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                              valid_len: Optional[int] = None,
                              dropout_rate: float = 0.0,
                              rng=None) -> torch.Tensor:
    """Plain PyTorch attention with the naive path's numerics
    (m3vit_tpu/models/vit.py:114-131): scores and softmax in f32, the
    probabilities cast to qkv's dtype for p.v, f32 accumulation.  Keys at or
    past `valid_len` are masked.  dropout_rate > 0 drops probabilities with
    masks from `rng` (training's attention dropout, which the kernels do
    not have; vit.py:128-129).  qkv [B, N, 3C] -> [B, N, C]."""
    B, N, _ = qkv.shape
    q, k, v = _split(qkv, num_heads)
    p = dropout(torch.softmax(_scores(q, k, scale, valid_len),
                              dim=-1).to(qkv.dtype), dropout_rate, rng)
    o = torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float())
    return o.reshape(B, N, -1).to(qkv.dtype)


def flash_attention_lse_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                              valid_len: Optional[int] = None) -> torch.Tensor:
    """Row logsumexp of the masked f32 scores, [B, H, N] f32 (what the
    forward kernel writes for the backward)."""
    q, k, _ = _split(qkv, num_heads)
    return torch.logsumexp(_scores(q, k, scale, valid_len), dim=-1)


def flash_attention_qkv_bwd_plain(qkv, o, lse, dout, num_heads: int,
                                  scale: float,
                                  valid_len: Optional[int] = None
                                  ) -> torch.Tensor:
    """Plain backward with the TPU kernel's numerics (_bwd_kernel :125-178):
    p = exp(s - lse) from f32 scores, delta = rowsum(dO o) in f32,
    dS = p (dP - delta) scale; p and dS are rounded to qkv's dtype before
    their products, which accumulate in f32.  Returns dqkv [B, N, 3C] in
    the fused projection's layout and qkv's dtype."""
    B, N, _ = qkv.shape
    cd = qkv.dtype
    q, k, v = _split(qkv, num_heads)
    do = dout.reshape(q.shape).float()
    p = torch.exp(_scores(q, k, scale, valid_len) - lse[..., None])
    dp = torch.einsum("bnhd,bmhd->bhnm", do, v.float())
    delta = (do * o.reshape(q.shape).float()).sum(-1)          # [B, N, H]
    ds = (p * (dp - delta.permute(0, 2, 1)[..., None]) * scale).to(cd).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k.float())
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q.float())
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(cd).float(), do)
    return torch.cat([t.reshape(B, N, -1) for t in (dq, dk, dv)],
                     dim=-1).to(cd)


class _FlashAttention(torch.autograd.Function):
    """Forward K1 (or plain) saving (qkv, o, lse); backward K2 (or plain),
    as the JAX custom_vjp :299-311."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, valid_len, use_kernels):
        kernels = qkv.is_cuda and use_kernels
        if kernels:
            o, lse = flash_attention_fwd(qkv, num_heads, scale, valid_len)
        else:
            o = flash_attention_qkv_plain(qkv, num_heads, scale, valid_len)
            lse = (flash_attention_lse_plain(qkv, num_heads, scale, valid_len)
                   if ctx.needs_input_grad[0] else None)
        ctx.save_for_backward(qkv, o, lse)
        ctx.args = (num_heads, scale, valid_len, kernels)
        return o

    @staticmethod
    def backward(ctx, dout):
        qkv, o, lse = ctx.saved_tensors
        num_heads, scale, valid_len, kernels = ctx.args
        bwd = flash_attention_bwd if kernels else flash_attention_qkv_bwd_plain
        dqkv = bwd(qkv, o, lse, dout.to(qkv.dtype).contiguous(), num_heads,
                   scale, valid_len)
        return dqkv, None, None, None, None


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                        valid_len: Optional[int] = None, *,
                        use_kernels: bool = True) -> torch.Tensor:
    """softmax(q k^T * scale) v per head on qkv [B, N, 3C] laid out as the
    torch fused projection [q; k; v] (head h of q is qkv[..., h*d:(h+1)*d]).
    Returns [B, N, C], differentiable in qkv.  valid_len masks keys >=
    valid_len (default N)."""
    return _FlashAttention.apply(qkv, num_heads, scale, valid_len,
                                 use_kernels)


def attention_flops(B: int, N: int, H: int, d: int,
                    backward: bool = False) -> float:
    """The products' FLOPs of K1 (QK^T and PV over all N keys; masked keys
    included, as the plain version computes them) or of K2 (those two
    recomputed and dV, dP, dQ, dK: 10 / 4 of them)."""
    return (10.0 if backward else 4.0) * B * H * N * N * d


def _check_qkv(name: str, qkv: torch.Tensor, num_heads: int, valid_len):
    """Raises on what the kernels do not take; returns (B, N, C, d, valid)."""
    if not qkv.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv shape {tuple(qkv.shape)} is not [B, N, 3*H*d] "
                         f"for H={num_heads}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16, got {qkv.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} (qkv {tuple(qkv.shape)}, "
                         f"{num_heads} heads) not in {HEAD_DIMS}")
    valid = N if valid_len is None else int(valid_len)
    if not 1 <= valid <= N:
        raise ValueError(f"valid_len {valid} outside [1, {N}]")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    return B, N, C, d, valid


def flash_attention_fwd(qkv: torch.Tensor, num_heads: int, scale: float,
                        valid_len: Optional[int] = None):
    """Launches the CUDA kernel; returns (o [B, N, C] bf16, lse [B, H, N] f32).
    Raises on a tensor or shape the kernel does not take."""
    B, N, C, d, valid = _check_qkv(NAME, qkv, num_heads, valid_len)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, num_heads, N), dtype=torch.float32,
                      device=qkv.device)
    if B * N == 0:
        return out, lse
    err = _build.call(
        _build.bind(NAME, _FWD_ARGS), qkv.device, qkv.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, N, num_heads, d, valid,
        float(scale))
    _build.check(err, NAME, f"qkv {tuple(qkv.shape)}, heads {num_heads}")
    _build.count_launch(NAME, attention_flops(B, N, num_heads, d))
    return out, lse


def flash_attention_bwd(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, num_heads: int, scale: float,
                        valid_len: Optional[int] = None) -> torch.Tensor:
    """Launches the CUDA backward; returns dqkv [B, N, 3C] bf16 in the fused
    projection's layout.  o and lse are the forward kernel's outputs.
    Raises on a tensor or shape the kernel does not take."""
    B, N, C, d, valid = _check_qkv(BWD_NAME, qkv, num_heads, valid_len)
    for name, t, shape, dtype in (
            ("o", o, (B, N, C), qkv.dtype), ("dout", dout, (B, N, C), qkv.dtype),
            ("lse", lse, (B, num_heads, N), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{BWD_NAME}: {name} {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if t.device != qkv.device or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError(f"{BWD_NAME}: {name} must be contiguous, 16-byte "
                             f"aligned and on {qkv.device}")
    dqkv = torch.empty_like(qkv)
    if B * N == 0:
        return dqkv
    # lse * log2(e) and delta = rowsum(dO o) per 64-row query tile, written
    # by the backward's prep kernel and read by its dk/dv and dq CTAs
    stats = torch.empty((B * num_heads * -(-N // 64) * 128,),
                        dtype=torch.float32, device=qkv.device)
    err = _build.call(
        _build.bind(BWD_NAME, _BWD_ARGS), qkv.device, qkv.data_ptr(),
        o.data_ptr(), lse.data_ptr(), dout.data_ptr(), stats.data_ptr(),
        dqkv.data_ptr(), B, N, num_heads, d, valid, float(scale))
    _build.check(err, BWD_NAME, f"qkv {tuple(qkv.shape)}, heads {num_heads}")
    _build.count_launch(BWD_NAME, attention_flops(B, N, num_heads, d, True))
    return dqkv
