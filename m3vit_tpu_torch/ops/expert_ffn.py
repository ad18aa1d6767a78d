"""Fused per-expert FFN, out = gelu(h @ w1^T + b1) @ w2^T + b2: forward (K3)
and backward (K4), and the int8-weight forward (K7).

Counterpart of ``m3vit_tpu/ops/expert_ffn.py`` (``fused_expert_ffn`` :309
and its ``custom_vjp`` :314-331, ``_ffn_forward`` :158, ``_ffn_kernel`` :145,
``_gelu_and_grad`` :196, ``_ffn_bwd_kernel`` :203, ``_ffn_backward`` :254,
``fused_dense_mlp`` :50 and the ``make_pallas_ffn_fn`` hook :400).  The
TPU kernels take any model width d (each block holds the whole of d); the
forward kernels here take d in ``FUSED_DIMS`` on the fused route and d in
``TWO_PASS_DIMS`` on the two-pass route (``ffn_route``), the backward all
of ``MODEL_DIMS``.  Weights
take the torch layout [E, out, in]: w1 [E, H, d], w2 [E, d, H] (the JAX
package keeps [E, in, out]).  ``fused_expert_ffn`` is a
``torch.autograd.Function``: on a CUDA tensor its forward launches
``csrc/expert_ffn_fwd.cu`` and its backward ``csrc/expert_ffn_bwd.cu``; on a
CPU tensor, or with ``use_kernels=False``, both run the plain versions here.
A shape the kernels do not take raises.

``quantized_expert_ffn`` (``quantized_expert_ffn`` :354 and
``_ffn_q_kernel`` :334) is the same forward on weight-only int8 banks with
one f32 scale per (expert, out channel): ``csrc/expert_ffn_q_fwd.cu`` on a
CUDA tensor (each call widens the banks once into a bf16 scratch and runs
K3's forward on it), ``quantized_expert_ffn_plain`` on the CPU.  It is
inference-only, as in the JAX package: it raises when autograd would
record it.

The Function takes the f32 master weights and casts them to h's dtype for
the products; its weight gradients stay f32 up to the parameters (the JAX
package rounds them to bf16 at the cast, expert_ffn.py:327-328).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from m3vit_tpu_torch.ops import _build
from m3vit_tpu_torch.ops.dropout import dropout

NAME = "expert_ffn_fwd"
BWD_NAME = "expert_ffn_bwd"
Q_NAME = "expert_ffn_q_fwd"
DEQUANT_SYMBOL = "expert_ffn_q_dequant"   # K7's first pass alone
# the model widths the forward kernels (K3, K5, K7) take, by route: the fused
# forward keeps a [64, d] f32 accumulator per consumer warpgroup in
# registers (csrc/ffn_fwd_wgmma.cuh), which fits up to d = 384; wider
# models write the hidden activation to a bf16 scratch and run two GEMMs
# (csrc/ffn_fwd_gemm.cuh).  The backward kernels (K4, K6) take all of them
FUSED_DIMS = (128, 192, 384)
TWO_PASS_DIMS = (768, 1024)
MODEL_DIMS = FUSED_DIMS + TWO_PASS_DIMS
HIDDEN_QUANTUM = 64
# the backward's tiles (csrc/ffn_bwd.cuh takes them from the build)
BWD_TILE_M, BWD_TILE_N, BWD_HIDDEN_TILE, BWD_KSTEP = (
    _build.FFN_BWD_TILES[k] for k in ("FFN_BWD_TILE_M", "FFN_BWD_TILE_N",
                                      "FFN_BWD_HIDDEN_TILE", "FFN_BWD_KSTEP"))


def fused_expert_ffn_plain(h, w1, b1, w2, b2, dropout_rate: float = 0.0,
                           rng=None) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics: both products
    accumulate in f32, bias and exact-erf GELU in f32, the hidden activation
    rounded to h's dtype before the second product; output in h's dtype.
    dropout_rate > 0 drops the rounded hidden activation with masks from
    `rng` (training only; m3vit_tpu/moe/dispatch.py:331-333, the kernel
    has no dropout)."""
    a = torch.bmm(h.float(), w1.float().transpose(1, 2)) + b1.float()[:, None]
    a = dropout(F.gelu(a).to(h.dtype), dropout_rate, rng)
    o = torch.bmm(a.float(), w2.float().transpose(1, 2)) + b2.float()[:, None]
    return o.to(h.dtype)


def expert_ffn_bwd_plain(h, w1, b1, w2, g):
    """Plain backward with the TPU kernel's numerics (_ffn_bwd_kernel
    :203-251, exact erf): a_pre = h w1^T + b1 in f32 (remat), a = gelu(a_pre)
    rounded to h's dtype, da = (g w2) gelu'(a_pre) rounded to h's dtype;
    dh = da w1, dw1 = da^T h, db1 = sum(da) (unrounded), dw2 = g^T a,
    db2 = sum(g).  Returns dh in h's dtype and the weight grads in f32."""
    cd = h.dtype
    hf, gf = h.float(), g.to(cd).float()
    a_pre = torch.bmm(hf, w1.float().transpose(1, 2)) + b1.float()[:, None]
    cdf = 0.5 * (1.0 + torch.erf(a_pre * (0.5 ** 0.5)))
    pdf = torch.exp(-0.5 * a_pre * a_pre) / math.sqrt(2.0 * math.pi)
    a = (a_pre * cdf).to(cd).float()
    da_f = torch.bmm(gf, w2.float()) * (cdf + a_pre * pdf)
    da = da_f.to(cd).float()
    dh = torch.bmm(da, w1.float()).to(cd)
    dw1 = torch.bmm(da.transpose(1, 2), hf)
    dw2 = torch.bmm(gf.transpose(1, 2), a)
    return dh, dw1, da_f.sum(1), dw2, gf.sum(1)


class _FusedFFN(torch.autograd.Function):
    """Forward K3 (or plain), backward K4 (or plain), as the JAX custom_vjp
    :314-331; the hidden activation is recomputed in the backward."""

    @staticmethod
    def forward(ctx, h, w1, b1, w2, b2, use_kernels):
        kernels = h.is_cuda and use_kernels
        w1c = w1.to(h.dtype).contiguous()
        w2c = w2.to(h.dtype).contiguous()
        fwd = expert_ffn_fwd if kernels else fused_expert_ffn_plain
        out = fwd(h, w1c, b1, w2c, b2)
        ctx.save_for_backward(h, w1c, b1, w2c)
        ctx.kernels = kernels
        return out

    @staticmethod
    def backward(ctx, g):
        h, w1c, b1, w2c = ctx.saved_tensors
        bwd = expert_ffn_bwd if ctx.kernels else expert_ffn_bwd_plain
        dh, dw1, db1, dw2, db2 = bwd(h, w1c, b1, w2c,
                                     g.to(h.dtype).contiguous())
        return dh, dw1, db1, dw2, db2, None


def fused_expert_ffn(h, w1, b1, w2, b2, *, use_kernels: bool = True):
    """Per-expert FFN over h [E, C, d]; w1 [E, H, d], b1 [E, H],
    w2 [E, d, H], b2 [E, d] (any float dtype: cast to h's for the
    products).  Returns [E, C, d] in h's dtype, differentiable in all
    five."""
    return _FusedFFN.apply(h, w1, b1, w2, b2, use_kernels)


def fused_dense_mlp(x, w1, b1, w2, b2, *, use_kernels: bool = True):
    """Tokenwise MLP on [..., d] through the expert kernels at E=1;
    w1 [H, d], w2 [d, H] (nn.Linear layout)."""
    h = x.reshape(1, -1, x.shape[-1])
    out = fused_expert_ffn(h, w1[None], b1[None], w2[None], b2[None],
                           use_kernels=use_kernels)
    return out.reshape(x.shape)


def ffn_route(d: int, hidden: int) -> str:
    """The forward route the kernels take for model width `d` and `hidden`
    units: "fused" or "two_pass".  Raises ValueError for a shape no kernel
    takes."""
    if hidden % HIDDEN_QUANTUM or hidden < HIDDEN_QUANTUM:
        raise ValueError(f"hidden {hidden} is not a positive multiple of "
                         f"{HIDDEN_QUANTUM}")
    if d in FUSED_DIMS:
        return "fused"
    if d in TWO_PASS_DIMS:
        return "two_pass"
    raise ValueError(f"model width {d} not taken by the FFN kernels (d in "
                     f"{MODEL_DIMS})")


def _check(name, h, tensors, weight_dtype=torch.bfloat16):
    """Raises on what the kernels do not take; returns (E, Ct, d, Hd).
    h and g are bf16, w1 and w2 `weight_dtype`."""
    if not h.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    E, Ct, d = h.shape
    Hd = tensors["w1"].shape[1]
    expect = {"w1": (E, Hd, d), "b1": (E, Hd), "w2": (E, d, Hd),
              "b2": (E, d), "g": (E, Ct, d), "s1": (E, Hd), "s2": (E, d)}
    for key, t in tensors.items():
        if tuple(t.shape) != expect[key]:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)}, expected"
                             f" {expect[key]} for h {tuple(h.shape)}")
        if t.device != h.device:
            raise ValueError(f"{name}: {key} on {t.device}, h on {h.device}")
    bf = [h] + [tensors[k] for k in ("w1", "w2", "g") if k in tensors]
    want = [torch.bfloat16] + [weight_dtype if k != "g" else torch.bfloat16
                               for k in ("w1", "w2", "g") if k in tensors]
    if [t.dtype for t in bf] != want:
        raise ValueError(f"{name} takes h/w1/w2/g as {want}, got "
                         f"{[t.dtype for t in bf]}")
    try:
        ffn_route(d, Hd)
    except ValueError as e:
        raise ValueError(f"{name}: h {tuple(h.shape)} x hidden {Hd} "
                         f"unsupported: {e}") from None
    for t in bf:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: h/w1/w2/g must be contiguous and "
                             "16-byte aligned")
    return E, Ct, d, Hd


def _f32_aligned(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous f32 tensor whose data is 16-byte aligned (the
    forward kernels read biases and LayerNorm parameters in pairs and
    fours)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scratch(name: str, device, *shape: int):
    """(tensor, pointer) of the per-call scratch kernel `name` needs for
    `shape`, or (None, 0) when it needs none."""
    n = _scratch_bytes(name, *shape)
    if not n:
        return None, 0
    t = torch.empty(n, dtype=torch.uint8, device=device)
    return t, t.data_ptr()


def expert_ffn_fwd(h, w1, b1, w2, b2) -> torch.Tensor:
    """Launches the CUDA kernel; raises on a tensor or shape it does not
    take.  Biases are read in f32 (cast here when given otherwise).  On the
    two-pass route the hidden activation [E, C, H] bf16 lives in a scratch
    for this call."""
    E, Ct, d, Hd = _check(NAME, h, {"w1": w1, "b1": b1, "w2": w2, "b2": b2})
    b1, b2 = (_f32_aligned(t) for t in (b1, b2))
    out = torch.empty_like(h)
    if E * Ct == 0:
        return out
    scratch, ptr = _scratch(NAME, h.device, E, Ct, d, Hd)
    fn = _build.bind(NAME, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
    err = _build.call(
        fn, h.device, h.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), ptr, E, Ct, d, Hd)
    _build.check(err, NAME, f"h {tuple(h.shape)}, hidden {Hd}")
    _build.count_launch(NAME)
    return out


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BwdPlan(NamedTuple):
    """How the fused FFN backward (K4, and K6 at E=1) launches: `splits`
    token ranges for the weight gradients, and the tiles and the grid of
    each tile pass (hidden, dh, dw1 + dw2)."""
    splits: int
    tiles: Tuple[int, int, int]
    grids: Tuple[int, int, int]


@functools.lru_cache(maxsize=None)
def bwd_plan(E: int, Ct: int, d: int, Hd: int, sms: int,
             splits: int = None) -> BwdPlan:
    """The launches of the backward over h [E, Ct, d] with `Hd` hidden
    units on `sms` SMs.  Each kernel is persistent: min(tiles, sms) CTAs
    walk its tiles.  dw1 [Hd, d] and dw2 [d, Hd] share one launch, each
    tile reducing over one split's token k-steps (split s of ks takes
    k-steps [n s // ks, n (s + 1) // ks)).  The split count is the most
    that keeps that launch within one wave, and at most one a k-step: a
    second wave of tiles cost more than the SMs a single wave leaves idle
    (on an H100, PERF.md).  `splits` sets the count instead, for
    holding the rule against another on the card."""
    ksteps = _cdiv(Ct, BWD_KSTEP)
    tok_tiles = _cdiv(Ct, BWD_TILE_M)
    # output tiles of dw1 [Hd, d] and of dw2 [d, Hd], all experts
    w_tiles = E * (_cdiv(Hd, BWD_TILE_M) * _cdiv(d, BWD_TILE_N)
                   + _cdiv(d, BWD_TILE_M) * _cdiv(Hd, BWD_TILE_N))
    ks = splits or max(1, min(ksteps, sms // w_tiles))
    tiles = (_cdiv(Hd, BWD_HIDDEN_TILE) * tok_tiles * E,
             tok_tiles * _cdiv(d, BWD_TILE_N) * E, w_tiles * ks)
    return BwdPlan(ks, tiles, tuple(min(t, sms) for t in tiles))


@functools.lru_cache(maxsize=None)
def _scratch_bytes(name: str, *shape: int) -> int:
    """Bytes of scratch kernel `name` needs (its C ``<name>_scratch``), by
    shape."""
    fn = _build.bind(name, [ctypes.c_int] * len(shape),
                     symbol=f"{name}_scratch", restype=ctypes.c_longlong)
    return int(fn(*shape))


def expert_ffn_bwd(h, w1, b1, w2, g, plan: BwdPlan = None):
    """Launches the CUDA backward: returns (dh [E, C, d] bf16, dw1 [E, H, d],
    db1 [E, H], dw2 [E, d, H], db2 [E, d] f32).  Raises on a tensor or shape
    it does not take.  `plan` replaces `bwd_plan`'s for this shape."""
    E, Ct, d, Hd = _check(BWD_NAME, h, {"w1": w1, "b1": b1, "w2": w2,
                                        "g": g})
    b1 = b1.float().contiguous()
    f32 = dict(dtype=torch.float32, device=h.device)
    dh = torch.empty_like(h)
    dw1 = torch.empty((E, Hd, d), **f32)
    db1 = torch.empty((E, Hd), **f32)
    dw2 = torch.empty((E, d, Hd), **f32)
    db2 = torch.empty((E, d), **f32)
    if E * Ct == 0:
        for t in (dw1, db1, dw2, db2):
            t.zero_()
        return dh, dw1, db1, dw2, db2
    sms = _build.sm_count(h.device.index)
    plan = plan or bwd_plan(E, Ct, d, Hd, sms)
    # a, da [E, Ct, Hd] bf16 and the f32 partials, carved by the kernel
    scratch = torch.empty(
        _scratch_bytes(BWD_NAME, E, Ct, d, Hd, plan.splits),
        dtype=torch.uint8, device=h.device)
    fn = _build.bind(BWD_NAME, [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                               + [ctypes.c_void_p])
    err = _build.call(
        fn, h.device, h.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), g.data_ptr(), dh.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), scratch.data_ptr(),
        E, Ct, d, Hd, plan.splits, *plan.grids, sms)
    _build.check(err, BWD_NAME, f"h {tuple(h.shape)}, hidden {Hd}")
    _build.count_launch(BWD_NAME)
    return dh, dw1, db1, dw2, db2


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 [..., out, in] times its f32 per-out-channel scale [..., out],
    in f32 (serve/quantize.py keeps the rule that made them)."""
    return q.float() * scale.float()[..., None]


def quantized_expert_ffn_plain(h, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """Plain version of K7: each int8 bank dequantized as
    ``(q.float() * s).to(h.dtype)``, then ``fused_expert_ffn_plain``."""
    return fused_expert_ffn_plain(h, dequantize_weight(w1, s1).to(h.dtype),
                                  b1, dequantize_weight(w2, s2).to(h.dtype),
                                  b2)


def quantized_expert_ffn(h, w1, s1, b1, w2, s2, b2, *,
                         use_kernels: bool = True) -> torch.Tensor:
    """Per-expert FFN over h [E, C, d] on int8 banks w1 [E, H, d] and
    w2 [E, d, H] with f32 scales s1 [E, H] and s2 [E, d] (one per out
    channel) and float biases b1 [E, H], b2 [E, d].  Returns [E, C, d] in
    h's dtype.  Inference only: raises when autograd would record it."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, s1, b1, s2, b2)):
        raise RuntimeError("quantized_expert_ffn is inference-only (the int8 "
                           "expert banks have no backward); run it under "
                           "torch.inference_mode() or torch.no_grad()")
    if h.is_cuda and use_kernels:
        return expert_ffn_q_fwd(h, w1, s1, b1, w2, s2, b2)
    return quantized_expert_ffn_plain(h, w1, s1, b1, w2, s2, b2)


def expert_ffn_q_fwd(h, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """Launches the int8-weight CUDA kernel (a dequantizing pass into a bf16
    scratch, then K3's forward on it, on K3's route for d); raises on a
    tensor or shape it does not take.  Scales and biases are read in f32.
    The scratch lives for this call only: the banks stay int8 between
    calls."""
    E, Ct, d, Hd = _check(Q_NAME, h, {"w1": w1, "b1": b1, "w2": w2,
                                      "b2": b2, "s1": s1, "s2": s2},
                          weight_dtype=torch.int8)
    s1, s2 = (t.float().contiguous() for t in (s1, s2))
    b1, b2 = (_f32_aligned(t) for t in (b1, b2))
    out = torch.empty_like(h)
    if E * Ct == 0:
        return out
    scratch, _ = _scratch(Q_NAME, h.device, E, Ct, d, Hd)
    fn = _build.bind(Q_NAME, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p])
    err = _build.call(
        fn, h.device, h.data_ptr(), w1.data_ptr(), s1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), E, Ct, d, Hd)
    _build.check(err, Q_NAME, f"h {tuple(h.shape)}, hidden {Hd}")
    _build.count_launch(Q_NAME)
    return out


def expert_ffn_q_dequant(w1, s1, w2, s2):
    """K7's dequantizing pass alone, for holding it bit for bit against
    ``dequantize_weight(q, s).bfloat16()`` and timing it: returns the bf16
    banks (w1 [E, H, d], w2 [E, d, H]).  Not on the serving path, and not
    counted as a K7 launch."""
    E, Hd, d = w1.shape
    # K7's checks, on a token-less h that carries the banks' E and d
    _check(DEQUANT_SYMBOL, torch.empty((E, 0, d), dtype=torch.bfloat16,
                                       device=w1.device),
           {"w1": w1, "w2": w2, "s1": s1, "s2": s2}, weight_dtype=torch.int8)
    s1, s2 = (t.float().contiguous() for t in (s1, s2))
    banks = torch.empty(2, E * Hd * d, dtype=torch.bfloat16, device=w1.device)
    fn = _build.bind(Q_NAME, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p], symbol=DEQUANT_SYMBOL)
    err = _build.call(fn, w1.device, w1.data_ptr(), s1.data_ptr(),
                      w2.data_ptr(), s2.data_ptr(), banks.data_ptr(), E, d, Hd)
    _build.check(err, DEQUANT_SYMBOL, f"banks {tuple(w1.shape)}")
    return banks[0].view(E, Hd, d), banks[1].view(E, d, Hd)
