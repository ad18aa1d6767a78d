"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc: every test here is marked ``cuda`` and skips
without a card.  The file imports no JAX, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -q

Inputs are bf16 at the flagship's shapes (or cut to a few thousand rows);
tolerances are the JAX package's bf16 ones (tests/test_flash_attention.py:53)
plus a relative bound for the FFN, whose outputs are sums of hundreds of
bf16 products.  The backward kernels round p, dS and da to bf16 before
their products, as the plain versions do, but from f32 values summed in
another order, so single roundings may differ by one bf16 step: their
gradients are held to 1e-2 relative Frobenius error and to a max abs error
of 2e-2 of the reference's largest magnitude.  The int8 FFN (K7) and the
fused LN+MLP+residual forward (K5) take the FFN's tolerances, its backward
(K6) the gradients'.
"""

import pytest
import torch

from m3vit_tpu_torch.ops import _build
from m3vit_tpu_torch.ops.expert_ffn import (
    bwd_plan,
    dequantize_weight,
    expert_ffn_bwd,
    expert_ffn_bwd_plain,
    expert_ffn_fwd,
    expert_ffn_q_dequant,
    expert_ffn_q_fwd,
    fused_expert_ffn,
    fused_expert_ffn_plain,
    quantized_expert_ffn,
    quantized_expert_ffn_plain,
)
from m3vit_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_qkv,
    flash_attention_lse_plain,
    flash_attention_qkv_bwd_plain,
    flash_attention_qkv_plain,
)
from m3vit_tpu_torch.ops.ln_mlp import (
    fused_ln_mlp_residual,
    ln_mlp_bwd,
    ln_mlp_fwd,
    ln_mlp_residual_bwd_plain,
    ln_mlp_residual_plain,
)
from m3vit_tpu_torch.serve.quantize import quantize_weight

GRAD_REL_TOL, GRAD_ABS_FRAC = 1e-2, 2e-2


def _assert_grad_close(got, ref, what):
    diff = got.float() - ref.float()
    rel = (diff.norm() / ref.float().norm().clamp(min=1e-30)).item()
    err = diff.abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    assert bool(torch.isfinite(got).all()), what
    assert rel <= GRAD_REL_TOL and err <= GRAD_ABS_FRAC * scale, \
        f"{what}: rel {rel}, max abs {err} (ref max {scale})"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# (B, N, head_dim, valid_len): the flagship's N = 1025 (16 tiles of 64 and
# one row), and N below, at and one past a 64-row tile, with valid_len 1 and
# N - 1, at batch 1 and 3; the distilled backbone's N = 1026
FLASH_CASES = [(2, 1025, 32, None), (2, 1025, 64, 1000), (2, 1025, 128, None),
               (1, 77, 32, None), (3, 77, 64, 76), (1, 128, 128, 1),
               (3, 128, 32, 127), (1, 129, 64, 128), (3, 129, 128, None),
               (3, 129, 64, 1), (2, 1026, 64, None)]
FLASH_BWD_CASES = [(2, 1025, 32, None), (2, 1025, 64, None),
                   (2, 1025, 64, 1000), (2, 1025, 128, 77),
                   (1, 77, 64, None), (3, 77, 32, 76), (1, 128, 64, 1),
                   (3, 128, 128, 127), (1, 129, 32, 128), (3, 129, 64, None),
                   (1, 129, 128, 1), (2, 1026, 64, None)]
LSE_TOL = 1e-3   # lse ~ 7-10 from f32 sums of the same bf16 products


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,d,valid", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, B, N, d, valid):
    g = torch.Generator(device=cuda).manual_seed(0)
    H = 384 // d
    qkv = torch.randn(B, N, 3 * 384, device=cuda, generator=g).bfloat16()
    before = _build.launches.get("flash_attention_fwd", 0)
    got = flash_attention_qkv(qkv, H, d ** -0.5, valid)
    ref = flash_attention_qkv_plain(qkv, H, d ** -0.5, valid)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention_fwd"] == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,d,valid", [(2, 1025, 64, None),
                                         (1, 1025, 64, 1000),
                                         (3, 129, 32, 1), (1, 77, 128, None)])
def test_flash_kernels_lse_and_determinism(cuda, B, N, d, valid):
    """K1's lse against the plain logsumexp; K1 and K2 give the same bits
    in two runs on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(5)
    H, C = 384 // d, 384
    qkv = torch.randn(B, N, 3 * C, device=cuda, generator=g).bfloat16()
    dout = torch.randn(B, N, C, device=cuda, generator=g).bfloat16()
    o, lse = flash_attention_fwd(qkv, H, d ** -0.5, valid)
    o2, lse2 = flash_attention_fwd(qkv, H, d ** -0.5, valid)
    ref = flash_attention_lse_plain(qkv, H, d ** -0.5, valid)
    dq = flash_attention_bwd(qkv, o, lse, dout, H, d ** -0.5, valid)
    dq2 = flash_attention_bwd(qkv, o, lse, dout, H, d ** -0.5, valid)
    torch.cuda.synchronize()
    assert (lse - ref).abs().max().item() <= LSE_TOL
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(dq, dq2)


# K3's cases: the serving and train capacities, the 5-task eval's no-drop
# capacity at B=8 (8200 = every token), the dense MLP, and token counts
# that are not a multiple of its 128-row tile (77: one tile whose second
# 64-row half is partly past the end; 40: wholly past it); then the other
# model widths: ViT-tiny's experts (d 192, hidden 384, train capacity 88)
# and dense MLP on the fused route, ViT-base's experts (768 x 1536) and
# dense MLP (x 3072) and ViT-large's dense MLP (1024 x 4096, whose last
# 192-column output tile is a third full) on the two-pass route, each also
# at a ragged token count; then the research knobs' paths: the stacked
# 5-task pass's experts (40 rows of 1025 tokens, K 4, cf 1.25: capacity
# 12816) and a pruned bank of 8 experts at the no-drop capacity
FFN_CASES = [(16, 520, 384, 384), (1, 1000, 384, 1536), (3, 77, 128, 256),
             (16, 2568, 384, 384), (16, 8200, 384, 384), (2, 77, 384, 384),
             (1, 40, 384, 1536),
             (16, 88, 192, 384), (1, 516, 192, 768), (3, 77, 192, 384),
             (16, 1288, 768, 1536), (1, 1000, 768, 3072), (2, 77, 768, 1536),
             (1, 1000, 1024, 4096), (3, 40, 1024, 256),
             (16, 12816, 384, 384), (8, 8200, 384, 384)]


def _ffn_args(cuda, E, C, d, H, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    return (r(E, C, d).bfloat16(), (r(E, H, d) * d ** -0.5).bfloat16(),
            r(E, H) * 0.1, (r(E, d, H) * 0.5 * H ** -0.5).bfloat16(),
            r(E, d) * 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,H", FFN_CASES)
def test_ffn_kernel_matches_plain(cuda, E, C, d, H):
    h, w1, b1, w2, b2 = _ffn_args(cuda, E, C, d, H, 0)
    before = _build.launches.get("expert_ffn_fwd", 0)
    got = fused_expert_ffn(h, w1, b1, w2, b2)
    ref = fused_expert_ffn_plain(h, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert _build.launches["expert_ffn_fwd"] == before + 1
    diff = (got.float() - ref.float())
    assert bool(torch.isfinite(got).all())
    assert diff.abs().max().item() <= 2e-2
    assert (diff.norm() / ref.float().norm()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,H", [(16, 2568, 384, 384), (1, 8200, 384, 1536),
                                     (16, 8200, 384, 384), (3, 77, 128, 256),
                                     (16, 88, 192, 384), (16, 1288, 768, 1536),
                                     (1, 9608, 1024, 4096)])
def test_ffn_kernel_is_deterministic(cuda, E, C, d, H):
    """Two runs of K3 on the same inputs give the same bits."""
    args = _ffn_args(cuda, E, C, d, H, 8)
    first = expert_ffn_fwd(*args)
    second = expert_ffn_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,d,valid", FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, B, N, d, valid):
    g = torch.Generator(device=cuda).manual_seed(1)
    H, C = 384 // d, 384
    qkv = torch.randn(B, N, 3 * C, device=cuda, generator=g).bfloat16()
    dout = torch.randn(B, N, C, device=cuda, generator=g).bfloat16()
    o, lse = flash_attention_fwd(qkv, H, d ** -0.5, valid)
    before = _build.launches.get("flash_attention_bwd", 0)
    got = flash_attention_bwd(qkv, o, lse, dout, H, d ** -0.5, valid)
    ref = flash_attention_qkv_bwd_plain(qkv, o, lse, dout, H, d ** -0.5,
                                        valid)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention_bwd"] == before + 1
    for i, name in enumerate("qkv"):
        sl = slice(i * C, (i + 1) * C)
        if valid == 1 and name != "v":
            # one valid key: p is one-hot, so dS = p (dP - delta) is 0 in
            # exact arithmetic and dq, dk are rounding noise (~1e-6 from
            # dP and delta ~ 8), where a relative error means nothing
            assert got[..., sl].float().abs().max().item() <= 1e-3, name
            continue
        _assert_grad_close(got[..., sl], ref[..., sl], f"d{name}")
    if valid is not None:   # masked keys get no gradient
        assert got[:, valid:, C:].abs().max().item() == 0.0


# K4's cases: the flagship's expert banks at the train capacity (2568
# tokens), its dense MLP (8200 tokens: 2 token splits of the weight
# gradients on 132 SMs), and shorter or ragged token counts (77: rows of
# 256 B, not a multiple of the 128-row tile; 2 splits); the stacked 5-task
# pass's experts (capacity 12816)
FFN_BWD_CASES = [(16, 520, 384, 384), (1, 1000, 384, 1536), (3, 77, 128, 256),
                 (16, 2568, 384, 384), (1, 8200, 384, 1536),
                 (16, 88, 192, 384), (1, 516, 192, 768), (16, 1288, 768, 1536),
                 (2, 77, 768, 1536), (1, 1000, 1024, 4096), (3, 77, 1024, 256),
                 (16, 12816, 384, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,H", FFN_BWD_CASES)
def test_ffn_bwd_kernel_matches_plain(cuda, E, C, d, H):
    g = torch.Generator(device=cuda).manual_seed(2)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    h = r(E, C, d).bfloat16()
    w1, w2 = (r(E, H, d) * d ** -0.5).bfloat16(), (r(E, d, H) * 0.5 * H ** -0.5).bfloat16()
    b1 = r(E, H) * 0.1
    gy = r(E, C, d).bfloat16()
    before = _build.launches.get("expert_ffn_bwd", 0)
    got = expert_ffn_bwd(h, w1, b1, w2, gy)
    ref = expert_ffn_bwd_plain(h, w1, b1, w2, gy)
    torch.cuda.synchronize()
    assert _build.launches["expert_ffn_bwd"] == before + 1
    assert got[0].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in got[1:])
    for name, a, b in zip(("dh", "dw1", "db1", "dw2", "db2"), got, ref):
        _assert_grad_close(a, b, name)


@pytest.mark.cuda
def test_ffn_bwd_cases_include_split_token_ranges(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert any(bwd_plan(*case, sms).splits > 1 for case in FFN_BWD_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [3, 16])
def test_ffn_bwd_kernel_matches_plain_at_other_splits(cuda, splits):
    """K4 under a plan other than the planner's: more token splits than one
    wave holds (grid smaller than the tiles), up to one a k-step."""
    E, C, d, H = 1, 1000, 384, 1536
    g = torch.Generator(device=cuda).manual_seed(4)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    h = r(E, C, d).bfloat16()
    w1, w2 = (r(E, H, d) * d ** -0.5).bfloat16(), (r(E, d, H) * 0.5 * H ** -0.5).bfloat16()
    b1 = r(E, H) * 0.1
    gy = r(E, C, d).bfloat16()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = bwd_plan(E, C, d, H, sms, splits=splits)
    assert plan.splits == splits
    got = expert_ffn_bwd(h, w1, b1, w2, gy, plan=plan)
    ref = expert_ffn_bwd_plain(h, w1, b1, w2, gy)
    for name, a, b in zip(("dh", "dw1", "db1", "dw2", "db2"), got, ref):
        _assert_grad_close(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,H", [(16, 2568, 384, 384), (3, 77, 128, 256),
                                     (16, 88, 192, 384), (16, 1288, 768, 1536),
                                     (1, 1000, 1024, 4096)])
def test_ffn_bwd_kernel_is_deterministic(cuda, E, C, d, H):
    """Two runs of K4 on the same inputs give the same bits (no atomics;
    split partials summed in a fixed order)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    args = (r(E, C, d).bfloat16(), (r(E, H, d) * d ** -0.5).bfloat16(),
            r(E, H) * 0.1, (r(E, d, H) * 0.5 * H ** -0.5).bfloat16(),
            r(E, C, d).bfloat16())
    first = expert_ffn_bwd(*args)
    second = expert_ffn_bwd(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dh", "dw1", "db1", "dw2", "db2"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_autograd_functions_launch_the_backward_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 130, 3 * 128, device=cuda,
                      generator=g).bfloat16().requires_grad_()
    w1 = torch.randn(4, 256, 128, device=cuda, generator=g).mul_(0.05)
    w1.requires_grad_()
    before = dict(_build.launches)
    out = flash_attention_qkv(qkv, 2, 0.125)
    y = fused_expert_ffn(out.reshape(2, 130, 128)[:, :128].reshape(4, 64, 128)
                         .contiguous(), w1, torch.zeros(4, 256, device=cuda),
                         w1.transpose(1, 2), torch.zeros(4, 128, device=cuda))
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "expert_ffn_fwd", "expert_ffn_bwd"):
        assert _build.launches[name] == before.get(name, 0) + 1, name
    assert qkv.grad.dtype == torch.bfloat16 and w1.grad.dtype == torch.float32
    assert bool(torch.isfinite(qkv.grad).all() and torch.isfinite(w1.grad).all())


def _ffn_close(got, ref):
    diff = got.float() - ref.float()
    assert bool(torch.isfinite(got).all())
    assert diff.abs().max().item() <= 2e-2
    assert (diff.norm() / ref.float().norm()).item() <= 1e-2


def _ffn_q_args(cuda, E, C, d, H, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    q1, s1 = quantize_weight(r(E, H, d) * d ** -0.5)
    q2, s2 = quantize_weight(r(E, d, H) * 0.5 * H ** -0.5)
    return r(E, C, d).bfloat16(), q1, s1, r(E, H) * 0.1, q2, s2, r(E, d) * 0.1


# bucket 1 and bucket 8 of the int8 serving path, a narrow width, and a
# 40-token tail (one 128-token tile, mostly past the end) at d = 384; the
# ViT-tiny and ViT-base expert widths (fused and two-pass routes)
@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,H", [(16, 520, 384, 384), (3, 77, 128, 256),
                                     (16, 4104, 384, 384), (2, 40, 384, 384),
                                     (3, 77, 192, 384), (16, 520, 768, 1536),
                                     (2, 40, 768, 1536), (2, 40, 1024, 256)])
def test_ffn_q_kernel_matches_plain(cuda, E, C, d, H):
    h, q1, s1, b1, q2, s2, b2 = _ffn_q_args(cuda, E, C, d, H, 4)
    before = _build.launches.get("expert_ffn_q_fwd", 0)
    with torch.inference_mode():
        got = quantized_expert_ffn(h, q1, s1, b1, q2, s2, b2)
    ref = quantized_expert_ffn_plain(h, q1, s1, b1, q2, s2, b2)
    torch.cuda.synchronize()
    assert _build.launches["expert_ffn_q_fwd"] == before + 1
    _ffn_close(got, ref)
    with pytest.raises(RuntimeError, match="inference-only"):
        quantized_expert_ffn(h, q1, s1, b1.requires_grad_(), q2, s2, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("E,d,H", [(16, 384, 384), (3, 128, 256),
                                   (3, 192, 384), (16, 768, 1536)])
def test_ffn_q_dequant_pass_is_bitwise_plain(cuda, E, d, H):
    """K7's dequantizing pass gives dequantize_weight(q, s).bfloat16() bit
    for bit: rows at -127 and 127 (and both in turn), an all-zero row, and
    scales from 1e-6 to 1e1."""
    g = torch.Generator(device=cuda).manual_seed(12)
    banks = []
    for rows, cols in ((H, d), (d, H)):
        q = torch.randint(-127, 128, (E, rows, cols), device=cuda,
                          generator=g).to(torch.int8)
        q[0, 0], q[0, 1], q[0, 2] = 127, -127, 0
        q[-1, -1, 0::2], q[-1, -1, 1::2] = 127, -127
        s = 10.0 ** (7 * torch.rand(E, rows, device=cuda, generator=g) - 6)
        s[0, :4] = torch.tensor([1e-6, 1e1, 1.0, 0.3], device=cuda)
        banks += [q, s]
    q1, s1, q2, s2 = banks
    w1, w2 = expert_ffn_q_dequant(q1, s1, q2, s2)
    torch.cuda.synchronize()
    assert torch.equal(w1, dequantize_weight(q1, s1).bfloat16())
    assert torch.equal(w2, dequantize_weight(q2, s2).bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,H", [(16, 520, 384, 384), (3, 77, 128, 256),
                                     (3, 77, 192, 384), (16, 520, 768, 1536)])
def test_ffn_q_kernel_is_k3_on_plain_banks(cuda, E, C, d, H):
    """K7 gives K3's bits on the plain-dequantized bf16 banks."""
    h, q1, s1, b1, q2, s2, b2 = _ffn_q_args(cuda, E, C, d, H, 13)
    got = expert_ffn_q_fwd(h, q1, s1, b1, q2, s2, b2)
    ref = expert_ffn_fwd(h, dequantize_weight(q1, s1).bfloat16(), b1,
                         dequantize_weight(q2, s2).bfloat16(), b2)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,H", [(16, 4104, 384, 384), (3, 77, 128, 256),
                                     (16, 520, 768, 1536)])
def test_ffn_q_kernel_is_deterministic(cuda, E, C, d, H):
    """Two runs of K7 on the same inputs give the same bits."""
    args = _ffn_q_args(cuda, E, C, d, H, 14)
    first = expert_ffn_q_fwd(*args)
    second = expert_ffn_q_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _ln_mlp_args(cuda, S, d, H, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    return (r(S, d).bfloat16(), 1.0 + 0.1 * r(d), 0.1 * r(d),
            (r(H, d) * d ** -0.5).bfloat16(), r(H) * 0.1,
            (r(d, H) * 0.5 * H ** -0.5).bfloat16(), r(d) * 0.1,
            r(S, d).bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("S,d,H", [(1000, 384, 1536), (77, 128, 256),
                                   (8200, 384, 1536), (77, 384, 1536),
                                   (40, 384, 384), (516, 192, 768),
                                   (77, 192, 384), (8200, 768, 3072),
                                   (77, 768, 3072), (1000, 1024, 4096),
                                   (40, 1024, 256)])
def test_ln_mlp_kernel_matches_plain(cuda, S, d, H):
    x, gamma, beta, w1, b1, w2, b2, _ = _ln_mlp_args(cuda, S, d, H, 5)
    before = _build.launches.get("ln_mlp_fwd", 0)
    got = ln_mlp_fwd(x, gamma, beta, w1, b1, w2, b2)
    ref = ln_mlp_residual_plain(x, gamma, beta, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert _build.launches["ln_mlp_fwd"] == before + 1
    _ffn_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("S,d,H", [(8200, 384, 1536), (77, 128, 256),
                                   (516, 192, 768), (8200, 768, 3072),
                                   (9608, 1024, 4096)])
def test_ln_mlp_kernel_is_deterministic(cuda, S, d, H):
    """Two runs of K5 on the same inputs give the same bits."""
    x, gamma, beta, w1, b1, w2, b2, _ = _ln_mlp_args(cuda, S, d, H, 10)
    first = ln_mlp_fwd(x, gamma, beta, w1, b1, w2, b2)
    second = ln_mlp_fwd(x, gamma, beta, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("S,d,H", [(1000, 384, 1536), (77, 128, 256),
                                   (8200, 384, 1536), (516, 192, 768),
                                   (1000, 768, 3072), (1000, 1024, 4096),
                                   (77, 1024, 256)])
def test_ln_mlp_bwd_kernel_matches_plain(cuda, S, d, H):
    x, gamma, beta, w1, b1, w2, _, gr = _ln_mlp_args(cuda, S, d, H, 6)
    before = _build.launches.get("ln_mlp_bwd", 0)
    got = ln_mlp_bwd(x, gamma, beta, w1, b1, w2, gr)
    ref = ln_mlp_residual_bwd_plain(x, gamma, beta, w1, b1, w2, gr)
    torch.cuda.synchronize()
    assert _build.launches["ln_mlp_bwd"] == before + 1
    assert got[0].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in got[1:])
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2",
                           "db2"), got, ref):
        _assert_grad_close(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("S,d,H", [(8200, 384, 1536), (77, 128, 256),
                                   (516, 192, 768), (1000, 1024, 4096)])
def test_ln_mlp_bwd_kernel_is_deterministic(cuda, S, d, H):
    """Two runs of K6 on the same inputs give the same bits."""
    x, gamma, beta, w1, b1, w2, _, gr = _ln_mlp_args(cuda, S, d, H, 9)
    first = ln_mlp_bwd(x, gamma, beta, w1, b1, w2, gr)
    second = ln_mlp_bwd(x, gamma, beta, w1, b1, w2, gr)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2",
                           "db2"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_ln_mlp_function_launches_both_kernels(cuda):
    x, gamma, beta, w1, b1, w2, b2, gr = _ln_mlp_args(cuda, 130, 128, 256, 7)
    leaves = [x.requires_grad_(), gamma.requires_grad_(),
              w1.float().requires_grad_()]
    before = dict(_build.launches)
    fused_ln_mlp_residual(x, gamma, beta, leaves[2], b1, w2, b2).backward(gr)
    torch.cuda.synchronize()
    for name in ("ln_mlp_fwd", "ln_mlp_bwd"):
        assert _build.launches[name] == before.get(name, 0) + 1, name
    assert x.grad.dtype == torch.bfloat16
    assert gamma.grad.dtype == leaves[2].grad.dtype == torch.float32
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)
