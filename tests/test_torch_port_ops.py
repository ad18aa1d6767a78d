"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as the JAX package's own CPU tests
run them.  Both sides get the same numpy inputs, in f32; the tolerance
2e-5 is the JAX package's own f32 kernel tolerance
(tests/test_pallas_ffn.py).  tests/test_torch_port_kernels.py holds the
hand-written kernels against these plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from m3vit_tpu.ops.expert_ffn import fused_dense_mlp as jax_dense_mlp
from m3vit_tpu.ops.expert_ffn import fused_expert_ffn as jax_expert_ffn
from m3vit_tpu.ops.flash_attention import flash_attention_qkv as jax_flash
from m3vit_tpu_torch.ops.expert_ffn import (
    BWD_KSTEP,
    bwd_plan,
    expert_ffn_fwd,
    expert_ffn_q_dequant,
    expert_ffn_q_fwd,
    fused_dense_mlp,
    fused_expert_ffn,
)
from m3vit_tpu_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_attention_qkv,
)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tests, restored afterwards
    (a process-wide setting: left in place it would slow every later test
    file of the same worker)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("valid_len", [None, 50])
def test_flash_attention_matches_jax(valid_len):
    B, N, C, H = 2, 65, 128, 2   # N=65: no tile multiple
    scale = (C // H) ** -0.5
    qkv = np.random.RandomState(0).randn(B, N, 3 * C).astype(np.float32)
    ref = np.asarray(jax_flash(jnp.asarray(qkv), H, scale, True, valid_len))
    got = flash_attention_qkv(torch.from_numpy(qkv), H, scale, valid_len)
    assert got.shape == (B, N, C)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def _ffn_inputs(rng, E, C, d, H):
    h = rng.randn(E, C, d).astype(np.float32)
    w1 = (rng.randn(E, d, H) * 0.1).astype(np.float32)   # JAX [E, in, out]
    b1 = (rng.randn(E, H) * 0.1).astype(np.float32)
    w2 = (rng.randn(E, H, d) * 0.1).astype(np.float32)
    b2 = (rng.randn(E, d) * 0.1).astype(np.float32)
    return h, w1, b1, w2, b2


# the model widths the port's FFN kernels take (d 128 and 384 in the
# flagships, 192 in ViT-tiny, 768 in ViT-base, 1024 in ViT-large), at small
# token counts and hidden sizes
FFN_WIDTHS = [(4, 40, 128, 256), (2, 24, 192, 128), (2, 24, 768, 128),
              (2, 24, 1024, 128)]


@pytest.mark.parametrize("E,C,d,H", FFN_WIDTHS,
                         ids=[f"d{c[2]}" for c in FFN_WIDTHS])
def test_fused_expert_ffn_matches_jax(E, C, d, H):
    h, w1, b1, w2, b2 = _ffn_inputs(np.random.RandomState(1), E, C, d, H)
    ref = np.asarray(jax_expert_ffn(*map(jnp.asarray, (h, w1, b1, w2, b2)),
                                    True))
    t = torch.from_numpy
    got = fused_expert_ffn(t(h), t(w1).transpose(1, 2), t(b1),
                           t(w2).transpose(1, 2), t(b2))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("E,C,d,H", FFN_WIDTHS,
                         ids=[f"d{c[2]}" for c in FFN_WIDTHS])
def test_fused_dense_mlp_matches_jax(E, C, d, H):
    rng = np.random.RandomState(2)
    h, w1, b1, w2, b2 = _ffn_inputs(rng, 1, C, d, H)
    x = h.reshape(2, C // 2, d)
    ref = np.asarray(jax_dense_mlp(jnp.asarray(x), jnp.asarray(w1[0]),
                                   jnp.asarray(b1[0]), jnp.asarray(w2[0]),
                                   jnp.asarray(b2[0]), interpret=True))
    t = torch.from_numpy
    got = fused_dense_mlp(t(x), t(w1[0]).T, t(b1[0]), t(w2[0]).T, t(b2[0]))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_kernel_entry_points_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(torch.zeros(1, 8, 3 * 128, dtype=torch.bfloat16),
                            2, 0.125)
    z = torch.zeros(1, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_fwd(z, torch.zeros(1, 64, 128), torch.zeros(1, 64),
                       torch.zeros(1, 128, 64), torch.zeros(1, 128))
    q1, q2 = (torch.zeros(sh, dtype=torch.int8)
              for sh in ((1, 64, 128), (1, 128, 64)))
    s1, s2 = torch.ones(1, 64), torch.ones(1, 128)
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_q_fwd(z, q1, s1, torch.zeros(1, 64), q2, s2,
                         torch.zeros(1, 128))
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_q_dequant(q1, s1, q2, s2)


# (E, Ct, d, Hd): the flagship's expert banks at the train capacity and its
# dense MLP (both launched per train step), and the cuda tests' shapes
BWD_PLAN_SHAPES = [(16, 2568, 384, 384), (1, 8200, 384, 1536),
                   (16, 520, 384, 384), (1, 1000, 384, 1536),
                   (3, 77, 128, 256), (1, 77, 128, 256), (2, 4104, 128, 64)]
FLAGSHIP_BWD = BWD_PLAN_SHAPES[:2]


@pytest.mark.parametrize("E,Ct,d,Hd", BWD_PLAN_SHAPES)
def test_bwd_plan_covers_every_token_step_once(E, Ct, d, Hd):
    sms = 132
    plan = bwd_plan(E, Ct, d, Hd, sms)
    ks, n = plan.splits, -(-Ct // BWD_KSTEP)
    assert 1 <= ks <= n
    # split s reduces over k-steps [n s // ks, n (s + 1) // ks)
    steps = [(n * s // ks, n * (s + 1) // ks) for s in range(ks)]
    assert [k for b, e in steps for k in range(b, e)] == list(range(n))
    assert all(e > b for b, e in steps)   # no empty split
    # every launch is persistent: min(tiles, SMs) CTAs, none without a tile
    assert plan.grids == tuple(min(t, sms) for t in plan.tiles)
    assert all(g >= 1 for g in plan.grids)
    one = bwd_plan(E, Ct, d, Hd, sms, splits=1)
    assert plan.tiles[:2] == one.tiles[:2]
    assert plan.tiles[2] == ks * one.tiles[2]
    # the most splits that keep the weight launch within one wave
    assert ks == 1 or plan.tiles[2] <= sms
    assert ks == n or (ks + 1) * one.tiles[2] > sms
    if (E, Ct, d, Hd) in FLAGSHIP_BWD:
        # the hidden pass, half of a call's time, fills every SM many times
        assert plan.tiles[0] >= 10 * sms


# ---- FLOP counts: utils/tracing.flops_of ----------------------------------

def _plain_calls():
    """Each kernel's plain version on small inputs, with the FLOPs its
    wrapper states for the same shapes (ops/_build.count_launch)."""
    from m3vit_tpu_torch.ops import expert_ffn as ef
    from m3vit_tpu_torch.ops import flash_attention as fa
    from m3vit_tpu_torch.ops import ln_mlp as lm

    rng = np.random.RandomState(8)

    def a(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    B, N, H, Dh = 2, 40, 2, 32
    E, C, d, Hd = 3, 16, 32, 64
    qkv, o, lse, dout = a(B, N, 3 * H * Dh), a(B, N, H * Dh), a(B, H, N), \
        a(B, N, H * Dh)
    h, w1, b1, w2, b2, g = a(E, C, d), a(E, Hd, d), a(E, Hd), a(E, d, Hd), \
        a(E, d), a(E, C, d)
    q1 = torch.randint(-127, 128, (E, Hd, d), dtype=torch.int8)
    q2 = torch.randint(-127, 128, (E, d, Hd), dtype=torch.int8)
    x, gam, bet = a(C, d), a(d), a(d)
    return {
        "flash_attention_fwd": (lambda: fa.flash_attention_qkv_plain(
            qkv, H, 0.1, valid_len=30), fa.attention_flops(B, N, H, Dh)),
        "flash_attention_bwd": (lambda: fa.flash_attention_qkv_bwd_plain(
            qkv, o, lse, dout, H, 0.1), fa.attention_flops(B, N, H, Dh,
                                                           True)),
        "expert_ffn_fwd": (lambda: ef.fused_expert_ffn_plain(
            h, w1, b1, w2, b2), ef.ffn_flops(E, C, d, Hd)),
        "expert_ffn_bwd": (lambda: ef.expert_ffn_bwd_plain(
            h, w1, b1, w2, g), ef.ffn_flops(E, C, d, Hd, True)),
        "expert_ffn_q_fwd": (lambda: ef.quantized_expert_ffn_plain(
            h, q1, b1.abs(), b1, q2, b2.abs(), b2), ef.ffn_flops(E, C, d,
                                                                 Hd)),
        "ln_mlp_fwd": (lambda: lm.ln_mlp_residual_plain(
            x, gam, bet, w1[0], b1[0], w2[0], b2[0]),
            ef.ffn_flops(1, C, d, Hd)),
        "ln_mlp_bwd": (lambda: lm.ln_mlp_residual_bwd_plain(
            x, gam, bet, w1[0], b1[0], w2[0], g[0]),
            ef.ffn_flops(1, C, d, Hd, True)),
    }


@pytest.mark.parametrize("kernel", sorted(_plain_calls()))
def test_kernel_flops_are_the_plain_versions(kernel):
    """Each kernel wrapper's stated FLOPs (what flops_of adds for a launch
    on the card) equal FlopCounterMode's count of its plain version on the
    same shapes, so --flops counts the same on the card as on the CPU."""
    from m3vit_tpu_torch.ops import _build
    from m3vit_tpu_torch.utils.tracing import flops_of

    fn, stated = _plain_calls()[kernel]
    assert kernel in _build.kernel_names()
    assert flops_of(fn) == stated > 0
    before = _build.launches.get(kernel, 0)
    assert flops_of(lambda: _build.count_launch(kernel, stated)) == stated
    assert _build.launches[kernel] == before + 1
    _build.launches[kernel] = before
    assert not _build.flop_tallies


def test_flops_of_model_is_the_analytic_count():
    """flops_of on a tiny MoE model's forward on one image without autograd
    (plain path, eval, two task passes), as the CLI's --flops counts it:
    every product and convolution counted once --
    the patch embedding, qkv, attention (QK^T, PV), projection, dense MLP,
    router, the experts' padded capacity, and the heads' five convs."""
    from m3vit_tpu_torch.models import build_flagship
    from m3vit_tpu_torch.moe.dispatch import compute_capacity
    from m3vit_tpu_torch.tasks import parse_task_dictionary
    from m3vit_tpu_torch.utils.tracing import flops_of

    tasks = parse_task_dictionary("PASCALContext", {
        "include_semseg": True, "include_normals": True})[0]
    img, C, E, K, Hh = 32, 64, 4, 2, 2
    model, _ = build_flagship(img=img, embed=C, depth=2, heads=Hh,
                              experts=E, top_k=K, tasks=tasks,
                              dtype=torch.float32, device="cpu")
    x = torch.randn(1, 3, img, img)
    n = (img // 16) ** 2 + 1
    attn = 2 * n * C * 3 * C + 4 * n * n * C + 2 * n * C * C
    dense = attn + 2 * n * C * 4 * C * 2
    cap = compute_capacity(n, K, E, model.backbone.blocks[1]
                           .mlp.eval_capacity_factor)
    moe = attn + 2 * n * C * E + 4 * E * cap * C * C
    patch = 2 * (n - 1) * 3 * 16 * 16 * C
    head = 0
    side = img // 16
    for i in range(4):
        head += 2 * (side * side) * (C if i == 0 else 256) * 256 * 9
        side *= 2 if i < 3 else 1
    per_task = patch + dense + moe + head
    with torch.no_grad():   # as --flops runs it: no lse for a backward
        counted = flops_of(lambda: model(x))
    classes = sum(2 * side * side * 256 * tk.num_output for tk in tasks)
    assert counted == len(tasks) * per_task + classes


def test_module_tree_lists_every_parameter_and_buffer():
    """utils/tracing.module_tree: one line a module (its name and class,
    indented by depth) and one a parameter or buffer with its shape and
    dtype, every one of the model's."""
    from m3vit_tpu_torch.models import build_flagship
    from m3vit_tpu_torch.tasks import parse_task_dictionary
    from m3vit_tpu_torch.utils.tracing import module_tree

    tasks = parse_task_dictionary("PASCALContext",
                                  {"include_semseg": True})[0]
    model, _ = build_flagship(img=32, embed=64, depth=2, heads=2, experts=4,
                              top_k=2, tasks=tasks, device="cpu")
    lines = module_tree(model).splitlines()
    assert lines[0] == "MultiTaskModel (MultiTaskModel)"
    assert "  backbone (VisionTransformerMoE)" in lines
    assert "      proj (Conv2d)" in lines
    assert "        weight: (64, 3, 16, 16) float32" in lines
    entries = [ln for ln in lines if ": (" in ln]
    assert len(entries) == len(model.state_dict())
