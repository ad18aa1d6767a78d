"""The token persistent-sharing MoE model and the task-conditioned shared
router of the port against the JAX package (CPU, f32).

Small shapes: depth 2 (block 0 dense, block 1 MoE), d 64, 4 heads, two
PASCAL tasks, E 4, K 2, 64 x 64 images, B 2; the weights are the port's
seeded init, carried into the JAX tree by the JAX package's reference
converters (no flax init to compile) except where a module has none.
The JAX package's Gumbel uniforms and gate noise are recorded while its
program is traced (a wrapper around ``token_moe.noisy_vmoe_gate`` and an
interceptor on ``ShareabilityPredictor.__call__``, which send the draws to
the host by ``jax.debug.callback``) and fed to the port in the same order
through
``models/token_moe.py``'s ``gumbel_uniform`` / ``gate_normal``.  Each
module fixture traces and compiles its JAX programs once, and the piece
tests (transition stage, shareability heads, task-conditioned attention)
take their inputs and outputs from those programs' captures.  Train-mode
comparisons check the share masks equal first (a score within rounding of
gamma would flip a position).  Tolerances: f32 2e-5 for the streams and
the pieces, the same bits for the stacked dispatch against per-stream
calls, 1e-4 for head predictions and test_torch_port_train.py's limits
for the train step (losses 1e-5 relative, parameters after the step
2e-6).
"""

import contextlib
import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import linen as nn

from m3vit_tpu.losses.functions import loss_fn_for_task as jax_loss_fn
from m3vit_tpu.models import multitask as jmt
from m3vit_tpu.models import relation_attention as jra
from m3vit_tpu.models import token_moe as jtok
from m3vit_tpu.models.heads import VisionTransformerUpHead as JaxHead
from m3vit_tpu.models.vit_moe import VisionTransformerMoE as JaxMoEViT
from m3vit_tpu.moe import dispatch as jdisp
from m3vit_tpu.tasks import parse_task_dictionary as jax_parse
from m3vit_tpu.train.optim import build_optimizer as jax_build_optimizer
from m3vit_tpu.train.optim import share_pred_temperature as jax_temp
from m3vit_tpu.train.state import TrainState
from m3vit_tpu.train.step import make_train_step as jax_make_train_step
from m3vit_tpu.utils.torch_interop import (
    reference_backbone_sd_to_params,
    reference_pup_head_sd_to_params,
    reference_token_sd_to_params,
)
from m3vit_tpu_torch.data.synthetic import synthetic_batch
from m3vit_tpu_torch.losses.functions import loss_fn_for_task
from m3vit_tpu_torch.models import token_moe as ttok
from m3vit_tpu_torch.models.factory import build_model, init_weights
from m3vit_tpu_torch.models.relation_attention import TaskConditionedAttention
from m3vit_tpu_torch.moe import dispatch as tdisp
from m3vit_tpu_torch.train.optim import build_optimizer, \
    share_pred_temperature
from m3vit_tpu_torch.train.step import make_train_step
from m3vit_tpu_torch.utils.convert import jax_variables_to_state_dict
from m3vit_tpu_torch.utils.torch_interop import \
    load_reference_token_state_dict
from tests.jax_fast_compile import FAST_COMPILE, fast_jit as _jit
from tests.torch_port_replay import replay_head_masks

ROOT = Path(__file__).resolve().parents[1]
IMG, B = 64, 2
TASK_DICT = {"include_semseg": True, "include_sal": True}
NAMES = ["semseg", "sal"]
T = len(NAMES)
D_TASK = 16
#: the token backbone, both packages' keyword names
ARCH = dict(img_size=(IMG, IMG), patch_size=16, embed_dim=64, depth=2,
            num_heads=4, mlp_ratio=4.0, moe_mlp_ratio=1.0, moe_experts=4,
            moe_top_k=2, num_tasks=T, gate_task_specific_dim=D_TASK,
            capacity_factor=1.25, eval_capacity_factor=4.0)
WEIGHTS = {"semseg": 1.0, "sal": 5.0}
OPT = {"optimizer": "sgd", "scheduler": "poly", "epochs": 3,
       "optimizer_kwargs": {"lr": 0.01, "momentum": 0.9,
                            "weight_decay": 1e-4}}
SHARE_TEMP = 1.5
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(**over):
    bb = jtok.TokenVisionTransformerMoE(
        **{**ARCH, "multi_gate": True, **over}, use_checkpointing=False,
        use_pallas_ffn=False, dtype=jnp.float32)
    tasks = jax_parse("PASCALContext", TASK_DICT)[0]
    heads = {tk.name: JaxHead(img_size=(IMG, IMG), patch_size=16,
                              embed_dim=64, num_classes=tk.num_output)
             for tk in tasks}
    return jtok.TokenMultiTaskModel(backbone=bb, decoders=heads,
                                    tasks=tuple(NAMES))


def _config(**over):
    """The token config the port's factory reads, at the test's size."""
    return {"setup": "multi_task", "train_db_name": "PASCALContext",
            "task_dictionary": TASK_DICT, "model": "token_moe",
            "backbone": "Token_VisionTransformer_moe",
            "backbone_kwargs": {"img_size": [IMG, IMG], "patch_size": 16,
                                "embed_dim": 64, "depth": 2, "num_heads": 4,
                                "mlp_ratio": 4.0, "moe_mlp_ratio": 1.0},
            "head": "TokenVisionTransformerUpHead",
            "head_kwargs": {"img_size": [IMG, IMG], "patch_size": 16,
                            "embed_dim": 64},
            "moe_experts": 4, "moe_top_k": 2, "multi_gate": True,
            "gate_task_specific_dim": D_TASK, "moe_capacity_factor": 1.25,
            "compute_dtype": "float32", **over}


@contextlib.contextmanager
def recording_jax_draws(on_draw):
    """While tracing the JAX token model, call on_draw(kind, array) with
    each Gumbel uniform ("u") and gate noise ("n") it draws, in draw
    order."""
    orig = jtok.noisy_vmoe_gate

    def gate(gate_inp, w_gate, *, rng=None, train=False, clean_logits=None,
             **kw):
        if train and rng is not None:
            rows = (gate_inp if clean_logits is None else clean_logits
                    ).shape[0]
            on_draw("n", jax.random.normal(
                rng, (rows, w_gate.shape[-1]), jnp.float32))
        return orig(gate_inp, w_gate, rng=rng, train=train,
                    clean_logits=clean_logits, **kw)

    def share(next_fun, args, kwargs, context):
        if isinstance(context.module, jtok.ShareabilityPredictor) \
                and context.method_name == "__call__":
            x, _, train, rng = args[:4]
            if train and rng is not None:
                on_draw("u", jax.random.uniform(
                    rng, (x.shape[0] * x.shape[1], 2), minval=1e-10,
                    maxval=1.0))
        return next_fun(*args, **kwargs)

    jtok.noisy_vmoe_gate = gate
    try:
        with nn.intercept_methods(share):
            yield
    finally:
        jtok.noisy_vmoe_gate = orig


@contextlib.contextmanager
def feeding_port(draws):
    """The port's token blocks take `draws` (kind, array) in order in
    place of their own."""
    queue = list(draws)

    def take(kind):
        def fn(shape, gen, device):
            k, a = queue.pop(0)
            assert k == kind and tuple(a.shape) == tuple(shape), (k, kind)
            return torch.from_numpy(np.array(a))
        return fn

    orig = ttok.gumbel_uniform, ttok.gate_normal
    ttok.gumbel_uniform, ttok.gate_normal = take("u"), take("n")
    try:
        yield
    finally:
        ttok.gumbel_uniform, ttok.gate_normal = orig
    assert not queue, f"{len(queue)} draws left"


@contextlib.contextmanager
def calling_back(store):
    """While a JAX program is traced, what its token model computes is sent
    to `store` by host callbacks when it runs, keyed by its order in the
    trace and tagged with the phase the tracing was in (``phase[0]``, which
    the caller sets between the calls it traces): the draws ("u", "n"), each
    token block's share mask ("mask"), each shareability head's input, task
    feature and score ("share_pred"), each transition stage's and shared
    broadcast's inputs and outputs ("transition", "broadcast"), each
    task-conditioned attention's inputs and output ("attn"), the backbone's
    streams, auxiliary loss and statistics ("backbone") and the heads'
    BatchNorm outputs (("bn", module path)).  Yields `phase`."""
    order = iter(range(10 ** 6))
    phase = [None]

    def send(kind, a):
        i, p = next(order), phase[0]
        jax.debug.callback(lambda v, i=i, p=p: store.__setitem__(
            i, (p, kind, jax.tree.map(np.array, v))), a)

    def watch(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if context.method_name != "__call__":
            return out
        if isinstance(mod, jtok.TokenBlock):
            send("mask", out[1])
        elif isinstance(mod, jtok.TokenVisionTransformerMoE):
            send("backbone", out)
        elif isinstance(mod, jtok.ShareabilityPredictor):
            send("share_pred", (args[0], args[1], out))
        elif isinstance(mod, jra.TaskConditionedAttention):
            send("attn", (args[0], args[1], out))
        elif isinstance(mod, nn.BatchNorm):
            send(("bn",) + tuple(mod.scope.path), out)
        return out

    orig = jtok.transition_stage, jtok.apply_shared_broadcast

    def transition(outs, g, gamma, eps=1e-6):
        res = orig[0](outs, g, gamma, eps)
        send("transition", ((outs, g, jnp.float32(gamma)), res))
        return res

    def broadcast(outs, mask, x):
        res = orig[1](outs, mask, x)
        send("broadcast", ((outs, mask, x), res))
        return res

    jtok.transition_stage, jtok.apply_shared_broadcast = transition, \
        broadcast
    try:
        with recording_jax_draws(send), nn.intercept_methods(watch):
            yield phase
    finally:
        jtok.transition_stage, jtok.apply_shared_broadcast = orig


def _jax_program(fns, *args):
    """Traces fns ({phase: callable(*args)}) into one program under
    calling_back, compiles it once at FAST_COMPILE and runs it: ({phase:
    its outputs, numpy}, {phase: [(kind, value)] in trace order})."""
    store = {}

    def program(*args):
        out = {}
        with calling_back(store) as phase:
            for name, fn in fns.items():
                phase[0] = name
                out[name] = fn(*args)
        return out

    out = _np_tree(_jit(program)(*args))
    jax.effects_barrier()
    got = {name: [] for name in fns}
    for i in sorted(store):
        p, kind, v = store[i]
        got[p].append((kind, v))
    return out, got


def _items(got, kind):
    return [v for k, v in got if k == kind]


def _draws(got):
    return [(k, v) for k, v in got if k in ("u", "n")]


def _relu(got):
    """{task: the heads' 4 ReLU masks, NCHW} from the captured BatchNorm
    outputs."""
    bn = {k[1:]: a for k, a in got if isinstance(k, tuple)}
    return {n: [torch.from_numpy(np.ascontiguousarray(
        bn[(f"decoders_{n}", f"syncbn_fc_{i}")].transpose(0, 3, 1, 2) > 0))
        for i in range(4)] for n in NAMES}


def _port_run(module, x, train, draws=(), **kw):
    """(outputs, share masks) of a port token module (backbone or whole
    model), fed `draws` in training."""
    module.train(train)
    if train:
        kw["noise"] = torch.Generator()
    bb = getattr(module, "backbone", module)
    masks = []
    hooks = [b.register_forward_hook(lambda m, a, out: masks.append(out[1]))
             for b in bb.blocks]
    try:
        with feeding_port(draws) if train else contextlib.nullcontext(), \
                torch.no_grad():
            out = module(t(x).permute(0, 3, 1, 2), **kw)
    finally:
        for h in hooks:
            h.remove()
        module.eval()
    return out, masks


def _check_backbone(got_jax, got):
    """Share masks equal, streams 2e-5, the auxiliary loss (cv + sharing)
    1e-5 relative, the sharing and MoE statistics."""
    jstreams, jaux, jstats = _items(got_jax, "backbone")[0]
    jmasks = _items(got_jax, "mask")
    (streams, aux, stats), masks = got
    assert len(masks) == len(jmasks) == 2
    for jm, m in zip(jmasks, masks):
        np.testing.assert_array_equal(m.numpy(), jm)
    for i in range(T):
        np.testing.assert_allclose(streams[i].numpy(), jstreams[i],
                                   atol=2e-5, err_msg=f"stream {i}")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5,
                               atol=1e-7)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k].item(), float(v), rtol=1e-6,
                                   err_msg=k)
    assert float(jstats["shared_positions"]) > 0


def _reference_sd(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _jax_params(sd, multi_gate_tasks=T):
    """The JAX tree of a reference-format token state dict, by the JAX
    package's own converters."""
    params = {"backbone": reference_token_sd_to_params(
        {k[len("backbone."):]: v for k, v in sd.items()
         if k.startswith("backbone.")}, multi_gate_tasks=multi_gate_tasks)}
    stats = {}
    for n in NAMES:
        params[f"decoders_{n}"], stats[f"decoders_{n}"] = \
            reference_pup_head_sd_to_params(sd, f"decoders.{n}.")
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def pair():
    """The port's seeded token model with seeded BN running statistics,
    its weights in the JAX tree (the reference-format state dict through
    the JAX package's converters), and a batch of images."""
    model, tasks = build_model(_config(), device="cpu")
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(t(rng.randn(*v.shape).astype(np.float32) * .2))
            elif k.endswith("running_var"):
                v.copy_(t(rng.uniform(.5, 2., v.shape).astype(np.float32)))
    variables = _jax_params(_reference_sd(model))
    x = rng.randn(B, IMG, IMG, 3).astype(np.float32)
    return _jax_model(), variables, model, tasks, x


@pytest.fixture(scope="module")
def jax_step(pair):
    """One JAX program on the pair's weights and images: the whole token
    model in eval (phase "eval") and one SGD step of it at SHARE_TEMP under
    key 0 (phase "step"), everything calling_back captures of both:
    (the step's labels, {phase: outputs}, {phase: captured})."""
    jmodel, variables, _, tasks, x = pair
    labels = {k: v for k, v in synthetic_batch(
        torch.Generator().manual_seed(5), tasks, B, (IMG, IMG)).items()
        if k != "image"}
    jbatch = {"image": jnp.asarray(x), **{
        k: jnp.asarray(v.permute(0, 2, 3, 1).numpy())
        for k, v in labels.items()}}
    jstep = jax_make_train_step(
        jmodel, NAMES, {n: jax_loss_fn(n, {"edge_w": 0.95})
                        for n in NAMES}, WEIGHTS,
        donate=False, pass_share_temp=True)

    def step(v, b, key, temp):
        return jstep(TrainState.create(
            apply_fn=jmodel.apply, params=v["params"],
            tx=jax_build_optimizer(OPT, steps_per_epoch=2),
            batch_stats=v["batch_stats"]), b, key, temp)

    out, got = _jax_program({
        "eval": lambda v, b, key, temp: jmodel.apply(v, b["image"],
                                                     train=False),
        "step": step}, variables, jbatch, jax.random.key(0),
        jnp.float32(SHARE_TEMP))
    return labels, out, got


# the backbone in training on the MoE block's paths: per-task routers and
# the per-task dispatch loop (the train step's own forward); the shared
# (task-embedded) router with the stacked dispatch; the task-conditioned
# attention (block 1 reads block 0's share mask) with the reuse cache
VARIANTS = {"multi_gate_loop": {},
            "shared_gate_batched": dict(multi_gate=False,
                                        batched_dispatch=True),
            "task_attn_reuse": dict(use_task_conditioned_attn=True,
                                    attn_num_experts=3, attn_expert_top_k=2,
                                    branch_embed_dim=8)}


@pytest.fixture(scope="module")
def variant_runs(pair):
    """The backbone variants but the first, in training at SHARE_TEMP under
    gate-noise key 5, both in one JAX program (phase = variant): {variant:
    (the port's backbone, its keywords, what calling_back captured)}."""
    x = pair[4]
    port = build_model(_config(multi_gate=False, batched_dispatch=True),
                       device="cpu", seed=1)[0]
    runs = {"shared_gate_batched": (
        port.backbone, {"share_temp": SHARE_TEMP}, _jax_params(
            _reference_sd(port), 0)["params"]["backbone"])}
    # no reference converter takes the task-conditioned attention: its
    # parameters join the JAX tree by name, and jax_variables_to_state_dict
    # must carry them back
    over = VARIANTS["task_attn_reuse"]
    bb = ttok.TokenVisionTransformerMoE(**{**ARCH, **over}, multi_gate=True)
    init_weights(bb, torch.Generator().manual_seed(2))
    own = {k: v.numpy().copy() for k, v in bb.state_dict().items()}
    tree = reference_token_sd_to_params({
        **own, **{f"blocks.{i}.attn.qkv.{w}": np.zeros(1)
                  for i in range(2) for w in ("weight", "bias")}},
        multi_gate_tasks=T)
    for i in range(2):
        tree[f"block_{i}"]["attn"] = {
            k[len(f"blocks.{i}.attn."):]: v for k, v in own.items()
            if k.startswith(f"blocks.{i}.attn.") and ".proj." not in k}
        tree[f"block_{i}"]["attn"]["proj"] = {
            "kernel": own[f"blocks.{i}.attn.proj.weight"].T,
            "bias": own[f"blocks.{i}.attn.proj.bias"]}
    back = jax_variables_to_state_dict({"params": {"backbone": tree}}, [], T)
    assert {k[len("backbone."):] for k in back} == set(own)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), own[k[9:]], err_msg=k)
    bits = np.random.RandomState(3).randint(0, 2 ** T, (B, 17))
    runs["task_attn_reuse"] = (bb, {"share_temp": SHARE_TEMP,
                                    "reuse_bits": bits.astype(np.int32)},
                               tree)

    def apply(variant):
        jbb = _jax_model(**VARIANTS[variant]).backbone
        kw = runs[variant][1]
        return lambda vs, x: jbb.apply(
            {"params": vs[variant]}, x, train=True,
            rngs={"gate_noise": jax.random.key(5)}, **kw)

    _, got = _jax_program({v: apply(v) for v in runs},
                          {v: r[2] for v, r in runs.items()},
                          jnp.asarray(x))
    return {v: (r[0], r[1], got[v]) for v, r in runs.items()}


def test_token_weights_round_trip(pair):
    """jax_variables_to_state_dict carries the JAX token tree (from the
    reference-format state dict) back to exactly the port's state dict,
    and load_reference_token_state_dict loads that state dict strictly
    (a missing name raises)."""
    _, variables, model, tasks, _ = pair
    sd = jax_variables_to_state_dict(variables, tasks, T)
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        torch.testing.assert_close(v, own[k].to(v.dtype), rtol=0, atol=0)
    ref = _reference_sd(model)
    other, _ = build_model(_config(), device="cpu", seed=1)
    load_reference_token_state_dict(other, ref)
    torch.testing.assert_close(other.state_dict(), own, rtol=0, atol=0)
    ref.pop("backbone.blocks.1.shared_ffn.fc1.weight")
    with pytest.raises(RuntimeError, match="shared_ffn.fc1.weight"):
        load_reference_token_state_dict(other, ref)


def test_token_model_eval_matches_jax(pair, jax_step):
    """The whole model in eval (argmax share scores): the share masks of
    both blocks, the streams (2e-5) and statistics, and every head's
    prediction (1e-4)."""
    _, _, model, _, x = pair
    _, out, got = jax_step
    jpred, jaux, jstats = out["eval"]
    (pred, aux, stats), masks = _port_run(model, x, False)
    jmasks = _items(got["eval"], "mask")
    assert len(masks) == len(jmasks) == 2
    for jm, m in zip(jmasks, masks):
        np.testing.assert_array_equal(m.numpy(), jm)
    assert aux.item() == float(jaux) == 0.0
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k].item(), float(v), rtol=1e-6,
                                   err_msg=k)
    assert float(jstats["shared_positions"]) > 0
    for n in NAMES:
        np.testing.assert_allclose(pred[n].numpy().transpose(0, 2, 3, 1),
                                   jpred[n], atol=1e-4, err_msg=n)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_token_backbone_train_matches_jax(pair, jax_step, variant_runs,
                                          variant):
    """Block 0 (dense) and block 1 (MoE) in training at the epoch's Gumbel
    temperature, JAX's draws fed: masks equal, streams 2e-5, the cv and
    sharing losses and the statistics (computed, reused and dropped)."""
    x = pair[4]
    if variant == "multi_gate_loop":
        bb, kw, got_jax = pair[2].backbone, {"share_temp": SHARE_TEMP}, \
            jax_step[2]["step"]
    else:
        bb, kw, got_jax = variant_runs[variant]
    kw = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if "reuse_bits" in kw:
        assert float(_items(got_jax, "backbone")[0][2]["reused_tokens"]) > 0
    draws = _draws(got_jax)
    got = _port_run(bb, x, True, draws, **kw)
    _check_backbone(got_jax, got)
    if variant == "shared_gate_batched":   # stacked dispatch: the loop's bits
        for blk in bb.blocks:
            blk.batched_dispatch = False
        loop = _port_run(bb, x, True, draws, **kw)[0][0]
        for blk in bb.blocks:
            blk.batched_dispatch = True
        for i in range(T):
            torch.testing.assert_close(got[0][0][i], loop[i], rtol=0, atol=0)


def test_moe_ffn_streams_is_per_stream_calls():
    """moe_ffn_streams: the same bits as one moe_ffn_local a stream, ids
    == E among the routed ones and slots dropped; and JAX's
    moe_ffn_streams to 1e-6."""
    rng = np.random.RandomState(0)
    Ts, S, d, h, E, K, cf = 3, 40, 16, 32, 4, 2, 0.75
    x = rng.randn(Ts, S, d).astype(np.float32)
    idx = rng.randint(0, E, (Ts, S, K))
    idx[rng.rand(Ts, S) < 0.25] = E
    gates = rng.rand(Ts, S, K).astype(np.float32)
    banks = [(rng.randn(*s) * 0.2).astype(np.float32)
             for s in ((E, h, d), (E, h), (E, d, h), (E, d))]
    params = tdisp.MoEFfnParams(*map(t, banks))
    got = tdisp.moe_ffn_streams(t(x), t(idx), t(gates), params,
                                capacity_factor=cf)
    cap = tdisp.compute_capacity(S, K, E, cf)
    assert any(np.bincount(idx[s].reshape(-1), minlength=E + 1)[:E].max()
               > cap for s in range(Ts)), "no slot dropped"
    for s in range(Ts):
        one = tdisp.moe_ffn_local(t(x[s]), t(idx[s]), t(gates[s]), params,
                                  capacity=cap)
        torch.testing.assert_close(got[s], one, rtol=0, atol=0)
    jparams = jdisp.MoEFfnParams(
        w1=jnp.asarray(banks[0].transpose(0, 2, 1)), b1=jnp.asarray(banks[1]),
        w2=jnp.asarray(banks[2].transpose(0, 2, 1)), b2=jnp.asarray(banks[3]))
    ref = _jit(functools.partial(
        jdisp.moe_ffn_streams, capacity_factor=cf,
        compute_dtype=jnp.float32))(jnp.asarray(x),
                                    jnp.asarray(idx.astype(np.int32)),
                                    jnp.asarray(gates), jparams)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_transition_stage_and_sharing_loss_match_jax(jax_step):
    """Every transition stage and shared broadcast of the model's eval and
    train forwards on JAX's own inputs: masks, valid positions and
    statistics equal, the representative and the broadcast streams 2e-5;
    the sharing loss of each mask."""
    got = jax_step[2]
    stages = [v for p in ("eval", "step") for v in _items(got[p],
                                                           "transition")]
    casts = [v for p in ("eval", "step") for v in _items(got[p], "broadcast")]
    assert len(stages) == 4 and len(casts) == 8
    assert any(jm.any() and not jm.all() for _, (jm, *_rest) in stages)
    for (outs, g, gamma), (jm, jv, jx, jst) in stages:
        m, v, x, st = ttok.transition_stage(t(outs), t(g), float(gamma))
        np.testing.assert_array_equal(m.numpy(), jm)
        np.testing.assert_array_equal(v.numpy(), jv)
        np.testing.assert_allclose(x.numpy(), jx, atol=2e-5)
        for k in st:
            assert st[k].item() == float(jst[k])
    for (outs, m, x), res in casts:
        np.testing.assert_allclose(
            ttok.apply_shared_broadcast(t(outs), t(m), t(x)).numpy(), res,
            atol=2e-5)
    loss = _jit(functools.partial(jtok.sharing_regularization_loss,
                                  lam=0.01))
    for _, (jm, *_rest) in stages:
        assert ttok.sharing_regularization_loss(t(jm), 0.0).item() == 0.0
        assert ttok.sharing_regularization_loss(t(jm), 0.01).item() == \
            pytest.approx(float(loss(jnp.asarray(jm))))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_shareability_predictor_matches_jax(pair, jax_step, train):
    """Every shareability head of the model's eval forward (the argmax
    one-hot) or train step (Gumbel-softmax at SHARE_TEMP on JAX's
    uniforms), on JAX's own inputs with the task feature: 2e-5."""
    model = pair[2]
    got = jax_step[2]["step" if train else "eval"]
    calls = _items(got, "share_pred")
    us = [a for k, a in got if k == "u"]
    assert len(calls) == 2 * T and len(us) == (2 * T if train else 0)
    with torch.no_grad():
        for i, (x, te, score) in enumerate(calls):
            head = model.backbone.blocks[i // T].share_pred
            res = head(t(x), t(te), t(us[i]) if train else None,
                       SHARE_TEMP if train else None)
            np.testing.assert_allclose(res.numpy(), score, atol=2e-5,
                                       err_msg=f"call {i}")


def test_task_conditioned_attention_matches_jax(variant_runs):
    """Relation-routed Q/K/V experts (ties kept), the private, neutral
    and participant branches with their -1e30 masks, on JAX's own inputs:
    block 0 with nothing shared before it, block 1 with block 0's share
    mask; 2e-5."""
    bb, _, got = variant_runs["task_attn_reuse"]
    calls = _items(got, "attn")
    assert len(calls) == 2 and calls[0][1] is None and calls[1][1].any()
    with torch.no_grad():
        for blk, (x, mask, out) in zip(bb.blocks, calls):
            res = blk.attn(t(x), None if mask is None else t(mask))
            np.testing.assert_allclose(res.numpy(), out, atol=2e-5)


#: the task-conditioned model's config (one shared router with the task
#: feature), at the test's size
TC_CONFIG = {
    "setup": "multi_task", "train_db_name": "PASCALContext",
    "task_dictionary": TASK_DICT, "backbone": "VisionTransformer_moe",
    "backbone_kwargs": {"img_size": [32, 32], "embed_dim": 64, "depth": 2,
                        "num_heads": 4, "moe_mlp_ratio": 1},
    "head_kwargs": {"img_size": [32, 32], "embed_dim": 64},
    "moe_experts": 4, "moe_top_k": 2, "multi_gate": False,
    "gate_task_specific_dim": D_TASK, "vmoe_noisy_std": 0.0,
    "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def task_conditioned():
    """The JAX task-conditioned model, joint and with shared_prefix, on the
    port's seeded weights (the JAX package's reference converters): both
    variants' eval predictions and train-mode cv loss at gate noise 0, in
    one program; (images, variables, {shared_prefix: (pred, cv)})."""
    jtasks = jax_parse("PASCALContext", TASK_DICT)[0]
    sd = _reference_sd(build_model(TC_CONFIG, device="cpu", seed=3)[0])
    params = {"backbone": reference_backbone_sd_to_params(
        {k[len("backbone."):]: v for k, v in sd.items()
         if k.startswith("backbone.")})}
    stats = {}
    for n in NAMES:
        params[f"decoders_{n}"], stats[f"decoders_{n}"] = \
            reference_pup_head_sd_to_params(sd, f"decoders.{n}.")

    def jax_model(shared_prefix):
        bb = JaxMoEViT(img_size=(32, 32), patch_size=16, embed_dim=64,
                       depth=2, num_heads=4, moe_mlp_ratio=1.0,
                       moe_experts=4, moe_top_k=2, multi_gate=False,
                       num_tasks=T, gate_task_specific_dim=D_TASK,
                       vmoe_noisy_std=0.0, dtype=jnp.float32)
        heads = {tk.name: JaxHead(img_size=(32, 32), patch_size=16,
                                  embed_dim=64, num_classes=tk.num_output)
                 for tk in jtasks}
        return jmt.TaskConditionedMultiTaskModel(
            backbone=bb, decoders=heads, tasks=NAMES,
            shared_prefix=shared_prefix)

    jmodels = {prefix: jax_model(prefix) for prefix in (False, True)}
    x = np.random.RandomState(4).randn(B, 32, 32, 3).astype(np.float32)

    def run(variables, x):
        res = {}
        for prefix, jmodel in jmodels.items():
            pred, _, _ = jmodel.apply(variables, x, train=False)
            (_, cv, _), _ = jmodel.apply(
                variables, x, train=True, mutable=["batch_stats"],
                rngs={"gate_noise": jax.random.key(0)})
            res[prefix] = pred, cv
        return variables, res

    return (x,) + _np_tree(_jit(run)({"params": params,
                                      "batch_stats": stats},
                                     jnp.asarray(x)))


@pytest.mark.parametrize("shared_prefix", [False, True],
                         ids=["joint", "shared_prefix"])
def test_task_conditioned_model_matches_jax(task_conditioned, shared_prefix):
    """The shared router with the task feature on its input
    (gate_task_represent), one pass a task or the prefix once: eval
    predictions (1e-4), and the train-mode forward's cv loss at gate noise
    0 (1e-5 relative)."""
    x, variables, res = task_conditioned
    jpred, jcv = res[shared_prefix]
    model, tasks = build_model({**TC_CONFIG, "shared_prefix": shared_prefix},
                               device="cpu")
    assert model.multi_gate and model.shared_prefix == shared_prefix
    assert model.backbone.gate_task_represent is not None
    assert model.backbone.blocks[1].mlp.gate.w_gate.shape == (64 + D_TASK,
                                                              4)
    model.load_state_dict(jax_variables_to_state_dict(variables, tasks, 0),
                          strict=True)
    with torch.no_grad():
        pred, _, _ = model(t(x).permute(0, 3, 1, 2))
        model.train()
        _, cv, _ = model(t(x).permute(0, 3, 1, 2))
    for n in NAMES:
        np.testing.assert_allclose(pred[n].numpy().transpose(0, 2, 3, 1),
                                   jpred[n], atol=1e-4, err_msg=n)
    assert cv.item() > 0
    np.testing.assert_allclose(cv.item(), float(jcv), rtol=1e-5)


def test_token_train_step_matches_jax(pair, jax_step):
    """One SGD step of the token model from a reference-format state dict
    loaded by both packages' converters (the JAX package's
    reference_token_sd_to_params and head converter; the port's strict
    load_reference_token_state_dict), at the epoch temperature, JAX's
    draws and head ReLU masks fed: the share masks equal, every loss and
    metric to 1e-5 relative and every parameter after the step to 2e-6."""
    _, _, model, _, x = pair
    labels, out, got = jax_step
    new, m = out["step"]
    got = got["step"]
    draws, jmasks = _draws(got), _items(got, "mask")
    assert len(jmasks) == 2 and len(draws) == 2 * T + T
    jmetrics = {k: float(v) for k, v in m.items() if np.ndim(v) == 0}

    port, ptasks = build_model(_config(), device="cpu")
    load_reference_token_state_dict(port, _reference_sd(model))
    opt, schedule = build_optimizer(port.parameters(), OPT,
                                    steps_per_epoch=2)
    step = make_train_step(port, NAMES, {n: loss_fn_for_task(
        n, {"edge_w": 0.95})
                                         for n in NAMES}, WEIGHTS, opt,
                           schedule, analysis_metrics=True)
    masks = []
    hooks = [b.register_forward_hook(lambda mod, a, o: masks.append(o[1]))
             for b in port.backbone.blocks]
    tbatch = {"image": t(x).permute(0, 3, 1, 2), **labels}
    with feeding_port(draws), replay_head_masks(port, _relu(got)):
        metrics = step(tbatch, torch.Generator(), share_temp=SHARE_TEMP)
    for h in hooks:
        h.remove()
    for jm, mm in zip(jmasks, masks):
        np.testing.assert_array_equal(mm.numpy(), jm)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert metrics["loss_cv"] > 0
    got = port.state_dict()
    want = jax_variables_to_state_dict(
        {"params": new.params, "batch_stats": new.batch_stats}, ptasks, T)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-6,
                                       err_msg=k)


@pytest.mark.parametrize("p", [
    {"share_pred_temp_schedule": "cosine", "share_pred_temp_start": 1.5,
     "share_pred_temp_end": 0.5, "share_pred_temp_warmup_epochs": 5,
     "epochs": 100},
    {"share_pred_temp_schedule": "linear", "share_pred_temp_start": 2.0,
     "share_pred_temp_end": 0.25, "epochs": 7},
    {"share_pred_temp_schedule": "cosine", "epochs": 1},
    {"epochs": 10}], ids=["cosine", "linear", "one_epoch", "none"])
def test_share_pred_temperature_matches_jax(p):
    for epoch in (0, 1, 4, 5, 6, 50, 98, 99, 150):
        assert share_pred_temperature(p, epoch) == jax_temp(p, epoch)


def test_token_remat_gives_the_same_gradients(pair):
    """use_checkpointing rematerialises each block: the recompute draws
    the same Gumbel and gate noise, so the loss and every gradient equal
    those without it."""
    _, _, model, _, x = pair
    grads = []
    for remat in (False, True):
        model.backbone.use_checkpointing = remat
        model.train()
        model.zero_grad(set_to_none=True)
        pred, aux, _ = model(t(x).permute(0, 3, 1, 2),
                             noise=torch.Generator().manual_seed(0),
                             share_temp=SHARE_TEMP)
        (sum(v.square().mean() for v in pred.values()) + aux).backward()
        grads.append({n: q.grad.clone() for n, q in model.named_parameters()
                      if q.grad is not None})
    model.backbone.use_checkpointing = False
    model.eval()
    assert grads[0].keys() == grads[1].keys()
    assert "backbone.blocks.1.mlp.experts.htoh4.weight" in grads[0]
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=1e-9,
                                   msg=n)


#: the configs that refused before the token variant and the
#: task-conditioned router were ported
CONFIGS = sorted(
    [str(f.relative_to(ROOT)) for f in (ROOT / "configs" / "nyud" /
                                        "token_moe").glob("*.yml")]
    + ["configs/pascal/token_moe/pup_moe_vit_small_multi_task_baseline.yml",
       "configs/pascal/token_moe_multi_task.yml",
       "configs/smoke/tiny_token_synthetic.yml",
       "configs/nyud/vit_moe_task_conditioned.yml",
       "configs/pascal/vit_moe/pup_moe_vit_small_multi_task_baseline_onehot"
       ".yml"])


@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_and_runs(path):
    """Each of the 12 builds on the CPU (widths shrunk to d 64, depth 2,
    32 x 32; everything else as the YAML says) and runs an eval forward:
    the token model, or the task-conditioned one."""
    p = yaml.safe_load((ROOT / path).read_text())
    p["backbone_kwargs"].update(img_size=[32, 32], embed_dim=64, depth=2,
                                num_heads=4)
    p["head_kwargs"].update(img_size=[32, 32], embed_dim=64)
    p["compute_dtype"] = "float32"
    model, tasks = build_model(p, device="cpu")
    token = "token" in p["backbone"].lower()
    if token:
        assert isinstance(model, ttok.TokenMultiTaskModel)
    else:   # one pass a task, each with its task feature on the one router
        assert model.multi_gate
        assert model.backbone.gate_task_represent is not None
    with torch.no_grad():
        pred, _, stats = model(torch.zeros(1, 3, 32, 32))
    assert set(pred) == {tk.name for tk in tasks}
    assert all(torch.isfinite(v).all() for v in pred.values())
    assert ("shared_positions" in stats) == token
