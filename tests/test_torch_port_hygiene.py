"""Port hygiene: the PyTorch package, chip_smoke.py and the port's scripts
import nothing of JAX
or of the JAX package, and the entry points refuse to fall back to the CPU.

The import check reads the sources with ``ast``: a ``sys.modules`` check
cannot work in a process where JAX is already imported.
"""

import ast
from pathlib import Path

import pytest
import torch

from m3vit_tpu_torch.models import build_flagship
from m3vit_tpu_torch.serve import InferenceSession

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "m3vit_tpu"}
SMALL = dict(img=32, embed=128, depth=2, heads=2, experts=4, top_k=2)


def _port_files():
    return sorted((ROOT / "m3vit_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "time_ffn_fwd.py",
        ROOT / "scripts" / "time_ffn_q.py",
        ROOT / "scripts" / "cnn_grad_precision.py"]


def _imported_roots(source):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path.read_text()))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_scan_matches_exact_modules():
    # the port's own name shares the prefix and must not count as m3vit_tpu
    src = ("import m3vit_tpu_torch.ops\nfrom m3vit_tpu.ops import x\n"
           "import jax.numpy as jnp\nimportlib.import_module('flax')\n")
    roots = set(_imported_roots(src))
    assert roots == {"m3vit_tpu_torch", "m3vit_tpu", "jax", "flax"}
    assert FORBIDDEN & roots == {"m3vit_tpu", "jax", "flax"}


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship(**SMALL)
    model, tasks = build_flagship(dtype=torch.float32, device="cpu", **SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceSession(model, [t.name for t in tasks], (32, 32))
    sess = InferenceSession(model, [t.name for t in tasks], (32, 32),
                            device="cpu")
    assert sess.device.type == "cpu"


def test_left_out_options_raise():
    # the lax.scan compile strategies are not to port, nor is --n_seq yet
    for knob in ("scan_blocks", "scan_tasks"):
        with pytest.raises(NotImplementedError, match="not to port"):
            build_flagship(device="cpu", **SMALL, **{knob: True})
    from m3vit_tpu_torch.cli import train as cli
    with pytest.raises(NotImplementedError, match="--n_seq"):
        cli._refuse_unported(cli.parse_args(
            ["--config_exp", "x.yml", "--n_seq", "2"]))
    # ported since the research-knob slice: stacked tasks and sem_force
    model, _ = build_flagship(device="cpu", stacked_tasks=True, **SMALL)
    assert model.stacked_tasks
    model, _ = build_flagship(device="cpu", sem_force=True, **SMALL)
    assert model.backbone.sem_force
    # the JAX name of the fused dense sublayer is not the port's knob
    with pytest.raises(TypeError, match="use_pallas_ln_mlp"):
        build_flagship(device="cpu", use_pallas_ln_mlp=True, **SMALL)
    # ported since the training slice: builds, and a zero rate is accepted
    model, _ = build_flagship(device="cpu", shared_prefix=True,
                              drop_path_rate=0.0, **SMALL)
    assert model.shared_prefix
    # ported since the int8 / ln_mlp slice: both build; the int8 model
    # serves only.  Since the recipe slice dropout, drop-path and remat
    # build too (here beside ln_mlp, which steps aside where they act)
    model, _ = build_flagship(device="cpu", ln_mlp=True, drop_rate=0.1,
                              drop_path_rate=0.1, use_checkpointing=True,
                              **SMALL)
    assert all(b.ln_mlp for b in model.backbone.blocks[::2])
    assert model.backbone.blocks[-1].drop_path_rate == 0.1
    assert model.backbone.use_checkpointing
    model, _ = build_flagship(device="cpu", expert_weights_int8=True, **SMALL)
    assert model.state_dict()[
        "backbone.blocks.1.mlp.experts.htoh4.weight_q"].dtype == torch.int8
    with pytest.raises(RuntimeError, match="serves only"):
        model.train()
