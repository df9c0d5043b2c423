"""The port's import boundary: trlx_tpu_torch imports torch and numpy, never
jax, jaxlib, flax, optax or any module of trlx_tpu (whose name it shares as a
prefix, so module names are matched exactly). Also: the engine's entry point
runs on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "trlx_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or name == "trlx_tpu" or name.startswith("trlx_tpu.")


def test_forbidden_predicate_uses_exact_names():
    assert _forbidden("trlx_tpu") and _forbidden("trlx_tpu.serving") and _forbidden("jax.numpy")
    assert _forbidden("optax")
    assert not _forbidden("trlx_tpu_torch") and not _forbidden("trlx_tpu_torch.serving.engine")


def test_importing_every_module_loads_no_jax_and_no_trlx_tpu():
    mods = list(_modules())
    for m in ("trlx_tpu_torch.serving.engine", "trlx_tpu_torch.ops._kernels",
              "trlx_tpu_torch.trainer.ppo_trainer", "trlx_tpu_torch.trlx",
              "trlx_tpu_torch.trainer.ilql_trainer", "trlx_tpu_torch.trainer.rft_trainer",
              "trlx_tpu_torch.methods.ilql", "trlx_tpu_torch.methods.rft", "trlx_tpu_torch.data.ilql_types",
              "trlx_tpu_torch.methods.grpo", "trlx_tpu_torch.trainer.grpo_trainer", "trlx_tpu_torch.online",
              "trlx_tpu_torch.online.collector", "trlx_tpu_torch.online.environment", "trlx_tpu_torch.rollout",
              "trlx_tpu_torch.rollout.engine", "trlx_tpu_torch.rollout.staleness",
              "trlx_tpu_torch.fleet", "trlx_tpu_torch.fleet.router", "trlx_tpu_torch.fleet.ledger",
              "trlx_tpu_torch.fleet.autoscaler", "trlx_tpu_torch.fleet.scenario", "trlx_tpu_torch.rollout.broadcast",
              "trlx_tpu_torch.serving.island", "trlx_tpu_torch.obs.islands", "trlx_tpu_torch.parallel",
              "trlx_tpu_torch.parallel.mesh"):
        assert m in mods, m
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    import json

    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"trlx_tpu_torch pulled in {bad}"
    assert "torch" in loaded
    # yaml (and other optional host packages) load only when used
    assert "yaml" not in loaded


def _forbidden_imports(paths):
    offenders = []
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    return offenders


def test_chip_smoke_and_the_port_scripts_name_no_forbidden_import():
    """chip_smoke.py, the port's scripts and the example module its gates
    take their walks from import nothing of JAX or trlx_tpu either."""
    paths = [ROOT / "chip_smoke.py", *sorted((ROOT / "scripts").glob("torch_*.py")),
             ROOT / "examples" / "randomwalks" / "__init__.py", ROOT / "examples" / "randomwalks" / "randomwalks.py"]
    assert len(paths) >= 10
    assert not _forbidden_imports(paths)


def test_sources_name_no_forbidden_import():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_engine_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for a host without one")
    from trlx_tpu_torch.models.presets import PRESETS
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.serving import ServingEngine

    cfg = PRESETS["gpt2"].replace(vocab_size=11, hidden_size=8, num_layers=1, num_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(TransformerLM(cfg), num_slots=1, max_seq_len=8)
    ServingEngine(TransformerLM(cfg), num_slots=1, max_seq_len=8, device="cpu")


def test_no_module_level_import_of_transformers_or_safetensors():
    """The checkpoint path reads and writes safetensors and config.json
    itself: ``safetensors`` is imported nowhere, and ``transformers`` only
    inside a function (the HF tokenizer-directory branch), never at module
    level, so the package imports and checkpoints on a host without them."""
    top_level, anywhere = [], []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        module_level = set()
        for node in tree.body:
            module_level.update(id(n) for n in _outside_functions(node))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                where = f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                if top == "safetensors":
                    anywhere.append(where)
                if top in ("transformers", "safetensors") and id(node) in module_level:
                    top_level.append(where)
    assert not top_level, top_level
    assert not anywhere, anywhere


def _outside_functions(node):
    """``node`` and its descendants that are not inside a function body."""
    yield node
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        return
    for child in ast.iter_child_nodes(node):
        yield from _outside_functions(child)
