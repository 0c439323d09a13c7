"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``, and
its entry points never fall back to the CPU without being asked."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _forbidden(module: str) -> bool:
    """True for ``jax``, ``repro`` and their submodules, not ``repro_torch``."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args:
            arg = node.args[0]  # a literal, or the literal head of an f-string
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.rstrip(".")


def test_guard_sees_the_forbidden_forms():
    src = ("import jax.numpy as jnp\nfrom repro.models import lm\nimport repro\n"
           "import importlib\nimportlib.import_module(f'repro.configs.{n}')\n"
           "import repro_torch\nfrom repro_torch.kernels import ops\n")
    assert [m for m in _imports(ast.parse(src)) if _forbidden(m)] == \
        ["jax.numpy", "repro.models", "repro", "repro.configs"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_the_reference(path):
    bad = [m for m in _imports(ast.parse(path.read_text())) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _entry_points():
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import ep_dispatch, serve
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine

    cfg = get_smoke_config("yi_6b")
    cpu_params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return {
        "ServeEngine": lambda: ServeEngine(cfg, cpu_params),
        "lm.init_model": lambda: lm.init_model(cfg, torch.Generator().manual_seed(0)),
        "lm.init_cache": lambda: lm.init_cache(cfg, 2, 8),
        "params_from_numpy": lambda: params_from_numpy(cfg, {}),
        "serve CLI": lambda: serve.main(["--arch", "yi_6b", "--smoke"]),
        "ep_dispatch CLI": lambda: ep_dispatch.main([]),
    }


@pytest.mark.parametrize("name", ["ServeEngine", "lm.init_model", "lm.init_cache",
                                  "params_from_numpy", "serve CLI", "ep_dispatch CLI"])
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()
