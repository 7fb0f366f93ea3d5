"""The port's two porting rules, checked from its sources.

1. No module of `nr3d_lib_tpu_torch/`, and not `chip_smoke.py`, imports
   JAX, Flax, Optax or the JAX package `nr3d_lib_tpu`: the port runs where
   none of them is installed. Every file is parsed with `ast`, so imports
   inside functions count too, and nothing is executed.
2. An entry point's `device=None` means the card: `resolve_device(None)`
   raises when there is none, and never falls back to the CPU.
"""

import ast
from pathlib import Path

import pytest
import torch

from nr3d_lib_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nr3d_lib_tpu"}
SOURCES = sorted((REPO / "nr3d_lib_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    """(line, top-level module) of every import statement in the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", getattr(node.func, "attr", None)) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_sources_are_found():
    names = {p.name for p in SOURCES}
    assert {"lotd_brick.py", "lotd_brick4.py", "model_base.py",
            "nerf_ray_query.py", "chip_smoke.py"} <= names
    assert len(SOURCES) > 30


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_guard_catches_an_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\n\ndef f():\n    from nr3d_lib_tpu.ops import "
                 "lotd\n    import jax.numpy as jnp\n")
    assert [m for _, m in _imported_roots(f) if m in FORBIDDEN] == \
        ["nr3d_lib_tpu", "jax"]


def test_resolve_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
