"""Nothing under bench/ imports JAX, its relatives or the JAX package: the
whole top-level name of every import is compared (``repro_torch`` starts
with ``repro`` and is allowed)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_check_compares_whole_names():
    import importlib.util
    spec = importlib.util.spec_from_file_location("benchrun",
                                                  BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    import sys
    sys.modules.setdefault("repro_torch_fake_probe", object())
    assert "repro" in run.FORBIDDEN
    assert "repro_torch" not in run.forbidden_modules()
    del sys.modules["repro_torch_fake_probe"]
