"""The port stands alone: it imports with JAX blocked, never imports JAX or
the reference package, and keeps the reference's engine configuration."""
from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch\n"
            "from repro_torch.launch import serve\n"
            "out = serve.main(['--device', 'cpu', '--requests', '2'])\n"
            "assert out['finished'] == 2\n"
            "assert 'repro' not in sys.modules\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_engine_config_fields_equal_reference():
    pytest.importorskip("jax")
    from repro.serving.engine import EngineConfig as Ref
    from repro_torch.serving.engine import EngineConfig as Port

    def sig(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert sig(Port) == sig(Ref)
