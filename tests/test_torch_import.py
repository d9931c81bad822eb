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


def test_analyzer_baselines_simulator_import_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.core.analyzer\n"
            "import repro_torch.core.baselines\n"
            "import repro_torch.core.simulator\n"
            "assert 'repro' not in sys.modules\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_training_and_ft_import_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.training.optimizer\n"
            "import repro_torch.training.train_loop\n"
            "import repro_torch.training.compression\n"
            "import repro_torch.ft.checkpoint\n"
            "import repro_torch.ft.elastic\n"
            "import repro_torch.ft.watchdog\n"
            "import repro_torch.launch.train\n"
            "from repro_torch.data.pipeline import SyntheticTokenStream\n"
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


def test_entry_points_default_to_the_card(monkeypatch):
    """Every entry point computes on the card unless the caller asks for
    the CPU."""
    import inspect

    from repro_torch.core import analyzer
    from repro_torch.core.memory_manager import OffloadRuntime
    from repro_torch.launch import profile_engine, serve
    from repro_torch.serving.engine import ServingEngine

    for fn in (OffloadRuntime.__init__, ServingEngine.__init__,
               analyzer.PerformanceAnalyzer.__init__,
               analyzer.determinism_check, serve.build_engine,
               profile_engine.smoke_engine, profile_engine.disk_engine,
               profile_engine.measured_engine,
               profile_engine.calibrated_clock):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__

    class Built(Exception):
        pass

    def build(*args, device, **kwargs):
        raise Built(device)

    monkeypatch.setattr(serve, "build_engine", build)
    with pytest.raises(Built, match="^cuda$"):
        serve.main([])
