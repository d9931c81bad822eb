"""The control on the card: the float32 reference computed with float8
weights, put in the program's place, must fail the cell's
limit while the program's served tokens pass it. One
seed, a short window at the cell's own load; ``bench/control.py`` takes
the readings on more seeds."""
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["deepseek7b-chat"])
def test_control_fails_and_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels")
    from bench import control
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    got = control.readings(cell, 2**31 + 977, seconds=10.0, warmup=5.0)
    stat = got["statistic"]
    assert got["program"][stat] <= got["limit"], got
    assert got["control"][stat] > got["limit"], got
