"""A whole run of the harness on the CPU at a tiny size, its look for a
card skipped, with the timed path broken underneath: ``correct`` must come
out false for each fault a served cell can have, and true unbroken. (Half
the batch left out with the mean over the rest is a training fault, and
the exchange between chips does not exist on one card.)"""
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"


def run_tiny(config: str, mix: str, seed: int = 2**31 + 101) -> dict:
    spec = importlib.util.spec_from_file_location("bench_run_main",
                                                  BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = {"name": "tiny", "config": config, "traffic": mix, "chips": 1}
    return run.run_cell(bench, cell, seed, 3.0, False, "cpu",
                        time.perf_counter(), DATA / "configs",
                        DATA / "traffic")


def altered_token(monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    monkeypatch.setattr(ServingEngine, "_greedy",
                        lambda self, req, logits: int(
                            (np.argmax(logits) + 1) % logits.shape[-1]))


def state_unchanged(monkeypatch):
    from repro_torch.core.memory_manager import OffloadRuntime
    orig = OffloadRuntime.paged_decode_step

    def step(self, params, tokens, pos, pool, *rest):
        logits, _ = orig(self, params, tokens, pos, pool.clone(), *rest)
        return logits, pool          # the new token's KV never lands
    monkeypatch.setattr(OffloadRuntime, "paged_decode_step", step)


@pytest.mark.parametrize("config,mix", [("tiny-dense", "tiny-open"),
                                        ("tiny-moe", "tiny-closed")])
def test_unbroken_run_is_correct(config, mix):
    res = run_tiny(config, mix)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {"output_tok_s", "itl_p95_ms", "tpot_p90_ms",
            "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", [altered_token, state_unchanged])
@pytest.mark.parametrize("config,mix", [("tiny-dense", "tiny-open"),
                                        ("tiny-moe", "tiny-closed")])
def test_fault_is_not_correct(monkeypatch, fault, config, mix):
    fault(monkeypatch)
    res = run_tiny(config, mix)
    assert not res["correct"], res["checks"]
