"""The port's dry run (``launch/dryrun.py``) against the reference, on the
CPU.

- The pure-Python meta of every runnable cell of ``ASSIGNED_ARCHS`` x
  ``LM_SHAPES`` on both production meshes, resident and offloaded, equals
  the reference's exactly: ``offload`` (``memory_report``),
  ``cache_bytes_global``, ``param_bytes_global`` and
  ``model_flops_global``. The reference's side is computed directly from
  ``OffloadRuntime.memory_report``, ``tree_bytes`` and
  ``costs.model_flops``: its ``build_cell`` needs 256 devices.
- One cell per step kind traced at 2 layers and full width on the fake
  16x16 and 2x16x16 meshes (the full-depth sweep is the CLI's): it ends
  ``ok`` with the kernels counted where the step runs them, exact
  argument bytes, and collectives where the mesh splits work.
- The train cell's per-device FLOPs within a stated band of
  ``model_flops / devices``.
- The CLI keeps the reference's skips and reports a failing cell.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun.py
"""
from __future__ import annotations

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import LM_SHAPES as JSHAPES  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.core.interval import OffloadPlan as JPlan  # noqa: E402
from repro.core.memory_manager import OffloadRuntime as JRuntime  # noqa: E402
from repro.models import spec as JS  # noqa: E402
from repro.models.frontends import encoder_len as jenc_len  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.transformer import pattern_info as jpattern  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, LM_SHAPES,  # noqa: E402
                                 cell_is_runnable, get_config)
from repro_torch.core.interval import NO_OFFLOAD  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.sharding.rules import MeshShape  # noqa: E402

MESHES = {"16x16": MeshShape((16, 16), ("data", "model")),
          "2x16x16": MeshShape((2, 16, 16), ("pod", "data", "model"))}


def _reference_meta(arch: str, shape_name: str, tp: int,
                    interval: int) -> dict:
    jcfg, jshape = jget_config(arch), JSHAPES[shape_name]
    model = jbuild(jcfg, tp=tp)
    meta = {}
    if jshape.step != "train":
        rt = JRuntime(model=model, plan=JPlan(jpattern(jcfg)[1], interval))
        meta["offload"] = rt.memory_report()
    if jshape.step == "decode":
        meta["cache_bytes_global"] = JS.tree_bytes(model.cache_spec(
            jshape.global_batch, jshape.seq_len, jenc_len(jcfg, jshape)))
    meta["param_bytes_global"] = JS.tree_bytes(model.spec)
    meta["model_flops_global"] = jcosts.model_flops(jcfg, jshape)
    return meta


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_pure_meta_equals_reference(arch):
    cfg = get_config(arch)
    n = 0
    for shape in LM_SHAPES.values():
        if not cell_is_runnable(cfg, shape)[0]:
            continue
        for mesh in MESHES.values():
            for interval in (NO_OFFLOAD, 2, 4):
                got = dryrun.cell_meta(cfg, shape, mesh, interval)
                want = _reference_meta(arch, shape.name,
                                       mesh.shape["model"], interval)
                assert got == want, (shape.name, mesh, interval)
                n += 1
    assert n >= 2 * 3 * 3


def test_abstract_trees_are_fake_tensors_of_the_spec(meshes):
    """``spec.abstract`` gives fake tensors of each spec's shape and dtype;
    ``abstract_with_sharding`` fake DTensors of the global shape whose local
    shard is this rank's, on the rules' placements."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.models import spec as S
    from repro_torch.models.model import build_model
    from repro_torch.sharding.rules import make_rules, placements, resolve

    cfg = _two_layers("grok-1-314b")
    model = build_model(cfg, tp=16)
    fm = FakeTensorMode()
    leaves = S.tree_leaves(S.abstract(model.spec, fm))
    specs = S.tree_leaves(model.spec, lambda x: isinstance(x, S.TensorSpec))
    assert all(isinstance(t, FakeTensor) and tuple(t.shape) == s.shape
               and t.dtype == s.dtype for t, s in zip(leaves, specs))
    mesh = meshes["16x16"]
    rules = make_rules(cfg, mesh, "train", 256)
    placed = S.tree_leaves(S.abstract_with_sharding(model.spec, mesh, rules,
                                                    fm))
    for t, s in zip(placed, specs):
        want = placements(resolve(s.shape, s.logical, rules, mesh), mesh)
        assert tuple(t.placements) == want and tuple(t.shape) == s.shape
        assert isinstance(t.to_local(), FakeTensor)
    assert any(t.to_local().numel() < t.numel() for t in placed)


@pytest.fixture(scope="module")
def meshes():
    """The fake 16x16 and 2x16x16 meshes in this process, ended after the
    module."""
    M.destroy()
    try:
        yield {"16x16": M.make_production_mesh(),
               "2x16x16": M.make_production_mesh(multi_pod=True)}
    finally:
        M.destroy()


def _two_layers(arch: str):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=2 * len(cfg.pattern))


# (arch, shape, mesh, the kernels the step launches at 2 layers)
TRACED = {
    "train_16x16": ("qwen2.5-3b", "train_4k", "16x16",
                    {"flash_attention": 4, "flash_attention_bwd": 2}),
    "train_2x16x16": ("qwen2.5-3b", "train_4k", "2x16x16",
                      {"flash_attention": 4, "flash_attention_bwd": 2}),
    "prefill_16x16": ("qwen2.5-3b", "prefill_32k", "16x16",
                      {"flash_attention": 2}),
    "decode_2x16x16": ("qwen2.5-3b", "decode_32k", "2x16x16", {}),
}


@pytest.mark.parametrize("case", sorted(TRACED))
def test_trace_a_two_layer_cell(meshes, case):
    """The cell ends ok; the kernels ran where the step runs them (train:
    a forward per layer and one more under remat, a backward per layer);
    argument bytes are the local shards' (the parameters at least split
    where the rules split them); the step's collectives are counted."""
    arch, shape_name, mesh_name, kernels = TRACED[case]
    cfg, shape = _two_layers(arch), LM_SHAPES[shape_name]
    res = dryrun.run_cell(cfg, shape, meshes[mesh_name], mesh_name,
                          verbose=False)
    assert res["ok"], res.get("traceback")
    assert res["kernel_calls"] == kernels
    assert res["flops_per_device"] > res["kernel_flops_per_device"] >= 0
    assert res["bytes_accessed_as_traced"] >= \
        res["bytes_accessed_per_device"] > 0
    mem = res["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_live_bytes"]
    assert mem["argument_bytes"] < res["param_bytes_global"] * (
        3 if shape.step == "train" else 1) + (1 << 30)
    assert res["collectives"]["bytes"]["total"] > 0
    assert res == json.loads(json.dumps(res))


def test_train_cell_flops_within_band_of_model_flops(meshes):
    """qwen2.5-3b at 2 layers and full width, train_4k on 16x16: the
    counted per-device FLOPs over ``model_flops / 256`` (6 N D, N with the
    tied embedding, whose LM-head products 6 N D already counts) lie in
    [1.05, 1.25] (reading 1.13). Above 1 by remat, which recomputes each
    layer's forward but its last product (the checkpoint stops once the
    backward has what it needs: +2 (N_layers - N_down) D, about 0.08
    here), and by causal attention in the kernels, 4 B H S^2/2 D per
    forward and 10 per backward (about 0.05); below that bound the
    embedding's lookup (no FLOPs) and the elementwise ops (not counted)
    leave room."""
    cfg, shape = _two_layers("qwen2.5-3b"), LM_SHAPES["train_4k"]
    res = dryrun.run_cell(cfg, shape, meshes["16x16"], "16x16",
                          verbose=False)
    assert res["ok"], res.get("traceback")
    ratio = res["flops_per_device"] / (res["model_flops_global"] / 256)
    assert 1.05 <= ratio <= 1.25, ratio


def test_cli_keeps_skips_and_reports_failures(meshes, tmp_path,
                                              monkeypatch):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k",
                 "--out", str(out)])
    got = json.loads(out.read_text())
    assert got == [{"arch": "qwen2.5-3b", "shape": "long_500k",
                    "skipped": cell_is_runnable(
                        get_config("qwen2.5-3b"),
                        LM_SHAPES["long_500k"])[1]}]

    def broken(*a, **k):
        raise RuntimeError("a cell that cannot trace")

    monkeypatch.setattr(dryrun, "build_cell", broken)
    with pytest.raises(SystemExit) as stop:
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(out)])
    assert stop.value.code == 1
    (cell,) = json.loads(out.read_text())
    assert cell["ok"] is False and "cannot trace" in cell["error"]
