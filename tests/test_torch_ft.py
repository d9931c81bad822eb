"""The port's gradient compression, checkpoints, elastic resume and
watchdog against the reference, on the CPU. Checkpoints cross between the
packages: one written by either restores in the other, bit for bit.

Tolerances are the reference tests' (``tests/test_training_ft.py``):
compression none 1e-6, bf16 1e-2, int8 with error feedback 2e-2, and its
16-step mean within rtol 5e-3 / atol 5e-4.

    PYTHONPATH=src python -m pytest -q tests/test_torch_ft.py
"""
from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.reduced import reduce_config as jreduce  # noqa: E402
from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.ft.elastic import ElasticPlan as JPlan  # noqa: E402
from repro.models import spec as JS  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training.compression import reduce_gradients as jreduce_grads  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.ft import checkpoint as ckpt  # noqa: E402
from repro_torch.ft import elastic  # noqa: E402
from repro_torch.ft.watchdog import StepWatchdog, WatchdogConfig  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.spec import (params_from_numpy, tree_leaves,  # noqa: E402
                                     tree_map)
from repro_torch.training import compression as C  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_loop import opt_state_spec  # noqa: E402

ARCH = "deepseek-7b"


@pytest.fixture(scope="module")
def group():
    g = C.one_rank_group()
    yield g
    C.destroy_group()


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jreduce(jget_config(ARCH), layers=2))
    tm = build_model(reduce_config(get_config(ARCH), layers=2))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _equal_trees(got, want) -> None:
    """Port tensors against reference arrays, leaf by leaf under the same
    checkpoint keys, bit for bit."""
    got, want = ckpt._flatten(got), jckpt._flatten(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g, w = got[key], np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16), w.view(np.uint16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# Gradient compression over a one-rank group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["none", "bf16", "int8_ef"])
def test_gradient_compression_modes(group, mode):
    g = {"w": torch.linspace(-1, 1, 64).reshape(8, 8)}
    red, err = C.reduce_gradients(g, group, mode=mode)
    tol = {"none": 1e-6, "bf16": 1e-2, "int8_ef": 2e-2}[mode]
    np.testing.assert_allclose(red["w"].numpy(), g["w"].numpy(), rtol=tol,
                               atol=tol)
    assert (err is None) == (mode != "int8_ef")
    assert torch.equal(g["w"], torch.linspace(-1, 1, 64).reshape(8, 8))


@pytest.mark.parametrize("mode", ["none", "bf16", "int8_ef"])
def test_gradient_compression_matches_reference(group, mode):
    """The same leaves through both packages' reductions on one rank."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_mesh_compat

    rng = np.random.default_rng(0)
    leaves = {"a": rng.standard_normal((5, 7)).astype(np.float32) * 3,
              "b": rng.standard_normal((4,)).astype(np.float32) * 1e-3}
    mesh = make_mesh_compat((1,), ("data",))
    fn = jax.jit(shard_map(lambda gr: jreduce_grads(gr, "data", mode=mode),
                           mesh=mesh, in_specs=(P(),), out_specs=(P(), P())))
    want, jerr = fn({k: jnp.asarray(v) for k, v in leaves.items()})
    got, err = C.reduce_gradients({k: torch.from_numpy(v)
                                   for k, v in leaves.items()}, group,
                                  mode=mode)
    for k in leaves:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
        if mode == "int8_ef":
            # the residual g - q * scale: fp32 rounding at the leaf's
            # magnitude (about 9 here: one ulp is 1e-6)
            np.testing.assert_allclose(err[k].numpy(), np.asarray(jerr[k]),
                                       rtol=1e-6, atol=1e-6)


def test_int8_error_feedback_converges(group):
    """With error feedback, repeated reductions of the same gradient have
    bounded accumulated bias (residual carried, not dropped)."""
    g = {"w": torch.tensor([[1e-4, 1.0, -0.5, 0.37]] * 2)}
    err = {"w": torch.zeros_like(g["w"])}
    acc = torch.zeros_like(g["w"])
    for _ in range(16):
        red, err = C.reduce_gradients(g, group, mode="int8_ef",
                                      error_state=err)
        acc = acc + red["w"]
    np.testing.assert_allclose((acc / 16).numpy(), g["w"].numpy(),
                               rtol=5e-3, atol=5e-4)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _equal_port_trees(got, want) -> None:
    got, want = ckpt._flatten(got), ckpt._flatten(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def test_checkpoint_roundtrip(tmp_path, models):
    *_, tm, tp = models
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 7, tp, extra={"note": "x"})
    assert ckpt.latest_step(d) == 7
    restored, extra = ckpt.restore_checkpoint(d, 7, tm.spec, "cpu")
    assert extra == {"note": "x"}
    _equal_port_trees(restored, tp)


def test_checkpoint_async_and_gc(tmp_path, models):
    *_, tp = models
    d = str(tmp_path / "ckpt")
    ac = ckpt.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        ac.save(s, tp)
    ac.wait()
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(d))
    assert steps == [2, 3]
    assert not any(".tmp" in x for x in os.listdir(d))


def test_reference_checkpoint_restores_in_port(tmp_path, models):
    """Parameters and an optimizer state written by the reference restore
    in the port equal to the weights bridge's conversion."""
    jm, jp, tm, _ = models
    jopt = JO.init_opt_state(jp)
    jopt["count"] = jnp.asarray(5, jnp.int32)
    jopt["m"] = jax.tree.map(lambda x: x + 0.5, jopt["m"])
    tree = {"params": jp, "opt": jopt}
    d = str(tmp_path / "ck")
    jckpt.save_checkpoint(d, 3, tree, extra={"step": 3})
    got, extra = ckpt.restore_checkpoint(
        d, 3, {"params": tm.spec, "opt": opt_state_spec(tm)}, "cpu")
    assert extra == {"step": 3}
    _equal_port_trees(got, params_from_numpy(jax.tree.map(np.asarray, tree),
                                             "cpu"))
    _equal_trees(got["params"], jp)
    assert got["opt"]["count"].dtype == torch.int32
    assert int(got["opt"]["count"]) == 5


def test_port_checkpoint_restores_in_reference(tmp_path, models):
    jm, jp, tm, tp = models
    topt = O.init_opt_state(tp)
    topt["count"] = torch.tensor(4, dtype=torch.int32)
    for m in tree_leaves(topt["v"]):
        m.fill_(0.25)
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 9, {"params": tp, "opt": topt}, extra={"step": 9})
    from repro.training.train_loop import opt_state_spec as jopt_spec

    got, extra = jckpt.restore_checkpoint(
        d, 9, {"params": JS.abstract(jm.spec),
               "opt": JS.abstract(jopt_spec(jm))})
    assert extra == {"step": 9}
    _equal_trees(tp, got["params"])
    _equal_trees(topt, got["opt"])


# ---------------------------------------------------------------------------
# Elastic resume and the watchdog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 6, 8, 12, 16, 48, 64])
def test_elastic_plan_factors_as_reference(n):
    got = elastic.ElasticPlan.for_devices(n)
    want = JPlan.for_devices(n)
    assert (got.mesh_shape, got.axis_names) == (want.mesh_shape,
                                                want.axis_names)


def test_elastic_resume_onto_one_device(tmp_path, models):
    """The latest checkpoint restores onto the mesh of the ranks that exist
    (one, on a gloo group the test ends): DTensors placed by the rules,
    equal to the reference's parameters."""
    from repro_torch.launch import mesh as M

    jm, jp, tm, tp = models
    d = str(tmp_path / "ck")
    jckpt.save_checkpoint(d, 1, jp)
    ckpt.save_checkpoint(d, 2, tp, extra={"step": 2})
    M.destroy()
    try:
        params, extra, mesh = elastic.resume(
            reduce_config(get_config(ARCH), layers=2), d, "cpu")
        assert extra == {"step": 2} and mesh.shape == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        _equal_trees(tree_map(lambda t: t.full_tensor(), params), jp)
    finally:
        M.destroy()
    with pytest.raises(FileNotFoundError):
        elastic.resume(reduce_config(get_config(ARCH), layers=2),
                       str(tmp_path / "none"), "cpu")


def test_watchdog_flags_stragglers():
    flagged = []
    wd = StepWatchdog(WatchdogConfig(warmup_steps=2, slow_factor=1.5),
                      on_straggler=lambda s, dt, e: flagged.append(s))
    for _ in range(10):
        wd.observe(0.1)
    wd.observe(0.3)
    assert flagged == [11] and wd.events[0]["step"] == 11
    with pytest.raises(TimeoutError):
        StepWatchdog(WatchdogConfig(hard_timeout_s=0.05)).observe(0.1)
