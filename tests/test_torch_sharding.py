"""The port's sharding rules, meshes and mesh paths against the reference,
on the CPU.

- ``make_rules`` and ``resolve`` equal the reference's for every arch of
  ``ASSIGNED_ARCHS`` + ``PAPER_MODELS``, each of ``LM_SHAPES`` (its step
  kind and global batch) and the 1x1, 16x16 and 2x16x16 meshes: over every
  leaf of the model spec, the cache spec and the step's inputs. The port
  reads a shape-only ``MeshShape``; the reference a
  ``jax.sharding.AbstractMesh`` (no devices either).
- A spec's placements give each rank the slice JAX's ``NamedSharding``
  gives the same device (``devices_indices_map``, read in a subprocess
  with 8 host devices).
- ``shard`` is a no-op outside a context and redistributes inside one
  (value and gradient), on a fake-backend mesh.
- The mesh paths: a 2-layer train step on a gloo 1x1 mesh, parameters,
  optimizer state and batch as DTensors, is bitwise the mesh-less port
  step, and within the train tests' tolerances of the reference's step
  under its own 1x1 mesh; a checkpoint restored onto the mesh; the mesh
  builders' backends and refusals.

Every test that starts a process group ends it (fixtures).

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharding.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial, Replicate,  # noqa: E402
                                      Shard, distribute_tensor)
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import LM_SHAPES as JSHAPES  # noqa: E402
from repro.configs.reduced import reduce_config as jreduce  # noqa: E402
from repro.launch.inputs import input_specs as jinput_specs  # noqa: E402
from repro.launch.mesh import make_mesh_compat as jmesh  # noqa: E402
from repro.models.frontends import encoder_len as jenc_len  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training.train_loop import TrainConfig as JTrainConfig  # noqa: E402
from repro.training.train_loop import build_train_step as jbuild_step  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, LM_SHAPES,  # noqa: E402
                                 PAPER_MODELS, get_config)
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream  # noqa: E402
from repro_torch.ft import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch.inputs import input_logical  # noqa: E402
from repro_torch.models import spec as S  # noqa: E402
from repro_torch.models.frontends import encoder_len  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_loop import (TrainConfig,  # noqa: E402
                                             build_train_step,
                                             opt_state_spec)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = ASSIGNED_ARCHS + PAPER_MODELS


@pytest.fixture
def gloo_1x1():
    """A 1x1 DeviceMesh on a one-rank gloo group, ended after the test."""
    M.destroy()
    mesh = M.make_mesh_compat((1, 1), ("data", "model"), "cpu")
    try:
        yield mesh
    finally:
        M.destroy()


@pytest.fixture
def fake_2x4():
    """A (2, 4) DeviceMesh on the fake backend (one process stands in for
    rank 0), ended after the test."""
    M.destroy()
    mesh = M.make_mesh_compat((2, 4), ("data", "model"), "cpu", "fake")
    try:
        yield mesh
    finally:
        M.destroy()


def _leaves(tree, path=()):
    """(path, TensorSpec) of a nested dict/list spec tree (either
    package's), dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    elif tree is not None:
        yield path, tree


def _jspec(p) -> tuple:
    """A PartitionSpec as the port's tuple (JAX keeps a one-axis entry as
    the bare name)."""
    return tuple(None if a is None else (a,) if isinstance(a, str)
                 else tuple(a) for a in p)


# ---------------------------------------------------------------------------
# Rules and resolve against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_equal_reference(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    mine, ref = R.MeshShape(sizes, names), AbstractMesh(sizes, names)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in LM_SHAPES.values():
        for gb in (shape.global_batch, None):
            assert R.make_rules(cfg, mine, shape.step, gb) == \
                JR.make_rules(jcfg, ref, shape.step, gb), (shape.name, gb)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_equal_reference_over_every_leaf(arch, mesh_name):
    """Every leaf of the model spec, the cache spec (each decode shape) and
    the inputs (each shape), under each shape's rules."""
    sizes, names = MESHES[mesh_name]
    mine, ref = R.MeshShape(sizes, names), AbstractMesh(sizes, names)
    cfg, jcfg = get_config(arch), jget_config(arch)
    tp = dict(zip(names, sizes))["model"]
    model, jmodel = build_model(cfg, tp=tp), jbuild(jcfg, tp=tp)
    n = 0
    for shape in LM_SHAPES.values():
        jshape = JSHAPES[shape.name]
        rules = R.make_rules(cfg, mine, shape.step, shape.global_batch)
        jrules = JR.make_rules(jcfg, ref, shape.step, shape.global_batch)
        trees = [(model.spec, jmodel.spec)]
        if shape.step == "decode":
            trees.append((
                model.cache_spec(shape.global_batch, shape.seq_len,
                                 encoder_len(cfg, shape)),
                jmodel.cache_spec(shape.global_batch, shape.seq_len,
                                  jenc_len(jcfg, jshape))))
        for tree, jtree in trees:
            got, want = list(_leaves(tree)), list(_leaves(jtree))
            assert [p for p, _ in got] == [p for p, _ in want]
            for (path, s), (_, js) in zip(got, want):
                assert (s.shape, s.logical) == (js.shape, js.logical), path
                assert R.resolve(s.shape, s.logical, rules, mine) == \
                    _jspec(JR.resolve(js.shape, js.logical, jrules, ref)), \
                    (shape.name, path)
                n += 1
        jins = jinput_specs(jcfg, jshape, ref, jrules)
        ins = input_logical(cfg, shape)
        assert sorted(ins) == sorted(jins)
        for k, (shp, logical, dtype) in ins.items():
            assert shp == jins[k].shape and str(dtype).split(".")[-1] == \
                jins[k].dtype.name, k
            assert R.resolve(shp, logical, rules, mine) == \
                _jspec(jins[k].sharding.spec), (shape.name, k)
            n += 1
    assert n > 0


def test_placements_of_a_spec():
    mesh = R.MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert R.placements((("pod", "data"), None, ("model",)), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert R.placements((), mesh) == (Replicate(),) * 3
    assert R.placements((None, ("data", "model")), mesh) == (
        Replicate(), Shard(1), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        R.placements((("model", "data"),), mesh)
    sh = R.named_sharding(mesh, R.make_rules(get_config("grok-1-314b"), mesh),
                          (48, 128), ("heads", None), "pinned_host")
    assert sh.spec == (("model",),) and sh.memory_kind == "pinned_host"


_JAX_SLICES = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    out = {}
    for key, spec in json.loads(os.environ["SPECS"]).items():
        spec = P(*[None if a is None else tuple(a) for a in spec])
        m = NamedSharding(mesh, spec).devices_indices_map((16, 8, 12))
        out[key] = {str(d.id): [[s.start or 0, n if s.stop is None
                                 else s.stop]
                                for s, n in zip(idx, (16, 8, 12))]
                    for d, idx in m.items()}
    print(json.dumps(out))
""")

SLICE_SPECS = {"both_on_dim0": [["data", "model"]],
               "data_then_model": [["data"], ["model"]],
               "both_on_dim1": [None, ["data", "model"]],
               "model_then_data": [["model"], ["data"]],
               "dim2_model": [["data"], None, ["model"]],
               "replicated": []}


def test_rank_to_slice_matches_jax():
    """Each rank's (offset, shape) under the spec's placements against the
    slices JAX gives the device at the same mesh position, including a dim
    split over both axes major to minor."""
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "SPECS": json.dumps(SLICE_SPECS)}
    run = subprocess.run([sys.executable, "-c", _JAX_SLICES],
                         capture_output=True, text=True, env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert run.returncode == 0, run.stderr[-2000:]
    want = json.loads(run.stdout.strip().splitlines()[-1])
    mesh = R.MeshShape((2, 4), ("data", "model"))
    shape = (16, 8, 12)
    for key, spec in SLICE_SPECS.items():
        pl = R.placements(tuple(None if a is None else tuple(a)
                                for a in spec), mesh)
        for rank in range(8):
            local, off = _compute_local_shape_and_global_offset(
                shape, (2, 4), [rank // 4, rank % 4], pl)
            got = [[o, o + n] for o, n in zip(off, local)]
            assert got == want[key][str(rank)], (key, rank)


# ---------------------------------------------------------------------------
# shard() and the context
# ---------------------------------------------------------------------------


def test_shard_is_a_noop_outside_a_context(fake_2x4):
    x = distribute_tensor(torch.randn(8, 4), fake_2x4,
                          [Replicate(), Replicate()])
    assert R.shard(x, "batch", None) is x
    plain = torch.randn(8, 4)
    rules = R.make_rules(get_config("qwen2.5-3b"), fake_2x4, "prefill", 8)
    with R.sharding_context(fake_2x4, rules):
        assert R.shard(plain, "batch", None) is plain
    with R.sharding_context(R.MeshShape((2, 4), ("data", "model")), rules):
        assert R.shard(x, "batch", None) is x


def test_shard_redistributes_value_and_gradient_inside(fake_2x4):
    """Inside a context a DTensor moves to the resolved placements, and its
    gradient is held to them too (the transpose of a sharding constraint):
    a Partial gradient arriving at the constraint is reduced onto them."""
    rules = R.make_rules(get_config("qwen2.5-3b"), fake_2x4, "prefill", 8)
    x = distribute_tensor(torch.randn(8, 6, 16), fake_2x4,
                          [Replicate(), Replicate()]).requires_grad_(True)
    with R.sharding_context(fake_2x4, rules):
        y = R.shard(x, "batch", None, "heads")
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert y.to_local().shape == (4, 6, 4)
        seen = []
        y.register_hook(lambda g: seen.append(tuple(g.placements)))
        w = distribute_tensor(torch.randn(16, 3), fake_2x4,
                              [Replicate(), Shard(0)])
        (g,) = torch.autograd.grad((y @ w).sum(), [x])
    assert isinstance(g, DTensor) and g.shape == x.shape
    assert not any(isinstance(p, Partial) for p in seen[0])


def test_rules_refuse_a_mesh_without_names(fake_2x4):
    from torch.distributed.device_mesh import DeviceMesh
    unnamed = DeviceMesh("cpu", torch.arange(8).reshape(2, 4))
    with pytest.raises(ValueError, match="mesh_dim_names"):
        R.make_rules(get_config("qwen2.5-3b"), unnamed)


# ---------------------------------------------------------------------------
# The meshes
# ---------------------------------------------------------------------------


def test_mesh_backends_and_refusals():
    M.destroy()
    try:
        one = M.make_mesh_from_spec("1x1", "cpu")
        assert torch.distributed.get_backend() == "gloo"
        assert one.shape == (1, 1) and one.mesh_dim_names == ("data",
                                                             "model")
        with pytest.raises(ValueError, match="world of"):
            M.make_mesh_from_spec("2x1", "cpu")
        M.destroy()
        with pytest.raises(ValueError, match="needs 2 processes"):
            M.make_mesh_from_spec("2x1", "cpu", "gloo")
        M.destroy()
        big = M.make_production_mesh(multi_pod=True)
        assert torch.distributed.get_backend() == "fake"
        assert big.shape == (2, 16, 16)
        assert big.mesh_dim_names == ("pod", "data", "model")
        assert M.make_production_mesh().shape == (16, 16)
        with pytest.raises(ValueError, match="mesh spec"):
            M.make_mesh_from_spec("4", "cpu")
    finally:
        M.destroy()


# ---------------------------------------------------------------------------
# The train step on a 1x1 mesh
# ---------------------------------------------------------------------------

ARCH = "qwen2.5-3b"
SHAPE = ShapeSpec("tiny", 16, 2, "train")


def _bridged():
    from repro.configs.base import ShapeSpec as JShape
    from repro.data.pipeline import DataConfig as JData
    from repro.data.pipeline import SyntheticTokenStream as JStream

    jcfg = jreduce(jget_config(ARCH), layers=2)
    cfg = reduce_config(get_config(ARCH), layers=2)
    jm, tm = jbuild(jcfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = S.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jb = JStream(jcfg, JShape("tiny", 16, 2, "train"), JData(seed=1)).batch(0)
    return jcfg, cfg, jm, jp, jb, tm, tp


def test_train_step_on_1x1_mesh_is_bitwise_the_plain_step(gloo_1x1):
    """Two AdamW steps, once on plain tensors and once with parameters,
    optimizer state and batch as DTensors on the gloo 1x1 mesh under the
    rules' context: the same losses and parameters, bit for bit; then the
    reference's step under its own 1x1 mesh within the train tests'
    tolerances (loss, grad_norm and lr at rtol 2e-2; each parameter at
    bf16 tolerance)."""
    jcfg, cfg, jm, jp, jb, tm, tp = _bridged()
    ocfg = dict(lr=1e-3, warmup_steps=1)
    step = build_train_step(tm, TrainConfig(optimizer=O.AdamWConfig(**ocfg)))
    rules = R.make_rules(cfg, gloo_1x1)
    batch = SyntheticTokenStream(cfg, SHAPE, DataConfig(seed=1),
                                 device="cpu").batch(0)
    plain_p = S.tree_map(torch.clone, tp)
    plain_o = O.init_opt_state(plain_p)
    mesh_p = S.place(S.tree_map(torch.clone, tp), tm.spec, gloo_1x1, rules)
    mesh_o = O.init_opt_state(mesh_p)
    mesh_b = SyntheticTokenStream(cfg, SHAPE, DataConfig(seed=1),
                                  gloo_1x1).batch(0)
    assert all(isinstance(t, DTensor) for t in S.tree_leaves(mesh_p))
    assert all(isinstance(t, DTensor) for t in S.tree_leaves(mesh_o["m"]))
    assert all(isinstance(t, DTensor) for t in mesh_b.values())
    jmesh_ = jmesh((1, 1), ("data", "model"))
    jrules = JR.make_rules(jcfg, jmesh_)
    jstep_ = jbuild_step(jm, JTrainConfig(optimizer=JO.AdamWConfig(**ocfg)))

    def jfn(p, o, b):
        with JR.sharding_context(jmesh_, jrules):
            return jstep_(p, o, b)

    jfn = jax.jit(jfn)
    jo = JO.init_opt_state(jp)
    for _ in range(2):
        plain_p, plain_o, pm = step(plain_p, plain_o, batch)
        with R.sharding_context(gloo_1x1, rules):
            mesh_p, mesh_o, mm = step(mesh_p, mesh_o, mesh_b)
        jp, jo, jmet = jfn(jp, jo, jb)
        assert torch.equal(pm["loss"], mm["loss"].full_tensor())
        for a, b in zip(S.tree_leaves(plain_p), S.tree_leaves(mesh_p)):
            assert torch.equal(a, b.full_tensor())
        for key in ("loss", "grad_norm", "lr"):
            got = mm[key].full_tensor() if isinstance(mm[key], DTensor) \
                else mm[key]
            np.testing.assert_allclose(float(got), float(jmet[key]),
                                       rtol=2e-2)
        for g, w in zip(S.tree_leaves(mesh_p),
                        jax.tree.leaves(jax.tree.map(np.asarray, jp))):
            np.testing.assert_allclose(g.full_tensor().float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=2e-2, atol=2e-2)


def test_checkpoint_restores_onto_the_mesh(gloo_1x1, tmp_path):
    """A checkpoint of plain tensors restored with the rules' shardings
    (and onto DTensor targets) comes back as DTensors, bit for bit; a
    DTensor tree saves whole."""
    cfg = reduce_config(get_config(ARCH), layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 3, params)
    rules = R.make_rules(cfg, gloo_1x1)
    shd = S.shardings(model.spec, gloo_1x1, rules)
    got, _ = ckpt.restore_checkpoint(d, 3, model.spec, shardings=shd)
    for a, b in zip(S.tree_leaves(params), S.tree_leaves(got)):
        assert isinstance(b, DTensor) and torch.equal(a, b.full_tensor())
    again, _ = ckpt.restore_checkpoint(d, 3, got)
    for a, b in zip(S.tree_leaves(got), S.tree_leaves(again)):
        assert isinstance(b, DTensor) and b.placements == a.placements
        assert torch.equal(a.full_tensor(), b.full_tensor())
    ckpt.save_checkpoint(d, 4, got)
    back, _ = ckpt.restore_checkpoint(d, 4, model.spec, "cpu")
    for a, b in zip(S.tree_leaves(params), S.tree_leaves(back)):
        assert torch.equal(a, b)
    opt = O.init_opt_state(got)
    assert all(isinstance(t, DTensor) and t.dtype == torch.float32
               for t in S.tree_leaves(opt["v"]))
    assert S.tree_bytes(opt_state_spec(model)) == sum(
        t.numel() * t.element_size() for t in S.tree_leaves(opt))


def test_decode_steps_on_1x1_mesh_are_bitwise_the_plain_steps(gloo_1x1):
    """``OffloadRuntime`` at interval 2 on a 2-unit reduced model: the
    dense decode step with the parameters and caches as DTensors (the
    offloaded units kept as the runtime placed them) equals the plain step
    bit for bit, logits and caches; so does one paged decode step through
    the paged kernel's plain version, logits and pool."""
    from repro_torch.core.interval import OffloadPlan
    from repro_torch.core.memory_manager import (OffloadRuntime,
                                                 offload_memory_kind_fn,
                                                 split_model_params)
    from repro_torch.models.transformer import pattern_info

    cfg = reduce_config(get_config(ARCH), layers=4)
    model = build_model(cfg)
    plan = OffloadPlan(pattern_info(cfg)[1], 2)
    rt = OffloadRuntime(model, plan, "cpu")
    rules = R.make_rules(cfg, gloo_1x1, "decode", 2)
    placed = rt.place(split_model_params(
        model.init(torch.Generator().manual_seed(0), "cpu"), plan))
    shd = S.shardings(rt.spec_split(), gloo_1x1, rules,
                      offload_memory_kind_fn)
    assert all(n.memory_kind == "pinned_host"
               for n in S.tree_leaves(shd["blocks"]["offloaded"]))
    on_mesh = lambda tree, s: S.tree_map(
        lambda t, n: distribute_tensor(t.clone(), gloo_1x1,
                                       list(n.placements)), tree, s)
    mparams = on_mesh(placed, shd)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    logits, caches, _ = rt.prefill(placed, {"tokens": toks}, 16)
    mcaches = on_mesh(caches, S.shardings(rt.cache_spec_split(2, 16),
                                          gloo_1x1, rules))
    tok, pos = logits.argmax(-1).to(torch.int32), torch.full(
        (2,), 12, dtype=torch.int32)
    for _ in range(3):
        want, caches = rt.decode_step(placed, tok, pos, caches)
        with R.sharding_context(gloo_1x1, rules):
            got, mcaches = rt.decode_step(mparams, tok, pos, mcaches)
        assert isinstance(got, DTensor)
        assert torch.equal(got.full_tensor(), want)
        tok, pos = want.argmax(-1).to(torch.int32), pos + 1
    for a, b in zip(S.tree_leaves(mcaches), S.tree_leaves(caches)):
        assert torch.equal(a.full_tensor(), b)
    page, nb = 4, 4
    pool = torch.randn((2 * nb + 1, page, cfg.num_layers, 2,
                        model.virtual_kv, cfg.resolved_head_dim),
                       generator=torch.Generator().manual_seed(2)
                       ).bfloat16()
    bt = torch.arange(1, 2 * nb + 1, dtype=torch.int32).reshape(2, nb)
    cl = torch.full((2,), 13, dtype=torch.int32)
    wf, wo = bt[:, 3].clone(), torch.zeros(2, dtype=torch.int32)
    mpool = pool.clone()
    want, pool = rt.paged_decode_step(placed, tok, cl - 1, pool, bt, cl, wf,
                                      wo)
    with R.sharding_context(gloo_1x1, rules):
        got, mpool = rt.paged_decode_step(mparams, tok, cl - 1, mpool, bt,
                                          cl, wf, wo)
    assert torch.equal(got.full_tensor(), want) and torch.equal(mpool, pool)


# ---------------------------------------------------------------------------
# Two real ranks (gloo on localhost): the sharded steps compute the
# one-device results
# ---------------------------------------------------------------------------

_TWO_RANKS = textwrap.dedent("""
    import os, sys, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    from repro_torch.models import spec as S
    from repro_torch.models.model import build_model
    from repro_torch.sharding import rules as R
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_loop import TrainConfig, build_train_step

    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=os.environ["ADDR"],
                            world_size=2, rank=rank)
    out = {}
    for arch, shape_, step in (("qwen2.5-3b", (2, 1), "train"),
                               ("dbrx-132b", (2, 1), "train"),
                               ("jamba-1.5-large-398b", (2, 1), "train"),
                               ("xlstm-125m", (2, 1), "train"),
                               ("dbrx-132b", (1, 2), "train"),
                               ("qwen2.5-3b", (1, 2), "prefill"),
                               ("dbrx-132b", (1, 2), "prefill")):
        mesh = init_device_mesh("cpu", shape_,
                                mesh_dim_names=("data", "model"))
        cfg = reduce_config(get_config(arch), layers=2)
        model = build_model(cfg, tp=shape_[1])
        params = S.tree_map(lambda t: t.float(), model.init(
            torch.Generator().manual_seed(0), "cpu"))
        rules = R.make_rules(cfg, mesh, step, 2)
        placed = S.place(params, model.spec, mesh, rules)
        shape = ShapeSpec("t", 16, 2, "train")
        batch = SyntheticTokenStream(cfg, shape, DataConfig(seed=1),
                                     mesh).batch(0)
        with R.sharding_context(mesh, rules):
            if step == "train":
                run = build_train_step(model, TrainConfig(
                    optimizer=O.AdamWConfig(lr=1e-3, warmup_steps=1,
                                            eps=1e-3)))
                p2, _, m = run(placed, O.init_opt_state(placed), batch)
                res = {"loss": m["loss"].full_tensor(),
                       "params": [t.full_tensor()
                                  for t in S.tree_leaves(p2)]}
            else:
                logits, _, _ = model.prefill(placed, {"tokens":
                                                      batch["tokens"]}, 16)
                res = {"logits": logits.full_tensor()}
        out[(arch, shape_, step)] = res
    if rank == 0:
        torch.save(out, os.environ["OUT"])
    dist.destroy_process_group()
""")


def test_two_gloo_ranks_compute_the_one_device_results(tmp_path):
    """Two processes on a real gloo group: train steps of the reduced
    qwen2.5-3b, dbrx-132b (MoE, FSDP weights), jamba (Mamba, MoE) and
    xlstm-125m (mLSTM, sLSTM) on a (2, 1) mesh (the batch split over
    "data", the gradients reduced across it; a rank's local routing,
    scans and lookups contribute its part of each shared weight's
    gradient), dbrx's on a (1, 2) mesh, and the prefills of qwen and dbrx
    on a (1, 2) mesh (heads, KV heads, MLP and experts split over "model")
    give the one-device port's loss and
    logits, in fp32, within 1e-5 relative: the same sums in another order,
    so not bit for bit. The parameters after one AdamW step within 1e-6
    absolute. The step's eps is 1e-3 so that a weight moves with its
    gradient: at the default 1e-8 Adam's first step moves a weight by
    about lr whatever its gradient's size, and a near-zero gradient summed
    in another order moves it apart (on one device, the batch's rows
    reversed move weights up to 9e-6 at 1e-8, 3e-8 at 1e-3); a rank's
    half-batch gradient left unreduced moves 89-99% of the weights beyond
    1e-6, by up to 1.9e-3 (on one device)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "ranks.pt"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               ADDR=f"tcp://127.0.0.1:{port}", OUT=str(out))
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS],
                              env=dict(env, RANK=str(r)), cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    logs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:]
                                                   for _, e in logs]
    got = torch.load(out)
    for (arch, _, step), res in got.items():
        cfg = reduce_config(get_config(arch), layers=2)
        model = build_model(cfg)
        params = S.tree_map(lambda t: t.float(), model.init(
            torch.Generator().manual_seed(0), "cpu"))
        batch = SyntheticTokenStream(cfg, SHAPE, DataConfig(seed=1),
                                     device="cpu").batch(0)
        if step == "train":
            run = build_train_step(model, TrainConfig(
                optimizer=O.AdamWConfig(lr=1e-3, warmup_steps=1, eps=1e-3)))
            p2, _, m = run(params, O.init_opt_state(params), batch)
            torch.testing.assert_close(res["loss"], m["loss"], rtol=1e-5,
                                       atol=0)
            for i, (a, b) in enumerate(zip(res["params"],
                                           S.tree_leaves(p2))):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-6,
                                           msg=lambda m: f"{arch} leaf {i}"
                                           f" {tuple(a.shape)}: {m}")
        else:
            logits, _, _ = model.prefill(params, {"tokens":
                                                  batch["tokens"]}, 16)
            torch.testing.assert_close(res["logits"], logits, rtol=1e-5,
                                       atol=1e-5)
