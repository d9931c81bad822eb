"""The port's traced-step cost counter (``launch/hlo_costs.py``), with the
claims of ``tests/test_hlo_costs.py`` carried over:

- a stack of L layers counts L times one layer (the port's stacks are
  Python loops, so every layer is counted as it runs; the reference's
  claim is that a scan counts as its unrolled program);
- a one-token KV write counts its slice, not the cache;
- a full cache read still counts in full;
- collectives are counted where they are issued, per device, with the
  reference's ring factors, and the train step's gradient constraint
  turns a pending ``Partial`` gradient into the reduce-scatter;
- each hand-written kernel reports its FLOPs and bytes (chip_smoke's bound
  formulas) where dispatch cannot see into it; on CPU tensors the plain
  versions run and their own ops are counted;
- one traced trip of a long scan on fake tensors counts as all its trips.

    PYTHONPATH=src python -m pytest -q tests/test_torch_costs.py
"""
from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial, Replicate,  # noqa: E402
                                      Shard, distribute_tensor)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import prefill_attention as PA  # noqa: E402
from repro_torch.launch import hlo_costs  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import spec as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.training.train_loop import \
    constrain_grads_like_params  # noqa: E402

BF16 = 2


def _stack(x, ws):
    for i in range(ws.shape[0]):
        x = torch.tanh(x @ ws[i])
    return x


def test_stack_of_layers_counts_each_layer():
    """Eight layers count eight times one layer, FLOPs and bytes exactly;
    the products are 2 * 128 * 256 * 256 FLOPs a layer."""
    x = torch.zeros(128, 256)
    ws = torch.zeros(8, 256, 256)
    _, c8 = hlo_costs.count(_stack, x, ws)
    _, c1 = hlo_costs.count(_stack, x, ws[:1])
    assert c8.flops == 8 * c1.flops == 8 * 2 * 128 * 256 * 256
    assert c8.hbm_bytes == 8 * c1.hbm_bytes
    # the weights are read once per layer
    assert c8.hbm_bytes >= 8 * 256 * 256 * 4


def test_model_layers_count_linearly():
    """Through the port's model: the prefill of 3 layers minus that of 2
    equals that of 2 minus that of 1, in FLOPs and bytes."""
    costs = []
    for layers in (1, 2, 3):
        model = build_model(reduce_config(get_config("qwen2.5-3b"),
                                          layers=layers))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        tokens = torch.zeros((2, 16), dtype=torch.int32)
        _, c = hlo_costs.count(model.prefill, params, {"tokens": tokens}, 16)
        costs.append(c)
    for field in ("flops", "hbm_bytes"):
        a, b, c = (getattr(x, field) for x in costs)
        assert c - b == b - a > 0, field


def test_one_token_cache_write_counts_its_slice():
    """A one-token write into a [4, 32768, 128] cache counts the token,
    read and written (2 KB), not the 32 MB cache; the dense decode's
    indexed write counts its rows (its whole-cache clone is a copy,
    outside ``hbm_bytes_native``)."""
    cache = torch.zeros(4, 32768, 128, dtype=torch.bfloat16)
    tok = torch.zeros(4, 1, 128, dtype=torch.bfloat16)

    def write(cache, tok):
        cache[:, 5:6] = tok
        return cache

    _, c = hlo_costs.count(write, cache, tok)
    assert c.hbm_bytes == 2 * tok.numel() * BF16 < 100_000
    k = torch.zeros(4, 32768, 2, 64, dtype=torch.bfloat16)
    pos = torch.full((4,), 7, dtype=torch.int32)
    kpos = torch.zeros(4, 32768, dtype=torch.int32)
    k1 = torch.ones(4, 1, 2, 64, dtype=torch.bfloat16)
    _, c = hlo_costs.count(T.cache_write_decode, k, k, kpos, k1, k1, pos)
    assert c.hbm_bytes_native < 100_000
    assert c.hbm_bytes > 2 * k.numel() * BF16      # the clones, counted


def test_full_cache_read_still_counted():
    cache = torch.zeros(4, 8192, 128, dtype=torch.bfloat16)
    q = torch.zeros(4, 128)
    _, c = hlo_costs.count(
        lambda c, q: torch.einsum("bsd,bd->bs", c.float(), q), cache, q)
    assert c.hbm_bytes >= cache.numel() * BF16
    assert c.flops == 2 * 4 * 8192 * 128


@pytest.fixture
def fake_2x4():
    M.destroy()
    mesh = M.make_mesh_compat((2, 4), ("data", "model"), "cpu", "fake")
    try:
        yield mesh
    finally:
        M.destroy()


def test_collectives_counted_with_ring_factors(fake_2x4):
    """Per device, where issued: an all-gather over the 4-way model axis
    moves 3/4 of its result, an all-reduce twice that, a reduce-scatter 3
    times its (scattered) result; a redistribution over both axes issues
    one per axis."""
    mesh = fake_2x4
    full = torch.randn(16, 32)
    rb = full.numel() * 4
    sharded = distribute_tensor(full, mesh, [Replicate(), Shard(0)])
    partial = DTensor.from_local(full, mesh, [Replicate(), Partial()],
                                 run_check=False)
    _, c = hlo_costs.count(lambda t: t.redistribute(
        mesh, [Replicate(), Replicate()]), sharded, default_group=8)
    assert c.collective_count == {"all-gather": 1}
    assert c.collective_bytes["all-gather"] == pytest.approx(rb * 3 / 4)
    _, c = hlo_costs.count(lambda t: t.redistribute(
        mesh, [Replicate(), Replicate()]), partial)
    assert c.collective_count == {"all-reduce": 1}
    assert c.collective_bytes["all-reduce"] == pytest.approx(2 * rb * 3 / 4)
    _, c = hlo_costs.count(lambda t: t.redistribute(
        mesh, [Replicate(), Shard(0)]), partial)
    assert c.collective_count == {"reduce-scatter": 1}
    assert c.collective_bytes["reduce-scatter"] == pytest.approx(rb / 4 * 3)
    both = distribute_tensor(full, mesh, [Shard(0), Shard(1)])
    _, c = hlo_costs.count(lambda t: t.redistribute(
        mesh, [Replicate(), Replicate()]), both)
    assert c.collective_count == {"all-gather": 2}
    assert c.collective_total == pytest.approx(
        rb / 2 * 3 / 4 + rb * 1 / 2)


def test_gradient_constraint_is_the_reduce_scatter(fake_2x4):
    """An embedding sharded on vocab (model axis) and fsdp (data axis, a
    giant arch's rule) whose gradient arrives as a pending sum over the
    data axis: ``constrain_grads_like_params`` turns it into one
    reduce-scatter onto the parameter's placement, no other collective."""
    from repro_torch.models.spec import TensorSpec

    rules = R.make_rules(get_config("grok-1-314b"), fake_2x4, "train", 256)
    spec = TensorSpec((64, 32), ("vocab", "fsdp"))
    want = R.placements(R.resolve(spec.shape, spec.logical, rules, fake_2x4),
                        fake_2x4)
    assert want == (Shard(1), Shard(0))      # fsdp over data, vocab model
    g = DTensor.from_local(torch.zeros(16, 32, dtype=torch.bfloat16),
                           fake_2x4, [Partial(), Shard(0)], run_check=False,
                           shape=spec.shape, stride=(32, 1))
    model = type("Spec", (), {"spec": {"embed": spec}})()
    with R.sharding_context(fake_2x4, rules), \
            hlo_costs.CostCounter(default_group=8) as cc:
        out = constrain_grads_like_params(model, {"embed": g})
    assert tuple(out["embed"].placements) == want
    assert out["embed"].to_local().shape == (16, 16)
    assert cc.costs().collective_count == {"reduce-scatter": 1}
    assert cc.costs().collective_bytes["reduce-scatter"] == pytest.approx(
        16 * 16 * BF16 * (2 - 1))


def _fake(fm, *shape, dtype=torch.bfloat16):
    with fm:
        return torch.empty(shape, dtype=dtype)


def test_kernels_report_their_costs_on_fake_tensors():
    """A fake tensor takes each kernel's path, launches nothing and reports
    chip_smoke's bound formulas: flash 4 B H pairs D FLOPs over the causal
    pairs (its backward 10 B H pairs D), the paged decode 4 tokens H D
    over the table's capacity, the chunk 4 H D pairs over its visible
    keys."""
    fm = FakeTensorMode()
    b, h, vh, s, d = 2, 8, 2, 256, 64
    q = _fake(fm, b, h, s, d).requires_grad_(True)
    k, v = _fake(fm, b, vh, s, d), _fake(fm, b, vh, s, d)
    pairs = s * (s + 1) // 2
    launched = (FA.launches, FA.launches_bwd, DA.launches, PA.launches)
    with fm, hlo_costs.CostCounter() as cc:
        out = FA.flash_attention(q, k, v)
        torch.autograd.grad(out.float().sum(), [q])
    c = cc.costs()
    assert c.kernel_calls == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert c.kernel_flops == 4 * b * h * pairs * d + 10 * b * h * pairs * d
    assert out.shape == (b, h, s, d)
    pool = _fake(fm, 40, 16, vh, d)
    bt = _fake(fm, b, 10, dtype=torch.int32)
    cl = _fake(fm, b, dtype=torch.int32)
    with fm, hlo_costs.CostCounter() as cc:
        o = DA.paged_decode_attention(_fake(fm, b, h, d), pool, pool, bt, cl)
        oc = PA.paged_chunk_attention(_fake(fm, 32, h, d), pool, pool,
                                      bt[0], 64, 96)
    c = cc.costs()
    assert o.shape == (b, h, d) and oc.shape == (32, h, d)
    tokens = b * 10 * 16
    chunk_pairs = sum(min(64 + t + 1, 96) for t in range(32))
    assert c.kernel_calls == {"paged_decode_attention": 1,
                              "paged_chunk_attention": 1}
    assert c.kernel_flops == 4 * tokens * h * d + 4 * h * d * chunk_pairs
    assert (FA.launches, FA.launches_bwd, DA.launches, PA.launches) == \
        launched


def test_kernel_head_dim_padding_on_fake_tensors():
    """A head dim the kernels lack (120) runs padded to 128 through
    ``flash_attention_padded``: the kernel reports D 128 and the output
    keeps D 120; ``flash_attention`` itself refuses it."""
    fm = FakeTensorMode()
    q, k = _fake(fm, 1, 4, 64, 120), _fake(fm, 1, 2, 64, 120)
    with fm, hlo_costs.CostCounter() as cc:
        out = FA.flash_attention_padded(q, k, k)
        with pytest.raises(ValueError, match="unsupported"):
            FA.flash_attention(q, k, k)
    assert out.shape == (1, 4, 64, 120)
    assert cc.costs().kernel_flops == 4 * 4 * (64 * 65 // 2) * 128


def test_plain_versions_on_cpu_count_their_own_ops():
    """Real CPU tensors run the plain versions: no kernel report, and the
    plain flash's products count as themselves (two 64-key tiles of QK^T
    and PV at full tile size)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 128, 32, generator=g).bfloat16()
    k = torch.randn(1, 2, 128, 32, generator=g).bfloat16()
    out, c = hlo_costs.count(FA.flash_attention, q, k, k)
    assert c.kernel_calls == {} and c.kernel_flops == 0
    assert c.flops == 2 * (2 * 2 * 128 * 64 * 32) * 2
    assert torch.equal(out, FA.flash_attention_plain(q, k, k))


def test_one_traced_trip_counts_all_trips():
    """On fake tensors Mamba's chunked scan and the xLSTM steps trace one
    trip, counted as every trip: the same FLOPs as the real loop on real
    tensors of the same shapes."""
    cfg = reduce_config(get_config("xlstm-125m"), layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    blocks = T.unit_slice(params["blocks"], 0)
    x = torch.randn(2, 24, cfg.d_model).bfloat16()
    fm = FakeTensorMode()
    fake = lambda tree: S.tree_map(fm.from_tensor, tree)
    fx, fb = fm.from_tensor(x), fake(blocks)
    for j, fn in enumerate((L.apply_mlstm_seq, L.apply_slstm_seq)):
        p = blocks[j]["attn"]
        _, real = hlo_costs.count(fn, cfg, p, x)
        with fm, hlo_costs.CostCounter() as cc:
            y, _ = fn(cfg, fb[j]["attn"], fx)
        assert y.shape == x.shape
        assert cc.costs().flops == real.flops > 0
    jcfg = reduce_config(get_config("jamba-1.5-large-398b"), layers=8)
    jm = build_model(jcfg)
    jp = jm.init(torch.Generator().manual_seed(0), "cpu")
    mamba = T.unit_slice(jp["blocks"], 0)[1]["attn"]
    x = torch.randn(2, 70, jcfg.d_model).bfloat16()
    _, real = hlo_costs.count(L.apply_mamba_seq, jcfg, mamba, x)
    fm_p, fx = fake(mamba), fm.from_tensor(x)
    with fm, hlo_costs.CostCounter() as cc:
        y, st = L.apply_mamba_seq(jcfg, fm_p, fx)
    assert y.shape == x.shape
    assert cc.costs().flops == real.flops > 0
    assert math.isclose(cc.costs().hbm_bytes, real.hbm_bytes, rel_tol=0.05)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_padded_head_dim_kernels_match_plain(cuda):
    """h2o-danube-3-4b's head dim 120 through the kernels padded to 128,
    forward and backward, against the plain versions at D 120 (bf16
    tolerance 2e-2 of the largest value)."""
    g = torch.Generator(cuda).manual_seed(3)
    mk = lambda *s: torch.randn(s, generator=g, device=cuda).bfloat16()
    q, k, v = (mk(2, 8, 300, 120).requires_grad_(True),
               mk(2, 4, 300, 120).requires_grad_(True),
               mk(2, 4, 300, 120).requires_grad_(True))
    do = mk(2, 8, 300, 120)
    before = FA.launches
    out = FA.flash_attention_padded(q, k, v)
    assert FA.launches == before + 1
    grads = torch.autograd.grad(out, (q, k, v), do)
    qp, kp, vp = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    want = FA.flash_attention_plain(qp, kp, vp)
    wgrads = torch.autograd.grad(want, (qp, kp, vp), do.float())
    for got, ref in zip((out, *grads), (want, *wgrads)):
        scale = float(ref.abs().max())
        assert float((got.float() - ref).abs().max()) <= 2e-2 * scale
