"""The port's CUDA kernels on the card, against their plain PyTorch
versions at bf16 tolerance (2e-2, tests/test_kernels.py). Every test here
carries the ``cuda`` marker and skips without a GPU; ``chip_smoke.py`` runs
the same checks at the serving path's full widths.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import prefill_attention as PA  # noqa: E402

TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _randn(rng, *shape, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        dev).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,vh,d,page,nb,window", [
    (3, 8, 2, 64, 16, 3, 0), (1, 4, 1, 16, 8, 5, 0), (4, 16, 2, 128, 16, 4, 20),
])
def test_decode_kernel_matches_plain(cuda, b, h, vh, d, page, nb, window):
    rng = np.random.default_rng(0)
    frames, layers = b * nb + 1, 3
    pool = _randn(rng, frames, page, layers, 2, vh, d, dev=cuda)
    kp, vp = pool[:, :, 1, 0], pool[:, :, 1, 1]
    q = _randn(rng, b, h, d, dev=cuda)
    bt = torch.from_numpy(rng.permutation(frames)[:b * nb].reshape(b, nb)
                          .astype(np.int32)).to(cuda)
    cl = torch.from_numpy(rng.integers(0, nb * page + 1, b)
                          .astype(np.int32)).to(cuda)
    before = DA.launches
    got = DA.paged_decode_attention(q, kp, vp, bt, cl, window=window)
    assert DA.launches == before + 1
    want = DA.paged_decode_attention_plain(q, kp, vp, bt, cl, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,vh,sq,sk,d,kw", [
    (1, 8, 2, 96, 96, 64, {}), (2, 4, 1, 33, 130, 16, {}),
    (1, 4, 4, 128, 128, 32, {"window": 24}),
    (1, 4, 2, 64, 100, 128, {"causal": False, "kv_len": 77}),
])
def test_flash_kernel_matches_plain(cuda, b, h, vh, sq, sk, d, kw):
    rng = np.random.default_rng(1)
    q = _randn(rng, b, h, sq, d, dev=cuda)
    k = _randn(rng, b, vh, sk, d, dev=cuda)
    v = _randn(rng, b, vh, sk, d, dev=cuda)
    before = FA.launches
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,vh,d,page,nb,start,cl", [
    (40, 8, 2, 64, 16, 6, 37, 77),       # mid-prompt, partial last page
    (16, 4, 1, 16, 8, 4, 0, 16),         # first chunk, g 4
    (9, 4, 4, 32, 8, 5, 30, 33),         # g 1, context clamped below end
    (1, 16, 2, 128, 16, 64, 1000, 1001),  # one token deep in the context
    (70, 16, 2, 128, 16, 8, 0, 0),       # context_len 0: zeros
])
def test_chunk_kernel_matches_plain(cuda, c, h, vh, d, page, nb, start, cl):
    rng = np.random.default_rng(2)
    frames, layers = nb + 3, 3
    pool = _randn(rng, frames, page, layers, 2, vh, d, dev=cuda)
    kp, vp = pool[:, :, 2, 0], pool[:, :, 2, 1]
    q = _randn(rng, c, h, d, dev=cuda)
    bt = rng.permutation(frames)[:nb].astype(np.int32)
    bt[-1] = 10_000                       # out of range past the context
    bt = torch.from_numpy(bt).to(cuda)
    before = PA.launches
    got = PA.paged_chunk_attention(q, kp, vp, bt, start, cl)
    assert PA.launches == before + 1
    want = PA.paged_chunk_attention_plain(q, kp, vp, bt, start, cl)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    if cl == 0:
        assert torch.count_nonzero(got) == 0


@pytest.mark.cuda
def test_kernels_refuse_unsupported_inputs(cuda):
    q = torch.zeros((1, 4, 8, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        FA.flash_attention(q, q, q)                  # head_dim 48
    with pytest.raises(ValueError, match="bf16"):
        FA.flash_attention(q.float(), q, q)
    pages = torch.zeros((3, 8, 1, 48), dtype=torch.bfloat16, device=cuda)
    bt = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        PA.paged_chunk_attention(q[0], pages, pages, bt, 0, 8)
    with pytest.raises(ValueError, match="bf16"):
        PA.paged_chunk_attention(q[0].float(), pages, pages, bt, 0, 8)


@pytest.mark.cuda
def test_interval_switch_frees_previous_placement(cuda):
    """The engine holds one interval's placement at a time: after each
    switch, the device memory the weights take is the new plan's
    ``device_bytes`` (resident units, tail, two-slot ring) plus the
    non-block parameters, and the offloaded units sit in pinned memory."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core import costs
    from repro_torch.core.hardware import PRESETS
    from repro_torch.core.interval import NO_OFFLOAD
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.spec import tree_leaves
    from repro_torch.serving.engine import EngineConfig

    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=256, heads=4,
                        layers=8, d_ff=512, vocab=1024)
    ecfg = EngineConfig(max_batch=2, max_seq=32, page_size=16,
                        hbm_budget_bytes=1e9)
    eng = build_engine("switch", cfg, PRESETS["h100"], ecfg, [0.01],
                       device=cuda)
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in tree_leaves(tree))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    held = {}
    for iv in (NO_OFFLOAD, 1, 2, NO_OFFLOAD, 4):
        assert eng.set_interval(iv)
        rt, placed = eng._rt()
        torch.cuda.synchronize()
        blk = placed["blocks"]
        ring = [] if rt._stream is None else rt._stream.slots
        dev_blocks = nbytes(blk["resident"]) + nbytes(blk["tail"]) \
            + nbytes(ring)
        assert dev_blocks == rt.plan.device_bytes(
            costs.unit_weight_bytes(cfg))
        off = [t for t in tree_leaves(blk["offloaded"]) if t.numel()]
        assert bool(off) == rt.plan.enabled
        assert all(t.is_pinned() for t in off)
        assert eng.host_weight_bytes == nbytes(blk["offloaded"])
        others = {k: v for k, v in placed.items() if k != "blocks"}
        want = dev_blocks + nbytes(others)
        n = len(tree_leaves(placed)) + len(tree_leaves(ring))
        got = torch.cuda.memory_allocated() - base
        # the caching allocator rounds each block up to 512 bytes
        assert want <= got <= want + 512 * n, (iv, got, want)
        held[iv] = got
    assert held[1] < held[2] < held[NO_OFFLOAD]
