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
    (8, 48, 8, 128, 16, 64, 0),           # dbrx-132b's heads, g 6, 1024 keys
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


def _decode_inputs(rng, dev, b, h, vh, d, page, nb, layers=3):
    """A strided layer slice of a [frames, page, L, 2, vh, d] pool, the
    queries and a table of distinct frames."""
    frames = b * nb + 1
    pool = _randn(rng, frames, page, layers, 2, vh, d, dev=dev)
    kp, vp = pool[:, :, 1, 0], pool[:, :, 1, 1]
    q = _randn(rng, b, h, d, dev=dev)
    bt = rng.permutation(frames)[:b * nb].reshape(b, nb).astype(np.int32)
    return q, kp, vp, bt


@pytest.mark.cuda
# g 1, 4, 8 and dbrx-132b's 6
@pytest.mark.parametrize("h,vh", [(8, 8), (16, 4), (16, 2), (48, 8)])
@pytest.mark.parametrize("window", [0, 50])
def test_decode_kernel_split_edges(cuda, h, vh, window):
    """Contexts at and around one split's span (P pages), one token and
    none, table entries out of range and negative past the context, and a
    window whose edge falls inside a split."""
    rng = np.random.default_rng(5)
    page, d, nb = 16, 64, 12
    span = DA.PAGES_PER_SPLIT * page
    lens = [span, span - 1, span + 1, 1, 0, 2 * span + 7, nb * page,
            nb * page + 40]
    q, kp, vp, bt = _decode_inputs(rng, cuda, len(lens), h, vh, d, page, nb)
    bt[0, DA.PAGES_PER_SPLIT:] = 99_999
    bt[1, DA.PAGES_PER_SPLIT:] = -3
    bt, cl = (torch.from_numpy(x).to(cuda)
              for x in (bt, np.array(lens, np.int32)))
    got = DA.paged_decode_attention(q, kp, vp, bt, cl, window=window)
    want = DA.paged_decode_attention_plain(q, kp, vp, bt, cl, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    assert torch.count_nonzero(got[4]) == 0                # cl = 0


@pytest.mark.cuda
def test_decode_kernel_bitwise_repeatable_and_batch_independent(cuda):
    """Two launches on the same inputs give the same bits, and each row of
    a batch-8 decode equals, bitwise, its request run alone at batch 1."""
    rng = np.random.default_rng(6)
    q, kp, vp, bt = _decode_inputs(rng, cuda, 8, 16, 2, 128, 16, 64,
                                   layers=4)
    bt = torch.from_numpy(bt).to(cuda)
    cl = torch.from_numpy(rng.integers(0, 64 * 16 + 1, 8).astype(np.int32)
                          ).to(cuda)
    for window in (0, 100):
        first = DA.paged_decode_attention(q, kp, vp, bt, cl, window=window)
        again = DA.paged_decode_attention(q, kp, vp, bt, cl, window=window)
        assert torch.equal(first, again)
        for i in range(8):
            alone = DA.paged_decode_attention(q[i:i + 1], kp, vp,
                                              bt[i:i + 1], cl[i:i + 1],
                                              window=window)
            assert torch.equal(alone[0], first[i]), (window, i)


# head_dim 120 (h2o-danube-3-4b): 15 lanes of 8 values each, rounded up to
# 16 for the score reduction, the 16th lane adding zero
@pytest.mark.cuda
@pytest.mark.parametrize("h,vh", [(32, 8), (8, 8), (16, 2)])   # danube: g 4
@pytest.mark.parametrize("window", [0, 50])      # 50: an edge inside a split
def test_decode_kernel_d120(cuda, h, vh, window):
    """head_dim 120 over split edges (contexts at and around one split's
    span, one token and none, out-of-range table entries past the
    context), g 4 as danube's 32 heads over 8, g 1 and g 8, with and
    without a window whose edge falls inside a split; two launches
    bitwise."""
    rng = np.random.default_rng(12)
    page, d, nb = 16, 120, 12
    span = DA.PAGES_PER_SPLIT * page
    lens = [span, span - 1, span + 1, 1, 0, 2 * span + 7, nb * page,
            nb * page + 40]
    q, kp, vp, bt = _decode_inputs(rng, cuda, len(lens), h, vh, d, page, nb)
    bt[0, DA.PAGES_PER_SPLIT:] = 99_999
    bt[1, DA.PAGES_PER_SPLIT:] = -3
    bt, cl = (torch.from_numpy(x).to(cuda)
              for x in (bt, np.array(lens, np.int32)))
    before = DA.launches
    got = DA.paged_decode_attention(q, kp, vp, bt, cl, window=window)
    assert DA.launches == before + 1
    want = DA.paged_decode_attention_plain(q, kp, vp, bt, cl, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    assert torch.count_nonzero(got[4]) == 0                # cl = 0
    assert torch.equal(got, DA.paged_decode_attention(q, kp, vp, bt, cl,
                                                      window=window))


@pytest.mark.cuda
def test_decode_kernel_d120_danube_shape_bitwise(cuda):
    """danube's decode shape (B 8, H 32 over V 8, D 120, 64 table pages)
    against the plain version, and each row bitwise its request alone."""
    rng = np.random.default_rng(13)
    q, kp, vp, bt = _decode_inputs(rng, cuda, 8, 32, 8, 120, 16, 64,
                                   layers=4)
    bt = torch.from_numpy(bt).to(cuda)
    cl = torch.from_numpy(rng.integers(1, 64 * 16 + 1, 8).astype(np.int32)
                          ).to(cuda)
    for window in (0, 100):
        first = DA.paged_decode_attention(q, kp, vp, bt, cl, window=window)
        want = DA.paged_decode_attention_plain(q, kp, vp, bt, cl,
                                               window=window)
        torch.testing.assert_close(first.float(), want.float(), **TOL)
        assert torch.equal(first, DA.paged_decode_attention(
            q, kp, vp, bt, cl, window=window))
        for i in range(8):
            alone = DA.paged_decode_attention(q[i:i + 1], kp, vp,
                                              bt[i:i + 1], cl[i:i + 1],
                                              window=window)
            assert torch.equal(alone[0], first[i]), (window, i)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 136, 264])
def test_decode_kernel_refuses_head_dims_it_lacks(cuda, d):
    """A head dim outside ``HEAD_DIMS`` raises before any launch: 96 and
    136 (multiples of 8 it is not checked at) and 264 (past a warp of
    lanes)."""
    pages = torch.zeros((5, 8, 1, d), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((2, 4, d), dtype=torch.bfloat16, device=cuda)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    cl = torch.ones((2,), dtype=torch.int32, device=cuda)
    before = DA.launches
    with pytest.raises(ValueError, match="head_dim"):
        DA.paged_decode_attention(q, pages, pages, bt, cl)
    assert DA.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,vh,sq,sk,d,kw", [
    (1, 8, 2, 96, 96, 64, {}), (2, 4, 1, 33, 130, 16, {}),
    (1, 4, 4, 128, 128, 32, {"window": 24}),
    (1, 4, 2, 64, 100, 128, {"causal": False, "kv_len": 77}),
    (1, 4, 2, 200, 200, 128, {}),                   # ragged, 4 query tiles
    (2, 4, 2, 70, 150, 16, {"window": 37}),         # window edge mid-tile
    (1, 8, 8, 65, 193, 32, {"causal": False, "kv_len": 129}),
    (1, 4, 1, 40, 300, 64, {"pos_offset": -100}),   # decode-style offset
    (1, 4, 2, 130, 130, 128, {"kv_len": 90}),       # causal with kv_len
    (1, 48, 8, 1024, 1024, 128, {}),    # dbrx-132b's bucketed prefill, g 6
    # head_dim 256 (gemma-2b, paligemma-3b): MQA at g 8, 32-key tiles
    (1, 8, 1, 512, 512, 256, {}),       # gemma's bucketed prefill
    (2, 8, 1, 300, 300, 256, {"window": 70}),
    (2, 8, 1, 64, 1024, 256, {"causal": False}),  # cross attention, Sq < Sk
    (1, 8, 1, 130, 130, 256, {"kv_len": 90}),
    (1, 16, 16, 70, 150, 256, {"causal": False, "kv_len": 129}),
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
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_kernel_reads_strided_projections(cuda, d):
    """The prefill passes [B,S,H,D] projections viewed as [B,H,S,D]; the
    kernel reads them through their strides, ragged lengths included."""
    rng = np.random.default_rng(3)
    b, h, vh, s = 2, 8, 2, 77
    q = _randn(rng, b, s, h, d, dev=cuda).transpose(1, 2)
    k = _randn(rng, b, s, vh, d, dev=cuda).transpose(1, 2)
    v = _randn(rng, b, s, vh, d, dev=cuda).transpose(1, 2)
    assert not q.is_contiguous()
    for kw in ({}, {"window": 20}):
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), **TOL)
        dense = FA.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)
        assert torch.equal(got, dense)


@pytest.mark.cuda
def test_flash_kernel_is_bitwise_repeatable(cuda):
    rng = np.random.default_rng(4)
    q = _randn(rng, 1, 16, 300, 128, dev=cuda)
    k = _randn(rng, 1, 2, 300, 128, dev=cuda)
    v = _randn(rng, 1, 2, 300, 128, dev=cuda)
    first = FA.flash_attention(q, k, v)
    assert torch.equal(first, FA.flash_attention(q, k, v))


# (C, H, V, D, page, nb, start, context_len); spans are PA.SPAN_KEYS (256)
# keys, so a context past 256 splits the key range
CHUNK_CASES = [
    (40, 8, 2, 64, 16, 6, 37, 77),       # mid-prompt, partial last page
    (16, 4, 1, 16, 8, 4, 0, 16),         # first chunk, g 4
    (9, 4, 4, 32, 8, 5, 30, 33),         # g 1, context clamped below end
    (1, 16, 2, 128, 16, 64, 1000, 1001),  # one token deep in the context
    (70, 16, 2, 128, 16, 8, 0, 0),       # context_len 0: zeros
    (64, 16, 2, 128, 16, 20, 230, 294),  # crosses one span bound
    (100, 8, 2, 64, 16, 50, 600, 700),   # crosses several span bounds
    # tiles straddling 256: span 1 holds no visible key for their first rows
    (20, 16, 2, 64, 16, 20, 250, 270),
    (12, 4, 2, 32, 8, 4, 20, 25),        # context_below_chunk_end
    (30, 32, 2, 128, 16, 40, 480, 510),  # g 16
    (50, 6, 2, 32, 16, 40, 500, 550),    # g 3: padding rows in every tile
    (200, 4, 4, 16, 16, 40, 300, 500),   # g 1, 64 tokens per tile, 2 spans
    (256, 48, 8, 128, 16, 64, 768, 1024),  # dbrx-132b's heads, g 6
    (256, 8, 1, 256, 16, 64, 768, 1024),   # gemma-2b's: D 256, g 8
    (77, 8, 1, 256, 16, 40, 512, 589),     # D 256, partial final chunk
]


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,vh,d,page,nb,start,cl", CHUNK_CASES)
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


def _chunk_inputs(rng, dev, c, h, vh, d, page, nb, layers=4):
    """A strided layer slice of a [frames, page, L, 2, vh, d] pool, the
    chunk's queries and a table of distinct frames."""
    frames = nb + 5
    pool = _randn(rng, frames, page, layers, 2, vh, d, dev=dev)
    kp, vp = pool[:, :, 1, 0], pool[:, :, 1, 1]
    q = _randn(rng, c, h, d, dev=dev)
    bt = torch.from_numpy(rng.permutation(frames)[:nb].astype(np.int32)
                          ).to(dev)
    return q, kp, vp, bt


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("h,vh", [(2, 2), (8, 2), (16, 2), (32, 2)])
def test_chunk_kernel_head_dims_and_groups(cuda, d, h, vh):
    """g = H / V in {1, 4, 8, 16} and every head dim, over a context that
    crosses span bounds, with table entries out of range and negative past
    the context (clamped into the pool)."""
    rng = np.random.default_rng(7)
    q, kp, vp, bt = _chunk_inputs(rng, cuda, 96, h, vh, d, 16, 48)
    bt[44:] = 99_999
    bt[46:] = -3
    for start, cl in ((0, 96), (224, 320), (600, 696), (650, 700)):
        got = PA.paged_chunk_attention(q, kp, vp, bt, start, cl)
        want = PA.paged_chunk_attention_plain(q, kp, vp, bt, start, cl)
        torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
def test_chunk_kernel_bitwise_repeatable_and_chunk_independent(cuda):
    """Two launches give the same bits, and a query row's bits depend only
    on its position and the keys up to it: the rows of tokens 800-815 in a
    256-token chunk (start 768, context 1024) equal, bitwise, the same
    tokens in a 16-token chunk (start 800, context 816), and single tokens
    alone, over the same table."""
    rng = np.random.default_rng(8)
    q, kp, vp, bt = _chunk_inputs(rng, cuda, 256, 16, 2, 128, 16, 64)
    full = PA.paged_chunk_attention(q, kp, vp, bt, 768, 1024)
    assert torch.equal(full, PA.paged_chunk_attention(q, kp, vp, bt, 768,
                                                      1024))
    part = PA.paged_chunk_attention(q[32:48], kp, vp, bt, 800, 816)
    assert torch.equal(part, full[32:48])
    for t in (0, 7, 191, 255):
        alone = PA.paged_chunk_attention(q[t:t + 1], kp, vp, bt, 768 + t,
                                         769 + t)
        assert torch.equal(alone[0], full[t]), t


@pytest.mark.cuda
def test_chunk_kernel_direct_write_equals_one_span_combine(cuda):
    """A one-span tile's direct write and the combine of one non-empty span
    give the same bits: token 255 alone (start 255, context 256: one span)
    equals its row in a 20-token chunk at start 250, context 270, whose
    first tile sees keys up to 257 (two spans, the second holding no
    visible key for token 255)."""
    rng = np.random.default_rng(9)
    q, kp, vp, bt = _chunk_inputs(rng, cuda, 20, 16, 2, 128, 16, 20)
    for c, start, cl, splits in ((1, 255, 256, 1), (20, 250, 270, 2)):
        k_end = PA.key_end(c, 16, start, cl)
        assert PA.split_geometry(c, 16, 2, 128, k_end)[0] == splits
    chunk = PA.paged_chunk_attention(q, kp, vp, bt, 250, 270)
    alone = PA.paged_chunk_attention(q[5:6], kp, vp, bt, 255, 256)
    assert torch.equal(alone[0], chunk[5])


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
    # the 16-byte loads refuse a base off 16 bytes and odd row strides
    x = torch.zeros((1 + 4 * 9 * 64,), dtype=torch.bfloat16,
                    device=cuda)[1:].view(1, 4, 9, 64)   # base 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(x, x, x)
    pool = torch.zeros((5, 8, 1, 36), dtype=torch.bfloat16, device=cuda)
    kp = pool[..., :32]                        # rows 72 bytes apart
    qc = torch.zeros((3, 4, 32), dtype=torch.bfloat16, device=cuda)
    bt1 = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        PA.paged_chunk_attention(qc, kp, kp, bt1, 0, 3)
    qx = torch.zeros((1 + 3 * 4 * 32,), dtype=torch.bfloat16,
                     device=cuda)[1:].view(3, 4, 32)     # base 2 bytes off
    p32 = torch.zeros((5, 8, 1, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        PA.paged_chunk_attention(qx, p32, p32, bt1, 0, 3)
    qd = torch.zeros((2, 4, 32), dtype=torch.bfloat16, device=cuda)
    cl = torch.ones((2,), dtype=torch.int32, device=cuda)
    bt2 = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        DA.paged_decode_attention(qd, kp, kp, bt2, cl)
    p48 = torch.zeros((5, 8, 1, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        DA.paged_decode_attention(p48[:2, :4, 0], p48, p48, bt2, cl)


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


def _mixed_walks(dev, intervals, switch_at=7, steps=16):
    """A small dense engine (qwen2.5-3b at width 256, 12 layers) serving six
    requests whose walks come in a mixed order: one-shot prefills and
    incremental 16-token chunks (the scheduler's chunk size set per
    admission), decode steps replayed from the graph and, every third
    step, run eagerly; the interval switches from ``intervals[0]`` to
    ``intervals[1]`` at step ``switch_at``. Returns per step the prefill
    logits (rid, row), the decode logits, each live request's KV pages in
    its own order and the whole pool, and the engine."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core import graphs
    from repro_torch.core.hardware import PRESETS
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.request import Request

    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=256, heads=4,
                        layers=12, d_ff=512, vocab=1024)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    ecfg = EngineConfig(max_batch=4, max_seq=64, page_size=16,
                        hbm_budget_bytes=1e9, prefill_chunk_tokens=16,
                        incremental_prefill=True)
    eng = build_engine("mixed", cfg, PRESETS["h100"], ecfg,
                       [0.01 * k for k in range(1, 30)], device=dev,
                       params=params)
    assert eng.set_interval(intervals[0])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 30, 14, 40, 7, 22)]
    # step -> (request, one-shot prefill?)
    arrivals = {0: [(0, True)], 2: [(1, False)], 4: [(2, True), (3, False)],
                9: [(4, True)], 11: [(5, False)]}
    out, walks = [], []
    for step in range(steps):
        if step == switch_at:
            assert eng.set_interval(intervals[1])
        for i, one_shot in arrivals.get(step, []):
            eng.scheduler.chunk_tokens = 0 if one_shot else 16
            eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=6,
                               ttft_slo_s=100.0, tpot_slo_s=100.0))
        if dev.type == "cuda":
            eng._capture = None if step % 3 == 1 else graphs.Graphed
        eng.prefill_log, eng.last_decode = [], None
        eng.step()
        kv = {rid: eng.pool[eng.kv.device_pages_of(rid)].cpu()
              for rid in range(len(prompts)) if eng.kv.device_pages_of(rid)}
        out.append(([(r.rid, lg.copy()) for r, _, lg in eng.prefill_log],
                    None if eng.last_decode is None
                    else eng.last_decode["logits"].copy(), kv,
                    eng.pool.to("cpu", copy=True)))
        ring = eng._runtime._stream if eng._runtime else None
        walks.append(None if ring is None else (ring.walks,
                                                ring.primed_walks))
    return out, walks, eng


@pytest.mark.cuda
def test_primed_walks_are_bitwise_unoffloaded(cuda):
    """Every walk at a held interval ends by priming the next one's units
    0 and 1: over one-shot prefills, incremental chunks, eager and graphed
    decode steps in a mixed order, at interval 4 (3 groups) and, after a
    switch, at interval 3 (4 groups), each prefill and decode logit row and
    the KV pages are bitwise the same sequence with nothing offloaded (the
    whole pool too, until the switch remaps its frames), and after each
    placement every walk but the first was primed by the walk before."""
    from repro_torch.core.interval import NO_OFFLOAD

    got, walks, eng = _mixed_walks(cuda, (4, 3))
    want, none, ref = _mixed_walks(cuda, (NO_OFFLOAD, NO_OFFLOAD))
    assert all(w is None for w in none)
    for step, ((gp, gd, gkv, gpool), (wp, wd, wkv, wpool)) in enumerate(
            zip(got, want)):
        assert [r for r, _ in gp] == [r for r, _ in wp], step
        for (_, a), (_, b) in zip(gp, wp):
            assert np.array_equal(a, b), step
        assert (gd is None) == (wd is None), step
        assert gd is None or np.array_equal(gd, wd), step
        assert gkv.keys() == wkv.keys(), step
        for rid in gkv:
            assert torch.equal(gkv[rid], wkv[rid]), (step, rid)
        if step < 7:
            assert torch.equal(gpool, wpool), step
        n, primed = walks[step]
        assert n > 0 and primed == n - 1, (step, walks[step])
    assert walks[6][0] > walks[7][0]         # a new placement at the switch
    assert eng.decode_graph_captures >= 2 and eng.ring_walks > 0
    assert ({r.rid: r.generated for r in eng.finished}
            == {r.rid: r.generated for r in ref.finished})


@pytest.mark.cuda
def test_priming_copies_run_in_the_host_gap(cuda):
    """The ring primes the next walk as soon as a replay is launched, so
    its copies run while the host works between two replays: with a host
    sleep of one unit's copy time before the second replay (qwen2.5-3b's
    width, 9 layers at interval 3: three 154 MB units), group 0 waits
    under 10% of a copy there, and the replay is shorter than the first by
    at least half a copy. The first replay starts from a ring that a
    caller's walk (``begin``) used, so it primes at its own launch, as a
    walk without priming copies."""
    import time

    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core import graphs
    from repro_torch.core.analyzer import decode_pool, paged_decode_inputs
    from repro_torch.core.interval import OffloadPlan
    from repro_torch.core.memory_manager import (OffloadRuntime,
                                                 split_model_params)
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import pattern_info

    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=2048, heads=16,
                        layers=9, d_ff=11008, vocab=1024)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    _, units = pattern_info(cfg)
    rt = OffloadRuntime(model, OffloadPlan(units, 3), cuda)
    placed = rt.place(split_model_params(params, rt.plan))
    ring = rt._stream
    assert rt.plan.num_groups == 3
    ring.timed = True
    pool = decode_pool(cfg, model.virtual_kv, 4, 64, cuda)
    d = paged_decode_inputs(pool, 4, 64)
    tokens = torch.zeros(4, dtype=torch.int32, device=cuda)
    g = graphs.Graphed(
        lambda *a: rt.paged_decode_step(placed, *a),
        (tokens, d.pos, pool, d.block_tables, d.context_lens,
         d.write_frames, d.write_offsets),
        [(ring, "copies"), (ring, "copy_bytes")])
    torch.cuda.synchronize()
    ring.begin()
    ring.end()

    def timed_replay():
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), ring.timings()

    torch.cuda.synchronize()
    ms1, t1 = timed_replay()
    copy_ms = float(np.median([c for c, _ in t1]))
    time.sleep(copy_ms / 1e3)
    ms2, t2 = timed_replay()
    torch.cuda.synchronize()
    assert t1[0][1] > 0.5 * copy_ms, (t1, copy_ms)    # unprimed: it waited
    assert t2[0][1] < 0.1 * copy_ms, (t2, copy_ms)
    assert ms2 <= ms1 - 0.5 * copy_ms, (ms1, ms2, copy_ms)
    assert ring.primed_walks == ring.walks - 2   # the warm-up's, the first


def _small_disk_params():
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.models.model import build_model

    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=256, heads=4,
                        layers=8, d_ff=512, vocab=1024)
    return cfg, build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")


@pytest.mark.cuda
def test_disk_trace_sync_and_async_on_the_card(cuda):
    """``profile_engine.disk_engine``'s pressure trace on the card at a
    small width, with the sync and the async copy-stage plane: parks retire
    to disk and stage back, the decode and flash kernels run, the pools end
    empty, and the two runs give the same tokens and modeled clock."""
    from repro_torch.launch.profile_engine import (disk_engine, disk_requests,
                                                   serve_disk_trace)

    cfg, params = _small_disk_params()
    runs = {}
    for async_plane in (False, True):
        eng = disk_engine(cuda, async_plane=async_plane, params=params,
                          cfg=cfg)
        assert eng.pool.is_cuda and eng.host_pool.is_pinned()
        assert not eng.disk_pool.is_cuda
        da, fa = DA.launches, FA.launches
        out = serve_disk_trace(eng, *disk_requests(
            eng, np.random.default_rng(5)))
        assert DA.launches > da and FA.launches > fa
        assert out["finished"] == 6 and out["preemptions"] > 0
        assert out["disk_demotions"] > 0 and out["disk_stagings"] > 0
        assert eng.trace.audit().ok
        assert eng.kv.device.used_pages == eng.kv.host.used_pages \
            == eng.kv.disk.used_pages == 0
        foot = eng.trace.footer()
        assert foot["staged_issued_pages_total"] \
            == foot["staged_completed_pages_total"] > 0
        runs[async_plane] = eng
    assert {r.rid: r.generated for r in runs[True].finished} == \
        {r.rid: r.generated for r in runs[False].finished}
    assert runs[True].clock_s == runs[False].clock_s


@pytest.mark.cuda
def test_disk_file_round_trip_on_the_card(cuda, tmp_path):
    """L1's pages (two on the host tier, two on the card) retire to a
    file-backed disk pool, the file holds their bf16 bits, and a resume
    (with the host pool cleared) stages the same bits back onto the card
    and the host tier."""
    from repro_torch.launch.profile_engine import disk_engine, disk_requests

    cfg, params = _small_disk_params()
    path = tmp_path / "kv_disk.bin"
    eng = disk_engine(cuda, backing_path=str(path), params=params, cfg=cfg)
    first, _ = disk_requests(eng, np.random.default_rng(1))
    for r in first:
        eng.submit(r)
    eng.step()
    eng.step()
    s0, l1 = (r.rid for r in first)
    bits = lambda t: t.view(torch.int16).cpu().numpy().copy()
    refs = eng.kv.refs(l1)
    assert {r.tier for r in refs} == {"device", "host"}
    before = [bits(eng.pool[r.page] if r.tier == "device"
                   else eng.host_pool[r.page]) for r in refs]
    eng.kv.demote_to_disk(l1, len(eng.kv.host_pages_of(l1)))
    assert eng.kv.park(l1, [s0]) is not None
    eng.kv.demote_to_disk(l1, 99)
    frames = [r.page for r in eng.kv.refs(l1)]
    assert all(r.tier == "disk" for r in eng.kv.refs(l1))
    raw = np.fromfile(path, dtype=np.int16).reshape(eng.kv.disk.total_pages,
                                                    -1)
    for f, b in zip(frames, before):
        np.testing.assert_array_equal(raw[f], b.ravel())
    eng.host_pool.zero_()
    assert eng.kv.resume(l1) is not None
    after = eng.kv.refs(l1)
    assert "disk" not in {r.tier for r in after}
    assert "device" in {r.tier for r in after}
    for r, b in zip(after, before):
        page = eng.pool[r.page] if r.tier == "device" else \
            eng.host_pool[r.page]
        np.testing.assert_array_equal(bits(page), b)
    eng.kv.check_invariants()


@pytest.mark.cuda
def test_wallclock_analyzer_on_the_card(cuda):
    """The analyzer's default mode times one unit on the card at a small
    width: positive times, records marked ``wallclock`` on the calibrated
    preset, and the prefill and decode units go through the flash and
    paged decode kernels."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core.analyzer import (PerformanceAnalyzer,
                                           determinism_check)
    from repro_torch.core.hardware import H100_CALIBRATED

    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=256, heads=4,
                        layers=4, d_ff=512, vocab=1024)
    an = PerformanceAnalyzer(cfg, H100_CALIBRATED)
    assert an.measure == "wallclock" and an.device.type == "cuda"
    da, fa = DA.launches, FA.launches
    for phase in ("prefill", "decode"):
        rec = an.generate_record([0.002 * k for k in range(1, 20)], [1, 4],
                                 [16, 64], phase)
        assert (rec.measure, rec.hardware) == ("wallclock", "h100_calibrated")
        mt = an.measure_times(4, 64, phase)
        assert mt.t_compute_s > 0 and mt.t_rest_s == 0.1 * mt.t_compute_s
    assert DA.launches > da and FA.launches > fa
    stats = determinism_check(cfg, 4, 64, iters=3)
    assert stats["mean_s"] > 0 and np.isfinite(stats["cv"])


@pytest.mark.cuda
def test_weight_stream_copy_overlaps_compute(cuda):
    """``WeightStream`` copies a group's offloaded unit on its side stream
    while the group's resident units compute (paper Fig. 7). With a
    synthetic compute load about 1.5x one unit's copy, a group with the
    prefetch must take at most 0.75 of compute and copy timed apart (fully
    serial: 1.0; fully overlapped: about 0.6)."""
    import time

    from repro_torch.core.memory_manager import WeightStream

    unit = 128 * 2**20
    host = {"w": torch.empty((2, unit), dtype=torch.uint8).pin_memory(),
            "b": torch.empty((2, 4096), dtype=torch.uint8).pin_memory()}
    ws = WeightStream(host, cuda)
    a = torch.randn((4096, 4096), device=cuda).to(torch.bfloat16)

    def wall(fn, reps=5):
        fn()
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def copy(g=0):
        slot = ws.issue(g)
        ws.acquire(slot)["w"][:1].add_(0)
        ws.release(slot)

    t_copy, t_mm = wall(copy), wall(lambda: a @ a)
    n = max(1, round(1.5 * t_copy / t_mm))

    def compute():
        for _ in range(n):
            a @ a

    def group():
        slot = ws.issue(1)            # the offloaded unit's prefetch
        compute()                     # the resident units
        ws.acquire(slot)["w"][:1].add_(0)
        ws.release(slot)

    t_compute, t_group = wall(compute), wall(group)
    assert t_group <= 0.75 * (t_compute + t_copy), (t_group, t_compute,
                                                    t_copy)
