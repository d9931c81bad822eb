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
@pytest.mark.parametrize("h,vh", [(8, 8), (16, 4), (16, 2)])   # g 1, 4, 8
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
@pytest.mark.parametrize("d", [16, 32, 64, 128])
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
@pytest.mark.parametrize("d", [16, 32, 64, 128])
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
