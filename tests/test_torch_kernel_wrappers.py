"""The Python side of the port's kernel wrappers, on the CPU: the split
geometry the paged decode and chunk-prefill wrappers size their scratch
by, the 16-byte alignment the kernels' vector loads need, and that CPU
tensors keep taking the plain versions whatever their alignment. The
kernels themselves run only on the card (``tests/test_torch_cuda.py``)."""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import prefill_attention as PA  # noqa: E402


@pytest.mark.parametrize("nb,splits", [(1, 1), (4, 1), (5, 2), (12, 3),
                                       (64, 16), (0, 0)])
def test_decode_split_count(nb, splits):
    got, parts = DA.split_geometry(8, 16, 2, 128, nb)
    assert got == splits == math.ceil(nb / DA.PAGES_PER_SPLIT)
    assert parts == {"acc": (8, 2, splits, 8, 128), "m": (8, 2, splits, 8),
                     "l": (8, 2, splits, 8)}


@pytest.mark.parametrize("nb", [1, 3, 4, 7, 64, 65])
def test_decode_spans_tile_the_table(nb):
    """Split s covers table pages [s*P, (s+1)*P): S splits cover every
    page of the table, and none of them starts past its end."""
    splits = DA.split_geometry(1, 8, 2, 64, nb)[0]
    assert (splits - 1) * DA.PAGES_PER_SPLIT < nb <= splits * DA.PAGES_PER_SPLIT


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,ok", [
    ("contiguous", True),
    ("pool_layer_slice", True),
    ("projection_view", True),
    ("base_off_16", False),
    ("row_stride_72_bytes", False),
    ("head_dim_slice", True),
])
def test_vector_alignment_refusal(case, ok):
    pool = _bf16(5, 16, 3, 2, 2, 64)
    t = {
        "contiguous": _bf16(4, 16, 2, 64),
        # one layer of the engine's [frames, page, L, 2, vh, hd] pool
        "pool_layer_slice": pool[:, :, 1, 0],
        # the prefill's [B,S,H,D] projections viewed as [B,H,S,D]
        "projection_view": _bf16(1, 40, 8, 32).transpose(1, 2),
        "base_off_16": _bf16(1 + 4 * 64)[1:].view(4, 64),
        "row_stride_72_bytes": _bf16(6, 36)[:, :32],
        "head_dim_slice": _bf16(2, 9, 4, 128)[..., :64],
    }[case]
    if ok:
        _build.require_vector_aligned(case, t)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            _build.require_vector_aligned(case, t)


def test_cpu_tensors_take_the_plain_versions_whatever_their_alignment():
    """Alignment binds the kernels only: a misaligned CPU view gives the
    plain version's answer on its contiguous copy."""
    rng = np.random.default_rng(0)
    buf = torch.from_numpy(rng.standard_normal(1 + 2 * 4 * 40 * 16,
                                               np.float32)).to(torch.bfloat16)
    q = buf[1:].view(2, 4, 40, 16)
    with pytest.raises(ValueError):
        _build.require_vector_aligned("q", q)
    k = q[:, :2]
    assert torch.equal(FA.flash_attention(q, k, k),
                       FA.flash_attention_plain(q.contiguous(),
                                                k.contiguous(),
                                                k.contiguous()))
    pool = torch.from_numpy(rng.standard_normal((6, 8, 1, 36), np.float32)
                            ).to(torch.bfloat16)
    kp = pool[..., :32]
    qd = torch.from_numpy(rng.standard_normal((2, 4, 32), np.float32)
                          ).to(torch.bfloat16)
    bt = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    cl = torch.tensor([20, 9], dtype=torch.int32)
    assert torch.equal(DA.paged_decode_attention(qd, kp, kp, bt, cl),
                       DA.paged_decode_attention_plain(
                           qd, kp.contiguous(), kp.contiguous(), bt, cl))


@pytest.mark.parametrize("c,h,vh,d,k_end,splits", [
    (256, 16, 2, 128, 0, 1),    # context 0: one span that writes zeros
    # the serving shapes, below, at and across the span bounds
    (256, 16, 2, 128, 1, 1), (256, 16, 2, 128, 100, 1),
    (256, 16, 2, 128, 255, 1), (256, 16, 2, 128, 256, 1),
    (256, 16, 2, 128, 257, 2), (256, 16, 2, 128, 512, 2),
    (256, 16, 2, 128, 513, 3), (256, 16, 2, 128, 700, 3),
    (256, 16, 2, 128, 1024, 4), (256, 16, 2, 128, 1025, 5),
    (256, 16, 2, 128, 5000, 20),
    # other groups, head dims and chunk lengths
    (1, 8, 8, 16, 1000, 4), (16, 8, 2, 64, 700, 3),
    (3, 12, 4, 32, 0, 1), (64, 32, 2, 128, 5000, 20),
])
def test_chunk_split_count(c, h, vh, d, k_end, splits):
    """Span s covers keys [s*SPAN, (s+1)*SPAN): the S spans tile [0, k_end)
    and none starts at or past k_end; the scratch holds S partials of every
    row."""
    got, parts = PA.split_geometry(c, h, vh, d, k_end)
    assert got == splits == max(1, math.ceil(k_end / PA.SPAN_KEYS))
    if k_end:
        assert (splits - 1) * PA.SPAN_KEYS < k_end <= splits * PA.SPAN_KEYS
    rows = (splits, vh, c * (h // vh))  # [S, V, C*g] in the Pallas order
    assert parts == {"acc": rows + (d,), "m": rows, "l": rows}


@pytest.mark.parametrize("c,page,start,cl,want", [
    (256, 16, 768, 1024, 1024),         # the serving chunk
    (16, 16, 800, 816, 816),
    (12, 8, 20, 25, 32),                # the last live page stays visible
    (8, 8, 24, 24, 24),                 # clamped over capacity
    (6, 8, 0, 0, 0),                    # context 0
    (1, 16, 1000, 1001, 1001),
])
def test_chunk_key_end(c, page, start, cl, want):
    """The keys some query of the chunk may see: the live pages, none past
    the last query position (what sizes the split scratch)."""
    assert PA.key_end(c, page, start, cl) == want


@pytest.mark.parametrize("case,ok", [
    ("engine_views", True),
    ("q_base_off_16", False),
    ("pages_row_stride_72_bytes", False),
    ("pages_base_off_16", False),
])
def test_chunk_wrapper_refuses_misaligned_views(case, ok):
    """The chunk kernel's 16-byte copies read q and the pages: the wrapper
    refuses a base off 16 bytes or a row stride that is not a multiple of
    16 bytes, and takes the engine's views (projections and a layer slice
    of the 6-D pool)."""
    pool = _bf16(5, 16, 3, 2, 2, 64)
    q, kp, vp = _bf16(10, 8, 64), pool[:, :, 1, 0], pool[:, :, 1, 1]
    if case == "q_base_off_16":
        q = _bf16(1 + 10 * 8 * 64)[1:].view(10, 8, 64)
    elif case == "pages_row_stride_72_bytes":
        kp = vp = _bf16(5, 16, 2, 36)[..., :32]
        q = _bf16(10, 8, 32)
    elif case == "pages_base_off_16":
        kp = _bf16(1 + 5 * 16 * 2 * 64)[1:].view(5, 16, 2, 64)
    bt = torch.zeros((4,), dtype=torch.int32)
    if ok:
        PA.check_kernel_inputs(q, kp, vp, bt)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            PA.check_kernel_inputs(q, kp, vp, bt)


def test_chunk_wrapper_takes_plain_version_for_misaligned_cpu_views():
    """Alignment binds the kernel only: a misaligned CPU view gives the
    plain version's answer on its contiguous copy."""
    rng = np.random.default_rng(1)
    buf = torch.from_numpy(rng.standard_normal(1 + 20 * 4 * 16, np.float32)
                           ).to(torch.bfloat16)
    q = buf[1:].view(20, 4, 16)
    pool = torch.from_numpy(rng.standard_normal((6, 8, 2, 20), np.float32)
                            ).to(torch.bfloat16)
    kp = pool[..., :16]                 # rows 40 bytes apart
    with pytest.raises(ValueError, match="16-byte"):
        PA.check_kernel_inputs(q, kp, kp, torch.zeros(3, dtype=torch.int32))
    bt = torch.tensor([4, 0, 5], dtype=torch.int32)
    assert torch.equal(
        PA.paged_chunk_attention(q, kp, kp, bt, 2, 22),
        PA.paged_chunk_attention_plain(q.contiguous(), kp.contiguous(),
                                       kp.contiguous(), bt, 2, 22))


def test_chunk_cuda_entry_refuses_cpu_tensors():
    """The kernel's entry has no plain fallback: CPU tensors are refused
    before the library is loaded, and no launch is counted."""
    q, pages = _bf16(4, 8, 64), _bf16(3, 16, 2, 64)
    bt = torch.zeros((2,), dtype=torch.int32)
    before = PA.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        PA.paged_chunk_attention_cuda(q, pages, pages, bt, 0, 4)
    assert PA.launches == before
