"""The Python side of the port's kernel wrappers, on the CPU: the split
geometry the paged decode wrapper sizes its scratch by, the 16-byte
alignment the flash and decode kernels' vector loads need, and that CPU
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
