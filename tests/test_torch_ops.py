"""The port's KV page data plane (``repro_torch.kernels.ops``): bitwise page
round trips between the device pool and the host pool, in-place pool
updates, and ``pack_token_pages`` equal to the reference's."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.kv_cache import PageConfig  # noqa: E402
from repro_torch.serving.kv_offload import TieredKVAllocator  # noqa: E402


def test_page_copy_round_trip_bitwise():
    """device -> host -> device through the data plane, bitwise equal (the
    port's twin of tests/test_kv_offload.py's round trip)."""
    page, vh, d = 8, 2, 16
    kv = TieredKVAllocator(6 * page, 8 * page,
                           PageConfig(page_size=page, bytes_per_token=1))
    kv.alloc(0, 3 * page)
    rng = np.random.default_rng(0)
    k_pool = torch.from_numpy(rng.normal(size=(6, page, vh, d))
                              .astype(np.float32))
    v_pool = torch.from_numpy(rng.normal(size=(6, page, vh, d))
                              .astype(np.float32))
    k_host = torch.zeros((kv.host.total_pages, page, vh, d))
    v_host = torch.zeros((kv.host.total_pages, page, vh, d))
    q = torch.from_numpy(rng.normal(size=(1, 4, d)).astype(np.float32))
    cl = torch.tensor([3 * page - 2], dtype=torch.int32)
    bt0 = torch.from_numpy(kv.device_block_table(0, 3)[None].astype(np.int32))
    out0 = ops.paged_decode_attention(q, k_pool, v_pool, bt0, cl)
    k_orig = k_pool.clone()

    moves = kv.swap_out(0, 2)
    src = [m.src_page for m in moves]
    dst = [m.dst_page for m in moves]
    ops.copy_pages_to_host(k_pool, src, k_host, dst)
    ops.copy_pages_to_host(v_pool, src, v_host, dst)
    k_pool[src] = 0.0                  # the copy path must restore content
    v_pool[src] = 0.0

    back = kv.swap_in(0, 2)
    bsrc = [m.src_page for m in back]
    bdst = [m.dst_page for m in back]
    k_pool2 = ops.copy_pages_from_host(k_host, bsrc, k_pool, bdst)
    v_pool2 = ops.copy_pages_from_host(v_host, bsrc, v_pool, bdst)
    assert k_pool2 is k_pool and v_pool2 is v_pool       # in place
    dev_now = kv.device_block_table(0, 3)
    for before, after in zip(bt0[0].tolist(), dev_now):
        assert torch.equal(k_orig[before], k_pool[after])
    out1 = ops.paged_decode_attention(
        q, k_pool, v_pool, torch.from_numpy(dev_now[None].astype(np.int32)),
        cl)
    assert torch.equal(out0, out1)


def test_bf16_pool_round_trip_and_empty_batches():
    rng = np.random.default_rng(1)
    shape = (7, 4, 3, 2, 2, 8)          # [frames, page, L, 2, vh, hd]
    pool = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)
    host = torch.zeros((5, *shape[1:]), dtype=torch.bfloat16)
    before = pool.clone()
    ops.copy_pages_to_host(pool, [], host, [])
    assert ops.copy_pages_from_host(host, [], pool, []) is pool
    ops.copy_pages_to_host(pool, [6, 1, 3], host, [0, 4, 2])
    assert torch.equal(host[[0, 4, 2]], pool[[6, 1, 3]])
    pool.zero_()
    ops.copy_pages_from_host(host, [2, 0, 4], pool, [3, 6, 1])
    assert torch.equal(pool[[6, 1, 3]], before[[6, 1, 3]])
    assert torch.equal(ops.gather_kv_pages(pool, [1, 6]), before[[1, 6]])


def test_copy_pages_on_device_reads_sources_before_writing():
    pool = torch.arange(6, dtype=torch.float32)[:, None].repeat(1, 4)
    out = ops.copy_pages_on_device(pool, [0, 1, 2], [1, 2, 3])
    assert out is pool
    assert pool[:, 0].tolist() == [0, 0, 1, 2, 4, 5]


def test_duplicate_destinations_refused():
    pool = torch.zeros((4, 2))
    host = torch.ones((4, 2))
    with pytest.raises(ValueError, match="duplicate"):
        ops.copy_pages_from_host(host, [0, 1], pool, [2, 2])
    with pytest.raises(ValueError, match="duplicate"):
        ops.copy_pages_on_device(pool, [0, 1], [3, 3])
    with pytest.raises(ValueError, match="duplicate"):
        ops.copy_pages_to_host(pool, [0, 1], host, [1, 1])


@pytest.mark.parametrize("s,page", [(1, 4), (8, 4), (13, 4), (16, 16)])
def test_pack_token_pages_equals_reference(s, page):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops

    rng = np.random.default_rng(s)
    k = rng.normal(size=(3, s, 2, 8)).astype(np.float32)
    v = rng.normal(size=(3, s, 2, 8)).astype(np.float32)
    want = jops.pack_token_pages(np.asarray(jnp.asarray(k, jnp.bfloat16)),
                                 np.asarray(jnp.asarray(v, jnp.bfloat16)),
                                 page, dtype=jnp.bfloat16)
    got = ops.pack_token_pages(torch.from_numpy(k).to(torch.bfloat16),
                               torch.from_numpy(v).to(torch.bfloat16), page,
                               dtype=torch.bfloat16)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.uint16).view(np.int16))
