"""The port's attention kernels, held against the reference on the CPU.

The plain PyTorch versions (what the wrappers run on CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernels against on the card) are compared
with the Pallas kernels in interpret mode (through the reference's jitted
``kernels.ops`` entry points) and with both packages' dense
oracles, over the cases of ``tests/test_kernels.py``. The chunk-prefill
kernel, which the reference tests only through its engine, is held against
the Pallas kernel in interpret mode and the port's dense oracle. Tolerances
are ``tests/test_kernels.py``'s: fp32 1e-5, bf16 2e-2. The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.prefill_attention import (  # noqa: E402
    paged_chunk_attention_pallas)
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import paged_decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    paged_chunk_attention, paged_chunk_attention_plain)

# the reference's dense oracles, jitted: one compile per shape instead of
# one per primitive
jref_flash = jax.jit(jref.ref_flash_attention,
                     static_argnames=("causal", "window", "kv_len"))
jref_paged = jax.jit(jref.ref_paged_decode_attention,
                     static_argnames=("window",))
jpallas_chunk = jax.jit(paged_chunk_attention_pallas,
                        static_argnames=("interpret",))
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounding
    from the same float32 bits on both sides)."""
    if x.dtype.kind in "iu":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    return (jnp.asarray(x).astype(JDT[dtype]),
            torch.from_numpy(x.copy()).to(TDT[dtype]))


def _close(got_t, want_j, dtype):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), **TOL[dtype])


def _qkv(b, h, vh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), np.float32),
            rng.standard_normal((b, vh, sk, d), np.float32),
            rng.standard_normal((b, vh, sk, d), np.float32))


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = {
    "mha_square": ((1, 4, 4, 64, 64, 64), {}),
    "gqa": ((2, 8, 2, 128, 128, 64), {}),
    "mqa_padded": ((1, 8, 1, 96, 96, 128), {}),
    "multi_block": ((1, 4, 4, 256, 256, 32), {}),
    "window16": ((1, 4, 2, 128, 128, 64), {"window": 16}),
    "window64": ((1, 4, 2, 128, 128, 64), {"window": 64}),
    "noncausal_cross": ((2, 4, 4, 32, 80, 64), {"causal": False}),
    "kv_len": ((1, 4, 4, 64, 128, 64), {"causal": False, "kv_len": 100}),
    "decode_offset": ((1, 4, 4, 32, 128, 64), {}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_pallas_and_oracles(case, dtype):
    shape, kw = FLASH_CASES[case]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in _qkv(*shape))
    got = flash_attention(tq, tk, tv, **kw)       # CPU tensor: plain version
    pallas = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                  interpret=True, **kw)
    _close(got, pallas, dtype)
    want = jref_flash(jq, jk, jv, **kw)
    _close(got, want, dtype)
    _close(tref.ref_flash_attention(tq, tk, tv, **kw), want, dtype)


def test_flash_pos_offset_matches_pallas():
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, "float32")
                                    for x in _qkv(1, 4, 2, 40, 96, 32))
    for off in (-8, 5):
        got = flash_attention_plain(tq, tk, tv, pos_offset=off)
        want = flash_attention_pallas(jq, jk, jv, pos_offset=off, block_q=32,
                                      block_k=32, interpret=True)
        _close(got, want, "float32")


def test_flash_strided_inputs_match_contiguous():
    """The prefill hands the kernel [B,S,H,D] projections viewed as
    [B,H,S,D]; strided and contiguous inputs give the same result."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 48, 48, 32))
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    ks = k.transpose(1, 2).contiguous().transpose(1, 2)
    vs = v.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qs.is_contiguous()
    assert torch.equal(flash_attention(qs, ks, vs), flash_attention(q, k, v))


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------


def _paged(b, h, vh, d, npages, page, nb, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), np.float32)
    kp = rng.standard_normal((npages, page, vh, d), np.float32)
    vp = rng.standard_normal((npages, page, vh, d), np.float32)
    bt = rng.permutation(npages)[:b * nb].reshape(b, nb).astype(np.int32)
    cl = rng.integers(1, nb * page + 1, b).astype(np.int32)
    return q, kp, vp, bt, cl


def _decode_both(q, kp, vp, bt, cl, dtype, window=0):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, kp, vp))
    (jb, tb), (jc, tc) = _pair(bt, dtype), _pair(cl, dtype)
    got = paged_decode_attention(tq, tk, tv, tb, tc, window=window)
    pallas = jops.paged_decode_attention(jq, jk, jv, jb, jc, window=window,
                                         interpret=True)
    return got, pallas, (jq, jk, jv, jb, jc), (tq, tk, tv, tb, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,vh,d,page,nb", [
    (2, 4, 4, 64, 16, 4),
    (3, 8, 2, 64, 32, 3),     # GQA
    (1, 8, 1, 128, 16, 8),    # MQA
])
def test_paged_decode_plain_matches_pallas_and_oracles(dtype, b, h, vh, d,
                                                       page, nb):
    inputs = _paged(b, h, vh, d, b * nb + 3, page, nb)
    got, pallas, j, t = _decode_both(*inputs, dtype)
    _close(got, pallas, dtype)
    want = jref_paged(*j)
    _close(got, want, dtype)
    _close(tref.ref_paged_decode_attention(*t), want, dtype)


def _edge_cases():
    q, kp, vp, bt, _ = _paged(2, 4, 2, 64, 19, 8, 9)
    yield "window", (q, kp, vp, bt, np.array([60, 33], np.int32)), 20
    q, kp, vp, bt, _ = _paged(2, 4, 4, 64, 16, 2, 7)
    yield "single_token", (q, kp, vp, bt, np.array([1, 5], np.int32)), 0
    q, kp, vp, bt, _ = _paged(2, 4, 2, 64, 13, 16, 4)
    bt = bt.copy()
    bt[0, 2:] = 99_999
    bt[1, 3:] = -3
    yield "padded_out_of_range", (q, kp, vp, bt,
                                  np.array([18, 33], np.int32)), 0
    q, kp, vp, bt, _ = _paged(3, 8, 2, 64, 15, 16, 3)
    yield "not_page_multiple", (q, kp, vp, bt,
                                np.array([7, 17, 45], np.int32)), 0
    q, kp, vp, bt, _ = _paged(3, 8, 2, 64, 15, 16, 3)
    yield "idle_rows", (q, kp, vp, bt, np.array([0, 17, -4], np.int32)), 0
    q, kp, vp, bt, _ = _paged(2, 4, 4, 32, 9, 16, 2)
    yield "over_capacity", (q, kp, vp, bt, np.array([500, 3], np.int32)), 0
    q, kp, vp, bt, _ = _paged(1, 4, 4, 64, 9, 16, 4)
    for c in (1, 15, 16, 17, 64):
        yield f"batch1_cl{c}", (q, kp, vp, bt, np.array([c], np.int32)), 0


EDGE = {name: (inputs, window) for name, inputs, window in _edge_cases()}


@pytest.mark.parametrize("case", list(EDGE))
def test_paged_decode_edge_cases(case):
    inputs, window = EDGE[case]
    got, pallas, j, t = _decode_both(*inputs, "float32", window=window)
    _close(got, pallas, "float32")
    bt, cl = inputs[3], inputs[4]
    jb = jnp.asarray(np.clip(bt, 0, inputs[1].shape[0] - 1))
    jc = jnp.asarray(np.clip(cl, 0, bt.shape[1] * inputs[1].shape[1]))
    _close(got, jref_paged(*j[:3], jb, jc, window=window), "float32")
    if case == "idle_rows":
        assert torch.count_nonzero(got[0]) == 0
        assert torch.count_nonzero(got[2]) == 0


def test_paged_decode_reads_strided_pool_layer():
    """The engine passes one layer of its [frames, page, L, 2, vh, hd] pool
    as strided K/V views; the result equals the contiguous pages' result
    and the Pallas kernel's on the sliced copies."""
    rng = np.random.default_rng(5)
    frames, page, layers, vh, d, b, nb, h = 11, 8, 3, 2, 32, 3, 3, 4
    pool = rng.standard_normal((frames, page, layers, 2, vh, d), np.float32)
    q = rng.standard_normal((b, h, d), np.float32)
    bt = rng.permutation(frames - 1)[:b * nb].reshape(b, nb).astype(np.int32)
    bt[2, 1:] = frames - 1                     # null-frame padding
    cl = np.array([20, 9, 5], np.int32)
    tpool = torch.from_numpy(pool).to(torch.bfloat16)
    for layer in range(layers):
        kv_l = tpool[:, :, layer]
        kp, vp = kv_l[:, :, 0], kv_l[:, :, 1]
        assert not kp.is_contiguous()
        got = paged_decode_attention(torch.from_numpy(q).to(torch.bfloat16),
                                     kp, vp, torch.from_numpy(bt),
                                     torch.from_numpy(cl))
        dense = paged_decode_attention(
            torch.from_numpy(q).to(torch.bfloat16), kp.contiguous(),
            vp.contiguous(), torch.from_numpy(bt), torch.from_numpy(cl))
        assert torch.equal(got, dense)
        jpool = jnp.asarray(pool).astype(jnp.bfloat16)[:, :, layer]
        want = jops.paged_decode_attention(
            jnp.asarray(q).astype(jnp.bfloat16), jpool[:, :, 0],
            jpool[:, :, 1], jnp.asarray(bt), jnp.asarray(cl), interpret=True)
        _close(got, want, "bfloat16")


# ---------------------------------------------------------------------------
# Paged chunk-prefill attention
# ---------------------------------------------------------------------------

# (C, H, V, D, page, nb, npages, start, context_len, table edit): the table
# edit writes out-of-range values past the context's last page
CHUNK_CASES = {
    "first_chunk_g2": (16, 4, 2, 32, 8, 4, 9, 0, 16, None),
    "mid_prompt_g4": (8, 8, 2, 64, 16, 4, 9, 24, 32, None),
    "partial_last_page_g1": (13, 4, 4, 32, 8, 5, 9, 16, 29, None),
    "out_of_range_table": (8, 4, 2, 32, 8, 6, 9, 16, 24, "oob"),
    # queries 20..31 over a context clamped to 25: keys 25..31 of the last
    # live page stay visible (no separate length mask)
    "context_below_chunk_end": (12, 4, 2, 32, 8, 4, 9, 20, 25, None),
    "context_zero": (6, 4, 2, 32, 8, 3, 5, 0, 0, None),
    "over_capacity": (8, 4, 2, 32, 8, 3, 5, 30, 500, None),
    "single_token": (1, 8, 2, 64, 16, 4, 6, 40, 41, None),
}


def _chunk(c, h, vh, d, page, nb, npages, start, cl, edit, seed=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((c, h, d), np.float32)
    kp = rng.standard_normal((npages, page, vh, d), np.float32)
    vp = rng.standard_normal((npages, page, vh, d), np.float32)
    bt = rng.permutation(npages)[:nb].astype(np.int32)
    if edit == "oob":
        live = -(-cl // page)
        bt[live:] = 99_999
        bt[-1] = -3
    return q, kp, vp, bt, start, cl


def _chunk_pallas(q, kp, vp, bt, start, cl, dtype):
    jq, jk, jv = (_pair(x, dtype)[0] for x in (q, kp, vp))
    return jpallas_chunk(jq, jk, jv, jnp.asarray(bt), jnp.int32(start),
                         jnp.int32(cl), interpret=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_paged_chunk_plain_matches_pallas_and_oracle(case, dtype):
    q, kp, vp, bt, start, cl = _chunk(*CHUNK_CASES[case])
    tq, tk, tv = (_pair(x, dtype)[1] for x in (q, kp, vp))
    tb = torch.from_numpy(bt)
    got = paged_chunk_attention(tq, tk, tv, tb, start, cl)   # plain version
    assert got.shape == tq.shape and got.dtype == tq.dtype
    _close(got, _chunk_pallas(q, kp, vp, bt, start, cl, dtype), dtype)
    _close(got, tref.ref_paged_chunk_attention(tq, tk, tv, tb, start, cl)
           .float().numpy(), dtype)
    if cl == 0:
        assert torch.count_nonzero(got) == 0


def test_paged_chunk_clamped_context_keeps_last_page_visible():
    """A query past a clamped ``context_len`` still sees the keys of the
    last live page up to its own position: a ``kpos < context_len`` mask
    would give a different answer."""
    q, kp, vp, bt, start, cl = _chunk(*CHUNK_CASES["context_below_chunk_end"])
    t = [torch.from_numpy(x) for x in (q, kp, vp, bt)]
    got = paged_chunk_attention_plain(*t, start, cl)
    # the same chunk over a context that ends at the chunk's end
    assert torch.allclose(got, paged_chunk_attention_plain(*t, start, 32),
                          rtol=1e-5, atol=1e-5)
    # the same queries under a kpos < context_len mask
    c, h, d = q.shape
    vh = kp.shape[2]
    k, v = (x[t[3].long()].reshape(-1, vh, d) for x in t[1:3])
    sc = torch.einsum("cvgd,svd->cvgs", t[0].reshape(c, vh, h // vh, d),
                      k) / d ** 0.5
    kpos = torch.arange(k.shape[0])
    qpos = start + torch.arange(c)
    vis = (kpos[None] <= qpos[:, None]) & (kpos[None] < cl)
    sc = sc.masked_fill(~vis[:, None, None], float("-inf"))
    masked = torch.einsum("cvgs,svd->cvgd", torch.softmax(sc, -1),
                          v).reshape(c, h, d)
    assert torch.allclose(got[:5], masked[:5], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got[-6:], masked[-6:], atol=1e-2)


def test_paged_chunk_reads_strided_pool_layer():
    """The engine passes one layer of its [frames, page, L, 2, vh, hd] pool
    as strided K/V views and the chunk's q as a view of its projections;
    the result equals the contiguous inputs' result and the Pallas
    kernel's on the sliced copies."""
    rng = np.random.default_rng(6)
    frames, page, layers, vh, d, h, c, nb = 9, 8, 3, 2, 32, 8, 10, 5
    pool = rng.standard_normal((frames, page, layers, 2, vh, d), np.float32)
    qs = rng.standard_normal((1, c, h, d), np.float32)
    bt = rng.permutation(frames - 1)[:nb].astype(np.int32)
    bt[3:] = frames - 1                        # null-frame padding
    start, cl = 14, 24
    tpool = torch.from_numpy(pool).to(torch.bfloat16)
    tq = torch.from_numpy(qs).to(torch.bfloat16)[0]
    for layer in range(layers):
        kv_l = tpool[:, :, layer]
        kp, vp = kv_l[:, :, 0], kv_l[:, :, 1]
        assert not kp.is_contiguous()
        got = paged_chunk_attention(tq, kp, vp, torch.from_numpy(bt), start,
                                    cl)
        dense = paged_chunk_attention(tq, kp.contiguous(), vp.contiguous(),
                                      torch.from_numpy(bt), start, cl)
        assert torch.equal(got, dense)
        want = _chunk_pallas(qs[0], pool[:, :, layer, 0], pool[:, :, layer, 1],
                             bt, start, cl, "bfloat16")
        _close(got, want, "bfloat16")
