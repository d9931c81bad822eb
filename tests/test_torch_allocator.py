"""The port's tiered KV allocator under random op sequences, with the
``extend`` rollback repaired (ROADMAP Queue C 5).

``TieredKVAllocator.extend`` may demote, through ``swap_out``, a tail page
that the same call has just added; when a later step of the call fails,
its rollback must release that page from the host pool it now sits on.
The reference releases it from the device pool and raises ``ValueError``
(``tests/differential/test_allocator_properties.py`` finds it now and
then). The port keeps the reference's result wherever the reference does
not raise, so the engines' lockstep traces stay equal.
"""
from __future__ import annotations

try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, st

    def example(**_kw):          # the fallback shim runs fixed draws only
        return lambda fn: fn

import pytest

from repro_torch.serving.kv_cache import PageConfig
from repro_torch.serving.kv_offload import DEVICE, HOST, TieredKVAllocator

PAGE = 4   # tokens per page
BPT = 4    # bytes per token
PB = PAGE * BPT
# the saved falsifying example of the reference's property test
C5 = dict(codes=[151936, 17592, 731369086, 0, 523224067], dev_pages=0,
          host_pages=2)


def _page_count(kv, rid, tier):
    return len(kv.device_pages_of(rid) if tier == DEVICE
               else kv.host_pages_of(rid))


def _apply(kv, tokens, code, dev_pages, host_pages, next_rid):
    """One op of the reference property test's sequence, with its checks.
    Returns (op, the op's result, the next free rid)."""
    op, arg = code % 6, code // 6
    alive = sorted(tokens)
    out = None
    if op == 0:                                          # alloc
        want = arg % ((dev_pages + host_pages + 2) * PAGE) + 1
        out = kv.alloc(next_rid, want, allow_host=bool(arg % 2))
        if out is not None:
            assert len(out) == kv.device.pages_for(want)
            tokens[next_rid] = want
            next_rid += 1
        else:
            kv.free(next_rid)        # nothing claimed: must be a no-op
    elif op == 1 and alive:                              # extend
        rid = alive[arg % len(alive)]
        before = kv.refs(rid)
        new_total = tokens[rid] + arg % (3 * PAGE) + 1
        out = kv.extend(rid, new_total, allow_host=bool(arg % 2))
        after = kv.refs(rid)
        if out is None:
            # exact rollback: same length, and position-wise either the
            # identical ref or a documented DEVICE->HOST demotion
            assert len(after) == len(before)
            for b4, now in zip(before, after):
                assert now == b4 or (b4.tier == DEVICE and now.tier == HOST)
        else:
            tokens[rid] = new_total
    elif op == 2 and alive:                              # swap_out
        rid = alive[arg % len(alive)]
        n_dev = _page_count(kv, rid, DEVICE)
        free_host = kv.host.free_pages
        out = kv.swap_out(rid, arg % 3 + 1)
        assert len(out) == min(arg % 3 + 1, n_dev, free_host)
        for m in out:
            assert m.dst_page in kv.host_pages_of(rid)
    elif op == 3 and alive:                              # swap_in
        rid = alive[arg % len(alive)]
        n_host = _page_count(kv, rid, HOST)
        out = kv.swap_in(rid, arg % 3 + 1)
        assert len(out) <= min(arg % 3 + 1, n_host)
    elif op == 4:                                        # resize
        new_bytes = (arg % (dev_pages + 4)) * PB
        if kv.can_resize_device(new_bytes):
            out = kv.resize_device(new_bytes)
            live_dev = sorted(p for r in tokens
                              for p in kv.device_pages_of(r))
            assert sorted(n for _, n in out.remap) == live_dev
            for m in out.demotions:
                assert m.src_tier == DEVICE
                assert m.dst_page in kv.host_pages_of(m.rid)
        else:
            snapshot = {r: kv.refs(r) for r in alive}
            with pytest.raises(RuntimeError):
                kv.resize_device(new_bytes)
            assert {r: kv.refs(r) for r in alive} == snapshot
    elif op == 5 and alive:                              # free
        rid = alive[arg % len(alive)]
        kv.free(rid)
        del tokens[rid]
        assert kv.refs(rid) == []
    return op, out, next_rid


def _check(kv, tokens):
    kv.check_invariants()            # tiers/pools/refs exactly consistent
    for rid, tok in tokens.items():
        refs = kv.refs(rid)
        assert len(refs) == kv.device.pages_for(tok)
        assert (_page_count(kv, rid, DEVICE)
                + _page_count(kv, rid, HOST)) == len(refs)


def _drive(codes, dev_pages, host_pages):
    kv = TieredKVAllocator(dev_pages * PB, host_pages * PB,
                           PageConfig(PAGE, bytes_per_token=BPT))
    tokens: dict[int, int] = {}
    next_rid = 0
    for code in codes:
        _, _, next_rid = _apply(kv, tokens, code, dev_pages, host_pages,
                                next_rid)
        _check(kv, tokens)
    for rid in list(tokens):
        kv.free(rid)
    kv.check_invariants()
    assert kv.device.used_pages == 0 and kv.host.used_pages == 0


def test_queue_c5_example_rolls_back_a_demoted_tail_page():
    """The saved example, step by step: rid 1 holds one device page of a
    3-page device pool; its extend to 4 pages demotes that page, adds a
    tail page, demotes the tail page too, and then finds device and host
    full. The rollback releases the demoted tail page from the host pool
    and leaves rid 1 with its one (demoted) page."""
    kv = TieredKVAllocator(0, 2 * PB, PageConfig(PAGE, bytes_per_token=BPT))
    tokens: dict[int, int] = {}
    next_rid = 0
    results = []
    for code in C5["codes"]:
        op, out, next_rid = _apply(kv, tokens, code, 0, 2, next_rid)
        results.append((op, out))
        _check(kv, tokens)
    assert [op for op, _ in results] == [4, 0, 4, 0, 1]
    assert results[-1][1] is None                  # the extend failed
    assert kv.refs(1) == [kv.refs(1)[0]] and kv.refs(1)[0].tier == HOST
    assert kv.host.used_pages == 1 and kv.device.free_pages == 1
    _drive(**C5)


@given(codes=st.lists(st.integers(0, (1 << 30) - 1), min_size=0, max_size=50),
       dev_pages=st.integers(0, 10), host_pages=st.integers(0, 10))
@example(**C5)
@settings(max_examples=80, deadline=None)
def test_tiered_allocator_random_op_sequences(codes, dev_pages, host_pages):
    """The reference's tiered property test on the port's allocator, with
    the Queue C 5 example pinned."""
    _drive(codes, dev_pages, host_pages)


@given(codes=st.lists(st.integers(0, (1 << 30) - 1), min_size=0, max_size=50),
       dev_pages=st.integers(0, 10), host_pages=st.integers(0, 10))
@settings(max_examples=60, deadline=None)
def test_port_allocator_gives_the_references_results(codes, dev_pages,
                                                     host_pages):
    """Where the reference's allocator does not raise, the port's returns
    the same results and holds the same refs after every op; where it
    raises (the Queue C 5 rollback), the comparison ends there."""
    from repro.serving.kv_cache import PageConfig as JPageConfig
    from repro.serving.kv_offload import TieredKVAllocator as JTiered

    ref = JTiered(dev_pages * PB, host_pages * PB,
                  JPageConfig(PAGE, bytes_per_token=BPT))
    port = TieredKVAllocator(dev_pages * PB, host_pages * PB,
                             PageConfig(PAGE, bytes_per_token=BPT))
    ref_tokens: dict[int, int] = {}
    port_tokens: dict[int, int] = {}
    ref_next = port_next = 0
    for code in codes:
        try:
            _, want, ref_next = _apply(ref, ref_tokens, code, dev_pages,
                                       host_pages, ref_next)
        except ValueError:
            return                   # the reference's fault: nothing to hold
        _, got, port_next = _apply(port, port_tokens, code, dev_pages,
                                   host_pages, port_next)
        assert repr(got) == repr(want)
        assert port_tokens == ref_tokens
        assert {r: [(x.tier, x.page) for x in port.refs(r)]
                for r in port_tokens} == \
            {r: [(x.tier, x.page) for x in ref.refs(r)] for r in ref_tokens}
