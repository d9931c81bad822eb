"""The port's copy-stage engine (``repro_torch.serving.data_plane``) held
against the reference's (``repro.serving.data_plane``).

Each hazard scenario of ``tests/test_data_plane.py`` runs the SAME
allocator op sequence through four twins: the reference plane over JAX and
numpy pools, and the port's plane over torch pools, each in sync and in
async mode (drains only at pass boundaries, as the serving engine drains).
The device, host and disk pools must come out bitwise equal across all
four. The port's pools are bf16, as in its engine; every payload value is
exact in bf16, so its pools compare bitwise with the reference's fp32 ones.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.serving import data_plane as ref_dp  # noqa: E402
from repro.serving import kv_offload as ref_kvo  # noqa: E402
from repro.serving.kv_cache import PageConfig as RefPageConfig  # noqa: E402
from repro_torch.serving import data_plane as port_dp  # noqa: E402
from repro_torch.serving import kv_offload as port_kvo  # noqa: E402
from repro_torch.serving.kv_cache import PageConfig  # noqa: E402

_PAGE = 4          # tokens per page
_BPT = 4           # bytes per token -> page_bytes = 16
_W = 8             # payload values per physical page frame
# a page's payload: (base + i) * 2**(j - 4), exact in bf16 for base + i < 256
_SCALE = 2.0 ** (np.arange(_W) - 4)
FRAMEWORKS = ("ref", "port")
TWINS = [(fw, mode) for fw in FRAMEWORKS for mode in (False, True)]


def _rows(vals) -> np.ndarray:
    return np.asarray(vals, np.float32)[:, None] * _SCALE[None].astype(
        np.float32)


class _Twin:
    """One allocator + physical pools + copy-stage plane, hooks wired the
    way each package's serving engine wires them."""

    def __init__(self, fw, *, dev_pages, host_pages, disk_pages,
                 async_mode, direct=False, background=True):
        self.fw = fw
        kvo = ref_kvo if fw == "ref" else port_kvo
        pcfg = (RefPageConfig if fw == "ref" else PageConfig)(
            page_size=_PAGE, bytes_per_token=_BPT)
        pb = _PAGE * _BPT
        self.kv = kvo.TieredKVAllocator(
            dev_pages * pb, host_pages * pb, pcfg, disk_bytes=disk_pages * pb,
            disk_link=kvo.LinkSpec(bw_bytes_s=1e9, latency_s=0.0))
        if fw == "ref":
            self._pool = [jnp.zeros((dev_pages, _W), jnp.float32)]
            self.host_pool = np.zeros((host_pages, _W), np.float32)
            self.disk_pool = np.zeros((disk_pages, _W), np.float32)
            plane_cls = ref_dp.CopyStageEngine
        else:
            zeros = lambda n: torch.zeros((n, _W), dtype=torch.bfloat16)
            self._pool = [zeros(dev_pages)]
            self.host_pool, self.disk_pool = zeros(host_pages), zeros(
                disk_pages)
            plane_cls = port_dp.CopyStageEngine
        self.plane = plane_cls(host_pool=self.host_pool,
                               disk_pool=self.disk_pool,
                               get_pool=lambda: self._pool[0],
                               set_pool=self._set_pool,
                               async_mode=async_mode, background=background)
        self.async_mode = async_mode
        self.kv.park_copy = lambda s, d: self.plane.stage("d2h", s, d)
        self.kv.promote_copy = lambda s, d: self.plane.stage("h2d", s, d)
        self.kv.disk_copy = self._disk_copy
        if direct:
            self.kv.direct_copy = self._direct_copy

    def _set_pool(self, pool):
        self._pool[0] = pool

    def _disk_copy(self, st, sp, dt, dp):
        self.plane.stage("h2disk" if dt == "disk" else "disk2h", sp, dp)

    def _direct_copy(self, st, sp, dt, dp):
        self.plane.stage("disk2d" if dt == "device" else "d2disk", sp, dp)

    def fill_device(self, rid, base):
        frames = self.kv.device_pages_of(rid)
        vals = _rows([base + i for i in range(len(frames))])
        for f, row in zip(frames, vals):
            if self.fw == "ref":
                self._pool[0] = self._pool[0].at[f].set(row)
            else:
                self._pool[0][f] = torch.from_numpy(row)

    def pools(self) -> tuple[np.ndarray, ...]:
        self.plane.sync()
        as_np = ((lambda a: np.asarray(a, np.float32)) if self.fw == "ref"
                 else (lambda t: t.float().numpy()))
        return tuple(as_np(p) for p in (self._pool[0], self.host_pool,
                                        self.disk_pool))


def _assert_pools_equal(twins: dict) -> None:
    base_key = ("ref", False)
    base = twins[base_key].pools()
    for key, tw in twins.items():
        for name, a, b in zip(("device", "host", "disk"), base, tw.pools()):
            np.testing.assert_array_equal(
                b, a, err_msg=f"{name} pool of {key} diverged from {base_key}")


def _park_to_disk(tw, rid, tokens, base):
    """alloc on device, fill with recognizable bytes, park, retire the
    whole parked set to disk."""
    assert tw.kv.alloc(rid, tokens) is not None
    tw.fill_device(rid, base)
    assert tw.kv.park(rid) is not None
    tw.kv.demote_to_disk(rid, len(tw.kv.host_pages_of(rid)))


def _first(pool, frames) -> list[float]:
    return sorted(float(pool[f][0]) / _SCALE[0] for f in frames)


# ---------------------------------------------------------------------------
# hazard scenarios on twins (tests/test_data_plane.py, op for op)
# ---------------------------------------------------------------------------


def _resume_chains_through_one_transit_frame(tw):
    """disk2h -> h2d -> disk2h through ONE host transit frame: the queued
    promotion must read the frame before the next staging overwrites it."""
    _park_to_disk(tw, 1, 16, base=10)          # 4 disk pages
    if tw.async_mode:
        tw.plane.drain()
    assert tw.kv.alloc(2, 12) is not None
    tw.fill_device(2, base=50)
    assert tw.kv.park(2) is not None
    if tw.async_mode:
        tw.plane.drain()                       # iteration boundary
    assert tw.kv.host.free_pages == 1
    assert tw.kv.resume(1) is not None
    assert _first(tw.pools()[0], tw.kv.device_pages_of(1)) == \
        [10.0, 11.0, 12.0, 13.0]


def _park_overlaps_same_pass_demotion(tw):
    """park(1)'s d2h legs, the demotion of those frames to disk and park(2)
    reusing the freed host frames, all in one pass."""
    assert tw.kv.alloc(1, 8) is not None       # 2 device pages
    tw.fill_device(1, base=20)
    assert tw.kv.alloc(2, 8) is not None
    tw.fill_device(2, base=70)
    assert tw.kv.park(1) is not None
    tw.kv.demote_to_disk(1, 2)
    assert tw.kv.park(2) is not None
    _, host, disk = tw.pools()
    assert _first(disk, [r.page for r in tw.kv._disk_refs_of(1)]) == \
        [20.0, 21.0]
    assert _first(host, tw.kv.host_pages_of(2)) == [70.0, 71.0]


def _prefetch_races_its_own_resume(tw):
    """A staged prefetch's disk2h writes and the resume's h2d promotions of
    the same host frames, back to back in one pass (RAW)."""
    _park_to_disk(tw, 1, 16, base=30)
    assert tw.kv.prefetch_from_disk(1, tw.kv.host.free_pages) == 4
    assert tw.kv.resume(1) is not None
    assert _first(tw.pools()[0], tw.kv.device_pages_of(1)) == \
        [30.0, 31.0, 32.0, 33.0]


def _prefetch_only_uses_free_host_frames(tw):
    """Prefetch stops at host capacity, never evicts, and charges the
    pending NVMe counters like any staging."""
    _park_to_disk(tw, 1, 16, base=10)
    tw.plane.drain()
    assert tw.kv.alloc(2, 8) is not None
    tw.fill_device(2, base=90)
    assert tw.kv.park(2) is not None            # 2 host frames taken
    before = tw.kv.pending_disk_in_pages
    assert tw.kv.prefetch_from_disk(1, 99) == 2
    assert tw.kv.host.free_pages == 0
    assert tw.kv.pending_disk_in_pages == before + 2
    assert len(tw.kv._disk_refs_of(1)) == 2
    assert _first(tw.pools()[1], tw.kv.host_pages_of(1)) == [10.0, 11.0]


SCENARIOS = {
    "resume_transit_frame_waw": (_resume_chains_through_one_transit_frame,
                                 dict(dev_pages=4, host_pages=4,
                                      disk_pages=8)),
    "park_overlaps_demotion": (_park_overlaps_same_pass_demotion,
                               dict(dev_pages=4, host_pages=2, disk_pages=8)),
    "prefetch_races_resume": (_prefetch_races_its_own_resume,
                              dict(dev_pages=4, host_pages=4, disk_pages=8)),
    "prefetch_free_frames_only": (_prefetch_only_uses_free_host_frames,
                                  dict(dev_pages=4, host_pages=4,
                                       disk_pages=8)),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_hazard_scenario_pools_match_reference(scenario):
    run, kw = SCENARIOS[scenario]
    twins = {}
    for fw, mode in TWINS:
        tw = _Twin(fw, async_mode=mode, **kw)
        run(tw)
        twins[(fw, mode)] = tw
    _assert_pools_equal(twins)


def test_direct_resume_bypasses_host_and_pcie_charge():
    """With direct_copy wired, resume stages disk pages straight onto free
    device frames: the NVMe read is still charged, the host-transit PCIe
    promotion disappears, and the bytes land as on the host-bounce path."""
    for direct in (False, True):
        twins = {}
        for fw, mode in TWINS:
            tw = _Twin(fw, dev_pages=4, host_pages=4, disk_pages=8,
                       async_mode=mode, direct=direct)
            _park_to_disk(tw, 1, 16, base=40)
            moves = tw.kv.resume(1)
            assert moves is not None
            assert tw.kv.disk_in_pages_total == 4
            assert tw.kv.pending_disk_in_pages == 4
            host_src = sum(1 for m in moves if m.src_tier == "host")
            assert host_src == (0 if direct else 4)
            assert tw.kv.disk_direct_pages_total == (4 if direct else 0)
            if direct:
                assert tw.kv.host.used_pages == 0
            assert _first(tw.pools()[0], tw.kv.device_pages_of(1)) == \
                [40.0, 41.0, 42.0, 43.0]
            twins[(fw, mode)] = tw
        _assert_pools_equal(twins)


@pytest.mark.parametrize("fw", FRAMEWORKS)
def test_direct_path_shortfall_drops_transit_frame(fw):
    """The host-bounce path needs one transit frame to stage a resume; the
    direct path needs none when the device can absorb the disk set."""
    for direct, want in ((False, 1), (True, 0)):
        tw = _Twin(fw, dev_pages=4, host_pages=4, disk_pages=8,
                   async_mode=False, direct=direct)
        _park_to_disk(tw, 1, 16, base=40)
        assert tw.kv.alloc(2, 12) is not None
        tw.fill_device(2, base=60)
        assert tw.kv.park(2) is not None
        assert tw.kv.alloc(3, 4) is not None
        assert tw.kv.park(3) is not None
        assert tw.kv.host.free_pages == 0
        assert tw.kv.resume_staging_shortfall(1) == want


# ---------------------------------------------------------------------------
# the plane alone
# ---------------------------------------------------------------------------


def _bare_plane(fw, host, disk, dev, **kw):
    """A plane over given pools (numpy/JAX for the reference, torch for the
    port); returns (plane, box holding the device pool)."""
    if fw == "ref":
        box = [jnp.asarray(dev)]
        mod = ref_dp
    else:
        box = [torch.from_numpy(np.array(dev)).to(torch.bfloat16)]
        host = torch.from_numpy(host).to(torch.bfloat16)
        disk = torch.from_numpy(disk).to(torch.bfloat16)
        mod = port_dp
    plane = mod.CopyStageEngine(host_pool=host, disk_pool=disk,
                                get_pool=lambda: box[0],
                                set_pool=lambda p: box.__setitem__(0, p),
                                **kw)
    return plane, box


def _np(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32)).copy()


@pytest.mark.parametrize("fw", FRAMEWORKS)
def test_background_retirement_vs_host_write_guard(fw):
    """A host-pool write must wait for an in-flight background retirement
    that still reads the frame: the disk page keeps the old bytes."""
    plane, _ = _bare_plane(fw, np.zeros((4, _W), np.float32),
                           np.zeros((4, _W), np.float32),
                           np.zeros((2, _W), np.float32), async_mode=True)
    plane.host_pool[1] = 7.0
    plane.stage("h2disk", 1, 2)
    plane.drain()                       # submits to the background worker
    plane.guard_host_writes([1])        # engine about to overwrite frame 1
    plane.host_pool[1] = 99.0
    plane.sync()
    assert float(plane.disk_pool[2][0]) == 7.0


def test_duplicate_dst_flushes_batch():
    """Two queued ops writing the same dst frame never share a batch: last
    write wins, exactly as in sync mode, in both packages."""
    out = {}
    for fw, mode in TWINS:
        host = _rows(np.arange(4)) + np.arange(_W, dtype=np.float32)[None]
        plane, box = _bare_plane(fw, host, np.zeros((4, _W), np.float32),
                                 np.zeros((2, _W), np.float32),
                                 async_mode=mode, background=False)
        plane.stage("h2disk", 0, 3)
        plane.stage("h2disk", 1, 3)     # WAW on disk frame 3
        plane.stage("h2d", 2, 0)
        plane.stage("h2d", 3, 0)        # WAW on device frame 0
        plane.sync()
        out[(fw, mode)] = (_np(box[0]), _np(plane.disk_pool), host)
    for (dev, disk, host) in out.values():
        np.testing.assert_array_equal(dev, out[("ref", False)][0])
        np.testing.assert_array_equal(disk, out[("ref", False)][1])
        np.testing.assert_array_equal(disk[3], host[1])
        np.testing.assert_array_equal(dev[0], host[3])


@pytest.mark.parametrize("fw", FRAMEWORKS)
def test_iteration_counters_conserve(fw):
    """issued == completed + inflight at every point; per-iteration deltas
    sum to the totals (the engine-side contract behind audit check I10)."""
    plane, _ = _bare_plane(fw, np.ones((4, _W), np.float32),
                           np.zeros((4, _W), np.float32),
                           np.zeros((2, _W), np.float32),
                           async_mode=True, background=False)
    plane.stage("h2disk", 0, 0)
    plane.stage("h2disk", 1, 1)
    assert plane.inflight_pages() == 2
    assert plane.take_iteration_counters() == (2, 0)
    plane.drain()
    assert plane.inflight_pages() == 0
    assert plane.take_iteration_counters() == (0, 2)
    assert plane.issued_pages_total == plane.completed_pages_total == 2


@pytest.mark.parametrize("async_mode", [False, True])
def test_every_kind_batches_like_the_reference(async_mode):
    """One op of each kind, then a run of each kind, through both planes:
    the port's batched index copies leave the pools bitwise equal to the
    reference's per-page loops."""
    ops = [("d2h", 0, 1), ("h2d", 2, 3), ("h2disk", 1, 0), ("disk2h", 2, 3),
           ("disk2d", 3, 1), ("d2disk", 2, 5),
           ("h2disk", 0, 1), ("h2disk", 3, 2), ("h2disk", 0, 4),
           ("disk2h", 5, 0), ("disk2h", 1, 2), ("d2h", 3, 1), ("d2h", 0, 2),
           ("disk2d", 4, 0), ("disk2d", 2, 2), ("h2d", 1, 3), ("h2d", 3, 1),
           ("d2disk", 1, 6), ("d2disk", 0, 7)]
    got = {}
    for fw in FRAMEWORKS:
        plane, box = _bare_plane(
            fw, _rows(np.arange(4) + 10), _rows(np.arange(8) + 50),
            _rows(np.arange(4) + 100), async_mode=async_mode)
        for i, (kind, s, d) in enumerate(ops):
            plane.stage(kind, s, d)
            if i == 5:
                plane.drain()           # a boundary between the two passes
        plane.sync()
        got[fw] = (_np(box[0]), _np(plane.host_pool), _np(plane.disk_pool))
        assert plane.issued_pages_total == plane.completed_pages_total \
            == len(ops)
    for a, b in zip(got["ref"], got["port"]):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("async_mode", [False, True])
def test_peer_export_import_round_trip(async_mode):
    """peer_export gathers host frames (after draining queued writes to
    them); peer_import scatters the payload into other frames. Both planes
    give the same payload and pools."""
    got = {}
    for fw in FRAMEWORKS:
        plane, box = _bare_plane(fw, _rows(np.arange(6) + 1),
                                 np.zeros((4, _W), np.float32),
                                 _rows(np.arange(2) + 30),
                                 async_mode=async_mode)
        plane.stage("d2h", 1, 2)        # queued write to an exported frame
        srcs, dsts = [2, 0, 3], [5, 4, 1]
        if fw == "ref":
            payload = np.zeros((3, _W), np.float32)
        else:
            payload = torch.zeros((3, _W), dtype=torch.bfloat16)
        plane.peer_export(srcs, payload)
        plane.peer_import(payload, dsts)
        plane.sync()
        got[fw] = (_np(payload), _np(plane.host_pool))
        host = got[fw][1]
        np.testing.assert_array_equal(got[fw][0][0], _rows([31])[0])
        np.testing.assert_array_equal(host[dsts], got[fw][0])
    for a, b in zip(got["ref"], got["port"]):
        np.testing.assert_array_equal(b, a)


def test_host_write_guard_waits_for_a_blocked_worker():
    """With the background worker held inside a retirement of host frame 1,
    a guarded write to frame 1 waits until the worker finishes, while a
    guard on an unrelated frame returns at once; the disk page keeps the
    pre-write bytes."""
    plane, _ = _bare_plane("port", _rows(np.arange(4) + 3),
                           np.zeros((4, _W), np.float32),
                           np.zeros((2, _W), np.float32), async_mode=True)
    release, entered = threading.Event(), threading.Event()
    copy = plane._host_to_disk

    def held(srcs, dsts):
        entered.set()
        assert release.wait(10.0)
        copy(srcs, dsts)

    plane._host_to_disk = held
    plane.stage("h2disk", 1, 2)
    plane.drain()                       # submits to the background worker
    assert entered.wait(10.0)
    plane.guard_host_writes([0, 3])     # no conflict: returns at once
    wrote = threading.Event()

    def writer():
        plane.guard_host_writes([1])
        plane.host_pool[1] = 99.0
        wrote.set()

    t = threading.Thread(target=writer)
    t.start()
    time.sleep(0.2)
    assert not wrote.is_set(), "the host write did not wait for the worker"
    assert plane.inflight_pages() == 1
    release.set()
    t.join(10.0)
    assert wrote.is_set()
    plane.sync()
    assert float(plane.disk_pool[2][0]) == 4.0 * _SCALE[0]
    assert float(plane.host_pool[1][0]) == 99.0
    assert plane.inflight_pages() == 0 and plane.background_copy_s > 0


@pytest.mark.parametrize("backing", ["ram", "file"])
def test_worker_copy_routine_is_bitwise(backing, tmp_path):
    """The worker's host->disk routine (one ``numpy.copyto`` of each page's
    bits) writes exactly the bits the index-copy routine it replaced
    writes: random bf16 patterns including NaN, infinities and negative
    zero, into a RAM pool and into a file-backed one (the engine's
    ``torch.from_file`` mapping)."""
    rng = np.random.default_rng(5)
    shape = (6, 16, 3, 2, 8)
    bits = rng.integers(0, 2**16, (6, int(np.prod(shape[1:]))),
                        dtype=np.uint16)
    bits[0, :4] = [0x7FC0, 0x7F80, 0xFF80, 0x8000]     # NaN, +inf, -inf, -0
    host = torch.from_numpy(bits.view(np.int16).reshape(shape)).view(
        torch.bfloat16)
    if backing == "file":
        path = tmp_path / "disk.bin"
        n = 5 * int(np.prod(shape[1:]))
        with open(path, "wb") as f:
            f.truncate(2 * n)
        disk = torch.from_file(str(path), shared=True, size=n,
                               dtype=torch.bfloat16).view(5, *shape[1:])
    else:
        disk = torch.zeros((5, *shape[1:]), dtype=torch.bfloat16)
    want = disk.clone()
    srcs, dsts = [0, 4, 2], [3, 0, 4]
    want.index_copy_(0, torch.as_tensor(dsts), host.index_select(
        0, torch.as_tensor(srcs)))
    plane = port_dp.CopyStageEngine(host_pool=host, disk_pool=disk,
                                    get_pool=lambda: None,
                                    set_pool=lambda p: None)
    plane._host_to_disk(srcs, dsts)
    assert torch.equal(disk.view(torch.int16), want.view(torch.int16))
    if backing == "file":
        raw = np.fromfile(path, dtype=np.uint16).reshape(5, -1)
        for s, d in zip(srcs, dsts):
            np.testing.assert_array_equal(raw[d], bits[s])


@pytest.mark.parametrize("async_mode", [False, True])
def test_worker_starts_with_an_async_plane_and_empty_drains_cost_nothing(
        async_mode):
    """An async plane starts its worker when it is built, so no drain pays
    for the start; a drain with nothing queued and nothing in flight adds
    no blocking time. A sync plane starts no thread."""
    plane, _ = _bare_plane("port", _rows(np.arange(4) + 3),
                           np.zeros((4, _W), np.float32),
                           np.zeros((2, _W), np.float32),
                           async_mode=async_mode)
    assert (plane._worker is not None) == async_mode
    if async_mode:
        assert plane._worker.is_alive()
    for _ in range(5):
        plane.drain()
    assert plane.blocking_copy_s == 0.0


def test_retirement_a_later_op_touches_runs_inline():
    """A host->disk retirement whose host frame a later op of the same
    drain overwrites (the park's transit-frame reuse) runs inline instead
    of on the worker, which the later op would wait for at once; one that
    no later op touches still goes to the worker. The pools end as the
    reference's plane leaves them, bit for bit."""
    host0 = _rows(np.arange(4) + 3)
    dev0 = _rows(np.arange(2) + 40)
    got = {}
    for fw in FRAMEWORKS:
        plane, box = _bare_plane(fw, host0.copy(),
                                 np.zeros((4, _W), np.float32), dev0.copy(),
                                 async_mode=True)
        submitted = []
        submit = plane._submit_bg
        plane._submit_bg = lambda s, d: submitted.append(s) or submit(s, d)
        plane.stage("h2disk", 1, 0)       # frame 1 is overwritten below
        plane.stage("d2h", 0, 1)
        plane.stage("h2disk", 2, 3)       # nothing later touches frame 2
        plane.drain()
        plane.sync()
        if fw == "port":
            assert submitted == [[2]]
        got[fw] = [_np(plane.host_pool), _np(plane.disk_pool)]
    for a, b in zip(got["ref"], got["port"]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(got["port"][1][0], host0[1])
