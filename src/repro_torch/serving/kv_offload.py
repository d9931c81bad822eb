"""N-tier SLO-aware KV-cache offloading with cross-request dedup.

The paper offloads model *state*; the seed engine only tiered weights — KV
pages never left HBM, so max context/batch stayed HBM-bound however small
the offloading interval got (Fig. 14 saturates). This subsystem extends the
paged KV allocator with an ordered hierarchy of page pools below HBM and,
on top of the page refcounts, LMCache-style cross-request prefix sharing.
The hierarchy is ``DEVICE`` -> ``HOST`` -> ``DISK`` (``TIER_ORDER``):
frames migrate only between adjacent tiers, every tier is a
``PagedKVAllocator`` with the same page geometry, and each inter-tier link
carries a ``LinkSpec`` (bandwidth + latency) so the SLO math can charge the
right channel — host<->device traffic rides the PCIe copy stream the weight
prefetches use, host<->disk traffic rides the NVMe link and must never be
billed to (or hidden from) the TPOT-critical PCIe budget.

  * ``HostKVPool``      — host-side page pool, same page geometry as the
                          device pool, with an optional numpy backing buffer
                          (host memory on every backend; the pinned staging
                          area on a real TPU host).
  * ``DiskKVPool``      — NVMe-tier page pool: buffer-backed by default, or
                          file-backed (``np.memmap``) when a backing path is
                          given. Holds parked/preempted state and aged-out
                          prefix-cache frames; never read by the decode
                          kernel directly — disk pages stage through host.
  * ``TieredKVAllocator`` — per-request block tables spanning the tiers.
                          Pages are ordered oldest-first; the lower tiers
                          hold the *front* (cold prefix) so the decode write
                          path always lands on device frames. Page migration
                          (``swap_out`` / ``swap_in`` / ``demote_to_disk``)
                          rewrites refs and reports (src, dst) frame pairs
                          for the data plane
                          (``kernels.ops.copy_pages_to_host/from_host``);
                          host<->disk moves additionally fire the
                          synchronous ``disk_copy`` hook so the bytes are
                          saved before a vacated frame can be reused.
  * ``PrefixIndex``     — content-addressed map from (page position, rolling
                          hash over the token ids, model-config scope) to the
                          physical frame holding that page's KV. A request
                          whose prompt shares a prefix with a live or
                          host-parked request maps its block-table entries
                          onto the same frames (refcount += 1) instead of
                          recomputing + re-storing them. With
                          ``host_prefix_cache_pages > 0`` indexed host
                          frames outlive their last owner under a synthetic
                          cache owner (LRU-bounded, reclaimed on demand), so
                          a re-submitted prefix still dedups.
  * ``park`` / ``resume`` — preempt-to-host: one whole-request migration of
                          a victim's device-resident KV to the host tier
                          (frame-wise and dedup-aware — frames an active
                          sibling still references stay put), and the
                          promotion back when the scheduler un-parks it.
  * ``SwapScheduler``   — per-iteration planner: promotes host pages into
                          freed device frames, streams the still-host-resident
                          KV of active requests in for attention, and charges
                          every byte to the same link budget as weight
                          prefetch (``interval.iter_time_with_interval_kv``,
                          ``coordinator.InstanceState.kv_bytes_per_iter``).

Sharing + copy-on-write protocol (refcounts live in ``PagedKVAllocator``):

  * Only pages covering the *prompt* are content-indexed: full pages keyed by
    (index, chain digest), the trailing partial page additionally by its
    token count. Tail (decode) pages are always private.
  * A sharer that will decode (total tokens > prompt length) pre-claims a
    private COW *reserve* frame at admission time, so the copy-on-write at
    its first decode write can never fail or race a later admission for a
    frame. Reserves are PER PAGE: the admission-time reserve covers the
    partial prompt page, and forked beams (``fork`` + ``add_reserve``)
    claim one reserve per shared page each sharer may write, so N live
    writers of one shared tail diverge safely. ``prepare_write`` swaps the
    page's reserve into the block table and returns the data-plane copy;
    the shared frame is left untouched for its siblings.
  * The request that *registered* a page (its origin) may keep appending in
    place even while the page is shared: a sharer's context never extends
    past the `k` prompt tokens the index key describes until the sharer
    itself writes — and its first write moves it onto its reserve first.
    Positions >= k therefore stay invisible to every sibling (attention
    masks by context length), so the in-place append is safe.
  * Migration is frame-wise: demoting/promoting/remapping a shared frame
    moves it ONCE (one ``Migration``, one physical copy, one charge against
    the link budget) and rewrites the refs of every owner. The frame is
    released — and its index entry evicted — only when the last reference
    drops.

Latency semantics (kept SLO-exact, property-tested against the event
simulator): swap-in gates layer-0 compute; write-back is issued next and
queues the weight prefetches behind it; weight transfers then follow the
Fig. 7 group-start schedule. No byte is double-counted: streamed pages do
not change residency, promoted/demoted pages move exactly once, and a page
shared by several active requests streams once per iteration, not once per
owner.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.serving.kv_cache import (PageConfig, PagedKVAllocator,
                                    padded_block_table)

DEVICE = "device"
HOST = "host"
DISK = "disk"
PEER = "peer"

# Role-typed tier registry: every tier declares what it is FOR, not where
# it sits in a fixed ladder. Local roles form the ordered spill hierarchy
# (compute -> staging -> spill: frames migrate only between adjacent local
# tiers — device <-> host over PCIe, host <-> disk over NVMe). The PEER
# tier's role is different in kind: its far side is another instance's
# host pool, reached over its own ``LinkSpec`` — pages never "migrate
# adjacent" into it, they are exported/imported whole-request as
# ``MigrationTicket`` payloads, and its traffic is charged to the peer
# link's own latency term (``interval.peer_transfer_seconds``), never to
# PCIe or NVMe.
ROLE_COMPUTE = "compute"   # the tier the decode kernel indexes (HBM)
ROLE_STAGING = "staging"   # pinned-host pool below HBM (PCIe)
ROLE_SPILL = "spill"       # cold storage at the ladder's end (NVMe)
ROLE_PEER = "peer"         # a remote instance's staging tier (peer link)

TIER_ROLES: dict[str, str] = {
    DEVICE: ROLE_COMPUTE,
    HOST: ROLE_STAGING,
    DISK: ROLE_SPILL,
    PEER: ROLE_PEER,
}


def tier_role(tier: str) -> str:
    return TIER_ROLES[tier]


def local_tiers() -> tuple[str, ...]:
    """The ordered local ladder (tiers that own frames in THIS instance's
    pools), derived from the role registry. Adding a local tier means
    registering its role here — every migration / invariant / reclaim path
    below iterates this instead of naming pools."""
    return tuple(t for t, role in TIER_ROLES.items() if role != ROLE_PEER)


# Backwards-compatible ladder view: the fixed (DEVICE, HOST, DISK) tuple is
# now DERIVED from the role registry instead of hand-ordered.
TIER_ORDER = local_tiers()


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One inter-tier link of the hierarchy: sustained bandwidth plus a
    fixed per-batch issue latency. ``bw_bytes_s == 0`` means "modeled
    elsewhere" — the device<->host link's bandwidth is implied by the
    measured ``LayerTimes`` the SLO algebra already carries."""
    bw_bytes_s: float = 0.0
    latency_s: float = 0.0

# Synthetic owner of keep-alive prefix-cache frames: host pages whose last
# real owner freed but whose content stays indexed (bounded LRU), so a
# re-submitted shared prefix still dedups. Real request ids are >= 0.
CACHE_RID = -1


@dataclasses.dataclass(frozen=True)
class PageRef:
    tier: str
    page: int


class HostKVPool(PagedKVAllocator):
    """Host-memory page pool mirroring the device pool geometry."""

    def make_pool_buffer(self, page_shape: tuple, dtype=np.float32
                         ) -> np.ndarray:
        """Backing store for real page contents (numpy = host memory)."""
        return np.zeros((self.total_pages, *page_shape), dtype)


class DiskKVPool(HostKVPool):
    """NVMe-tier page pool. Accounting is identical to the host pool; the
    backing buffer is a plain numpy array (a RAM stand-in for NVMe on dev
    boxes) or an ``np.memmap`` over ``backing_path`` (a real file — what a
    production host points at its NVMe mount)."""

    def __init__(self, total_bytes: int, pcfg: PageConfig,
                 backing_path: str | None = None):
        super().__init__(total_bytes, pcfg)
        self.backing_path = backing_path

    def make_pool_buffer(self, page_shape: tuple, dtype=np.float32
                         ) -> np.ndarray:
        if self.backing_path is None:
            return super().make_pool_buffer(page_shape, dtype)
        return np.memmap(self.backing_path, dtype=dtype, mode="w+",
                         shape=(self.total_pages, *page_shape))


@dataclasses.dataclass
class Migration:
    """One page move; src/dst are frame ids in the respective pools."""
    rid: int
    src_tier: str
    src_page: int
    dst_page: int
    dst_tier: str = HOST


@dataclasses.dataclass
class MigrationTicket:
    """Serialized form of one request's KV crossing an instance boundary —
    the ordinary transport of the PEER tier, not just the emergency one:
    the host-resident page payload in token order plus the decode-cursor
    snapshot (``next_token`` / ``resume_pos``) that makes the resume
    bitwise-exact on the destination. The payload is a COPY — the source
    frees its frames after exporting, the destination claims fresh private
    host frames and writes the payload in.

    Two kinds ride the same ticket shape, with different clock charging:

      * ``"evacuation"`` — cross-instance preemption of a parked request
        under overload (PR 9). The fleet charges the transfer seconds
        synchronously to BOTH instances' clocks (``mig_wait_s``).
      * ``"handoff"`` — live post-prefill KV handoff in a disaggregated
        prefill/decode fleet: the prefill side exports through the async
        copy-stage engine (transfer overlaps its next prefill) and each
        side drains the ticket's pages into its next iteration's
        ``peer_s`` channel term (``interval.peer_transfer_seconds``), so
        the decode scheduler certifies TPOT-plus-transfer the same way it
        certifies NVMe traffic.
    """
    rid: int
    n_pages: int
    page_bytes: int
    payload: object                  # [n_pages, *page_shape] array or None
    next_token: int
    resume_pos: int
    kind: str = "evacuation"         # "evacuation" | "handoff"

    @property
    def bytes_total(self) -> int:
        return self.n_pages * self.page_bytes


@dataclasses.dataclass
class CowMove:
    """Copy-on-write: ``rid`` leaves the shared ``src`` frame for its private
    ``dst`` frame; the data plane must copy the page bytes src -> dst before
    the next write lands."""
    rid: int
    src: PageRef
    dst: PageRef


@dataclasses.dataclass
class ResizeResult:
    """Data-plane instructions for a device-pool resize.

    ``demotions`` are device->host moves (src_page is the OLD device frame,
    dst_page the host slot); ``remap`` lists (old_frame, new_frame) pairs for
    pages that stay on device but land in a different frame of the rebuilt
    pool. A caller holding a real page buffer must copy demotions out first
    (old frames are still intact) and then permute the surviving frames.
    Shared frames appear exactly once in either list.
    """
    demotions: list[Migration]
    remap: list[tuple[int, int]]

    @property
    def num_demoted(self) -> int:
        return len(self.demotions)


# ---------------------------------------------------------------------------
# Content-addressed prefix index
# ---------------------------------------------------------------------------


def prefix_page_keys(scope: str, tokens, page_size: int
                     ) -> list[tuple[int, str, int]]:
    """Content keys for every page covering ``tokens``: a rolling hash
    chained page-by-page (so a key commits to the WHOLE prefix up to and
    including its page, not just its own tokens), scoped by ``scope`` (model
    config + page geometry — two models never share frames). Returns
    (page_index, digest, tokens_in_page) per page; the last entry may be
    partial."""
    keys: list[tuple[int, str, int]] = []
    h = hashlib.sha1(scope.encode()).digest()
    toks = np.asarray(tokens, np.int64)
    n = int(toks.shape[0])
    for start in range(0, n, page_size):
        chunk = toks[start:start + page_size]
        h = hashlib.sha1(h + chunk.tobytes()).digest()
        keys.append((start // page_size, h.hex(), int(chunk.shape[0])))
    return keys


class PrefixIndex:
    """key <-> physical frame map, kept in lock-step with page migration:
    entries follow their frame across tiers and die with the frame's last
    reference."""

    def __init__(self):
        self._by_key: dict[tuple, PageRef] = {}
        self._by_frame: dict[PageRef, tuple] = {}

    def get(self, key: tuple) -> PageRef | None:
        return self._by_key.get(key)

    def put(self, key: tuple, ref: PageRef) -> None:
        assert key not in self._by_key and ref not in self._by_frame
        self._by_key[key] = ref
        self._by_frame[ref] = key

    def move(self, old: PageRef, new: PageRef) -> None:
        """The frame holding an indexed page migrated (swap/resize)."""
        key = self._by_frame.pop(old, None)
        if key is not None:
            self._by_key[key] = new
            self._by_frame[new] = key

    def remap_frames(self, tier: str, remap: list[tuple[int, int]]) -> None:
        """Apply a whole-pool frame permutation (device resize). Two-phase:
        old and new frame ids overlap, so pairwise ``move`` calls would
        alias — a moved entry could clobber one not yet moved."""
        moved: list[tuple[tuple, PageRef]] = []
        for old, new in remap:
            key = self._by_frame.pop(PageRef(tier, old), None)
            if key is not None:
                moved.append((key, PageRef(tier, new)))
        for key, ref in moved:
            self._by_key[key] = ref
            self._by_frame[ref] = key

    def evict(self, ref: PageRef) -> None:
        """The frame died (last reference dropped): forget its content."""
        key = self._by_frame.pop(ref, None)
        if key is not None:
            del self._by_key[key]

    def has_frame(self, ref: PageRef) -> bool:
        return ref in self._by_frame

    def __len__(self) -> int:
        return len(self._by_key)


@dataclasses.dataclass
class DedupPreview:
    """What ``alloc`` would share for a given prompt (admission planning).
    Carries the computed rolling-hash ``keys`` so a caller that previews and
    then allocates (``alloc(..., preview=)``) hashes the prompt once, not
    three times per admission attempt."""
    hit_refs: list[PageRef]
    hit_indices: list[int]
    need_reserve: bool
    keys: list[tuple[int, str, int]] = dataclasses.field(
        default_factory=list)

    @property
    def n_hits(self) -> int:
        return len(self.hit_refs)

    def host_hit_pages(self) -> set[int]:
        return {r.page for r in self.hit_refs if r.tier == HOST}

    def disk_hit_pages(self) -> set[int]:
        """Disk-resident (pure prefix-cache) frames the allocation would
        revive: each needs a host frame and one NVMe read to stage."""
        return {r.page for r in self.hit_refs if r.tier == DISK}


class TieredKVAllocator:
    """Paged KV accounting across device HBM + pinned host memory.

    The device pool is the one the paged decode kernel indexes through block
    tables; the host pool absorbs the cold prefix of requests whose KV does
    not fit on device. Per-request refs are kept in token order. With
    ``enable_dedup`` the prompt pages are content-addressed through the
    ``PrefixIndex`` and shared across requests (see module docstring for the
    COW protocol).
    """

    def __init__(self, device_bytes: float, host_bytes: float,
                 pcfg: PageConfig, scope: str = "",
                 enable_dedup: bool = False,
                 host_prefix_cache_pages: int = 0,
                 disk_bytes: float = 0.0,
                 disk_link: LinkSpec = LinkSpec(),
                 disk_backing_path: str | None = None,
                 peer_link: LinkSpec = LinkSpec()):
        self.pcfg = pcfg
        self.device = PagedKVAllocator(max(int(device_bytes), 0), pcfg)
        self.host = HostKVPool(max(int(host_bytes), 0), pcfg)
        self.disk = DiskKVPool(max(int(disk_bytes), 0), pcfg,
                               backing_path=disk_backing_path)
        # local-ladder view (role registry order): every tier-generic path
        # below goes through this map instead of naming a pool. The PEER
        # tier deliberately has no entry — its frames live in another
        # instance's host pool, reached through tickets, never indexed here.
        self.pools: dict[str, PagedKVAllocator] = {
            DEVICE: self.device, HOST: self.host, DISK: self.disk}
        assert set(self.pools) == set(local_tiers())
        self.disk_link = disk_link
        # the PEER tier's link: bandwidth/latency to another instance's
        # host pool (NIC / NVLink). Handoff traffic performed since the
        # swap scheduler last planned is charged to this link's own
        # latency term (interval.peer_transfer_seconds), never to PCIe or
        # NVMe. The emergency evacuation path (fleet cross-instance
        # preemption) does NOT ride these counters — it charges transfer
        # seconds synchronously to both clocks (mig_wait_s).
        self.peer_link = peer_link
        self.pending_peer_in_pages = 0    # handoff imports (peer -> host)
        self.pending_peer_out_pages = 0   # handoff exports (host -> peer)
        self.peer_in_pages_total = 0
        self.peer_out_pages_total = 0
        # data-plane hook for host<->disk moves: called as
        # disk_copy(src_tier, src_page, dst_tier, dst_page) the moment the
        # accounting move lands, while the vacated frame's bytes are still
        # intact. The engine wires this into its copy-stage engine
        # (serving/data_plane.py), which either executes the op immediately
        # (sync mode) or queues it in planning order and drains at the next
        # iteration boundary — either way execution order is a linear
        # extension of planning order, which is what the hazard notes below
        # rely on. Pure accounting users leave it None.
        self.disk_copy = None
        # hook for ``resume``'s host->device promotion legs, called as
        # promote_copy(src_host_page, dst_device_frame). Required whenever
        # disk_copy is wired: resume staging chains several disk pages
        # through one host transit frame, so an apply-time promotion copy
        # would read a frame the NEXT staging already overwrote — the
        # promotion must read its bytes in planning order.
        self.promote_copy = None
        # hook for ``park``'s device->host legs, called as
        # park_copy(src_device_frame, dst_host_frame). Also required with a
        # disk tier: a park and a demotion of the parked pages can land in
        # ONE planning pass, so a deferred park copy would let the NVMe
        # hook read a host frame whose bytes had not arrived yet.
        self.park_copy = None
        # hook for the direct disk->device staging path that bypasses the
        # host bounce buffer when a device frame is free, called as
        # direct_copy(src_tier, src_page, dst_tier, dst_page). When wired,
        # ``resume`` stages pass-through pages straight onto the device:
        # the NVMe read is still charged, but the host-transit PCIe
        # promotion charge disappears (the scheduler only notes HOST-src
        # promotions). Leave None to force every page through the host.
        self.direct_copy = None
        # NVMe traffic performed since the swap scheduler last planned:
        # charged to the disk link's own latency term, never to PCIe
        self.pending_disk_in_pages = 0    # disk -> host staging reads
        self.pending_disk_out_pages = 0   # host -> disk demotion writes
        self.disk_in_pages_total = 0
        self.disk_out_pages_total = 0
        self.disk_direct_pages_total = 0  # of disk_in: direct disk->device
        self._refs: dict[int, list[PageRef]] = {}
        self.scope = scope
        self.enable_dedup = enable_dedup
        self.index = PrefixIndex()
        self._dedup_hits: dict[int, list[int]] = {}   # rid -> hit page idxs
        self._fresh_host: dict[int, int] = {}         # rid -> fresh host pages
        # per-page COW reserves: rid -> {page_idx -> private spare frame}.
        # The admission-time reserve covers the partial prompt page; forked
        # beams add one per shared page they may write (``add_reserve``).
        self._reserves: dict[int, dict[int, PageRef]] = {}
        self.dedup_pages_reused = 0                   # cumulative hit count
        self.cow_copies = 0                           # cumulative COW moves
        # prefix-cache keep-alive: up to this many host frames survive their
        # last owner under CACHE_RID (LRU; 0 disables). A cached frame keeps
        # its index entry, so a later identical prefix still dedups; cache
        # frames are reclaimed on demand when the host pool runs dry.
        self.host_prefix_cache_pages = host_prefix_cache_pages
        self._cache_lru: dict[int, None] = {}  # host frame -> None (ordered)
        # cache frames that retired to disk under host pressure (all pure —
        # refcount 1 under CACHE_RID: a dedup hit revives them host-ward
        # before any request maps them)
        self._disk_cache: dict[int, None] = {}
        self.cache_hits = 0                    # dedup hits on cached frames

    # ---- queries -------------------------------------------------------------
    @property
    def page_bytes(self) -> int:
        return self.device.page_bytes

    def pool_of(self, tier: str) -> PagedKVAllocator:
        return self.pools[tier]

    def refs(self, rid: int) -> list[PageRef]:
        return list(self._refs.get(rid, []))

    def tier_pages_of(self, rid: int, tier: str) -> list[int]:
        return [r.page for r in self._refs.get(rid, []) if r.tier == tier]

    def device_pages_of(self, rid: int) -> list[int]:
        return self.tier_pages_of(rid, DEVICE)

    def host_pages_of(self, rid: int) -> list[int]:
        return self.tier_pages_of(rid, HOST)

    def disk_pages_of(self, rid: int) -> list[int]:
        return self.tier_pages_of(rid, DISK)

    def host_bytes_of(self, rid: int) -> int:
        return len(self.host_pages_of(rid)) * self.page_bytes

    def occupancy(self) -> dict:
        """Per-tier frame occupancy snapshot for the telemetry plane:
        used/total pages per pool plus the cache frames parked in each
        (cache frames are counted inside used_pages — they hold live
        refcounts under CACHE_RID)."""
        occ = {tier: {"used_pages": pool.used_pages,
                      "total_pages": pool.total_pages,
                      "cache_pages": 0}
               for tier, pool in self.pools.items()}
        occ[HOST]["cache_pages"] = len(self._cache_lru)
        occ[DISK]["cache_pages"] = len(self._disk_cache)
        return occ

    def spill_writeback_bytes_of(self, rid: int) -> int:
        """Host bytes prefill must actually write back for ``rid``: freshly
        claimed host frames only — dedup'd host pages are already resident,
        so they cost stream traffic but no spill write-back."""
        return self._fresh_host.get(rid, 0) * self.page_bytes

    def dedup_hit_pages(self, rid: int) -> list[int]:
        """Page indices of ``rid`` that were mapped onto existing frames at
        alloc time (prefill must NOT scatter KV into these)."""
        return list(self._dedup_hits.get(rid, []))

    def reserve_of(self, rid: int) -> PageRef | None:
        """The single reserve of an unforked sharer (compat view): the
        first per-page reserve held, or None."""
        rmap = self._reserves.get(rid)
        return next(iter(rmap.values())) if rmap else None

    def reserves_of(self, rid: int) -> dict[int, PageRef]:
        """page_idx -> private COW reserve frame held by ``rid``."""
        return dict(self._reserves.get(rid, {}))

    def n_reserve_frames(self) -> int:
        """Total claimed COW reserve frames across all requests."""
        return sum(len(m) for m in self._reserves.values())

    def refcount(self, ref: PageRef) -> int:
        return self.pool_of(ref.tier).refcount(ref.page)

    def max_allocatable_tokens(self, include_host: bool = True) -> int:
        """Fig. 14's metric, lifted by the host tier."""
        pages = self.device.free_pages
        if include_host:
            pages += self.host.free_pages
        return pages * self.pcfg.page_size

    # ---- dedup probing -------------------------------------------------------
    def _prompt_keys(self, prompt) -> list[tuple[int, str, int]]:
        return prefix_page_keys(self.scope, prompt, self.pcfg.page_size)

    def dedup_preview(self, prompt, tokens: int) -> DedupPreview:
        """Which prompt pages ``alloc(rid, tokens, prompt=...)`` would share.
        Hits are the contiguous leading run of index matches (prefix
        semantics); ``need_reserve`` is True when the trailing partial prompt
        page is a hit AND the request will decode into it (tokens >
        prompt length), which pre-claims one private frame for the COW.
        Disk-resident entries count as hits only while they are pure cache
        frames (revivable by staging one NVMe read through a host frame);
        a disk frame a parked request still owns ends the hit run — staging
        it would drag the whole parked set's sharing along."""
        if not self.enable_dedup or prompt is None or len(prompt) == 0:
            return DedupPreview([], [], False)
        keys = self._prompt_keys(prompt)
        hits: list[PageRef] = []
        idxs: list[int] = []
        need_reserve = False
        for (idx, digest, ntok) in keys:
            ref = self.index.get((idx, digest, ntok))
            if ref is None:
                break
            if ref.tier == DISK and ref.page not in self._disk_cache:
                break
            hits.append(ref)
            idxs.append(idx)
            if ntok < self.pcfg.page_size and tokens > len(prompt):
                need_reserve = True
        return DedupPreview(hits, idxs, need_reserve, keys)

    def claimed_prefix_hits(self, keys) -> int:
        """Contiguous leading prompt pages this allocator could serve from
        its prefix index right now — the fleet router's affinity score.
        Same hit-run semantics as ``dedup_preview`` (a disk frame a parked
        request still owns ends the run), but over pre-hashed ``keys``
        (``prefix_page_keys`` output) so the router hashes an arriving
        prompt ONCE and probes every instance's index with one key list."""
        if not self.enable_dedup:
            return 0
        n = 0
        for key in keys:
            ref = self.index.get(key)
            if ref is None:
                break
            if ref.tier == DISK and ref.page not in self._disk_cache:
                break
            n += 1
        return n

    # ---- allocation ----------------------------------------------------------
    def alloc(self, rid: int, tokens: int, allow_host: bool = True,
              prompt=None, preview: DedupPreview | None = None
              ) -> list[PageRef] | None:
        """Reserve the whole allocation up front, device-preferred; fresh
        frames fill the non-shared positions host-first (the cold front) and
        device-last, so decode writes land on device frames whenever the
        device pool can hold the tail (when it cannot — e.g. a full-prefix
        dedup hit with an exhausted device pool — the write path falls back
        to the streamed-page + dirty-write-back route). With ``prompt``
        given and dedup enabled, prompt pages already present in the prefix
        index are shared (refcount += 1) instead of claiming fresh frames,
        and fresh prompt pages are registered in the index — the caller must
        land their KV before the next ``alloc`` (the engine prefills
        synchronously after admitting). A caller that already ran
        ``dedup_preview`` this scheduling step (no allocator mutation in
        between) passes it as ``preview`` to skip re-hashing the prompt.
        ``allow_host=False`` refuses any allocation that would claim a new
        host frame OR reference an existing host-resident shared page (both
        put traffic on the link that admission must re-check). None if the
        allocation cannot be satisfied (nothing is claimed on failure)."""
        assert prompt is None or len(prompt) <= tokens, \
            "allocation must cover the whole prompt"
        need = self.device.pages_for(tokens)
        pv = preview if preview is not None \
            else self.dedup_preview(prompt, tokens)
        n_fresh = need - pv.n_hits + (1 if pv.need_reserve else 0)
        n_host = max(n_fresh - self.device.free_pages, 0)
        disk_hits = pv.disk_hit_pages()
        if not allow_host and (n_host > 0 or pv.host_hit_pages()
                               or disk_hits):
            return None
        # disk-resident cache hits are revived through fresh host frames
        # (one NVMe read each), so they claim host capacity like a spill
        if n_host + len(disk_hits) > self.host.free_pages:
            # keep-alive cache frames are reclaimable capacity — but never
            # the ones this very allocation is about to share
            self._reclaim_host(n_host + len(disk_hits)
                               - self.host.free_pages,
                               keep=pv.host_hit_pages(),
                               keep_disk=disk_hits)
        if n_host + len(disk_hits) > self.host.free_pages:
            return None
        revived = {p: self._revive_cached_from_disk(p) for p in disk_hits}
        hit_refs = [PageRef(HOST, revived[r.page]) if r.tier == DISK else r
                    for r in pv.hit_refs]
        hp = self.host.alloc_pages(rid, n_host)
        dp = self.device.alloc_pages(rid, n_fresh - n_host)
        assert hp is not None and dp is not None
        if pv.need_reserve:
            # the reserve prefers a device frame (the COW target is the
            # decode write page); it is claimed in the pool but not in
            # refs, keyed by the partial prompt page it protects
            self._reserves[rid] = {
                pv.hit_indices[-1]: (PageRef(DEVICE, dp.pop()) if dp
                                     else PageRef(HOST, hp.pop()))}
        for ref in hit_refs:
            self.pool_of(ref.tier).share_pages(rid, [ref.page])
            if ref.tier == HOST and ref.page in self._cache_lru:
                # keep-alive hit: refresh recency (the cache keeps its claim,
                # so the frame re-enters the cache when this owner frees)
                self._cache_lru.pop(ref.page)
                self._cache_lru[ref.page] = None
                self.cache_hits += 1
        self.dedup_pages_reused += pv.n_hits
        # position-wise refs: hits keep their page index, fresh pages fill
        # the rest host-first (cold prefix on host)
        fresh = iter([PageRef(HOST, p) for p in hp]
                     + [PageRef(DEVICE, p) for p in dp])
        hitmap = dict(zip(pv.hit_indices, hit_refs))
        refs = [hitmap.get(i) or next(fresh) for i in range(need)]
        if refs:
            self._refs.setdefault(rid, []).extend(refs)
        if pv.hit_indices:
            self._dedup_hits[rid] = list(pv.hit_indices)
        self._fresh_host[rid] = len(hp)
        for key in pv.keys:
            if key[0] not in hitmap and self.index.get(key) is None:
                self.index.put(key, refs[key[0]])
        return refs

    def extend(self, rid: int, new_total_tokens: int,
               allow_host: bool = True, on_demote=None, active_rids=()
               ) -> list[Migration] | None:
        """Grow ``rid`` to ``new_total_tokens``. New (tail) pages must be
        device frames; if the device pool is exhausted, the request's own
        oldest cold device page is demoted to host to vacate a frame —
        frames an ``active_rids`` sibling still references spill last (see
        ``swap_out``) — which the very next tail allocation may recycle. A
        data plane holding real page buffers must therefore copy demoted
        pages out *synchronously* via ``on_demote(migration)``, which fires
        while the vacated frame is still unclaimed; the returned list is
        for traffic accounting only. None if the growth cannot be satisfied
        (nothing is changed then beyond already-performed demotions)."""
        have = len(self._refs.get(rid, []))
        need = self.device.pages_for(new_total_tokens) - have
        if need <= 0:
            return []
        migrations: list[Migration] = []
        added: list[int] = []

        def rollback():
            # undo this call's tail allocations so the refs list still
            # matches the request's token count (demotions stay: the data
            # plane may already have copied them). A tail page this call
            # added may itself have been demoted by a later swap_out, so
            # each is released from the tier it sits on now
            for p in reversed(added):
                ref = self._refs[rid].pop()
                assert ref.tier in (DEVICE, HOST)
                assert ref.tier == HOST or ref.page == p
                self.pool_of(ref.tier).release_pages(rid, [ref.page])
            return None

        for _ in range(need):
            if self.device.free_pages == 0:
                if not allow_host:
                    return rollback()
                moved = self.swap_out(rid, 1, active_rids)
                if not moved:
                    return rollback()
                if on_demote is not None:
                    for m in moved:
                        on_demote(m)
                migrations.extend(moved)
            dp = self.device.alloc_pages(rid, 1)
            assert dp is not None
            self._refs.setdefault(rid, []).append(PageRef(DEVICE, dp[0]))
            added.append(dp[0])
        return migrations

    def free(self, rid: int) -> None:
        """Drop every reference ``rid`` holds (refs + COW reserve). Shared
        frames survive for their remaining owners; frames whose last
        reference dropped leave the prefix index with them — except indexed
        host frames when the keep-alive prefix cache is on, which survive
        under ``CACHE_RID`` (LRU-bounded) so a re-submitted prefix dedups."""
        adopted = False
        if self.host_prefix_cache_pages > 0:
            for ref in self._refs.get(rid, []):
                if (ref.tier == HOST and self.host.refcount(ref.page) == 1
                        and self.index.has_frame(ref)
                        and ref.page not in self._cache_lru):
                    self.host.share_pages(CACHE_RID, [ref.page])
                    self._cache_lru[ref.page] = None
                    adopted = True
        for tier in TIER_ORDER:
            for p in self.pool_of(tier).free(rid):
                self.index.evict(PageRef(tier, p))
        self._refs.pop(rid, None)
        self._dedup_hits.pop(rid, None)
        self._fresh_host.pop(rid, None)
        self._reserves.pop(rid, None)
        if adopted:
            # trim AFTER rid's own claims are gone: adopted frames are
            # refcount-1 (pure cache) only now, so the LRU bound can evict
            self._trim_cache()

    # ---- keep-alive prefix cache ---------------------------------------------
    def cached_pages(self) -> list[int]:
        """Host frames alive only as prefix-cache entries (LRU order,
        oldest first). Frames also held by a live request are listed too —
        they cost no extra capacity and re-enter pure-cache state when the
        owner frees."""
        return list(self._cache_lru)

    def reclaimable_host_pages(self) -> int:
        return sum(1 for p in self._cache_lru if self.host.refcount(p) == 1)

    def reclaimable_disk_pages(self) -> int:
        """Disk frames alive only as prefix-cache entries (always pure —
        a dedup hit revives them host-ward before any request maps them)."""
        return len(self._disk_cache)

    def _evict_cached(self, page: int) -> None:
        del self._cache_lru[page]
        freed = self.host.release_pages(CACHE_RID, [page])
        for p in freed:
            self.index.evict(PageRef(HOST, p))

    def _evict_cached_disk(self, page: int) -> None:
        del self._disk_cache[page]
        for p in self.disk.release_pages(CACHE_RID, [page]):
            self.index.evict(PageRef(DISK, p))

    def _reclaim_disk(self, n_pages: int, keep: set[int] | None = None
                      ) -> int:
        """Evict up to ``n_pages`` disk-tier prefix-cache frames, oldest
        first (the end of the hierarchy: below disk there is nowhere left
        to demote to)."""
        freed = 0
        for p in list(self._disk_cache):
            if freed >= n_pages:
                break
            if keep and p in keep:
                continue
            self._evict_cached_disk(p)
            freed += 1
        return freed

    def _demote_cached_to_disk(self, page: int,
                               keep_disk: set[int] | None = None) -> bool:
        """Retire one pure host-cache frame to the disk tier (NVMe write,
        index entry follows) instead of evicting its content outright."""
        if self.disk.total_pages == 0:
            return False
        if self.disk.free_pages == 0 and self._reclaim_disk(1, keep_disk) == 0:
            return False
        dp = self.disk.alloc_pages(CACHE_RID, 1)
        assert dp is not None
        del self._cache_lru[page]
        self.host.release_pages(CACHE_RID, [page])
        self._fire_disk_copy(HOST, page, DISK, dp[0])
        self.pending_disk_out_pages += 1
        self.disk_out_pages_total += 1
        self.index.move(PageRef(HOST, page), PageRef(DISK, dp[0]))
        self._disk_cache[dp[0]] = None
        return True

    def _revive_cached_from_disk(self, page: int) -> int:
        """Stage a disk-resident cache frame back into a host frame (one
        NVMe read) so a dedup hit on it can be shared. Host capacity must
        have been checked by the caller."""
        hp = self.host.alloc_pages(CACHE_RID, 1)
        assert hp is not None, "revival without host room"
        del self._disk_cache[page]
        self.disk.release_pages(CACHE_RID, [page])
        self._fire_disk_copy(DISK, page, HOST, hp[0])
        self.pending_disk_in_pages += 1
        self.disk_in_pages_total += 1
        self.index.move(PageRef(DISK, page), PageRef(HOST, hp[0]))
        self._cache_lru[hp[0]] = None
        return hp[0]

    def _trim_cache(self) -> None:
        over = len(self._cache_lru) - self.host_prefix_cache_pages
        for p in list(self._cache_lru):
            if over <= 0:
                break
            if self.host.refcount(p) == 1:   # only pure-cache frames leave
                # aged out of the host LRU bound: retire to disk when a
                # disk tier exists, evict only at the end of the hierarchy
                if not self._demote_cached_to_disk(p):
                    self._evict_cached(p)
                over -= 1

    def _reclaim_host(self, n_pages: int, keep: set[int] | None = None,
                      keep_disk: set[int] | None = None) -> int:
        """Free up to ``n_pages`` host frames by retiring prefix-cache
        entries, oldest first — demoted to the disk tier when one exists
        (content survives, rides the NVMe link), evicted otherwise. Frames
        with a live owner free no capacity and are skipped; ``keep``
        protects host frames the caller is about to share, ``keep_disk``
        protects disk frames it is about to revive."""
        freed = 0
        for p in list(self._cache_lru):
            if freed >= n_pages:
                break
            if keep and p in keep:
                continue
            if self.host.refcount(p) == 1:
                if not self._demote_cached_to_disk(p, keep_disk):
                    self._evict_cached(p)
                freed += 1
        return freed

    def _fire_disk_copy(self, src_tier: str, src_page: int,
                        dst_tier: str, dst_page: int) -> None:
        if self.disk_copy is not None:
            self.disk_copy(src_tier, src_page, dst_tier, dst_page)

    # ---- copy-on-write -------------------------------------------------------
    def prepare_write(self, rid: int, page_idx: int) -> list[CowMove]:
        """Called before ``rid`` writes into its page ``page_idx`` (the
        decode write position's page). Resolves sharing so the write cannot
        corrupt a sibling:

          * private page (refcount 1): write in place; a now-stale COW
            reserve for this page (every sibling left or finished) is
            released.
          * shared page, ``rid`` holds a reserve for it (admission dedup or
            ``add_reserve``): swap the reserve into the block table — the
            returned ``CowMove`` tells the data plane to copy the page
            bytes first.
          * shared page, no reserve: ``rid`` is the page's origin; appending
            in place is safe (sibling contexts never reach the appended
            positions before their own COW — see module docstring).
        """
        refs = self._refs.get(rid, [])
        assert 0 <= page_idx < len(refs)
        ref = refs[page_idx]
        pool = self.pool_of(ref.tier)
        if pool.refcount(ref.page) <= 1:
            self._drop_reserve(rid, page_idx)
            return []
        new_ref = self._reserves.get(rid, {}).pop(page_idx, None)
        if new_ref is None:
            return []                          # origin: in-place append
        if not self._reserves[rid]:
            del self._reserves[rid]
        pool.release_pages(rid, [ref.page])    # rc > 1: frame survives
        refs[page_idx] = new_ref
        self.cow_copies += 1
        return [CowMove(rid, ref, new_ref)]

    def _drop_reserve(self, rid: int, page_idx: int) -> None:
        rmap = self._reserves.get(rid)
        if rmap is None:
            return
        res = rmap.pop(page_idx, None)
        if not rmap:
            del self._reserves[rid]
        if res is None:
            return
        self.pool_of(res.tier).release_pages(rid, [res.page])

    # ---- forked beams --------------------------------------------------------
    def fork(self, src_rid: int, dst_rid: int) -> list[PageRef] | None:
        """Make ``dst_rid`` a full sharer of ``src_rid``'s block table:
        every frame's refcount += 1, position-wise (multiplicity kept), so
        N beams decode from one shared context without copying a byte. The
        fork inherits NO reserves and no dedup/fresh-host bookkeeping — it
        writes no prefill; callers pre-claim per-page COW reserves with
        ``add_reserve`` on every shared page the beam may write before it
        diverges. None when ``src_rid`` has no refs or ``dst_rid`` is
        already live."""
        if dst_rid in self._refs or src_rid not in self._refs:
            return None
        refs = list(self._refs[src_rid])
        for r in refs:
            self.pool_of(r.tier).share_pages(dst_rid, [r.page])
        self._refs[dst_rid] = list(refs)
        return list(refs)

    def add_reserve(self, rid: int, page_idx: int) -> PageRef | None:
        """Pre-claim a private COW reserve for an ARBITRARY shared page of
        ``rid`` (forked beams: each sharer of a shared tail page needs its
        own spare frame so its first divergent write can never fail or
        race a later admission). Device-preferred, host fallback — same
        policy as the admission-time reserve. Returns the reserve (the
        existing one if this page is already covered); None when the page
        is private (no reserve needed) or neither pool has a free frame
        (nothing is claimed then)."""
        refs = self._refs.get(rid, [])
        assert 0 <= page_idx < len(refs)
        ref = refs[page_idx]
        if self.pool_of(ref.tier).refcount(ref.page) <= 1:
            return None
        rmap = self._reserves.setdefault(rid, {})
        if page_idx in rmap:
            return rmap[page_idx]
        dp = self.device.alloc_pages(rid, 1)
        if dp is not None:
            res = PageRef(DEVICE, dp[0])
        else:
            hp = self.host.alloc_pages(rid, 1)
            if hp is None:
                if not rmap:
                    del self._reserves[rid]
                return None
            res = PageRef(HOST, hp[0])
        rmap[page_idx] = res
        return res

    # ---- migration -----------------------------------------------------------
    def _owners_of(self, ref: PageRef) -> list[tuple[int, list[int]]]:
        """(rid, ref positions) for every request referencing ``ref``."""
        out = []
        for rid, refs in self._refs.items():
            idxs = [i for i, r in enumerate(refs) if r == ref]
            if idxs:
                out.append((rid, idxs))
        return out

    def _move_frame(self, ref: PageRef, new_ref: PageRef) -> None:
        """Rewrite every owner's refs after a frame migration; the pools'
        ownership must already have been transferred by the caller."""
        for rid, refs in self._refs.items():
            for i, r in enumerate(refs):
                if r == ref:
                    refs[i] = new_ref
        for rmap in self._reserves.values():
            for idx, r in rmap.items():
                if r == ref:
                    rmap[idx] = new_ref
        self.index.move(ref, new_ref)

    def _transfer_frame(self, ref: PageRef, dst_pool, dst_tier: str
                        ) -> int | None:
        """Move one frame — with EVERY owner's reference — to ``dst_pool``.
        Returns the new frame id, or None when the destination is full."""
        src_pool = self.pool_of(ref.tier)
        holders: list[int] = []        # one entry per reference held
        for rid, idxs in self._owners_of(ref):
            holders.extend([rid] * len(idxs))
        holders.extend(rid for rid, rmap in self._reserves.items()
                       for r in rmap.values() if r == ref)
        assert holders, "transferring an unreferenced frame"
        dp = dst_pool.alloc_pages(holders[0], 1)
        if dp is None:
            return None
        if ref.tier == HOST and ref.page in self._cache_lru:
            # the frame (and its index entry) leaves the host tier; the
            # keep-alive LRU only spans the host tier, so its claim drops
            del self._cache_lru[ref.page]
            self.host.release_pages(CACHE_RID, [ref.page])
        elif ref.tier == DISK and ref.page in self._disk_cache:
            del self._disk_cache[ref.page]
            self.disk.release_pages(CACHE_RID, [ref.page])
        for rid in holders[1:]:
            dst_pool.share_pages(rid, [dp[0]])
        for rid in holders:
            src_pool.release_pages(rid, [ref.page])
        self._move_frame(ref, PageRef(dst_tier, dp[0]))
        return dp[0]

    def hot_pages(self, active_rids, tier: str,
                  exclude_rid: int | None = None) -> set[int]:
        """Frames on ``tier`` a still-active request references (block
        table or COW reserve). Demoting one frees no net capacity for
        long: the active owner streams (host) or re-promotes (device) the
        page — every per-tier "don't touch the siblings' frames" rule
        below and in the scheduler derives from this one set."""
        hot: set[int] = set()
        for arid in active_rids:
            if arid == exclude_rid:
                continue
            hot.update(r.page for r in self._refs.get(arid, [])
                       if r.tier == tier)
            hot.update(r.page for r in self._reserves.get(arid, {}).values()
                       if r.tier == tier)
        return hot

    def swap_out(self, rid: int, n_pages: int, active_rids=()
                 ) -> list[Migration]:
        """Demote ``rid``'s ``n_pages`` device pages to host, oldest first
        — but frames a still-active sibling references go LAST: demoting a
        hot shared frame moves it for every owner, so the sibling would
        stream it back over the link every subsequent iteration. Unshared
        (or sibling-cold) frames spill first; shared hot frames only when
        nothing else remains. A shared frame moves once, for every owner.
        Returns the moves actually performed (host pool may fill up)."""
        hot = self.hot_pages(active_rids, DEVICE, rid)
        refs = self._refs.get(rid, [])
        order = ([r for r in refs if r.tier == DEVICE and r.page not in hot]
                 + [r for r in refs if r.tier == DEVICE and r.page in hot])
        moves: list[Migration] = []
        for ref in order:
            if len(moves) >= n_pages:
                break
            if ref not in self._refs.get(rid, []):
                continue
            if self.host.free_pages == 0:
                self._reclaim_host(1)
            hp = self._transfer_frame(ref, self.host, HOST)
            if hp is None:
                break
            moves.append(Migration(rid, DEVICE, ref.page, hp, HOST))
        return moves

    def swap_in(self, rid: int, n_pages: int) -> list[Migration]:
        """Promote ``rid``'s ``n_pages`` oldest host pages back to device
        (shared frames move once, for every owner)."""
        moves: list[Migration] = []
        refs = self._refs.get(rid, [])
        for ref in list(refs):
            if len(moves) >= n_pages:
                break
            if ref.tier != HOST or ref not in refs:
                continue
            dp = self._transfer_frame(ref, self.device, DEVICE)
            if dp is None:
                break
            moves.append(Migration(rid, HOST, ref.page, dp, DEVICE))
        return moves

    def demote_to_disk(self, rid: int, n_pages: int, active_rids=(),
                       keep=(), keep_disk: set[int] | None = None
                       ) -> list[Migration]:
        """Demote ``rid``'s ``n_pages`` oldest host pages to the disk tier
        (NVMe writes, fired synchronously through ``disk_copy``). Frames a
        still-ACTIVE sibling references are skipped entirely — an active
        request streams its host pages every iteration and the engine never
        reads the disk pool directly; frames shared only with other parked
        requests move once for all owners. The COW reserve rides along.
        ``keep`` protects extra host frames (a caller's dedup-preview hits:
        moving them would invalidate the preview it is about to allocate
        with); ``keep_disk`` protects disk-cache frames from the reclaim
        this demotion may trigger, for the same reason."""
        skip = self.hot_pages(active_rids, HOST, rid) | set(keep)
        cands = list(self._refs.get(rid, []))
        cands.extend(self._reserves.get(rid, {}).values())
        moves: list[Migration] = []
        seen: set[int] = set()
        for ref in cands:
            if len(moves) >= n_pages:
                break
            if ref.tier != HOST or ref.page in skip or ref.page in seen:
                continue
            seen.add(ref.page)
            if self.disk.free_pages == 0:
                self._reclaim_disk(1, keep_disk)
            src = ref.page
            dp = self._transfer_frame(ref, self.disk, DISK)
            if dp is None:
                break
            self._fire_disk_copy(HOST, src, DISK, dp)
            self.pending_disk_out_pages += 1
            self.disk_out_pages_total += 1
            moves.append(Migration(rid, HOST, src, dp, DISK))
        return moves

    # ---- preempt-to-host (whole-request park/resume) -------------------------
    def _park_targets(self, rid: int, active_rids=()) -> list[PageRef]:
        """Device frames ``park`` would migrate: every device frame ``rid``
        references (block table + COW reserve) EXCEPT frames a still-active
        request also references — moving those frees no capacity (the
        sibling keeps the claim) and would force the sibling to stream a
        page it attends through every iteration. Frame-wise: a frame
        referenced at several positions appears once."""
        keep = self.hot_pages(active_rids, DEVICE, rid)
        cands = list(self._refs.get(rid, []))
        cands.extend(self._reserves.get(rid, {}).values())
        uniq: list[PageRef] = []
        seen: set[int] = set()
        for r in cands:
            if r.tier == DEVICE and r.page not in keep and r.page not in seen:
                seen.add(r.page)
                uniq.append(r)
        return uniq

    def park_preview(self, rid: int, active_rids=()) -> tuple[int, int]:
        """(device frames ``park(rid)`` would free, host frames it still
        NEEDS once prefix-cache reclaim is counted) — the scheduler's
        feasibility precheck, no mutation. ``park`` reclaims keep-alive
        cache frames via ``_reclaim_host`` before giving up, so a preview
        reporting the raw target count would refuse parks the real call
        absorbs: the second element nets out ``reclaimable_host_pages()``
        and is the number to compare against ``host.free_pages``."""
        n = len(self._park_targets(rid, active_rids))
        return n, max(n - self.reclaimable_host_pages(), 0)

    def park(self, rid: int, active_rids=()) -> list[Migration] | None:
        """Preempt-to-host: migrate the request's ENTIRE device-resident KV
        (block-table frames + COW reserve) to the host tier in one
        whole-request move. Shared prefix frames move once for all owners —
        and not at all while an active sibling still references them (they
        free nothing and would cost the sibling streaming traffic). Returns
        the migrations for the data plane, or None (nothing moved) when the
        host pool cannot absorb the parked set even after reclaiming
        prefix-cache frames."""
        targets = self._park_targets(rid, active_rids)
        if len(targets) > self.host.free_pages:
            self._reclaim_host(len(targets) - self.host.free_pages)
        if len(targets) > self.host.free_pages:
            return None
        moves: list[Migration] = []
        for ref in targets:
            hp = self._transfer_frame(ref, self.host, HOST)
            assert hp is not None          # capacity checked up front
            if self.park_copy is not None:
                # synchronous d2h leg: the parked bytes must be resident
                # before a same-pass demotion can retire them to disk
                self.park_copy(ref.page, hp)
            moves.append(Migration(rid, DEVICE, ref.page, hp, HOST))
        return moves

    def _disk_refs_of(self, rid: int) -> list[PageRef]:
        """Unique disk-tier frames ``rid`` references (block table + COW
        reserve), oldest first."""
        cands = list(self._refs.get(rid, []))
        cands.extend(self._reserves.get(rid, {}).values())
        out: list[PageRef] = []
        seen: set[int] = set()
        for r in cands:
            if r.tier == DISK and r.page not in seen:
                seen.add(r.page)
                out.append(r)
        return out

    def unspill_from_disk(self, rid: int) -> int:
        """Stage every disk page of ``rid`` back into host frames (the
        exact reverse of ``demote_to_disk``, NVMe reads through the same
        hooks). Defensive path for a park that fell through AFTER its
        victim's spill was already retired: an ACTIVE request must never
        be left holding disk-tier pages (the decode path cannot read
        them). The host frames the demotion just vacated are still free —
        nothing claimed them between the two calls — so this cannot run
        out of room."""
        n = 0
        for ref in self._disk_refs_of(rid):
            src = ref.page
            hp = self._transfer_frame(ref, self.host, HOST)
            assert hp is not None, "unspill without host room"
            self._fire_disk_copy(DISK, src, HOST, hp)
            self.pending_disk_in_pages += 1
            self.disk_in_pages_total += 1
            n += 1
        return n

    def parked_disk_pages(self, rid: int) -> int:
        """Unique disk frames ``resume(rid)`` would stage back: block-table
        entries AND the COW reserve — what the scheduler must charge as
        NVMe reads (``disk_pages_of`` alone misses the reserve)."""
        return len(self._disk_refs_of(rid))

    def prefetch_from_disk(self, rid: int, max_pages: int) -> int:
        """Stage up to ``max_pages`` of a PARKED request's disk pages into
        FREE host frames ahead of its predicted resume. Opportunistic:
        never reclaims cache frames or evicts anything — it only soaks up
        idle host capacity so the eventual ``resume`` finds the pages
        already host-resident. Charged as NVMe reads through the pending
        disk counters like any staging. Returns the pages staged."""
        n = 0
        for ref in self._disk_refs_of(rid):
            if n >= max_pages or self.host.free_pages == 0:
                break
            src = ref.page
            hp = self._transfer_frame(ref, self.host, HOST)
            if hp is None:
                break
            self._fire_disk_copy(DISK, src, HOST, hp)
            self.pending_disk_in_pages += 1
            self.disk_in_pages_total += 1
            n += 1
        return n

    def resume_staging_shortfall(self, rid: int) -> int:
        """Host frames ``resume`` is short of for staging ``rid``'s disk
        pages back, even after its own host pages promote device-ward and
        prefix-cache frames are reclaimed. Staging INTERLEAVES with
        promotion (stage one page into a host frame, promote it onward,
        reuse the frame), so pages passing through to the device need only
        ONE transit frame; only pages that must STAY host-resident (no
        device frame left) hold a frame each. The scheduler demotes OTHER
        parked requests to cover exactly this shortfall."""
        n_disk = len(self._disk_refs_of(rid))
        if n_disk == 0:
            return 0
        promote = min(len(self.host_pages_of(rid)), self.device.free_pages)
        dev_after = self.device.free_pages - promote
        host_after = (self.host.free_pages + promote
                      + self.reclaimable_host_pages())
        stay = max(n_disk - dev_after, 0)   # pages the device cannot take
        if self.direct_copy is not None:
            # pass-through pages go disk->device directly — no transit
            # frame; only the pages that must stay host-resident need one
            return max(stay - host_after, 0)
        return max(max(stay, 1) - host_after, 0)

    def resume(self, rid: int) -> list[Migration] | None:
        """Un-park. Host-resident pages promote into free device frames
        first (oldest first; shared frames move once, for every owner) —
        this also vacates host frames. Disk-resident pages (a long-parked
        request demoted under host pressure) are then staged disk->host
        one at a time — the decode path can stream host pages through the
        slab but never reads the disk pool — each promoting onward while
        device frames remain, so a chain of pages can pass through a host
        pool smaller than the disk set. Whatever stays host-resident
        streams through the slab until the swap scheduler promotes the
        rest. Returns None (nothing moved) when the host tier cannot
        absorb the staging even after the promotions and prefix-cache
        reclaim; otherwise the host->device promotions (NVMe staging reads
        are charged through the pending disk counters)."""
        if self.resume_staging_shortfall(rid) > 0:
            return None

        def promote(n: int) -> list[Migration]:
            ms = self.swap_in(rid, n)
            if self.promote_copy is not None:
                for m in ms:
                    self.promote_copy(m.src_page, m.dst_page)
            return ms

        moves = promote(len(self.host_pages_of(rid)))
        for ref in self._disk_refs_of(rid):
            src = ref.page
            if self.direct_copy is not None and self.device.free_pages > 0:
                # direct path: the page lands on the device without a host
                # bounce — the NVMe read is charged, the PCIe promotion is
                # not (the saved host-transit bytes leave the link charge)
                dframe = self._transfer_frame(ref, self.device, DEVICE)
                assert dframe is not None
                self.direct_copy(DISK, src, DEVICE, dframe)
                self.pending_disk_in_pages += 1
                self.disk_in_pages_total += 1
                self.disk_direct_pages_total += 1
                moves.append(Migration(rid, DISK, src, dframe, DEVICE))
                continue
            if self.host.free_pages == 0:
                self._reclaim_host(1)
            hp = self._transfer_frame(ref, self.host, HOST)
            assert hp is not None          # shortfall checked up front
            self._fire_disk_copy(DISK, src, HOST, hp)
            self.pending_disk_in_pages += 1
            self.disk_in_pages_total += 1
            if self.device.free_pages > 0:
                moves.extend(promote(1))
        # sweep any remaining host pages into still-free device frames
        if self.device.free_pages > 0:
            moves.extend(promote(len(self.host_pages_of(rid))))
        return moves

    # ---- cross-instance migration (PEER tier) --------------------------------
    def note_peer_export(self, n_pages: int) -> None:
        """Charge a live handoff EXPORT (host -> peer) to the peer link:
        the pages drain into the next ``SwapPlan.peer_out_bytes`` and from
        there into the iteration's ``peer_s`` channel term. The emergency
        evacuation path never calls this — it bills ``mig_wait_s``."""
        self.pending_peer_out_pages += n_pages
        self.peer_out_pages_total += n_pages

    def note_peer_import(self, n_pages: int) -> None:
        """Charge a live handoff IMPORT (peer -> host): the decode side's
        TPOT-plus-transfer certification drains these into ``peer_s``."""
        self.pending_peer_in_pages += n_pages
        self.peer_in_pages_total += n_pages

    def export_parked(self, rid: int) -> list[int] | None:
        """Host frame ids of a fully host-parked request, in token order —
        the payload a ``MigrationTicket`` serializes for cross-instance
        preemption. None (nothing exported) unless EVERY block-table ref
        is host-resident and no COW reserve is held: a partially
        disk-demoted or reserve-holding park stays put (the fleet migrates
        only the bitwise-safe shape). Shared frames are fine — the payload
        is a copy, and the source-side ``free(rid)`` afterwards just drops
        this owner's refcount, leaving the frame to its siblings."""
        refs = self._refs.get(rid)
        if not refs or self._reserves.get(rid):
            return None
        if any(r.tier != HOST for r in refs):
            return None
        return [r.page for r in refs]

    def import_parked(self, rid: int, n_pages: int) -> list[int] | None:
        """Claim ``n_pages`` PRIVATE host frames for a request migrating
        in from a peer instance and install them as its block table (token
        order; the caller writes the ticket payload into them). The frames
        are not prefix-index-registered — this instance never hashed that
        KV — and the request resumes and frees like any locally parked
        one. None (nothing claimed) when the host tier cannot absorb the
        set even after prefix-cache reclaim."""
        assert rid not in self._refs, "import over a live rid"
        if n_pages > self.host.free_pages:
            self._reclaim_host(n_pages - self.host.free_pages)
        hp = self.host.alloc_pages(rid, n_pages)
        if hp is None:
            return None
        self._refs[rid] = [PageRef(HOST, p) for p in hp]
        return hp

    def can_resize_device(self, new_total_bytes: float) -> bool:
        """Would ``resize_device`` succeed? False when the shrink's overflow
        exceeds free host capacity (resize_device would raise). Shared
        frames count once — ``used_pages`` is unique frames; keep-alive
        cache frames count as reclaimable capacity."""
        new_pages = max(int(new_total_bytes), 0) // self.page_bytes
        return (self.device.used_pages - new_pages
                <= self.host.free_pages + self.reclaimable_host_pages())

    def resize_device(self, new_total_bytes: float) -> ResizeResult:
        """Rebuild the device pool for a new byte budget (the offloading
        interval changed the resident weight set). Existing device frames
        are re-assigned to fresh frames; overflow demotes host-ward, largest
        holders first, one move per unique frame however many requests share
        it. Returns the demotions and the old->new frame remap so a caller
        holding the physical page buffer can mirror the move (serving.engine
        copies demoted frames to the host pool and permutes the surviving
        frames in place).
        """
        if not self.can_resize_device(new_total_bytes):
            # validated up front so failure never leaves partial state
            raise RuntimeError("device KV overflow exceeds host capacity")
        new_total = max(int(new_total_bytes), 0) // self.page_bytes
        overflow = self.device.used_pages - new_total
        if overflow > self.host.free_pages:
            self._reclaim_host(overflow - self.host.free_pages)
        demotions: list[Migration] = []
        # shed overflow: take from the requests holding the most device
        # pages, their oldest (front) frames first. Counts are maintained
        # incrementally (a shared frame's transfer drops every owner's
        # count) — rebuilding them per demoted frame would make a large
        # shrink quadratic in pool size.
        counts = {rid: len(self.device_pages_of(rid)) for rid in self._refs}
        while self.device.used_pages > new_total:
            holders = {r: c for r, c in counts.items() if c > 0}
            if holders:
                rid = max(holders, key=holders.get)
                ref = next(r for r in self._refs[rid] if r.tier == DEVICE)
            else:
                # only COW reserves left on device
                rid, ref = next((r, v) for r, rmap in self._reserves.items()
                                for v in rmap.values() if v.tier == DEVICE)
            owners = self._owners_of(ref)
            hp = self._transfer_frame(ref, self.host, HOST)
            assert hp is not None            # entry check guarantees room
            for orid, idxs in owners:
                counts[orid] -= len(idxs)
            demotions.append(Migration(rid, DEVICE, ref.page, hp, HOST))
        # re-assign surviving device frames to fresh frames in a new pool
        new_dev = PagedKVAllocator(max(int(new_total_bytes), 0), self.pcfg)
        frame_new: dict[int, int] = {}
        remap: list[tuple[int, int]] = []

        def assign(rid: int, old: int) -> int:
            if old not in frame_new:
                dp = new_dev.alloc_pages(rid, 1)
                assert dp is not None
                frame_new[old] = dp[0]
                remap.append((old, dp[0]))
            else:
                new_dev.share_pages(rid, [frame_new[old]])
            return frame_new[old]

        for rid, refs in self._refs.items():
            for i, r in enumerate(refs):
                if r.tier == DEVICE:
                    refs[i] = PageRef(DEVICE, assign(rid, r.page))
        for rid, rmap in self._reserves.items():
            for idx, r in list(rmap.items()):
                if r.tier == DEVICE:
                    rmap[idx] = PageRef(DEVICE, assign(rid, r.page))
        # the index follows its frames to their new ids (two-phase: old and
        # new frame ids overlap)
        self.index.remap_frames(DEVICE, remap)
        self.device = new_dev
        self.pools[DEVICE] = new_dev
        return ResizeResult(demotions=demotions, remap=remap)

    # ---- block tables --------------------------------------------------------
    def device_block_table(self, rid: int, max_pages: int) -> np.ndarray:
        """Block table for the paged decode kernel. Valid only when the
        request is fully device-resident (swap_in first). Raises when the
        request holds more pages than ``max_pages`` (truncation would drop
        context pages silently)."""
        refs = self._refs.get(rid, [])
        assert all(r.tier == DEVICE for r in refs), \
            "host-resident pages: swap_in before building the kernel table"
        return padded_block_table([r.page for r in refs], max_pages, rid)

    def check_invariants(self) -> None:
        for pool in self.pools.values():
            pool.check_invariants()
        rids = set(self._refs) | set(self._reserves)
        for rid in rids:
            refs = self._refs.get(rid, [])
            by_tier = {t: [r.page for r in refs if r.tier == t]
                       for t in TIER_ORDER}
            for res in self._reserves.get(rid, {}).values():
                by_tier[res.tier].append(res.page)
            for tier in TIER_ORDER:
                assert sorted(by_tier[tier]) == \
                    sorted(self.pool_of(tier).pages_of(rid)), \
                    f"{tier} refs out of sync with pool for rid {rid}"
        for rid, rmap in self._reserves.items():
            assert rmap, "empty reserve map left behind"
            for res in rmap.values():
                # a COW reserve is a claimed, private, spare frame
                assert self.refcount(res) == 1, "reserve frame is shared"
                assert all(res != r for r in self._refs.get(rid, [])), \
                    "reserve frame already mapped in the block table"
        for key, ref in self.index._by_key.items():
            assert self.index._by_frame.get(ref) == key
            assert self.refcount(ref) >= 1, "index entry on a dead frame"
        for ref, key in self.index._by_frame.items():
            assert self.index._by_key.get(key) == ref
        # keep-alive cache: CACHE_RID's claims are exactly the per-tier
        # LRU sets, and every cached frame still answers a prefix lookup
        assert sorted(self._cache_lru) == sorted(
            self.host.pages_of(CACHE_RID)), "cache LRU out of sync with pool"
        assert sorted(self._disk_cache) == sorted(
            self.disk.pages_of(CACHE_RID)), \
            "disk cache out of sync with pool"
        for p in self._cache_lru:
            assert self.index.has_frame(PageRef(HOST, p)), \
                "cached frame lost its index entry"
        for p in self._disk_cache:
            assert self.index.has_frame(PageRef(DISK, p)), \
                "disk-cached frame lost its index entry"
            assert self.disk.refcount(p) == 1, \
                "disk cache frame gained a live owner without revival"


# ---------------------------------------------------------------------------
# Per-iteration swap planning
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SwapPlan:
    """Link traffic of one inference iteration's KV tier activity. PCIe
    (kv_in/kv_out) and NVMe (disk_in/disk_out) are separate channels: the
    SLO model charges each to its own term, never disk bytes to the
    TPOT-critical PCIe budget."""
    kv_in_bytes: float = 0.0      # host->device: promotions + streamed KV
    kv_out_bytes: float = 0.0     # device->host: demotions / spill write-back
    streamed_bytes: float = 0.0   # recurring share of kv_in (no residency change)
    disk_in_bytes: float = 0.0    # disk->host staging reads (NVMe)
    disk_out_bytes: float = 0.0   # host->disk demotion writes (NVMe)
    peer_in_bytes: float = 0.0    # handoff imports from a peer (peer link)
    peer_out_bytes: float = 0.0   # handoff exports to a peer (peer link)
    promotions: list[Migration] = dataclasses.field(default_factory=list)


class SwapScheduler:
    """Decides, per iteration, which pages move between tiers.

    Policy: freed device frames are back-filled by promoting the oldest host
    pages of active requests (cheapest first: the request with the fewest
    host pages clears its streaming debt soonest — re-selected after every
    promotion, because a shared-frame swap_in rewrites sibling counts);
    whatever stays on host is streamed in for attention each iteration.
    Demotions queued by interval changes or tail growth are charged as
    write-back traffic; NVMe moves the allocator performed since the last
    plan (park-to-disk, cache retirement/revival, resume staging) are
    drained into the plan's ``disk_in/out_bytes`` — the disk link's own
    term, never the PCIe budget. All byte accounting is frame-wise: a host
    page shared by several active requests streams ONCE per iteration and a
    shared demotion writes back ONCE — charging per owner would double-bill
    the link the SLO math budgets (``iter_time_with_interval_kv``).
    """

    def __init__(self, kv: TieredKVAllocator):
        self.kv = kv
        self._pending_out_pages = 0
        self._pending_in_pages = 0
        # cumulative counters for the trace auditor: every page ever noted
        # or promoted, so "bytes charged to the clock" can be cross-checked
        # against "bytes the allocator actually moved" over a whole trace
        self.in_pages_noted_total = 0
        self.out_pages_noted_total = 0
        self.promoted_pages_total = 0

    def note_demotions(self, n_pages: int) -> None:
        """Register demotions performed by resize/extend/park since last
        plan (callers pass unique frame moves — one per ``Migration``)."""
        self._pending_out_pages += n_pages
        self.out_pages_noted_total += n_pages

    def note_promotions(self, n_pages: int) -> None:
        """Register promotions already performed by the data plane (resume)
        whose copy bytes must be charged to the next iteration's link."""
        self._pending_in_pages += n_pages
        self.in_pages_noted_total += n_pages

    def pending_out_bytes(self) -> float:
        """Write-back traffic already queued for the next iteration."""
        return self._pending_out_pages * self.kv.page_bytes

    def pending_in_bytes(self) -> float:
        """Promotion traffic (resume copies) charged to the next iteration."""
        return self._pending_in_pages * self.kv.page_bytes

    def pending_disk_in_bytes(self) -> float:
        """NVMe staging reads (disk->host) performed since the last plan —
        the allocator counts them at the moment the copy fires."""
        return self.kv.pending_disk_in_pages * self.kv.page_bytes

    def pending_disk_out_bytes(self) -> float:
        """NVMe demotion writes (host->disk) performed since the last plan."""
        return self.kv.pending_disk_out_pages * self.kv.page_bytes

    def pending_peer_in_bytes(self) -> float:
        """Handoff imports (peer->host) performed since the last plan —
        charged to the peer link's own term, never PCIe or NVMe."""
        return self.kv.pending_peer_in_pages * self.kv.page_bytes

    def pending_peer_out_bytes(self) -> float:
        """Handoff exports (host->peer) performed since the last plan."""
        return self.kv.pending_peer_out_pages * self.kv.page_bytes

    def streamed_host_pages(self, active_rids: list[int]) -> set[int]:
        """UNIQUE host frames the active requests attend through."""
        return {p for r in active_rids for p in self.kv.host_pages_of(r)}

    def streamed_bytes(self, active_rids: list[int]) -> float:
        return float(len(self.streamed_host_pages(active_rids))
                     * self.kv.page_bytes)

    def plan_iteration(self, active_rids: list[int]) -> SwapPlan:
        plan = SwapPlan()
        plan.kv_out_bytes = self._pending_out_pages * self.kv.page_bytes
        self._pending_out_pages = 0
        plan.kv_in_bytes = self._pending_in_pages * self.kv.page_bytes
        self._pending_in_pages = 0
        plan.disk_in_bytes = self.pending_disk_in_bytes()
        plan.disk_out_bytes = self.pending_disk_out_bytes()
        self.kv.pending_disk_in_pages = 0
        self.kv.pending_disk_out_pages = 0
        plan.peer_in_bytes = self.pending_peer_in_bytes()
        plan.peer_out_bytes = self.pending_peer_out_bytes()
        self.kv.pending_peer_in_pages = 0
        self.kv.pending_peer_out_pages = 0
        # promote into free device frames, cheapest request first (a shared
        # frame promotes once: the first owner's swap_in rewrites them all).
        # The cheapest request is RE-selected after every promotion: a
        # shared-frame swap_in rewrites sibling refs too, so host-page
        # counts taken before the move go stale mid-loop — a one-shot
        # up-front sort could promote a request that is no longer the one
        # clearing its streaming debt soonest.
        while self.kv.device.free_pages > 0:
            cands = [r for r in active_rids if self.kv.host_pages_of(r)]
            if not cands:
                break
            rid = min(cands, key=lambda r: len(self.kv.host_pages_of(r)))
            moves = self.kv.swap_in(rid, self.kv.device.free_pages)
            if not moves:
                break
            plan.promotions.extend(moves)
            plan.kv_in_bytes += len(moves) * self.kv.page_bytes
            self.promoted_pages_total += len(moves)
        plan.streamed_bytes = self.streamed_bytes(active_rids)
        plan.kv_in_bytes += plan.streamed_bytes
        return plan
