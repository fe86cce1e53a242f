"""EN-side reuse store: LSH-indexed storage of executed tasks (paper §IV-E).

Port of ``repro/core/reuse_store.py``.  The host-side bookkeeping (LRU,
slot tables, fills, cursors, grouped scatter, statistics) is the reference's
numpy code unchanged; the two device mirrors (embedding pages and slot
tables) are torch tensors on the store's device, and the kernels are the
port's hand-written CUDA kernels (their plain versions on a CPU device).

Stores ``(input embedding, result)`` of every from-scratch execution.  For an
incoming task it multi-probes the LSH tables (FALCONN-style, see ``lsh.py``),
gathers candidate previous tasks, and returns the nearest neighbour by the
configured similarity.  The EN reuses that result iff the similarity exceeds
the task-carried threshold.

Array-native index (DESIGN.md §Array-native store): each LSH table is a
fixed-capacity contiguous bucket array — ``(T, num_buckets, bucket_cap)``
int32 slot ids plus ``(T, num_buckets)`` fill counts.  Probe -> candidate
gather is vectorized indexing, and ``query_batch`` serves a whole batch with
one probe call plus one gather/score kernel launch (``gather_top1``).
Buckets that exceed ``bucket_cap`` overwrite their oldest slot ring-buffer
style (``overflows`` counts occurrences).

Paged device residency: embeddings live in host *pages* of ``page_size``
rows, mirrored on the device by one preallocated ``(num_pages, page_size,
dim)`` tensor.  A slot id decomposes as ``(idx // page_size, idx %
page_size)``.  Inserts and removals mark only their pages dirty; a device
sync copies exactly the dirty pages into the device tensor in place (the
reference's donated ``dynamic_update_slice``; the port updates in place), so
sync cost is O(dirty pages).  Growth appends host pages and doubles the
device allocation with a device-side copy.  ``sync_pages_total`` /
``sync_bytes_total`` / ``last_sync_pages`` account every upload; each sync
is a ``store.sync`` span of the wall recorder (``obs.trace``) whose args
are the pages, slabs and bytes it uploaded.

One-call query path: ``_slots`` is mirrored on the device as a flat
``(T * num_buckets, bucket_cap)`` int32 tensor, dirtied in fixed-size row
slabs by every table mutation and synced O(dirty slabs) by ``sync_device``.
With both mirrors resident, ``query_batch`` routes large cosine batches
through ``kernels.ops.reuse_query_top1``: probe math, masked cosine top-1
over the probed slot rows (one ``reuse_top1_probed`` launch) and candidate
counting on the device, with no host-side candidate matrix.  ``_fill`` is not mirrored:
every slot at position >= fill holds -1, so validity is readable from the
slot values alone.

Capacity-bounded with LRU eviction (paper §V-C).  Removal tombstones the
entry's page row (zeros it and dirties the page) so a stale embedding can
never be gathered after slot-id reuse.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..analysis import sanitizer as _sanitize
from ..device import DeviceLike, resolve_device
from ..kernels import ops as _kops
from ..obs import trace as _trace
from .lsh import LSH, LSHParams, get_lsh, normalize
from .similarity import get_similarity

# Hard ceiling on total bucket-table slots (int32 entries) per store.
_MAX_TABLE_SLOTS = 1 << 25

# Default rows per embedding page: 4096 x dim f32 = 1 MiB at dim=64 — big
# enough that a batch insert rarely straddles more than two pages, small
# enough that one dirty row doesn't re-upload a meaningful store fraction.
DEFAULT_PAGE_SIZE = 4096

# Target int32 slots per table-mirror sync slab (~64 KiB): small enough that
# a single insert's <= T dirty rows upload a sliver of the tables, big
# enough that a full resync is a few hundred slabs at the size ceiling.
_TABLE_SLAB_SLOTS = 16384


def _host(t: Any) -> np.ndarray:
    """A device tensor (or array) as a host numpy array."""
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def scores_on_device(similarity_name: str, work: int, use_kernel_threshold: int) -> bool:
    """The reference's scoring route for a staged query (scalar ``query``:
    work = its candidates; ``_score_batch``: queries x candidate width).

    Cosine work of at least ``use_kernel_threshold`` rows scores on the
    device (``similarity_scores``, or K3 for a batch); anything smaller, and
    every other similarity, scores on the host with the configured function,
    which divides by the norms where a kernel takes a plain dot.  The store's
    device plays no part: a CUDA store takes the same route as a CPU one.
    """
    return similarity_name == "cosine" and work >= use_kernel_threshold


@dataclasses.dataclass
class StoreExport:
    """A migratable slice of a ``ReuseStore`` (DESIGN.md §Store migration).

    ``ids`` are the *source* slot ids in LRU order (oldest first) — purely
    informational after extraction; the destination allocates its own slots.
    ``buckets`` carries the admission-time LSH buckets (N, T), so landing
    the slice via ``insert_batch(embeddings, results, buckets=buckets)``
    preserves exactly the table placement the entries were named under.
    """

    ids: List[int]
    embeddings: np.ndarray       # (N, dim) float32, normalized as stored
    results: List[Any]
    buckets: np.ndarray          # (N, T) admission-time bucket indices

    def __len__(self) -> int:
        return len(self.ids)


def _auto_bucket_cap(params: LSHParams, capacity: int) -> int:
    """Slots per bucket: ~4x the uniform fill at capacity, clamped to [8, 512]."""
    nb = max(params.num_buckets, 1)
    est = -(-4 * max(capacity, 1) // nb)
    cap = max(8, min(512, est))
    per_bucket_budget = _MAX_TABLE_SLOTS // max(params.num_tables * nb, 1)
    if per_bucket_budget < 4:
        raise ValueError(
            f"num_tables*num_buckets={params.num_tables * nb} too large for "
            "array-native bucket tables; reduce num_buckets or num_tables")
    return min(cap, max(per_bucket_budget, 4))


class ReuseStore:
    def __init__(
        self,
        lsh_params: LSHParams,
        capacity: int = 100_000,
        similarity: str = "cosine",
        use_kernel_threshold: int = 4096,
        bucket_cap: Optional[int] = None,
        page_size: int = DEFAULT_PAGE_SIZE,
        full_resync: bool = False,
        fused: bool = True,
        fused_min_batch: int = 64,
        device: DeviceLike = None,
    ):
        # the device mirrors and the kernels live on ``device`` (None ->
        # cuda; pass device="cpu" for the kernels' plain versions)
        self.device = resolve_device(device)
        self.lsh: LSH = get_lsh(lsh_params, self.device)
        self.params = lsh_params
        self.capacity = int(capacity)
        self.similarity_name = similarity
        self.similarity = get_similarity(similarity)
        self.use_kernel_threshold = use_kernel_threshold
        self.dim = lsh_params.dim
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        # paged embedding storage: host truth is a list of (page_size, dim)
        # pages (growth appends, never reallocates); the device mirror is one
        # (alloc_pages, page_size, dim) tensor synced page-at-a-time.  Pages
        # are rounded up to a multiple of 8 rows, as in the reference.
        self.page_size = -(-int(page_size) // 8) * 8
        # debug/bench knob: a dirty sync re-uploads every page (the seed's
        # whole-matrix invalidation); clean syncs stay free in both modes
        self.full_resync = bool(full_resync)
        self._pages: List[np.ndarray] = []
        self._n_slots = 0                      # high-water slot id
        self._dirty: set = set()               # host pages not yet on device
        self._emb_dev: Optional[torch.Tensor] = None  # (alloc, page_size, dim)
        self.sync_pages_total = 0
        self.sync_bytes_total = 0
        self.last_sync_pages = 0
        self._results: List[Any] = []
        self._buckets_of: List[Optional[np.ndarray]] = []  # per slot: (T,) ids
        self._free: List[int] = []
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # --- array-native LSH tables
        t, nb = lsh_params.num_tables, lsh_params.num_buckets
        self.bucket_cap = (int(bucket_cap) if bucket_cap is not None
                           else _auto_bucket_cap(lsh_params, self.capacity))
        self._slots = np.full((t, nb, self.bucket_cap), -1, np.int32)
        self._fill = np.zeros((t, nb), np.int32)
        self._cursor = np.zeros((t, nb), np.int32)  # ring position when full
        # --- device mirror of the slot tables (fused query path):
        # flat (t*nb, bucket_cap) int32, synced in _table_slab_rows-row slabs
        self.fused = bool(fused)
        self.fused_min_batch = int(fused_min_batch)
        self._table_rows = t * nb
        self._table_slab_rows = min(
            max(8, -(-_TABLE_SLAB_SLOTS // self.bucket_cap)), self._table_rows)
        self._slots_dev: Optional[torch.Tensor] = None
        self._tdirty: set = set()  # dirty table slab indices
        self.table_sync_pages_total = 0
        self.last_table_sync_pages = 0
        self.overflows = 0
        self.inserts = 0
        self.queries = 0
        # --- observability: which path answered the last query and how many
        # pages its device sync uploaded, plus running route counts
        self.fused_queries = 0
        self.staged_queries = 0
        self.last_query_fused = False
        self.last_query_sync_pages = 0
        self.candidate_counts: List[int] = []
        # RESERVOIR_SANITIZE arms post-mutation invariant audits; disarmed,
        # every hook below is a single bool test on the hot path
        self.sanitize = _sanitize.env_enabled()

    def __len__(self) -> int:
        return len(self._lru)

    # ----------------------------------------------------------------- pages
    @property
    def num_pages(self) -> int:
        """Host pages allocated (each ``page_size`` rows)."""
        return len(self._pages)

    @property
    def device_pages(self) -> int:
        """Pages in the device allocation (0 until the kernel path runs)."""
        return 0 if self._emb_dev is None else int(self._emb_dev.shape[0])

    def _row(self, idx: int) -> np.ndarray:
        return self._pages[idx // self.page_size][idx % self.page_size]

    @staticmethod
    def _page_runs(pg: np.ndarray):
        """Boundaries of equal-page runs in ``pg`` -> (starts, ends) arrays.

        Gather/scatter callers pass ascending slot ids, so runs == distinct
        pages and each run is one contiguous fancy-index; unsorted input is
        still correct, just split into more runs."""
        bounds = np.flatnonzero(pg[1:] != pg[:-1]) + 1
        return (np.concatenate(([0], bounds)),
                np.concatenate((bounds, [pg.size])))

    def _rows(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized host gather of slot ids through (page, offset)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return np.empty((0, self.dim), np.float32)
        pg = ids // self.page_size
        first = int(pg[0])
        if pg[-1] == first and (pg == first).all():  # common: one page
            return self._pages[first][ids - first * self.page_size]
        off = ids - pg * self.page_size
        out = np.empty((ids.size, self.dim), np.float32)
        for s, e in zip(*self._page_runs(pg)):
            # np.take with out= gathers straight into the slice (no temp);
            # the residual cost vs one contiguous fancy-index is a few
            # percent of a scalar query — the batched path gathers on device
            np.take(self._pages[pg[s]], off[s:e], axis=0, out=out[s:e])
        return out

    def _write_rows(self, ids: np.ndarray, embs: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        pg = ids // self.page_size
        off = ids - pg * self.page_size
        for s, e in zip(*self._page_runs(pg)):
            self._pages[pg[s]][off[s:e]] = embs[s:e]
            self._dirty.add(int(pg[s]))

    def sync_device(self, ensure: bool = False) -> int:
        """Upload dirty host pages into the device mirror; returns the number
        of embedding pages uploaded.

        A no-op until the batched kernel path has materialized the device
        buffer (small stores never pay for device residency); ``ensure=True``
        forces allocation — benchmarks and the serving commit path use it to
        move the upload off the query critical path.  Also drains the slot
        tables' dirty slabs once the fused query path has materialized the
        table mirror, so a post-insert eager sync covers both mirrors and
        steady-state fused queries are sync-free.
        """
        return self._sync(ensure)

    def _sync(self, ensure: bool, ensure_tables: bool = False) -> int:
        """``sync_device``, then with ``ensure_tables`` the table mirror's
        first upload (the fused query), as one ``store.sync`` span whose
        args are the pages, slabs and bytes uploaded (a slab counted whole)."""
        with _trace.span("store.sync") as sp:
            if sp:
                p0, s0, b0 = (self.sync_pages_total, self.table_sync_pages_total,
                              self.sync_bytes_total)
            if self._emb_dev is None and not ensure:
                self._sync_tables()
                n = 0
            else:
                n = self._sync_device()
                self._sync_tables()
            if ensure_tables:
                self._sync_tables(ensure=True)
            if sp:
                slabs = self.table_sync_pages_total - s0
                sp.note(pages=self.sync_pages_total - p0, slabs=slabs,
                        bytes=self.sync_bytes_total - b0
                        + slabs * self._table_slab_rows * self.bucket_cap * 4)
        return n

    def _sync_tables(self, ensure: bool = False) -> int:
        """Upload dirty slot-table slabs into the device table mirror.

        First sync uploads the whole flat (T * num_buckets, bucket_cap)
        array in one transfer; afterwards each table mutation dirties only
        the slab(s) holding its bucket rows, so sync cost is O(dirty slabs).
        ``_fill`` is intentionally not mirrored: the tables keep every slot
        at position >= fill equal to -1 (property-tested invariant), so the
        device side reads validity from the slot values alone.
        """
        if self._slots_dev is None and not ensure:
            return 0
        n_rows = self._table_rows
        flat = self._slots.reshape(n_rows, self.bucket_cap)
        if self._slots_dev is None:
            self._slots_dev = torch.from_numpy(flat.copy()).to(self.device)
            self._tdirty.clear()
            pages = -(-n_rows // self._table_slab_rows)
        elif self._tdirty:
            rows = self._table_slab_rows
            uploaded = sorted(self._tdirty)
            for p in uploaded:
                start = min(p * rows, max(n_rows - rows, 0))
                # in place: the port overwrites the slab of the device tensor
                self._slots_dev[start:start + rows].copy_(
                    torch.from_numpy(flat[start:start + rows]))
            self._tdirty.clear()
            pages = len(uploaded)
            if self.sanitize:
                self._audit_table_sync(uploaded)
        else:
            pages = 0
        self.last_table_sync_pages = pages
        self.table_sync_pages_total += pages
        return pages

    def _sync_device(self) -> int:
        n_pages = len(self._pages)
        if n_pages == 0:
            self.last_sync_pages = 0
            return 0
        if self._emb_dev is None:
            alloc = 1
            while alloc < n_pages:
                alloc *= 2
            self._emb_dev = torch.zeros(
                (alloc, self.page_size, self.dim), dtype=torch.float32,
                device=self.device)
            self._dirty.update(range(n_pages))  # first residency: upload all
        elif self._emb_dev.shape[0] < n_pages:
            # growth: double the device allocation with a device-side copy —
            # previously-synced pages never cross the host/device boundary
            alloc = int(self._emb_dev.shape[0])
            while alloc < n_pages:
                alloc *= 2
            pad = self._emb_dev.new_zeros(
                (alloc - self._emb_dev.shape[0], self.page_size, self.dim))
            self._emb_dev = torch.cat([self._emb_dev, pad])
        if self.full_resync and self._dirty:
            # bench knob: emulate the pre-paging behaviour — any dirty row
            # invalidates the whole matrix (but an already-clean store stays
            # clean, exactly like the seed's version check)
            self._dirty.update(range(n_pages))
        uploaded = sorted(self._dirty)
        for p in uploaded:
            # in place: the port overwrites the page of the device tensor
            self._emb_dev[p].copy_(torch.from_numpy(self._pages[p]))
        self._dirty.clear()
        self.last_sync_pages = len(uploaded)
        self.sync_pages_total += len(uploaded)
        self.sync_bytes_total += len(uploaded) * self.page_size * self.dim * 4
        if self.sanitize:
            self._audit_sync(uploaded)
        return len(uploaded)

    # ------------------------------------------------------ sanitizer audits
    def _san_fail(self, check: str, message: str, **details: Any) -> None:
        san = _sanitize.current()
        raise _sanitize.SanitizerError(
            check, message, san.provenance() if san is not None else "",
            **details)

    def _audit_sync(self, uploaded: Sequence[int]) -> None:
        """Post-``_sync_device`` audit (armed only): the dirty set must be
        fully drained and every uploaded device page must match its host
        page bit-for-bit (O(uploaded), not O(store))."""
        if self._dirty:
            self._san_fail(
                "dirty-page-conservation",
                f"sync_device left {len(self._dirty)} page(s) dirty "
                f"({sorted(self._dirty)[:8]}...): uploads were dropped",
                dirty=sorted(self._dirty))
        for p in uploaded:
            dev = _host(self._emb_dev[p])
            if not np.array_equal(dev, self._pages[p]):
                bad = int(np.flatnonzero(
                    (dev != self._pages[p]).any(axis=-1))[0])
                self._san_fail(
                    "mirror-divergence",
                    f"device page {p} diverges from host after upload "
                    f"(first bad row {bad}): the store would answer "
                    "queries from stale embeddings", page=p, row=bad)

    def _audit_table_sync(self, uploaded: Sequence[int]) -> None:
        """Post-``_sync_tables`` audit (armed only): uploaded slot-table
        slabs must match the host tables bit-for-bit."""
        if self._tdirty:
            self._san_fail(
                "table-dirty-conservation",
                f"_sync_tables left {len(self._tdirty)} slab(s) dirty",
                tdirty=sorted(self._tdirty))
        flat = self._slots.reshape(self._table_rows, self.bucket_cap)
        rows = self._table_slab_rows
        for p in uploaded:
            start = min(p * rows, max(self._table_rows - rows, 0))
            dev = _host(self._slots_dev[start:start + rows])
            if not np.array_equal(dev, flat[start:start + rows]):
                self._san_fail(
                    "table-mirror-divergence",
                    f"device slot-table slab {p} diverges from host after "
                    "upload: the fused query would gather wrong slots",
                    slab=p)

    def _audit_bucket_rows(self, pairs) -> None:
        """Trailing-(-1) validity of touched bucket rows (armed only): each
        row must be ``fill`` valid slot ids then -1 padding — the fused
        kernel reads validity from the slot values alone, so a hole or a
        stale id past ``fill`` silently corrupts every gather."""
        for t, b in pairs:
            row = self._slots[t, b]
            f = int(self._fill[t, b])
            if (row[:f] < 0).any() or (f < row.size and
                                       (row[f:] != -1).any()):
                self._san_fail(
                    "slot-table-trailing-invalid",
                    f"bucket row (table={t}, bucket={b}) violates the "
                    f"trailing-(-1) invariant: fill={f}, row={row.tolist()}",
                    table=int(t), bucket=int(b), fill=f)

    def audit_mirror(self) -> None:
        """Deep coherence audit of *every* device-resident page and table
        slab against host truth (O(store) — tests and post-migration
        checks, not the hot path).  Clean mirrors with pending dirty pages
        are fine (the dirt is by definition not uploaded yet)."""
        if self._emb_dev is not None:
            clean = [p for p in range(len(self._pages))
                     if p not in self._dirty]
            held_dirty, self._dirty = self._dirty, set()
            try:
                self._audit_sync(clean)
            finally:
                self._dirty = held_dirty
        if self._slots_dev is not None and not self._tdirty:
            self._audit_table_sync(
                range(-(-self._table_rows // self._table_slab_rows)))
        self._audit_bucket_rows(
            (t, b) for t in range(self.params.num_tables)
            for b in range(self.params.num_buckets))

    # ---------------------------------------------------------------- tables
    def _tslab(self, t: int, b: int) -> int:
        """Table-mirror sync slab holding bucket row (t, b)."""
        return (t * self.params.num_buckets + b) // self._table_slab_rows

    def _table_add(self, idx: int, buckets: np.ndarray) -> None:
        cap = self.bucket_cap
        for t in range(self.params.num_tables):
            b = int(buckets[t])
            self._tdirty.add(self._tslab(t, b))
            f = int(self._fill[t, b])
            if f < cap:
                self._slots[t, b, f] = idx
                self._fill[t, b] = f + 1
            else:  # full bucket: ring-overwrite the oldest slot
                c = int(self._cursor[t, b])
                self._slots[t, b, c] = idx
                self._cursor[t, b] = (c + 1) % cap
                self.overflows += 1
        if self.sanitize:
            self._audit_bucket_rows(
                (t, int(buckets[t]))
                for t in range(self.params.num_tables))

    def _table_remove(self, idx: int, buckets: np.ndarray) -> None:
        """Remove idx from its buckets (swap-with-last keeps slots compact)."""
        for t in range(self.params.num_tables):
            b = int(buckets[t])
            row = self._slots[t, b]
            f = int(self._fill[t, b])
            pos = np.nonzero(row[:f] == idx)[0]
            if pos.size:  # absent if ring-overflow already displaced it
                p = int(pos[0])
                row[p] = row[f - 1]
                row[f - 1] = -1
                self._fill[t, b] = f - 1
                self._tdirty.add(self._tslab(t, b))
        if self.sanitize:
            self._audit_bucket_rows(
                (t, int(buckets[t]))
                for t in range(self.params.num_tables))

    def _candidate_matrix(self, probes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B, T, P) probe buckets -> ((B, C) slot ids, (B,) counts).

        Rows are front-packed valid store ids (slot order) with -1 padding; C
        is trimmed to the densest query's candidate count.  Ids hit through
        several tables appear once per table — dedup is the caller's concern
        (``query_batch`` sorts + compacts, ``candidates`` uses np.unique), so
        this stays a branch-free O(candidates) gather.
        """
        b = probes.shape[0]
        t_idx = np.arange(self.params.num_tables)[None, :, None]
        raw = self._slots[t_idx, probes].reshape(b, -1)
        valid = raw >= 0
        counts = valid.sum(axis=1).astype(np.int64)
        width = max(int(counts.max()) if b else 0, 1)
        out = np.full((b, width), -1, np.int32)
        rows, cols = np.nonzero(valid)
        starts = np.zeros(b + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        out[rows, np.arange(rows.size) - starts[rows]] = raw[rows, cols]
        return out, counts

    # ---------------------------------------------------------------- insert
    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        idx = self._n_slots
        if idx >= len(self._pages) * self.page_size:
            self._pages.append(np.zeros((self.page_size, self.dim), np.float32))
            self._results.extend([None] * self.page_size)
            self._buckets_of.extend([None] * self.page_size)
        self._n_slots += 1
        return idx

    def remove(self, idx: int) -> None:
        """Drop a live entry: detach it from the LSH tables, tombstone its
        page row (zeroed + page dirtied) so the device mirror can never
        return the stale embedding after the slot id is reused, and recycle
        the slot."""
        if idx not in self._lru:
            raise KeyError(f"slot {idx} is not live")
        del self._lru[idx]
        self._release(idx)

    def _evict_lru(self) -> None:
        idx, _ = self._lru.popitem(last=False)
        self._release(idx)

    def _release(self, idx: int) -> None:
        self._table_remove(idx, self._buckets_of[idx])
        self._results[idx] = None
        self._buckets_of[idx] = None
        self._row(idx)[:] = 0.0          # tombstone the embedding row
        self._dirty.add(idx // self.page_size)
        self._free.append(idx)

    def _insert_hashed(self, emb: np.ndarray, result: Any, buckets: np.ndarray) -> int:
        while len(self._lru) >= self.capacity > 0:
            self._evict_lru()
        idx = self._alloc()
        self._row(idx)[:] = emb
        self._dirty.add(idx // self.page_size)
        self._results[idx] = result
        self._buckets_of[idx] = buckets
        self._table_add(idx, buckets)
        self._lru[idx] = None
        self.inserts += 1
        return idx

    def insert(self, embedding: np.ndarray, result: Any) -> int:
        emb = normalize(np.asarray(embedding, np.float32).reshape(-1))
        return self._insert_hashed(emb, result, self.lsh.hash_one(emb))

    def insert_batch(self, embeddings: np.ndarray, results: Sequence[Any],
                     buckets: Optional[np.ndarray] = None) -> List[int]:
        """Bulk insert: one batched LSH hash + one grouped table scatter.

        Bucket writes are vectorized per table with a conflict-free grouped
        scatter: items are stably grouped by destination bucket, each group
        fills its bucket's free slots front-to-back and ring-overwrites from
        the bucket cursor beyond ``bucket_cap`` — bit-identical table state
        (slots, fills, cursors, overflow count) to the scalar insert loop.
        Falls back to the scalar loop whenever the insert would evict:
        scalar evictions interleave with inserts (each insert reuses the
        slot it just freed), an order the grouped scatter cannot reproduce,
        and parity with the scalar path outranks speed at capacity.

        ``buckets``: precomputed (N, T) LSH buckets for these embeddings
        (e.g. from naming at admission) — skips the second hash dispatch.
        """
        with _trace.span("store.insert"):
            embs = normalize(np.atleast_2d(np.asarray(embeddings, np.float32)))
            if buckets is None:
                buckets = _host(self.lsh.hash_batch(embs))  # (N, T)
            else:
                buckets = np.asarray(buckets)
            n = embs.shape[0]
            if self.capacity > 0 and len(self._lru) + n > self.capacity:
                with _trace.span("store.evict") as sp:
                    if sp:
                        sp.note(tasks=n)
                    return [self._insert_hashed(emb, res, bks)
                            for emb, res, bks in zip(embs, results, buckets)]
            ids = np.asarray([self._alloc() for _ in range(n)], np.int32)
            self._write_rows(ids, embs)
            for i, (idx, res) in enumerate(zip(ids, results)):
                idx = int(idx)
                self._results[idx] = res
                self._buckets_of[idx] = buckets[i]
                self._lru[idx] = None
            self.inserts += n
            self._table_add_batch(ids, buckets)
            return [int(i) for i in ids]

    def _table_add_batch(self, ids: np.ndarray, buckets: np.ndarray) -> None:
        """Grouped (table, bucket) scatter of ``ids`` into the slot arrays.

        Per table: stable-sort items by bucket, rank them within their
        group, and write free-slot fills and ring overwrites in one fancy
        assignment each (duplicate ring positions keep numpy's last-write-
        wins order == sequential semantics).
        """
        cap = self.bucket_cap
        n = ids.shape[0]
        rank_base = np.arange(n, dtype=np.int64)
        touched = [] if self.sanitize else None
        for t in range(self.params.num_tables):
            order = np.argsort(buckets[:, t], kind="stable")
            bs = buckets[order, t]
            ids_s = ids[order]
            uniq, starts, counts = np.unique(
                bs, return_index=True, return_counts=True)
            rank = rank_base - np.repeat(starts, counts)
            fill_g = self._fill[t, uniq].astype(np.int64)
            cur_g = self._cursor[t, uniq].astype(np.int64)
            take_g = np.minimum(counts, np.maximum(cap - fill_g, 0))
            fill_i = np.repeat(fill_g, counts)
            cur_i = np.repeat(cur_g, counts)
            take_i = np.repeat(take_g, counts)
            slot = np.where(rank < take_i, fill_i + rank,
                            (cur_i + rank - take_i) % cap)
            self._slots[t, bs, slot] = ids_s
            self._fill[t, uniq] = fill_g + take_g
            over_g = counts - take_g
            self._cursor[t, uniq] = np.where(
                over_g > 0, (cur_g + over_g) % cap, cur_g)
            self.overflows += int(over_g.sum())
            self._tdirty.update(
                ((t * self._slots.shape[1] + uniq)
                 // self._table_slab_rows).tolist())
            if touched is not None:
                touched.extend((t, int(b)) for b in uniq)
        if touched is not None:
            self._audit_bucket_rows(touched)

    # ----------------------------------------------------------------- query
    def candidates(self, embedding: np.ndarray) -> List[int]:
        emb = normalize(np.asarray(embedding, np.float32).reshape(-1))
        probes = self.lsh.probe_one(emb)  # (T, P)
        cand, counts = self._candidate_matrix(probes[None])
        return [int(i) for i in np.unique(cand[0, : counts[0]])]

    def query(
        self, embedding: np.ndarray, threshold: float = 0.0
    ) -> Tuple[Optional[Any], float, Optional[int]]:
        """Nearest stored task; returns (result, similarity, idx) or misses."""
        self.queries += 1
        self.staged_queries += 1
        self.last_query_fused = False
        self.last_query_sync_pages = 0
        cand = self.candidates(embedding)
        self.candidate_counts.append(len(cand))
        if not cand:
            return None, -1.0, None
        emb = normalize(np.asarray(embedding, np.float32).reshape(-1))
        cand_arr = np.asarray(cand, np.int64)
        store = self._rows(cand_arr)
        if scores_on_device(self.similarity_name, len(cand), self.use_kernel_threshold):
            sims = _host(_kops.similarity_scores(
                torch.from_numpy(emb[None]).to(self.device),
                torch.from_numpy(store).to(self.device)))[0]
        else:
            sims = self.similarity(emb, store)
        best = int(np.argmax(sims))
        idx, sim = int(cand_arr[best]), float(sims[best])
        if sim < threshold:
            return None, sim, None
        self._lru.move_to_end(idx)  # reuse refreshes LRU position
        return self._results[idx], sim, idx

    def query_batch(
        self,
        embeddings: np.ndarray,
        thresholds: Union[float, Sequence[float], np.ndarray] = 0.0,
        peek: bool = False,
    ) -> List[Tuple[Optional[Any], float, Optional[int]]]:
        """Batched ``query``: one fused pipeline call on the hot path.

        Large cosine batches (``len >= fused_min_batch`` and enough gather
        work to clear ``use_kernel_threshold``) run the fused pipeline
        (``kernels.ops.reuse_query_top1``): LSH probe math, slot-table
        gather, masked cosine top-1 (one kernel launch) and candidate
        counting over the device mirrors.  Small batches and non-cosine
        stores keep the host-staged path (probe call + host candidate matrix
        + gather/score kernel), which doubles as the fused path's oracle.

        ``thresholds`` is a scalar or per-query sequence.  Returns one
        (result, similarity, idx) triple per query with the same hit/miss
        semantics as the scalar path; every query is scored against the store
        state at call time (a batch cannot reuse results inserted for earlier
        queries of the same batch).  ``peek=True`` is a pure read: no LRU
        refresh and no query/candidate statistics (the forwarding-error
        oracle and cross-replica probes must not perturb cache state).

        The call is a ``store.query`` span of the wall recorder (args: the
        queries, the path, the distinct (query, candidate) pairs).
        """
        with _trace.span("store.query") as sp:
            out = self._query_batch(embeddings, thresholds, peek)
            if sp:
                n, counts = len(out), self.candidate_counts
                sp.note(queries=n, fused=self.last_query_fused,
                        pairs=int(sum(counts[len(counts) - n:])) if not peek else None)
        return out

    def _query_batch(
        self,
        embeddings: np.ndarray,
        thresholds: Union[float, Sequence[float], np.ndarray],
        peek: bool,
    ) -> List[Tuple[Optional[Any], float, Optional[int]]]:
        embs = normalize(np.atleast_2d(np.asarray(embeddings, np.float32)))
        n = embs.shape[0]
        if not peek:
            self.queries += n
        thr = np.asarray(thresholds, np.float32)
        if thr.ndim == 0:
            thr = np.full(n, float(thr), np.float32)
        elif thr.shape != (n,):
            raise ValueError("thresholds must be scalar or length-B")
        if not self._lru:
            if not peek:
                self.candidate_counts.extend([0] * n)
            return [(None, -1.0, None)] * n
        p0 = self.sync_pages_total + self.table_sync_pages_total
        if self._use_fused(n):
            # peek reads record no statistics, so the fused path skips the
            # candidate-count epilogue entirely (counts is None)
            val, idx, counts = self._query_fused(embs, need_counts=not peek)
            self.last_query_fused = True
            if not peek:
                self.fused_queries += n
        else:
            val, idx, counts = self._query_staged(embs)
            self.last_query_fused = False
            if not peek:
                self.staged_queries += n
        self.last_query_sync_pages = (
            self.sync_pages_total + self.table_sync_pages_total - p0)
        out: List[Tuple[Optional[Any], float, Optional[int]]] = []
        with _trace.span("store.results"):
            if not peek:
                self.candidate_counts.extend(int(c) for c in counts)
            for i in range(n):
                # idx < 0 iff the query had zero live candidates (tables hold
                # only live ids, so every gathered candidate is scoreable)
                if idx[i] < 0:
                    out.append((None, -1.0, None))
                    continue
                sim = float(val[i])
                if sim < thr[i]:
                    out.append((None, sim, None))
                    continue
                j = int(idx[i])
                if not peek:
                    self._lru.move_to_end(j)
                out.append((self._results[j], sim, j))
        return out

    def _use_fused(self, n: int) -> bool:
        """Route a batch of ``n`` queries through the fused pipeline?

        Cosine only (the fused kernel is a dot-product top-1), and only when
        the batch is big enough that the fused call beats the host-staged
        path: ``fused_min_batch`` gates out small simulator windows, and the raw
        gather work n * T * P * bucket_cap must clear
        ``use_kernel_threshold``.
        """
        if not (self.fused and self.similarity_name == "cosine"):
            return False
        width = (self.params.num_tables * self.params.num_probes
                 * self.bucket_cap)
        return (n >= self.fused_min_batch
                and n * width >= self.use_kernel_threshold)

    def _query_fused(
        self, embs: np.ndarray, need_counts: bool = True
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Fused query over the device mirrors (see _use_fused): the
        ``store.sync``, ``store.dispatch`` (the enqueue of the probe math,
        K1 and the count epilogue) and ``store.read`` (the host reads of
        val, idx and counts) spans."""
        # embeddings O(dirty pages), slot tables O(dirty slabs)
        self._sync(ensure=True, ensure_tables=True)
        with _trace.span("store.dispatch"):
            val, idx, counts = _kops.reuse_query_top1(
                torch.from_numpy(embs).to(self.device), self.lsh, self._slots_dev,
                self._emb_dev, need_counts=need_counts)
        with _trace.span("store.read"):
            return (_host(val), _host(idx),
                    None if counts is None else _host(counts).astype(np.int64))

    def _query_staged(
        self, embs: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-staged query: probe dispatch + host candidate matrix +
        gather/score call.  Oracle for the fused path; default for small
        batches and non-cosine similarities.  One ``store.staged`` span."""
        with _trace.span("store.staged"):
            n = embs.shape[0]
            probes = _host(self.lsh.probe_batch(embs))  # (B, T, P)
            cand, counts = self._candidate_matrix(probes)
            # Dedup per-table duplicates: sort each row, keep first occurrences,
            # re-compact.  This matches the scalar path both in candidate_counts
            # stats and in argmax tie-breaking (candidates() returns ascending
            # unique ids), and shrinks the kernel's candidate dimension.
            srt = np.sort(cand, axis=1)
            uniq = np.ones(srt.shape, bool)
            uniq[:, 1:] = srt[:, 1:] != srt[:, :-1]
            uniq &= srt >= 0
            counts = uniq.sum(axis=1).astype(np.int64)
            if counts.max() == 0:
                return (np.full(n, -np.inf, np.float32),
                        np.full(n, -1, np.int64), counts)
            width = max(int(counts.max()), 1)
            dedup = np.full((n, width), -1, np.int32)
            rows, cols = np.nonzero(uniq)
            starts = np.zeros(n + 1, np.int64)
            np.cumsum(counts, out=starts[1:])
            dedup[rows, np.arange(rows.size) - starts[rows]] = srt[rows, cols]
            val, idx = self._score_batch(embs, dedup, counts)
            return val, idx, counts

    def _score_batch(
        self, embs: np.ndarray, cand: np.ndarray, counts: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Score the (B, C) candidate matrix -> ((B,) best sim, (B,) best id).

        Rows of ``cand`` are ascending unique ids, front-packed, -1 padded.
        Cosine stores use the gather/score kernel (K3) when the gather is
        big enough to pay for the launch (``scores_on_device``: at least
        ``use_kernel_threshold`` rows): candidates gather straight out of
        the paged device mirror after an O(dirty pages) sync.  Smaller
        workloads — notably single-row oracle peeks — score in numpy like
        the scalar path, on a CUDA store as on a CPU one.  Other similarity
        measures always score per query with the configured function.
        """
        work = embs.shape[0] * cand.shape[1]
        if scores_on_device(self.similarity_name, work, self.use_kernel_threshold):
            self.sync_device(ensure=True)
            val, idx = _kops.gathered_top1(
                torch.from_numpy(embs).to(self.device), self._emb_dev,
                torch.from_numpy(cand).to(self.device))
            return _host(val), _host(idx)
        val = np.full(embs.shape[0], -np.inf, np.float32)
        idx = np.full(embs.shape[0], -1, np.int64)
        for i in range(embs.shape[0]):
            ids = cand[i, : counts[i]]
            if ids.size == 0:
                continue
            sims = self.similarity(embs[i], self._rows(ids))
            best = int(np.argmax(sims))
            val[i], idx[i] = sims[best], int(ids[best])
        return val, idx

    # ------------------------------------------------------------ inspection
    def embedding_of(self, idx: int) -> np.ndarray:
        return self._row(idx)

    def result_of(self, idx: int) -> Any:
        return self._results[idx]

    def buckets_of(self, idx: int) -> np.ndarray:
        """Admission-time (T,) LSH buckets of a live entry."""
        if idx not in self._lru:
            raise KeyError(f"slot {idx} is not live")
        return self._buckets_of[idx]

    def live_ids(self) -> List[int]:
        """Slot ids currently resident (LRU order, oldest first)."""
        return list(self._lru)

    def live_buckets(self) -> Tuple[List[int], np.ndarray]:
        """(live ids in LRU order, their (N, T) admission-time buckets)."""
        ids = list(self._lru)
        if not ids:
            t = self.params.num_tables
            return ids, np.empty((0, t), np.int64)
        return ids, np.stack([np.asarray(self._buckets_of[i], np.int64)
                              for i in ids])

    # ------------------------------------------------------------- migration
    def ids_in_bucket_range(self, lo: int, hi: int) -> List[int]:
        """Live ids (LRU order) whose admission buckets majority-fall in
        [lo, hi].

        "Majority" is a strict per-entry vote (more than half the T tables)
        — the single-range analogue of the rFIB's per-EN majority routing.
        Network-level migration diffs the full multi-EN partition instead
        (``rfib.owners_batch``); this helper serves single-range callers
        and the property harness.
        """
        t = self.params.num_tables
        out = []
        for idx in self._lru:
            bks = self._buckets_of[idx]
            inside = sum(1 for b in bks if lo <= int(b) <= hi)
            if 2 * inside > t:
                out.append(idx)
        return out

    def export(self, ids: Sequence[int]) -> StoreExport:
        """Pure read of live entries -> ``StoreExport`` (order preserved).

        Embeddings gather through the paged (page, offset) decomposition
        (``_rows``); results and admission buckets copy by reference.
        """
        ids = [int(i) for i in ids]
        for i in ids:
            if i not in self._lru:
                raise KeyError(f"slot {i} is not live")
        t = self.params.num_tables
        buckets = (np.stack([np.asarray(self._buckets_of[i], np.int64)
                             for i in ids])
                   if ids else np.empty((0, t), np.int64))
        return StoreExport(
            ids=ids,
            embeddings=np.array(self._rows(np.asarray(ids, np.int64))),
            results=[self._results[i] for i in ids],
            buckets=buckets,
        )

    def extract(self, ids: Sequence[int]) -> StoreExport:
        """Export ``ids`` and remove them from this store (migration source).

        Removal rides the existing tombstone path (``remove``): table
        detach + zeroed page row + dirty-page mark, so the next device sync
        stays O(touched pages) and a reused slot id can never resurrect the
        migrated embedding.
        """
        exp = self.export(ids)
        for i in exp.ids:
            self.remove(i)
        return exp
