"""Paged staging store — page-table allocator, LRU spill tier, dedup.

The staging area used to reserve one flat tmpfs region per dataset, so a
single slow SAVIME hop (or one jumbo dataset) pushed the global memory
watermark up and squeezed ``_credit_grant`` for every producer at once.
This module rebuilds that substrate the way a kv-cache page table builds
device memory (DESIGN.md §11):

  * **page-table allocator** — one tmpfs *arena* file carved into
    fixed-size page frames (default 64 KiB).  A dataset is a
    :class:`PageTable`: an ordered list of physical pages, possibly
    non-contiguous in the arena.  Clients still reach frames with
    one-sided mmap writes — the arena is the registered memory region,
    the page table is the address translation.
  * **LRU spill tier** — *sealed* (fully received) pages are evictable:
    when the free list runs dry, the coldest unpinned sealed pages are
    written to per-page files under ``spill_dir`` and their frames
    reused.  ``read`` pulls spilled pages back on access; the forward
    path gathers them straight from disk (a streaming read) without
    displacing hot pages.  Unsealed pages (mid-ingest, possibly being
    written one-sided by a client) and pinned pages (mid-forward) never
    move.
  * **content-addressed dedup** — at seal time each page's content is
    hashed (BLAKE2b-128 over the used bytes); a page whose digest is
    already resident drops its frame and refcounts the existing physical
    page.  Checkpoint streams and iterative outputs that repeat most of
    their bytes cost one copy; a shared page is freed only when its last
    referencing dataset releases it.

Credit grants derive from *available pages* — free frames plus sealed
evictable ones — so small datasets keep flowing while a big cold one
spills, instead of every producer stalling on one global watermark.
"""
from __future__ import annotations

import collections
import hashlib
import mmap
import os
import secrets
import threading
from typing import Optional

import numpy as np

DEFAULT_PAGE_BYTES = 64 << 10


class PageStoreFull(MemoryError):
    """No frame can be freed (every resident page is unsealed or pinned).
    Callers fall back to the flat disk tier."""


class _PhysPage:
    """One physical page: an arena frame, or a spill file when cold."""

    __slots__ = ("frame", "spill_path", "used", "refs", "pins", "digest",
                 "sealed")

    def __init__(self, frame: int, used: int):
        self.frame: Optional[int] = frame   # arena frame idx; None = spilled
        self.spill_path: Optional[str] = None
        self.used = used                    # bytes of this page in use
        self.refs = 1                       # page tables referencing it
        self.pins = 0                       # readers forbidding eviction
        self.digest: Optional[tuple] = None  # dedup key once sealed
        self.sealed = False

    @property
    def resident(self) -> bool:
        return self.frame is not None


class PageTable:
    """Per-dataset page list (ordered; pages may be shared via dedup)."""

    __slots__ = ("table_id", "nbytes", "pages", "sealed", "freed")

    def __init__(self, table_id: str, nbytes: int, pages: list):
        self.table_id = table_id
        self.nbytes = nbytes
        self.pages: list[_PhysPage] = pages
        self.sealed = False
        self.freed = False

    @property
    def n_pages(self) -> int:
        return len(self.pages)


class PageStore:
    """Fixed-frame arena + page tables + spill tier + dedup index.

    Thread-safe: one lock guards the free list, LRU, dedup index and
    counters.  Views handed out by :meth:`segments` outlive the lock —
    that is safe because only *sealed unpinned* pages can be evicted, and
    segments are only used while a page is unsealed (ingest) or pinned
    (forward).
    """

    _GUARDED_BY = {
        "_free": "_lock",
        "_lru": "_lock",
        "_n_evictable": "_lock",
        "_by_digest": "_lock",
        "_spill_files": "_lock",
        "_seq": "_lock",
        "_closed": "_lock",
        "counters": "_lock",
        "_mm": "_lock",
        "_view": "_lock",
    }

    def __init__(self, capacity: int, page_bytes: int = DEFAULT_PAGE_BYTES,
                 mem_dir: str = "/dev/shm", spill_dir: str = "/tmp",
                 dedup: bool = False):
        if page_bytes < 1:
            raise ValueError(f"page_bytes must be >= 1, got {page_bytes}")
        self.page_bytes = page_bytes
        self.n_frames = max(1, capacity // page_bytes)
        self.dedup = dedup
        os.makedirs(mem_dir, exist_ok=True)
        os.makedirs(spill_dir, exist_ok=True)
        self.spill_dir = spill_dir
        self.arena_bytes = self.n_frames * page_bytes
        self.arena_path = os.path.join(
            mem_dir, f"arena-{os.getpid()}-{secrets.token_hex(3)}")
        self._fd = os.open(self.arena_path, os.O_RDWR | os.O_CREAT, 0o600)
        os.ftruncate(self._fd, self.arena_bytes)
        self._mm = mmap.mmap(self._fd, self.arena_bytes)
        self._view = np.frombuffer(self._mm, dtype=np.uint8)
        self._lock = threading.Lock()
        self._free: list[int] = list(range(self.n_frames - 1, -1, -1))
        # LRU of sealed+resident pages, oldest first; pinned entries stay
        # in the dict but are skipped by eviction (and not counted
        # evictable)
        self._lru: "collections.OrderedDict[_PhysPage, None]" = \
            collections.OrderedDict()
        self._n_evictable = 0
        self._by_digest: dict[tuple, _PhysPage] = {}
        self._spill_files: dict[str, int] = {}   # path -> live bytes
        self._seq = 0
        self._closed = False
        self.counters = {
            "page_bytes": page_bytes, "pages_total": self.n_frames,
            "spill_outs": 0, "spill_ins": 0,
            "spill_bytes_out": 0, "spill_bytes_in": 0,
            "dedup_hits": 0, "dedup_saved_bytes": 0,
            "peak_mem_used": 0,
        }

    # -- allocation ------------------------------------------------------
    def alloc(self, nbytes: int) -> PageTable:
        """Allocate frames for ``nbytes`` (spilling cold pages to make
        room).  Raises :class:`PageStoreFull` when the demand cannot be
        met even after spilling everything evictable."""
        n = -(-nbytes // self.page_bytes) if nbytes else 0
        with self._lock:
            if n > self.n_frames:
                raise PageStoreFull(
                    f"{n} pages wanted, store holds {self.n_frames}")
            self._reclaim(n)
            pages = []
            for i in range(n):
                used = self.page_bytes if i < n - 1 \
                    else nbytes - (n - 1) * self.page_bytes
                pages.append(_PhysPage(self._free.pop(), used))
            self._seq += 1
            table = PageTable(f"t{self._seq}", nbytes, pages)
            self.counters["peak_mem_used"] = max(
                self.counters["peak_mem_used"],
                (self.n_frames - len(self._free)) * self.page_bytes)
        return table

    def _reclaim(self, n: int) -> None:  # holds: self._lock
        """Evict cold sealed pages until >= n frames are free (locked)."""
        while len(self._free) < n:
            victim = next((p for p in self._lru if p.pins == 0), None)
            if victim is None:
                raise PageStoreFull(
                    f"need {n} pages, {len(self._free)} free and nothing "
                    "evictable (all resident pages unsealed or pinned)")
            self._evict(victim)

    def _evict(self, phys: _PhysPage) -> None:  # holds: self._lock
        path = os.path.join(
            self.spill_dir, f"page-{os.getpid()}-{id(phys):x}")
        base = phys.frame * self.page_bytes
        with open(path, "wb") as f:
            f.write(self._mm[base:base + phys.used])
        phys.spill_path = path
        self._spill_files[path] = phys.used
        self._free.append(phys.frame)
        phys.frame = None
        self._lru_remove(phys)
        self.counters["spill_outs"] += 1
        self.counters["spill_bytes_out"] += phys.used

    def _promote(self, phys: _PhysPage) -> None:  # holds: self._lock
        """Pull one spilled page back into a frame (locked)."""
        self._reclaim(1)
        frame = self._free.pop()
        base = frame * self.page_bytes
        with open(phys.spill_path, "rb") as f:
            data = f.read(phys.used)
        self._mm[base:base + phys.used] = data
        os.unlink(phys.spill_path)
        self._spill_files.pop(phys.spill_path, None)
        phys.spill_path = None
        phys.frame = frame
        self._lru_insert(phys)
        self.counters["spill_ins"] += 1
        self.counters["spill_bytes_in"] += phys.used
        self.counters["peak_mem_used"] = max(
            self.counters["peak_mem_used"],
            (self.n_frames - len(self._free)) * self.page_bytes)

    # -- LRU bookkeeping (locked) ---------------------------------------
    def _lru_insert(self, phys: _PhysPage) -> None:  # holds: self._lock
        if phys not in self._lru:
            self._lru[phys] = None
            if phys.pins == 0:
                self._n_evictable += 1

    def _lru_remove(self, phys: _PhysPage) -> None:  # holds: self._lock
        if phys in self._lru:
            del self._lru[phys]
            if phys.pins == 0:
                self._n_evictable = max(0, self._n_evictable - 1)

    def _touch(self, phys: _PhysPage) -> None:  # holds: self._lock
        if phys in self._lru:
            self._lru.move_to_end(phys)

    # -- lifecycle of a table -------------------------------------------
    def seal(self, table: PageTable) -> None:
        """Dataset fully received: its pages become evictable, and (with
        dedup on) content-identical pages collapse onto one copy."""
        with self._lock:
            if table.sealed or table.freed:
                return
            table.sealed = True
            for i, phys in enumerate(table.pages):
                if phys.sealed:        # already-shared page (intra-table)
                    continue
                phys.sealed = True
                if self.dedup:
                    base = phys.frame * self.page_bytes
                    dg = hashlib.blake2b(
                        self._mm[base:base + phys.used],
                        digest_size=16).digest()
                    key = (dg, phys.used)
                    existing = self._by_digest.get(key)
                    if existing is not None and existing is not phys \
                            and existing.refs > 0:
                        existing.refs += 1
                        self._free.append(phys.frame)
                        phys.frame = None
                        phys.refs = 0
                        table.pages[i] = existing
                        self._touch(existing)
                        self.counters["dedup_hits"] += 1
                        self.counters["dedup_saved_bytes"] += phys.used
                        continue
                    phys.digest = key
                    self._by_digest[key] = phys
                self._lru_insert(phys)

    def free(self, table: PageTable) -> None:
        """Release one table's reference on every page; frames and spill
        files of pages nobody references anymore are reclaimed."""
        with self._lock:
            if table.freed:
                return
            table.freed = True
            for phys in table.pages:
                phys.refs -= 1
                if phys.refs > 0:
                    continue
                if phys.resident:
                    self._free.append(phys.frame)
                    phys.frame = None
                elif phys.spill_path:
                    try:
                        os.unlink(phys.spill_path)
                    except OSError:
                        pass
                    self._spill_files.pop(phys.spill_path, None)
                    phys.spill_path = None
                self._lru_remove(phys)
                if phys.digest is not None:
                    self._by_digest.pop(phys.digest, None)
            table.pages = []

    def pin(self, table: PageTable) -> None:
        """Forbid eviction of this table's pages (forward in progress)."""
        with self._lock:
            for phys in table.pages:
                phys.pins += 1
                if phys.pins == 1 and phys in self._lru:
                    self._n_evictable = max(0, self._n_evictable - 1)

    def unpin(self, table: PageTable) -> None:
        with self._lock:
            for phys in table.pages:
                phys.pins -= 1
                if phys.pins == 0 and phys in self._lru:
                    self._n_evictable += 1

    # -- data access -----------------------------------------------------
    def _span(self, table: PageTable, offset: int, size: int):  # holds: self._lock
        """Yield (phys, in-page offset, length) covering [offset, offset+size)."""
        if offset < 0 or offset + size > table.nbytes:
            raise ValueError(f"range [{offset},{offset + size}) outside "
                             f"table [0,{table.nbytes})")
        while size > 0:
            idx, in_off = divmod(offset, self.page_bytes)
            phys = table.pages[idx]
            n = min(phys.used - in_off, size)
            yield phys, in_off, n
            offset += n
            size -= n

    def segments(self, table: PageTable, offset: int = 0,
                 size: Optional[int] = None) -> list[np.ndarray]:
        """Writable views over the resident pages covering a byte range
        (the gather/scatter targets for ingest ``recv_into``).  Only
        valid for ranges whose pages are resident — i.e. unsealed
        (mid-ingest) or pinned pages."""
        if size is None:
            size = table.nbytes - offset
        out = []
        with self._lock:
            for phys, in_off, n in self._span(table, offset, size):
                if not phys.resident:
                    raise PageStoreFull(
                        "segments() over a spilled page — pin or read() "
                        "to pull it back first")
                base = phys.frame * self.page_bytes + in_off
                out.append(self._view[base:base + n])
        return out

    def page_views(self, table: PageTable) -> list:
        """Per-page gather list for the forward path: arena views for
        resident pages, file *bytes* for spilled ones (streamed from
        disk without displacing hot pages).  Pin the table first."""
        out = []
        with self._lock:
            for phys in table.pages:
                if phys.resident:
                    base = phys.frame * self.page_bytes
                    out.append(self._view[base:base + phys.used])
                else:
                    with open(phys.spill_path, "rb") as f:
                        out.append(f.read(phys.used))
        return out

    def read(self, table: PageTable, offset: int = 0,
             size: Optional[int] = None) -> bytearray:
        """Gather a byte range, pulling spilled pages back on access
        (LRU promote).  Falls back to a direct disk read when nothing
        can be evicted to make room."""
        if size is None:
            size = table.nbytes - offset
        out = bytearray(size)
        pos = 0
        with self._lock:
            for phys, in_off, n in self._span(table, offset, size):
                if not phys.resident:
                    try:
                        self._promote(phys)
                    except PageStoreFull:
                        with open(phys.spill_path, "rb") as f:
                            f.seek(in_off)
                            out[pos:pos + n] = f.read(n)
                        pos += n
                        continue
                self._touch(phys)
                base = phys.frame * self.page_bytes + in_off
                out[pos:pos + n] = self._mm[base:base + n]
                pos += n
        return out

    def write(self, table: PageTable, offset: int, data) -> int:
        """Scatter bytes into a table (server-local producers, tests)."""
        src = np.frombuffer(data, dtype=np.uint8) \
            if not isinstance(data, np.ndarray) \
            else data.reshape(-1).view(np.uint8)
        pos = 0
        for seg in self.segments(table, offset, src.size):
            n = len(seg)
            np.copyto(seg, src[pos:pos + n])
            pos += n
        return src.size

    def frame_offsets(self, table: PageTable) -> list[int]:
        """Arena byte offset of each page (the translation table shipped
        to one-sided writers).  Valid while the table is unsealed: those
        pages are pinned by construction (never evicted)."""
        with self._lock:
            offs = []
            for phys in table.pages:
                if not phys.resident:
                    raise PageStoreFull("frame_offsets of a spilled page")
                offs.append(phys.frame * self.page_bytes)
            return offs

    # -- introspection ---------------------------------------------------
    def available_pages(self) -> int:
        """Frames free now plus frames reclaimable by spilling — what
        credit grants derive from (a big sealed backlog does not starve
        small producers: it can always be spilled)."""
        with self._lock:
            return len(self._free) + self._n_evictable

    def available_fraction(self) -> float:
        return self.available_pages() / self.n_frames

    def stats(self) -> dict:
        with self._lock:
            mem_used = (self.n_frames - len(self._free)) * self.page_bytes
            return dict(self.counters,
                        pages_free=len(self._free),
                        pages_evictable=self._n_evictable,
                        pages_spilled=len(self._spill_files),
                        spill_used=sum(self._spill_files.values()),
                        mem_used=mem_used,
                        dedup_pages=len(self._by_digest))

    def close(self) -> None:
        """Release the arena and every live spill file."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            spills = list(self._spill_files)
            self._spill_files.clear()
            self._view = None
            try:
                self._mm.close()
            except BufferError:
                pass    # an exported view dies with its last holder
            os.close(self._fd)
            try:
                os.unlink(self.arena_path)
            except OSError:
                pass
        for path in spills:
            try:
                os.unlink(path)
            except OSError:
                pass
