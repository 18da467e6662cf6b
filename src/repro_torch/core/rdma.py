"""RDMA emulation over POSIX shared memory (/dev/shm mmap).

Faithful to the paper's §3.2 data path on a single Linux host:

  * the staging server ``mmap()``s an in-memory file *without touching the
    mapped memory or registering it* (lazy);
  * blocks are *registered on demand* when the client asks for them —
    emulated by populating the block's pages (page pinning is the dominant
    cost of ibv_reg_mr) and minting an rkey;
  * the client maps the same file and performs **one-sided writes** — raw
    memory stores into the server's region with zero server-CPU involvement
    (numpy ``copyto`` releases the GIL, so I/O threads truly overlap);
  * a two-sided sync message (over the TCP control channel, = the RC QP's
    send/recv) ends the transfer, after which the server may deregister.

What intentionally does NOT transfer from real verbs hardware: QP state
machines, MTU segmentation, CQ polling (see DESIGN.md §2).
"""
from __future__ import annotations

import mmap
import os
import secrets
import threading
from typing import Optional

import numpy as np


class MemoryRegion:
    """Server-side registered memory region backed by a (tmpfs) file."""

    paged = False

    def __init__(self, path: str, nbytes: int, create: bool = True):
        self.path = path
        self.nbytes = nbytes
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(path, flags, 0o600)
        if create:
            os.ftruncate(self._fd, nbytes)
        self._mm = mmap.mmap(self._fd, nbytes) if nbytes else None
        self._registered: dict[tuple[int, int], str] = {}
        self._lock = threading.Lock()

    @property
    def fd(self) -> int:
        return self._fd

    def view(self) -> np.ndarray:
        return np.frombuffer(self._mm, dtype=np.uint8)

    def segments(self, offset: int = 0, size: Optional[int] = None) \
            -> list[np.ndarray]:
        """Writable views covering a byte range (one contiguous view for
        a flat region; the paged variant scatters across frames)."""
        if size is None:
            size = self.nbytes - offset
        if size == 0:
            return []
        return [self.view()[offset:offset + size]]

    def register_block(self, offset: int, size: int) -> dict:
        """On-demand registration (paper: "the server register each block as
        needed before sending the remote memory address information")."""
        if offset < 0 or offset + size > self.nbytes:
            raise ValueError(f"block [{offset},{offset + size}) outside MR")
        with self._lock:
            key = (offset, size)
            if key not in self._registered:
                # populate pages = the pinning cost of ibv_reg_mr
                v = self.view()[offset:offset + size]
                v[::mmap.PAGESIZE] = v[::mmap.PAGESIZE]
                self._registered[key] = secrets.token_hex(4)
            return {"offset": offset, "size": size,
                    "rkey": self._registered[key]}

    def deregister_all(self) -> None:
        with self._lock:
            self._registered.clear()

    def is_registered(self, offset: int, size: int, rkey: str) -> bool:
        with self._lock:
            return self._registered.get((offset, size)) == rkey

    def close(self, unlink: bool = False) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # a numpy view is still exported; the mapping is reclaimed
                # when the last view dies — safe to continue (file still
                # unlinked below, memory freed on last unmap)
                pass
            self._mm = None
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class PagedMemoryRegion:
    """MemoryRegion-compatible facade over a :class:`~repro_torch.core.
    pagestore.PageStore` page table (DESIGN.md §11).

    The dataset's bytes live in fixed-size pages scattered across the
    store's arena (and, once sealed and cold, its spill tier); views
    gather/scatter across the non-contiguous frames.  ``path`` is the
    *arena* path — a one-sided client maps the arena once and translates
    dataset offsets through the ``frame_offsets()`` table
    (:class:`PagedRdmaWriter` is that translation on the client side).
    """

    paged = True

    def __init__(self, store, table):
        self.store = store
        self.table = table
        self.path = store.arena_path
        self.nbytes = table.nbytes
        self._registered: dict[tuple[int, int], str] = {}
        self._lock = threading.Lock()
        self._freed = False

    @property
    def fd(self) -> None:
        return None          # no flat file: forward gathers page views

    def segments(self, offset: int = 0, size: Optional[int] = None):
        return self.store.segments(self.table, offset, size)

    def frame_offsets(self) -> list[int]:
        return self.store.frame_offsets(self.table)

    def register_block(self, offset: int, size: int) -> dict:
        """On-demand registration, page-granular: populating each frame
        emulates the pinning cost of ibv_reg_mr exactly like the flat
        region — just over scattered pages."""
        if offset < 0 or offset + size > self.nbytes:
            raise ValueError(f"block [{offset},{offset + size}) outside MR")
        with self._lock:
            key = (offset, size)
            if key not in self._registered:
                for seg in self.segments(offset, size):
                    seg[::mmap.PAGESIZE] = seg[::mmap.PAGESIZE]
                self._registered[key] = secrets.token_hex(4)
            return {"offset": offset, "size": size,
                    "rkey": self._registered[key]}

    def deregister_all(self) -> None:
        with self._lock:
            self._registered.clear()

    def is_registered(self, offset: int, size: int, rkey: str) -> bool:
        with self._lock:
            return self._registered.get((offset, size)) == rkey

    # -- paged lifecycle -------------------------------------------------
    def seal(self) -> None:
        """Mark fully received: pages become spillable and dedup-able."""
        self.store.seal(self.table)

    def pin(self) -> None:
        self.store.pin(self.table)

    def unpin(self) -> None:
        self.store.unpin(self.table)

    def page_views(self) -> list:
        """Gather list for the forward path (pin first)."""
        return self.store.page_views(self.table)

    def read(self, offset: int = 0, size: Optional[int] = None) -> bytearray:
        return self.store.read(self.table, offset, size)

    def close(self, unlink: bool = False) -> None:
        if self._freed:
            return
        self._freed = True
        self.store.free(self.table)


def writer_for_reply(h: dict, nbytes: int):
    """Pick the client-side writer a reservation reply calls for: a
    paged server ships ``frames`` (its page-translation table) and gets
    a :class:`PagedRdmaWriter`; a flat one gets :class:`RdmaWriter`."""
    frames = h.get("frames")
    if frames is not None:
        return PagedRdmaWriter(h["path"], int(h["page_bytes"]), frames,
                               nbytes)
    return RdmaWriter(h["path"], nbytes)


class RdmaWriter:
    """Client-side endpoint for one-sided writes into a remote MR."""

    def __init__(self, path: str, nbytes: int):
        self._mr = MemoryRegion(path, nbytes, create=False)
        self._view: Optional[np.ndarray] = self._mr.view()

    def write(self, offset: int, buf: np.ndarray | memoryview | bytes,
              rkey: Optional[str] = None) -> int:
        """One-sided RDMA write: raw store into the remote region.
        numpy copyto releases the GIL -> concurrent I/O threads overlap."""
        src = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) \
            else buf.view(np.uint8).reshape(-1)
        np.copyto(self._view[offset:offset + src.size], src)
        return src.size

    def close(self) -> None:
        self._view = None  # drop the buffer export before unmapping
        self._mr.close()


class PagedRdmaWriter:
    """One-sided writer into a *paged* remote MR.

    Maps the server's page arena once and translates dataset offsets to
    frame offsets through the page table the server shipped at
    reservation time (``frames``: arena byte offset of each page) — the
    client-side half of scatter/gather over non-contiguous pages.  Same
    contract as :class:`RdmaWriter`: raw stores, no server CPU.
    """

    def __init__(self, path: str, page_bytes: int, frames: list[int],
                 nbytes: int):
        if page_bytes < 1:
            raise ValueError(f"page_bytes must be >= 1, got {page_bytes}")
        self.page_bytes = page_bytes
        self.frames = [int(f) for f in frames]
        self.nbytes = nbytes
        self._mr = MemoryRegion(path, os.path.getsize(path), create=False)
        self._view: Optional[np.ndarray] = self._mr.view()

    def write(self, offset: int, buf, rkey: Optional[str] = None) -> int:
        src = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) \
            else buf.reshape(-1).view(np.uint8)
        if offset < 0 or offset + src.size > self.nbytes:
            raise ValueError(
                f"write [{offset},{offset + src.size}) outside MR "
                f"[0,{self.nbytes})")
        pos = 0
        while pos < src.size:
            idx, in_off = divmod(offset + pos, self.page_bytes)
            n = min(self.page_bytes - in_off, src.size - pos)
            dst = self.frames[idx] + in_off
            np.copyto(self._view[dst:dst + n], src[pos:pos + n])
            pos += n
        return src.size

    def close(self) -> None:
        self._view = None
        self._mr.close()
