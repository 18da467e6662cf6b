"""Staging server — the paper's §3 architecture, component 2 of 2.

Receives datasets from compute-node clients via emulated-RDMA one-sided
writes into mmap'd in-memory files (tmpfs, capacity-limited, disk
fallback), then forwards them to SAVIME in the background over TCP with
sendfile/splice, FCFS, from a pool of send threads. In-memory files are
unlinked after ingest to release memory (paper §3.2). Also proxies SAVIME
control commands for clients that cannot reach the analytical network.

Striped ingest (DESIGN.md §9): ``stripe_open`` allocates the region and
declares ``n_stripes``; each ``stripe`` frame carries ``(name,
stripe_idx, n_stripes, offset)`` and its payload is received *directly
into the mmap'd region at its offset* — stripes reassemble out of order,
from any number of concurrent channel connections, with one copy (same
per-byte cost as the one-sided RDMA path). Every stripe ack returns a
credit grant computed from current memory pressure: when the SAVIME hop
is slow and tmpfs fills, grants shrink toward 1 and senders stall
instead of ballooning staging memory.

Small-dataset fast path (DESIGN.md §10): ``hello`` negotiates the bin1
wire format per connection (stripe / reg_block frames then arrive
struct-packed and are acked in kind); ``batch_open`` reserves regions
for N datasets in one round-trip (rolled back as a unit if any
reservation fails) and the following ``batch_write`` lands the
concatenated payloads straight into those regions and feeds each
sub-dataset into the existing finish/forward pipeline — SAVIME ingest is
unchanged. Connections that speak bin1 also receive proactive ``credit``
frames when a forward to SAVIME releases staging memory, so stalled
windows recover without waiting for the next ack.
"""
from __future__ import annotations

import collections
import logging
import math
import os
import secrets
import socket
import threading
import time
import zlib
from typing import Optional

from repro_torch import codec as codec_mod
from repro_torch.core import wire
from repro_torch.core.pagestore import PageStore, PageStoreFull
from repro_torch.core.queues import FCFSPool, TaskHandle
from repro_torch.core.rdma import MemoryRegion, PagedMemoryRegion
from repro_torch.core.savime import SavimeClient

log = logging.getLogger(__name__)

# bounded (name, epoch) replay-dedup log: large enough to cover every
# epoch a producer could still replay (its journal is far smaller), small
# enough to never matter for memory. A miss only means a re-ingest, which
# SAVIME's last-write-wins load absorbs.
_ACKED_CAP = 4096


class _Dataset:
    def __init__(self, file_id: str, name: str, dtype: str, nbytes: int,
                 region: MemoryRegion, in_memory: bool):
        self.file_id = file_id
        self.name = name
        self.dtype = dtype
        self.nbytes = nbytes
        self.region = region
        self.in_memory = in_memory
        self.received_at: Optional[float] = None
        # striped-ingest bookkeeping (None for the RDMA block path)
        self.n_stripes: Optional[int] = None
        self.stripes_seen: set[int] = set()
        self.credits_wanted: int = 4
        self.finished = False
        # activity clock for the abandoned-reservation reaper: starts at
        # creation so an idle block-path reservation ages out too (0.0
        # would make every fresh dataset instantly stale)
        self.last_stripe_at: float = time.monotonic()
        # producer-assigned replay identity (None for epoch-less writes)
        self.epoch: Optional[str] = None
        # egress-codec state (DESIGN.md §13): nbytes is always the *wire*
        # size of the region; raw_size the decoded size it stands for
        self.codec: Optional[str] = None
        self.cmeta: dict = {}
        self.raw_size: int = 0
        self.decode_at: str = "staging"
        self.decoded = False


class StagingServer:
    # lock->attribute protection map, enforced by `python -m repro.lint`
    # (DESIGN.md §14).  The plain-counter `stats` dict is deliberately
    # unguarded: increments are best-effort telemetry and the `stats` op
    # snapshots the authoritative watermarks under their own locks.
    _GUARDED_BY = {
        "_mem_used": "_alloc_lock",
        "_disk_used": "_alloc_lock",
        "_datasets": "_ds_lock",
        "_acked": "_ds_lock",
        "_threads": "_threads_lock",
        "_conns": "_conn_lock",
        "_push_conns": "_conn_lock",
        "_decoders": "_codec_mutex",
        "_parked": "_codec_mutex",
        "_fwd_tails": "_codec_mutex",
    }

    def __init__(self, savime_addr: str, host: str = "127.0.0.1",
                 port: int = 0, mem_capacity: int = 1 << 30,
                 mem_dir: Optional[str] = None,
                 disk_dir: Optional[str] = None,
                 send_threads: int = 2,
                 straggler_timeout: Optional[float] = None,
                 auto_subtar: bool = True,
                 stripe_ttl: float = 300.0,
                 page_bytes: int = 0,
                 spill_dir: Optional[str] = None,
                 dedup: bool = False):
        self.savime_addr = savime_addr
        uid = f"{os.getpid()}-{secrets.token_hex(3)}"
        self.mem_dir = mem_dir or f"/dev/shm/staging-{uid}"
        self.disk_dir = disk_dir or f"/tmp/staging-{uid}"
        os.makedirs(self.mem_dir, exist_ok=True)
        os.makedirs(self.disk_dir, exist_ok=True)
        self.mem_capacity = mem_capacity
        self._mem_used = 0
        self._disk_used = 0
        self._alloc_lock = threading.Lock()
        # paged staging substrate (DESIGN.md §11): page_bytes > 0 replaces
        # flat per-dataset tmpfs regions with page tables over one arena
        # (LRU spill tier + optional content-addressed dedup); 0 keeps the
        # flat path byte-identical to the original
        self._store: Optional[PageStore] = None
        if page_bytes > 0:
            self._store = PageStore(
                capacity=mem_capacity, page_bytes=page_bytes,
                mem_dir=self.mem_dir,
                spill_dir=spill_dir or os.path.join(self.disk_dir, "spill"),
                dedup=dedup)
        # _datasets is written by connection threads and popped by send
        # threads — every mutation goes through _ds_lock
        self._ds_lock = threading.Lock()
        self._datasets: dict[str, _Dataset] = {}
        # (name, epoch) -> True for completed epoched ingests (bounded
        # FIFO): replayed writes whose ack was lost dedup against this
        self._acked: collections.OrderedDict = collections.OrderedDict()
        self._send_pool = FCFSPool(send_threads, "staging-send",
                                   straggler_timeout=straggler_timeout)
        self._savime_local = threading.local()
        self.auto_subtar = auto_subtar
        self.stripe_ttl = stripe_ttl
        self.stats = {"datasets": 0, "bytes_in": 0, "raw_bytes_in": 0,
                      "bytes_to_savime": 0,
                      "disk_fallbacks": 0, "registrations": 0,
                      "stripes": 0, "stripe_dups": 0, "stripe_aborts": 0,
                      "batches": 0, "batched_datasets": 0,
                      "codec_datasets": 0, "codec_parked": 0,
                      "bin_conns": 0, "credit_pushes": 0, "conns": 0,
                      "replay_dups": 0, "crc_errors": 0}
        # egress-codec decode state (DESIGN.md §13): one decoder instance
        # per codec name (chained codecs keep per-dataset-name history),
        # serialized by _codec_mutex; a chained dataset that arrives before
        # its predecessor parks keyed (name, base_seq) until the base lands
        self._decoders: dict[str, codec_mod.Codec] = {}
        self._codec_mutex = threading.Lock()
        self._parked: dict[tuple[str, int], _Dataset] = {}
        # chained datasets share a SAVIME name across links, so their
        # forwards must reach SAVIME in decode order even across the
        # send pool's threads: each queued forward for a name waits on
        # the previous one's handle (FIFO dequeue makes that safe)
        self._fwd_tails: dict[str, TaskHandle] = {}
        # bin1 data connections eligible for proactive credit pushes:
        # conn -> the send lock shared with its serve thread
        self._push_conns: dict[socket.socket, threading.Lock] = {}

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(128)
        self.addr = f"{host}:{self._srv.getsockname()[1]}"
        self._stop = threading.Event()
        # _threads is appended by the accept loop and walked by stop();
        # both sides hold _threads_lock (an unlocked prune-while-join
        # race used to drop serve threads from stop()'s view)
        self._threads: list[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> "StagingServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="staging-accept", daemon=True)
        self._accept_thread.start()
        return self

    def stop(self, join_timeout: float = 2.0) -> None:
        self._stop.set()
        self._send_pool.stop()
        try:
            # shutdown (not just close) wakes a thread blocked in accept()
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(join_timeout)
        deadline = time.monotonic() + join_timeout
        with self._threads_lock:
            threads = list(self._threads)
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        with self._threads_lock:
            self._threads = [t for t in self._threads if t.is_alive()]
        with self._ds_lock:
            datasets = list(self._datasets.values())
        for ds in datasets:
            ds.region.close(unlink=True)
        if self._store is not None:
            self._store.close()
            self._try_rmdir(self._store.spill_dir)
        self._try_rmdir(self.mem_dir)
        self._try_rmdir(self.disk_dir)

    @staticmethod
    def _try_rmdir(path: str) -> None:
        """Reap a directory this server created, but only when empty —
        live datasets (or a user-supplied shared dir) keep it."""
        try:
            os.rmdir(path)
        except OSError:
            pass

    def live_threads(self) -> int:
        with self._threads_lock:
            return sum(t.is_alive() for t in self._threads)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until the send queue is empty (staging→SAVIME finished)."""
        self._send_pool.sync(timeout)

    # ------------------------------------------------------------------
    def _savime(self) -> SavimeClient:
        cli = getattr(self._savime_local, "cli", None)
        if cli is None:  # one connection per send/serve thread
            cli = SavimeClient(self.savime_addr)
            self._savime_local.cli = cli
        return cli

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            if self._stop.is_set():
                # raced stop(): it already shut the conns it could see —
                # serving this one would leave a thread stop() never joins
                try:
                    conn.close()
                except OSError:
                    pass
                return
            with self._threads_lock:
                self._threads = [t for t in self._threads if t.is_alive()]
                t = threading.Thread(target=self._serve, args=(conn,),
                                     name="staging-conn", daemon=True)
                t.start()
                self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._conn_lock:
            self._conns.add(conn)
        # replies and proactive credit pushes may interleave on this
        # socket from different threads — all sends go through this lock
        send_lock = threading.Lock()
        # conn-local protocol state: the reservation ids of the last
        # successful batch_open, consumed by the next batch_write
        conn_state: dict = {}
        # payloads for the generic ops are consumed before the next frame
        # is read, so their receive buffers are pooled, not per-frame
        pool = wire.BufferPool(max_per_bucket=2)

        def _reply(reply: dict, is_bin: bool) -> bool:
            try:
                with send_lock:
                    if is_bin:
                        wire.send_frame_bin(conn, dict(reply, op="ack"))
                    else:
                        wire.send_frame(conn, reply)
            except OSError:
                return False
            return True

        counted = False   # probe-only conns (ping/stats) stay uncounted
        try:
            with conn:
                while True:
                    try:
                        header = wire.recv_header(conn)
                        is_bin = bool(header.pop("_bin", False))
                        op = header.get("op")
                        if not counted and op not in ("ping", "stats"):
                            # a health prober that only ever pings must not
                            # inflate the data-connection total
                            self.stats["conns"] += 1
                            counted = True
                        if op in ("stripe", "batch_write"):
                            # these handlers receive their own payload —
                            # straight into the mmap'd region(s).
                            # _register_push_conn re-checks membership under
                            # _conn_lock (an unlocked pre-check here raced
                            # the pop in _serve's finally)
                            if is_bin:
                                self._register_push_conn(conn, send_lock)
                            try:
                                if op == "stripe":
                                    reply = self._op_stripe(conn, header)
                                else:
                                    reply = self._op_batch_write(
                                        conn, header, conn_state)
                            except (ConnectionError, OSError):
                                raise
                            except Exception as e:  # noqa: BLE001
                                # post-validation failure (e.g. region
                                # closed by stop() mid-transfer): report
                                # it, then drop the conn — the payload may
                                # not be fully consumed, so framing is gone
                                log.debug("ingest op %r failed: %s", op, e)
                                _reply({"ok": False, "error": str(e),
                                        "code": "ingest_failed"},
                                       is_bin)
                                return
                        elif op == "batch_open":
                            wire.drain_payload(conn, header)
                            # a prior batch_open whose batch_write never
                            # arrived is abandoned: release it or its
                            # reservations leak with no owner
                            self._abandon_batch(conn_state)
                            try:
                                reply = self._op_batch_open(header)
                                conn_state["batch"] = reply.pop("_ids")
                            except Exception as e:  # noqa: BLE001
                                log.debug("batch_open failed: %s", e)
                                reply = {"ok": False, "error": str(e),
                                         "code": "open_failed"}
                        else:
                            payload = wire.recv_payload(conn, header, pool)
                            try:
                                reply = self._handle(header, payload)
                            except Exception as e:  # noqa: BLE001
                                log.debug("op %r failed: %s",
                                          header.get("op"), e)
                                reply = {"ok": False, "error": str(e),
                                         "code": "error"}
                            finally:
                                # no generic op retains its payload past
                                # the handler — return the lease
                                if isinstance(payload, memoryview):
                                    pool.release(payload)
                            if op == "hello" and reply.get("ok"):
                                # remember the agreed caps on this conn:
                                # stripe CRC verification is gated on them
                                wire.set_negotiated_caps(
                                    conn, reply.get("caps") or ())
                    except (ConnectionError, OSError):
                        return
                    if not _reply(reply, is_bin):
                        return
        finally:
            # a connection that died between batch_open and batch_write
            # leaves reservations no client holds a handle to — release
            # them (the stripe TTL reaper only covers striped datasets)
            self._abandon_batch(conn_state)
            with self._conn_lock:
                self._conns.discard(conn)
                self._push_conns.pop(conn, None)

    def _abandon_batch(self, conn_state: dict) -> None:
        for fid in conn_state.pop("batch", None) or ():
            self._release_reservation(fid)

    def _register_push_conn(self, conn: socket.socket, send_lock) -> None:
        """Mark a bin1 data connection as eligible for proactive credit
        frames (only bin1 peers understand unsolicited ``credit`` ops)."""
        with self._conn_lock:
            if conn not in self._push_conns:
                self._push_conns[conn] = send_lock
                self.stats["bin_conns"] += 1

    # ------------------------------------------------------------------
    def _handle(self, h: dict, payload) -> dict:
        op = h.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "hello":
            return wire.hello_reply(h, codecs=codec_mod.available(),
                                    caps=wire.SUPPORTED_CAPS)
        if op == "write_req":
            return self._op_write_req(h)
        if op == "reg_block":
            return self._op_reg_block(h)
        if op == "client_sync":
            return self._op_client_sync(h)
        if op == "stripe_open":
            return self._op_stripe_open(h)
        if op == "run_savime":
            res = self._savime().run(h["q"])
            if hasattr(res, "tolist"):
                res = res.tolist()
            return {"ok": True, "result": res}
        if op == "drain":
            self.drain(h.get("timeout"))
            return {"ok": True}
        if op == "stats":
            # snapshot under the owning locks: torn reads here made
            # monitoring report mutually inconsistent numbers
            with self._alloc_lock:
                mem_used = self._mem_used
                disk_used = self._disk_used
            with self._ds_lock:
                queued = len(self._datasets)
            out = {"ok": True, **self.stats, "mem_used": mem_used,
                   "disk_used": disk_used, "queued": queued,
                   "mem_capacity": self.mem_capacity,
                   "free_fraction": self.free_fraction()}
            if self._store is not None:
                pages = self._store.stats()
                out["pages"] = pages
                out["mem_used"] = mem_used + pages["mem_used"]
                out["disk_used"] = disk_used + pages["spill_used"]
            return out
        raise ValueError(f"unknown op {op!r}")

    def _dup_reply(self, h: dict) -> Optional[dict]:
        """Idempotent-replay check: a producer re-sending a journaled
        write whose ack was lost must not double-ingest. ``None`` means
        proceed; otherwise the positive ack to return as-is."""
        epoch = h.get("epoch")
        if not epoch:
            return None
        with self._ds_lock:
            if (h["name"], epoch) not in self._acked:
                return None
        self.stats["replay_dups"] += 1
        return {"ok": True, "dup": True, "file_id": "",
                "credits": self._credit_grant(int(h.get("credits", 4)))}

    def _apply_epoch(self, file_id: str, h: dict) -> None:
        epoch = h.get("epoch")
        if not epoch:
            return
        with self._ds_lock:
            ds = self._datasets.get(file_id)
            if ds is not None:
                ds.epoch = str(epoch)

    def _op_write_req(self, h: dict) -> dict:
        nbytes = int(h["size"])
        dup = self._dup_reply(h)
        if dup is not None:
            return dup
        cfields = self._parse_codec(h)   # validate before reserving
        if self._store is not None:
            rep = self._open_paged(h, nbytes)
            if rep is not None:
                self._apply_codec(rep["file_id"], cfields)
                self._apply_epoch(rep["file_id"], h)
                return rep
            # unsealed demand exceeds the store even after spilling
            # everything cold — the paper's disk tier takes the overflow
            in_memory = False
            with self._alloc_lock:
                self._disk_used += nbytes
            self.stats["disk_fallbacks"] += 1
        else:
            with self._alloc_lock:
                in_memory = self._mem_used + nbytes <= self.mem_capacity
                if in_memory:
                    self._mem_used += nbytes
                else:
                    self._disk_used += nbytes
            if not in_memory:
                self.stats["disk_fallbacks"] += 1  # paper: disk as fallback
        file_id = secrets.token_hex(8)
        base = self.mem_dir if in_memory else self.disk_dir
        path = os.path.join(base, file_id)
        try:
            region = MemoryRegion(path, nbytes, create=True)
        except BaseException:
            # mmap/ftruncate can fail after the capacity reservation was
            # taken; without the rollback the bytes leak until restart
            with self._alloc_lock:
                if in_memory:
                    self._mem_used -= nbytes
                else:
                    self._disk_used -= nbytes
            raise
        ds = _Dataset(file_id, h["name"], h.get("dtype", "uint8"), nbytes,
                      region, in_memory)
        if cfields is not None:
            ds.codec, ds.cmeta, ds.raw_size, ds.decode_at = cfields
        if h.get("epoch"):
            ds.epoch = str(h["epoch"])
        with self._ds_lock:
            self._datasets[file_id] = ds
        return {"ok": True, "file_id": file_id, "path": path,
                "in_memory": in_memory}

    def _parse_codec(self, h: dict) -> Optional[tuple]:
        """Validate and extract the codec fields riding an open header
        (``codec``/``cmeta``/``raw_size``/``decode_at``, DESIGN.md §13).
        Raises before any capacity is reserved so a bad codec name cannot
        leak a reservation; ``None`` for plain (uncoded) datasets."""
        name = h.get("codec")
        if not name or name == "none":
            return None
        cls = codec_mod.get(name)    # UnknownCodecError on bad names
        decode_at = h.get("decode_at") or "staging"
        if decode_at not in ("staging", "query"):
            raise ValueError(f"unknown decode_at {decode_at!r}")
        if cls.chained:
            # chain order only exists at ingest: deltas must decode in
            # sequence, so query-time laziness is forced off
            decode_at = "staging"
        return (name, dict(h.get("cmeta") or {}),
                int(h.get("raw_size") or 0), decode_at)

    def _apply_codec(self, file_id: str, cfields: Optional[tuple]) -> None:
        if cfields is None:
            return
        with self._ds_lock:
            ds = self._datasets.get(file_id)
        if ds is not None:
            ds.codec, ds.cmeta, ds.raw_size, ds.decode_at = cfields

    def _open_paged(self, h: dict, nbytes: int) -> Optional[dict]:
        """Reserve a page table for one dataset; ``None`` when unsealed
        demand exceeds the store (caller falls back to the disk tier).

        The reply carries the address translation for one-sided writers:
        ``path`` is the page *arena*, ``frames`` the arena byte offset of
        each page (``PagedRdmaWriter`` scatters through it); reg_block
        grants stay flat-shaped, so the bin1 wire format is untouched.
        """
        try:
            table = self._store.alloc(nbytes)
        except PageStoreFull:
            return None
        region = PagedMemoryRegion(self._store, table)
        file_id = secrets.token_hex(8)
        ds = _Dataset(file_id, h["name"], h.get("dtype", "uint8"), nbytes,
                      region, True)
        with self._ds_lock:
            self._datasets[file_id] = ds
        return {"ok": True, "file_id": file_id, "path": region.path,
                "in_memory": True, "page_bytes": self._store.page_bytes,
                "arena_bytes": self._store.arena_bytes,
                "frames": region.frame_offsets()}

    def _free_dataset(self, ds: _Dataset) -> None:
        """Release one dataset's storage and return its accounting — page
        tables back to the store (which owns frames and spill files), flat
        regions back to the mem/disk watermark."""
        ds.region.close(unlink=True)
        if ds.region.paged:
            return
        with self._alloc_lock:
            if ds.in_memory:
                self._mem_used -= ds.nbytes
            else:
                self._disk_used -= ds.nbytes

    def _release_reservation(self, file_id: str) -> None:
        """Undo one ``write_req`` reservation that never finished: close
        and unlink the region and return its capacity."""
        with self._ds_lock:
            ds = self._datasets.pop(file_id, None)
        if ds is None:
            return
        self._free_dataset(ds)

    # -- coalesced small-dataset ingest (DESIGN.md §10) -------------------
    def _op_batch_open(self, h: dict) -> dict:
        """Reserve regions for N datasets in one round-trip.

        All-or-nothing: if any reservation fails (capacity, tmpfs error),
        every region already opened for this batch is closed, unlinked
        and its capacity returned before the error is reported — a
        partial batch must not leak reservations that no client holds a
        handle to.
        """
        items = h.get("items")
        if not isinstance(items, list) or not items:
            raise ValueError("batch_open needs a non-empty items list")
        opened: list[dict] = []
        try:
            for it in items:
                opened.append(self._op_write_req(it))
        except BaseException as e:
            for rep in opened:
                self._release_reservation(rep["file_id"])
            raise RuntimeError(
                f"batch_open failed at item {len(opened)}/{len(items)} "
                f"({e}); {len(opened)} reservations rolled back") from e
        return {"ok": True, "items": opened,
                "_ids": [rep["file_id"] for rep in opened]}

    def _op_batch_write(self, conn: socket.socket, h: dict,
                        conn_state: dict) -> dict:
        """Land one jumbo multi-dataset payload into the regions reserved
        by the immediately preceding ``batch_open`` on this connection,
        then feed each sub-dataset into the finish/forward pipeline.

        Any validation failure must drain the declared payload before
        replying, or the connection's framing desynchronizes (the client
        pipelines batch_open + batch_write in one vectored send).
        """
        ids = conn_state.pop("batch", None)
        declared = int(h.get("nbytes") or 0)
        if ids is None:
            wire.drain_payload(conn, h)
            return {"ok": False, "code": "bad_request", "error":
                    "batch_write without a preceding successful batch_open"}
        with self._ds_lock:
            dss = [self._datasets.get(fid) for fid in ids]
        count = int(h.get("count", len(ids)))
        if any(ds is None for ds in dss) or count != len(ids) \
                or sum(ds.nbytes for ds in dss) != declared:
            wire.drain_payload(conn, h)
            for fid in ids:
                self._release_reservation(fid)
            return {"ok": False, "code": "bad_request", "error":
                    f"batch_write mismatch (count={count}, "
                    f"declared={declared} bytes)"}
        done = 0
        try:
            for ds in dss:
                # scatter across the region's segments (one contiguous
                # view for flat regions, per-page views when paged)
                for seg in ds.region.segments(0, ds.nbytes):
                    wire.recv_into(conn, seg)
                self._finish_dataset(ds)
                done += 1
        except BaseException:
            # connection died mid-payload: finished sub-datasets are
            # already forwarding; the rest must not leak their regions
            for ds in dss[done:]:
                self._release_reservation(ds.file_id)
            raise
        self.stats["batches"] += 1
        self.stats["batched_datasets"] += done
        return {"ok": True, "count": done,
                "credits": self._credit_grant(4)}

    def _op_reg_block(self, h: dict) -> dict:
        with self._ds_lock:
            ds = self._datasets[h["file_id"]]
            ds.last_stripe_at = time.monotonic()   # keep the reaper away
        grant = ds.region.register_block(int(h["offset"]), int(h["size"]))
        self.stats["registrations"] += 1
        return {"ok": True, **grant}

    def _op_client_sync(self, h: dict) -> dict:
        with self._ds_lock:
            ds = self._datasets[h["file_id"]]
        self._finish_dataset(ds)
        return {"ok": True}

    def _finish_dataset(self, ds: _Dataset) -> None:
        """Dataset fully received (block-path sync or last stripe): account
        it, decode it if an egress codec applies at ingest, and queue the
        staging→SAVIME forward."""
        ds.received_at = time.perf_counter()
        ds.finished = True    # universal: the reaper must skip forwards
        if ds.epoch:
            with self._ds_lock:
                first = (ds.name, ds.epoch) not in self._acked
                if first:
                    self._acked[(ds.name, ds.epoch)] = True
                    while len(self._acked) > _ACKED_CAP:
                        self._acked.popitem(last=False)
            if not first:
                # a replayed transfer raced the original's completion —
                # both finished. Keep the copy already forwarding; free
                # this one without double-counting it.
                self.stats["replay_dups"] += 1
                with self._ds_lock:
                    self._datasets.pop(ds.file_id, None)
                self._free_dataset(ds)
                return
        ds.region.deregister_all()   # paper: undo registration after sync
        if ds.region.paged:
            # fully received: pages become spillable / dedup-able
            ds.region.seal()
        self.stats["datasets"] += 1
        self.stats["bytes_in"] += ds.nbytes          # wire (coded) bytes
        self.stats["raw_bytes_in"] += ds.raw_size if ds.codec else ds.nbytes
        if ds.codec and ds.decode_at == "staging":
            self._decode_ingest(ds)   # forwards (or parks) from inside
            return
        self._send_pool.submit(self._send_to_savime, ds,
                               name=f"send-{ds.name}")

    # -- egress-codec decode (DESIGN.md §13) ------------------------------
    def _decoder(self, name: str) -> codec_mod.Codec:  # holds: self._codec_mutex
        dec = self._decoders.get(name)
        if dec is None:
            dec = self._decoders[name] = codec_mod.create(name)
        return dec

    def _region_bytes(self, ds: _Dataset):
        """One contiguous copy of the dataset's wire payload (the decoder
        keeps chain history across region swaps, so it needs its own
        buffer either way)."""
        if ds.region.paged:
            ds.region.pin()
            try:
                return ds.region.read(0, ds.nbytes)
            finally:
                ds.region.unpin()
        return bytes(ds.region.view()[:ds.nbytes])

    def _decode_ingest(self, ds: _Dataset) -> None:
        """Decode one finished dataset — and any parked chain successors
        it unblocks — then queue each for forwarding.

        Chained codecs (delta-rle) require decode in chain order, but
        io_threads/striping can reorder arrivals: a dataset whose base has
        not landed yet parks keyed ``(name, base_seq)`` and is revisited
        the moment its predecessor decodes. All decoder state and parking
        live under ``_codec_mutex``."""
        with self._codec_mutex:
            pending: Optional[_Dataset] = ds
            while pending is not None:
                try:
                    raw = self._decoder(pending.codec).decode(
                        self._region_bytes(pending), pending.cmeta,
                        key=pending.name)
                except codec_mod.CodecOrderError as e:
                    self._parked[(pending.name, e.base)] = pending
                    self.stats["codec_parked"] += 1
                    return
                except Exception as e:
                    # corrupt payload: the region must not leak while the
                    # error surfaces to the client
                    log.debug("codec %r decode of %r failed: %s",
                              pending.codec, pending.name, e)
                    with self._ds_lock:
                        self._datasets.pop(pending.file_id, None)
                    self._free_dataset(pending)
                    raise
                self._swap_region(pending, raw)
                self.stats["codec_datasets"] += 1
                self._submit_ordered(pending)
                seq = (pending.cmeta or {}).get("seq")
                pending = (self._parked.pop((pending.name, seq), None)
                           if seq is not None else None)

    def _submit_ordered(self, ds: _Dataset) -> None:  # holds: self._codec_mutex
        """Queue a decoded dataset's forward behind the previous forward
        queued for the same SAVIME name.

        Chained links decode in order under _codec_mutex, but the send
        pool has several workers: two same-name forwards could otherwise
        race and SAVIME's last-write-wins would keep the older link.  The
        wait cannot deadlock: a task only ever waits on one submitted
        *earlier*, and FIFO dequeue means the oldest unfinished task is
        never stuck behind a waiter."""
        prev = self._fwd_tails.get(ds.name)
        handle = self._send_pool.submit(self._send_after, ds, prev,
                                        name=f"send-{ds.name}")
        self._fwd_tails[ds.name] = handle
        if len(self._fwd_tails) > 64:
            self._fwd_tails = {n: h for n, h in self._fwd_tails.items()
                               if not h.done.is_set()}

    def _send_after(self, ds: _Dataset, prev: Optional[TaskHandle]) -> None:
        if prev is not None:
            # wait for completion, success *or* failure — ordering is the
            # only contract; poll so stop() (which abandons queued tasks,
            # leaving their handles forever pending) cannot wedge a worker
            while not prev.done.wait(0.05):
                if self._stop.is_set():
                    return
        self._send_to_savime(ds)

    def _swap_region(self, ds: _Dataset, raw) -> None:
        """Replace the dataset's wire-size storage with its decoded bytes:
        allocate raw-size storage through the normal tiers (paged store →
        flat tmpfs → disk), copy, and free the coded region together with
        its capacity accounting."""
        n = int(getattr(raw, "nbytes", None) or len(raw))
        ds.decoded = True
        old_region, old_mem, old_n = ds.region, ds.in_memory, ds.nbytes
        if n == 0 and old_n == 0:
            return                    # empty dataset: nothing to re-home
        rawv = codec_mod.as_bytes_array(raw)
        region, in_memory = self._alloc_plain(n)
        try:
            off = 0
            for seg in region.segments(0, n):
                ln = int(getattr(seg, "nbytes", None) or len(seg))
                seg[:] = rawv[off:off + ln]
                off += ln
            if region.paged:
                region.seal()
        except BaseException:
            region.close(unlink=True)
            if not region.paged:
                with self._alloc_lock:
                    if in_memory:
                        self._mem_used -= n
                    else:
                        self._disk_used -= n
            raise
        ds.region, ds.in_memory, ds.nbytes = region, in_memory, n
        old_region.close(unlink=True)
        if not old_region.paged:
            with self._alloc_lock:
                if old_mem:
                    self._mem_used -= old_n
                else:
                    self._disk_used -= old_n

    def _alloc_plain(self, nbytes: int):
        """Allocate dataset storage exactly like ``_op_write_req`` does,
        but for a server-internal (decoded) buffer with no client reply:
        paged store first, flat tmpfs under the watermark, disk overflow.
        Returns ``(region, in_memory)`` with the reservation taken."""
        if self._store is not None:
            try:
                table = self._store.alloc(nbytes)
                return PagedMemoryRegion(self._store, table), True
            except PageStoreFull:
                with self._alloc_lock:
                    self._disk_used += nbytes
                self.stats["disk_fallbacks"] += 1
                in_memory = False
        else:
            with self._alloc_lock:
                in_memory = self._mem_used + nbytes <= self.mem_capacity
                if in_memory:
                    self._mem_used += nbytes
                else:
                    self._disk_used += nbytes
            if not in_memory:
                self.stats["disk_fallbacks"] += 1
        file_id = secrets.token_hex(8)
        path = os.path.join(self.mem_dir if in_memory else self.disk_dir,
                            file_id)
        try:
            region = MemoryRegion(path, nbytes, create=True)
        except BaseException:
            with self._alloc_lock:
                if in_memory:
                    self._mem_used -= nbytes
                else:
                    self._disk_used -= nbytes
            raise
        return region, in_memory

    # -- striped ingest (DESIGN.md §9) -----------------------------------
    def _op_stripe_open(self, h: dict) -> dict:
        self._gc_stale_stripes()
        dup = self._dup_reply(h)
        if dup is not None:
            return dup               # replayed epoch: nothing to receive
        rep = self._op_write_req(h)
        n_stripes = int(h["n_stripes"])
        with self._ds_lock:
            ds = self._datasets[rep["file_id"]]
            ds.n_stripes = n_stripes
            ds.credits_wanted = max(1, int(h.get("credits", 4)))
            ds.last_stripe_at = time.monotonic()
        if n_stripes == 0:           # empty dataset: complete at open
            with self._ds_lock:
                ds.finished = True
            self._finish_dataset(ds)
        rep["credits"] = self._credit_grant(ds.credits_wanted)
        return rep

    def _op_stripe(self, conn: socket.socket, h: dict) -> dict:
        """Receive one stripe payload directly into the dataset's region.

        Any validation failure must still drain the payload bytes before
        replying, or the connection's framing desynchronizes.
        """
        nbytes = int(h.get("nbytes") or 0)
        try:
            with self._ds_lock:
                ds = self._datasets[h["file_id"]]
                dup = int(h["stripe_idx"]) in ds.stripes_seen
            idx = int(h["stripe_idx"])
            off = int(h["offset"])
            # one-sided stripes (sided=1) landed via a direct memory write;
            # the frame is control-only and declares its extent in "size"
            if h.get("sided"):
                if nbytes:
                    raise ValueError("sided stripe must not carry payload")
                span = int(h.get("size") or 0)
            else:
                span = nbytes
            if ds.n_stripes is None:
                raise ValueError("dataset was not opened with stripe_open")
            if h.get("enc") and not ds.codec:
                raise ValueError(
                    "enc stripe for a dataset opened without a codec")
            if off < 0 or off + span > ds.nbytes:
                raise ValueError(
                    f"stripe [{off},{off + span}) outside dataset "
                    f"[0,{ds.nbytes})")
        except (KeyError, ValueError, TypeError) as e:
            wire.drain_payload(conn, h)       # keep the stream framed
            return {"ok": False, "error": str(e), "code": "bad_request"}
        grant = self._credit_grant(ds.credits_wanted)
        if dup:
            # duplicate (retry / speculative re-send): ack idempotently,
            # do not touch the region — it may already be forwarding
            wire.drain_payload(conn, h)
            self.stats["stripe_dups"] += 1
            return {"ok": True, "stripe_idx": idx, "dup": True,
                    "done": False, "credits": grant}
        crc = None if h.get("sided") else h.get("crc")
        check = crc is not None and \
            wire.CAP_CRC in wire.negotiated_caps(conn)
        if nbytes:
            csum = 0
            for seg in ds.region.segments(off, nbytes):
                wire.recv_into(conn, seg)
                if check:
                    csum = zlib.crc32(seg, csum)
            if check and (csum & 0xFFFFFFFF) != int(crc):
                # payload fully consumed (framing intact) but mangled in
                # flight: leave the stripe out of stripes_seen so the
                # sender's re-send overwrites the garbage. The error text
                # is the contract — bin1 acks carry no code field.
                self.stats["crc_errors"] += 1
                return {"ok": False, "code": "corrupt",
                        "error": f"crc mismatch on stripe {idx} of "
                                 f"{ds.name!r}",
                        "stripe_idx": idx, "credits": grant}
        if span:
            # on-demand registration per stripe (paper: "the server
            # register each block as needed") — credit-granted rather than
            # request/reply, so it pipelines with the writes instead of
            # costing a serialized RTT + cold zero-fill pass per block
            ds.region.register_block(off, span)
            self.stats["registrations"] += 1
        done = False
        with self._ds_lock:
            ds.stripes_seen.add(idx)
            ds.last_stripe_at = time.monotonic()
            if len(ds.stripes_seen) >= ds.n_stripes and not ds.finished:
                ds.finished = done = True
        self.stats["stripes"] += 1
        if done:
            self._finish_dataset(ds)
        return {"ok": True, "stripe_idx": idx, "dup": False, "done": done,
                "credits": grant}

    def _gc_stale_stripes(self) -> None:
        """Reap datasets abandoned mid-transfer (client or channel died):
        without this their capacity reservation never releases, and since
        credit grants derive from ``_mem_used`` a few dead transfers would
        permanently throttle every healthy client. Covers block-path
        ``write_req`` reservations whose sync never came as well as
        striped ingests. Activity-based: a credit-stalled sender still
        trickles stripes (grants are never 0) and one-sided writers touch
        via reg_block, so only truly dead transfers age past the TTL."""
        now = time.monotonic()
        with self._ds_lock:
            stale = [ds for ds in self._datasets.values()
                     if not ds.finished
                     and now - ds.last_stripe_at > self.stripe_ttl]
            for ds in stale:
                self._datasets.pop(ds.file_id, None)
        for ds in stale:
            self._free_dataset(ds)
            self.stats["stripe_aborts"] += 1

    def _credit_grant(self, wanted: int) -> int:
        """Per-channel window grant: full when tmpfs is empty, shrinking
        toward 1 as it fills (a slow SAVIME hop keeps memory occupied, so
        producers stall on credits instead of overrunning the staging
        area). Never 0 — a zero grant with an empty pipeline would leave
        no ack to ever raise it again.

        Paged mode derives from *available pages* (free frames plus
        sealed evictable ones): a big cold backlog can always be spilled,
        so it no longer pins every producer's window to 1 the way the
        flat watermark did."""
        frac_free = self.free_fraction()
        return max(1, min(wanted, math.ceil(wanted * max(frac_free, 0.0))))

    def free_fraction(self) -> float:
        """The credit machinery's pressure signal, also exported through
        the ``stats`` op so a gateway can cap fleet-wide admission on the
        most-pressured backend."""
        if self._store is not None:
            return self._store.available_fraction()
        with self._alloc_lock:
            used = self._mem_used
        return 1.0 - used / self.mem_capacity if self.mem_capacity else 1.0

    # -- background forward (FCFS pool) ---------------------------------
    def _send_to_savime(self, ds: _Dataset) -> None:
        sent = ds.nbytes
        try:
            cli = self._savime()
            if ds.codec and not ds.decoded:
                # decode_at="query": the dataset was staged in wire form
                # (coded pages dedup and spill as-is); decode lazily on
                # the staging→SAVIME hop
                with self._codec_mutex:
                    raw = self._decoder(ds.codec).decode(
                        self._region_bytes(ds), ds.cmeta, key=ds.name)
                cli.load_dataset(ds.name, ds.dtype, raw)
                sent = int(getattr(raw, "nbytes", None) or len(raw))
            elif ds.region.paged:
                # gather page views (spilled pages stream from disk
                # without displacing hot frames); pin so the LRU cannot
                # evict a page out from under the send
                ds.region.pin()
                try:
                    cli.load_dataset_views(ds.name, ds.dtype,
                                           ds.region.page_views(),
                                           ds.nbytes)
                finally:
                    ds.region.unpin()
            else:
                cli.load_dataset_from_file(ds.name, ds.dtype, ds.region.fd,
                                           ds.nbytes)
        except OSError:
            if self._stop.is_set():
                return    # stop() already closed the regions mid-forward
            raise
        self.stats["bytes_to_savime"] += sent
        with self._ds_lock:
            self._datasets.pop(ds.file_id, None)
        self._free_dataset(ds)  # release staging memory (paper §3.2)
        if ds.in_memory:
            self._push_credits()

    def _push_credits(self) -> None:
        """Proactively raise windows on bin1 data connections after a
        forward released staging memory — a channel stalled at a grant of
        1 recovers immediately instead of waiting for its next ack (only
        bin1 peers understand unsolicited ``credit`` frames; JSON
        channels keep the ack-carried grants)."""
        with self._conn_lock:
            targets = list(self._push_conns.items())
        if not targets:
            return
        with self._ds_lock:
            wanted = max((d.credits_wanted for d in self._datasets.values()
                          if d.n_stripes is not None and not d.finished),
                         default=4)
        grant = self._credit_grant(wanted)
        for conn, send_lock in targets:
            try:
                with send_lock:
                    wire.send_frame_bin(conn,
                                        {"op": "credit", "credits": grant})
                self.stats["credit_pushes"] += 1
            except OSError:
                pass          # conn is dying; its serve thread cleans up
