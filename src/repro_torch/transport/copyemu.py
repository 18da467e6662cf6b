"""scp/ssh baseline engines (paper §4 / Fig 6) as registered Transports.

All use real sockets / real tmpfs files on this host — scaled datasets,
same mechanisms; see DESIGN.md §6 (scaling honesty):

  scp_mem      pdsh+scp emulation into tmpfs on the staging node: TCP with
               16 KiB userspace copies + per-chunk CRC (cipher-cost proxy).
  scp_disk     same but staging storage is disk, fsync'd ("huge overhead,
               18x slower" — paper Fig 6); ``cfg.disk_bw`` optionally caps
               store throughput to the paper's 2018 disk-array class.
  ssh_direct   SSH-tunnel emulation: two chained TCP hops (compute->staging
               ->SAVIME), userspace copies + CRC at every hop, no staging
               store ("about 4 minutes" — paper §4).

Connection hygiene: every thread-local socket / client created by the
emulation is tracked and closed when its owning pool stops or its
transport closes (they used to leak until process exit).

Striping (``cfg.n_channels > 1``): the emulation engines reuse the
generic :class:`~repro_torch.transport.channels.ChannelGroup` — stripes are
round-robined across N concurrent connections with credit-based flow
control, and the copy servers reassemble them out of order before
storing/forwarding. The cost model is preserved at both ends: striped
sends go through 16K userspace chunk copies + CRC per stripe, and the
server side receives through the same copied path.

Wire format: the copy emulations are the paper's measured *baselines* —
they never negotiate the bin1 fast path or coalesce small datasets,
whatever ``cfg.wire_format`` / ``cfg.coalesce_bytes`` say (a baseline
that adopts the optimizations under test stops being a baseline). The
``ChannelGroup`` enforces this whenever a custom ``send_frame`` is
plugged in, and ``tests/test_wire_coalesce.py`` guards it. The same
holds for egress reduction codecs (DESIGN.md §13): these engines never
touch the :class:`~repro_torch.core.client.Communicator`, so ``cfg.codec`` is
structurally inert — baselines always ship raw bytes and report no
codec stats (``tests/test_codec.py`` pins this).

A torch tensor written to a baseline (on any device) is copied to the host
first (``repro_torch.tensors.to_host``, a bfloat16 tensor as its uint16
bits), so the baseline ships the same raw bytes the reference ships for
the same values and never launches the staging_pack kernel. The scp_disk
store lies under the temporary directory (``tempfile.gettempdir()``).
"""
from __future__ import annotations

import json
import os
import secrets
import shutil
import socket
import struct
import tempfile
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.core.queues import FCFSPool
from repro_torch.core.savime import SavimeClient
from repro_torch.tensors import to_host
from repro_torch.transport.base import Transport, register_transport

_SCP_CHUNK = 16 << 10   # scp/ssh move data through ~16K cipher blocks


# one TCP connection per I/O thread (like an ssh session), tracked so no
# connection outlives its pool — shared implementation in repro_torch.core.wire
_SockCache = wire.ConnCache


# ---------------------------------------------------------------------------
# emulation servers
# ---------------------------------------------------------------------------


class _CopyServer:
    """Receives frames with userspace 16K copies + CRC; stores (scp) or
    forwards (ssh tunnel hop)."""

    _GUARDED_BY = {
        "_asm": "_asm_lock",
        "_threads": "_threads_lock",
        "_conns": "_conn_lock",
    }

    def __init__(self, store_dir: Optional[str], fsync: bool,
                 forward_addr: Optional[str] = None,
                 savime_addr: Optional[str] = None,
                 disk_bw: Optional[float] = None):
        self.store_dir = store_dir
        self.fsync = fsync
        self.forward_addr = forward_addr
        self.savime_addr = savime_addr
        self.disk_bw = disk_bw  # B/s cap modeling the paper's 2018 disk array
        self._fwd_socks = _SockCache()
        self._savime_clis = _SockCache()
        self._asm: dict[str, dict] = {}      # striped reassembly in progress
        self._asm_lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(64)
        self.addr = f"127.0.0.1:{self._srv.getsockname()[1]}"
        self._stop = threading.Event()
        # conn threads were fire-and-forget daemons until the lifecycle
        # lint flagged them: stop() now shuts live conns and joins, so a
        # transport close leaves no serve thread (or its socket) behind
        self._threads: list[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept, daemon=True, name="copysrv-accept")
        self._accept_thread.start()

    def stop(self, join_timeout: float = 2.0):
        self._stop.set()
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
        self._accept_thread.join(join_timeout)
        deadline = time.monotonic() + join_timeout
        with self._threads_lock:
            threads = list(self._threads)
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        with self._threads_lock:
            self._threads = [t for t in self._threads if t.is_alive()]
        self._fwd_socks.close_all()
        self._savime_clis.close_all()

    def _accept(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            if self._stop.is_set():
                # raced stop(): serving now would leave a thread (and a
                # conn) that stop() already walked past
                try:
                    conn.close()
                except OSError:
                    pass
                return
            with self._threads_lock:
                self._threads = [t for t in self._threads if t.is_alive()]
                t = threading.Thread(target=self._serve, args=(conn,),
                                     daemon=True, name="copysrv-conn")
                t.start()
                self._threads.append(t)

    def _serve(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._conn_lock:
            self._conns.add(conn)
        try:
            with conn:
                while True:
                    try:
                        header, payload = self._recv_copied(conn)
                    except (ConnectionError, OSError):
                        return
                    try:
                        reply = self._handle_frame(header, payload)
                    except Exception as e:  # noqa: BLE001
                        reply = {"ok": False, "error": str(e),
                                 "code": "error"}
                    try:
                        wire.send_frame(conn, reply)
                    except OSError:
                        return
        finally:
            with self._conn_lock:
                self._conns.discard(conn)

    def _handle_frame(self, header, payload) -> dict:
        op = header.get("op")
        if op == "stripe_open":
            return self._stripe_open(header)
        if op == "stripe":
            return self._stripe(header, payload)
        self._sink(header, payload)
        return {"ok": True}

    # -- striped reassembly (same protocol the staging server speaks) ----
    def _stripe_open(self, h) -> dict:
        fid = secrets.token_hex(8)
        need = int(h["n_stripes"])
        asm = {"name": h["name"], "dtype": h.get("dtype", "uint8"),
               "buf": bytearray(int(h["size"])), "need": need,
               "seen": set(), "done": False,
               "wanted": max(1, int(h.get("credits", 4)))}
        if need == 0:                       # empty dataset: sink at open
            self._sink({"name": asm["name"], "dtype": asm["dtype"]},
                       asm["buf"])
        else:
            with self._asm_lock:
                self._asm[fid] = asm
        return {"ok": True, "file_id": fid,
                "credits": max(1, int(h.get("credits", 4)))}

    def _stripe(self, h, payload) -> dict:
        idx, off = int(h["stripe_idx"]), int(h["offset"])
        with self._asm_lock:
            asm = self._asm.get(h["file_id"])
            if asm is None:
                raise ValueError(f"unknown striped file {h['file_id']!r}")
            dup = idx in asm["seen"]
            if off < 0 or off + len(payload) > len(asm["buf"]):
                raise ValueError(
                    f"stripe [{off},{off + len(payload)}) outside dataset "
                    f"[0,{len(asm['buf'])})")
        # the copy emulation has no staging-memory model: grant whatever
        # window the sender asked for at stripe_open (never 0)
        reply = {"ok": True, "stripe_idx": idx, "dup": dup, "done": False,
                 "credits": asm["wanted"]}
        if dup:
            return reply
        asm["buf"][off:off + len(payload)] = payload   # land at its offset
        with self._asm_lock:
            asm["seen"].add(idx)
            if len(asm["seen"]) >= asm["need"] and not asm["done"]:
                asm["done"] = True
                self._asm.pop(h["file_id"], None)
                reply["done"] = True
        if reply["done"]:
            self._sink({"name": asm["name"], "dtype": asm["dtype"]},
                       asm["buf"])
        return reply

    def _recv_copied(self, conn):
        """recv with deliberate userspace chunk copies + CRC per chunk —
        models scp/ssh's copy+cipher CPU path (vs sendfile/RDMA zero-copy)."""
        raw = b""
        while len(raw) < 8:
            r = conn.recv(8 - len(raw))
            if not r:
                raise ConnectionError("closed")
            raw += r
        hlen = struct.unpack(">Q", raw)[0]
        hb = b""
        while len(hb) < hlen:
            r = conn.recv(hlen - len(hb))
            if not r:
                raise ConnectionError("closed")
            hb += r
        header = json.loads(hb)
        nbytes = header.get("nbytes", 0)
        out = bytearray()
        crc = 0
        while len(out) < nbytes:
            chunk = conn.recv(min(_SCP_CHUNK, nbytes - len(out)))
            if not chunk:
                raise ConnectionError("closed")
            crc = zlib.crc32(chunk, crc)          # cipher-cost proxy
            out += chunk                           # userspace copy
        header["crc"] = crc
        return header, out

    def _sink(self, header, payload):
        if self.store_dir is not None:            # scp: store at staging
            path = os.path.join(self.store_dir, header["name"])
            t0 = time.perf_counter()
            with open(path, "wb") as f:
                f.write(payload)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            if self.disk_bw:  # container disk is NVMe-fast; model the
                # paper's spinning-disk staging storage when asked to
                budget = len(payload) / self.disk_bw
                spent = time.perf_counter() - t0
                if budget > spent:
                    time.sleep(budget - spent)
            header["path"] = path
        elif self.forward_addr:                    # ssh hop: forward copied
            sock = self._fwd_socks.get(self.forward_addr)
            h, _ = wire.request(sock, {"op": "fwd", "name": header["name"],
                                       "dtype": header.get("dtype", "uint8")},
                                payload)
            if not h.get("ok"):
                raise RuntimeError(h.get("error"))
        elif self.savime_addr:                     # final hop into SAVIME
            cli = self._savime_clis.get(self.savime_addr, SavimeClient)
            cli.load_dataset(header["name"], header.get("dtype", "uint8"),
                             payload)


class _CopyServerFwdToSavime(_CopyServer):
    """Second tunnel hop: copied recv, then SAVIME ingest."""

    def __init__(self, savime_addr: str):
        super().__init__(store_dir=None, fsync=False,
                         savime_addr=savime_addr)

    def _sink(self, header, payload):
        op = header.get("op")
        if op != "fwd":   # only the first hop may talk to this endpoint
            raise ValueError(
                f"tunnel hop rejected frame with op={op!r} (expected 'fwd')")
        cli = self._savime_clis.get(self.savime_addr, SavimeClient)
        cli.load_dataset(header["name"], header.get("dtype", "uint8"),
                         payload)


def _copied_send_frame(sock: socket.socket, header: dict, payload) -> None:
    """Frame writer with the scp/ssh cost model: 16K userspace chunk
    copies + CRC per chunk (vs ``wire.send_frame``'s direct sendall).
    Plugged into ChannelGroup so striped sends keep the same CPU path."""
    mv = memoryview(payload).cast("B") if not isinstance(payload, memoryview) \
        else payload.cast("B")
    hb = json.dumps(dict(header, nbytes=len(mv))).encode()
    sock.sendall(struct.pack(">Q", len(hb)) + hb)
    crc = 0
    for off in range(0, len(mv), _SCP_CHUNK):
        chunk = bytes(mv[off:off + _SCP_CHUNK])       # userspace copy
        crc = zlib.crc32(chunk, crc)                  # cipher-cost proxy
        sock.sendall(chunk)


def _host(buf):
    """The raw host bytes a baseline ships: a tensor copied to the host."""
    return to_host(buf) if isinstance(buf, torch.Tensor) else buf


def _copy_send(socks: _SockCache, addr: str, name: str,
               dtype: str, buf: np.ndarray):
    """Client side of the scp/ssh emulation: chunked sendall with CRC."""
    sock = socks.get(addr)
    payload = memoryview(buf.reshape(-1).view(np.uint8))
    _copied_send_frame(sock, {"name": name, "dtype": dtype}, payload)
    h, _ = wire.recv_frame(sock)
    if not h.get("ok"):
        raise RuntimeError(h.get("error"))


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


class _CopyTransportBase(Transport):
    """Shared plumbing for the copy-emulation engines."""

    def __init__(self, cfg):
        super().__init__(cfg)
        if cfg.savime_addr is None:
            raise ValueError(f"{self.name} needs cfg.savime_addr")
        self._pool: Optional[FCFSPool] = None
        self._socks = _SockCache()
        self._group = None                  # striped channels, if enabled
        self._ctrl_savime: Optional[SavimeClient] = None
        self._ctrl_lock = threading.Lock()

    def _make_pool(self, name: str) -> FCFSPool:
        pool = FCFSPool(self.cfg.io_threads, name,
                        straggler_timeout=self.cfg.straggler_timeout)
        pool.add_stop_callback(self._socks.close_all)
        return pool

    def _make_group(self, addr: str):
        """Striped ChannelGroup against ``addr`` when cfg asks for more
        than one channel — with the copied-send cost model per stripe.
        ``cfg.wire_format`` is deliberately not forwarded: the custom
        ``send_frame`` pins the group to JSON (baseline honesty)."""
        if self.cfg.n_channels <= 1:
            return None
        from repro_torch.transport.channels import ChannelGroup
        return ChannelGroup(
            addr, n_channels=self.cfg.n_channels,
            stripe_bytes=self.cfg.stripe_bytes or self.cfg.block_size,
            credits=self.cfg.credits,
            send_frame=_copied_send_frame).open()

    def channel_stats(self) -> list[dict]:
        return self._group.channel_stats() if self._group is not None else []

    def sync(self, timeout: Optional[float] = None) -> None:
        self._pool.sync(timeout)

    # scp/ssh have no staging proxy; the analytical endpoint is reached
    # directly (that is exactly what the paper's baselines do).
    def run_savime(self, q: str):
        with self._ctrl_lock:
            if self._ctrl_savime is None:
                self._ctrl_savime = SavimeClient(self.cfg.savime_addr)
            return self._ctrl_savime.run(q)

    def _close_ctrl(self) -> None:
        with self._ctrl_lock:
            if self._ctrl_savime is not None:
                try:
                    self._ctrl_savime.close()
                except (OSError, RuntimeError):
                    pass
                self._ctrl_savime = None


class _ScpTransport(_CopyTransportBase):
    """pdsh+scp emulation: copy files to staging storage (mem|disk), then
    the staging side forwards to SAVIME on drain."""

    storage = "mem"

    def open(self) -> None:
        uid = secrets.token_hex(3)
        self._store = (f"/dev/shm/scp-{uid}" if self.storage == "mem"
                       else os.path.join(tempfile.gettempdir(),
                                         f"scp-{uid}"))
        os.makedirs(self._store, exist_ok=True)
        self._srv = _CopyServer(
            store_dir=self._store, fsync=(self.storage == "disk"),
            disk_bw=self.cfg.disk_bw if self.storage == "disk" else None)
        self._pool = self._make_pool(self.name)
        self._group = self._make_group(self._srv.addr)
        self._fwd_pool = FCFSPool(self.cfg.send_threads, f"{self.name}-fwd")
        self._fwd_savime = _SockCache()
        self._fwd_pool.add_stop_callback(self._fwd_savime.close_all)
        self._written: list[tuple[str, str, int]] = []
        self._forwarded = 0

    def write(self, name: str, dtype: str, buf):
        buf = _host(buf)
        self._written.append((name, dtype, buf.nbytes))
        if self._group is not None:
            return self._pool.submit(self._group.send_dataset, name, dtype,
                                     buf, name=f"{self.name}-{name}")
        return self._pool.submit(_copy_send, self._socks, self._srv.addr,
                                 name, dtype, buf, name=f"{self.name}-{name}")

    def drain(self, timeout: Optional[float] = None) -> None:
        """Forward everything stored at staging into SAVIME (FCFS pool)."""
        self.sync(timeout)

        def forward(name, dtype, nbytes):
            cli = self._fwd_savime.get(self.cfg.savime_addr, SavimeClient)
            path = os.path.join(self._store, name)
            fd = os.open(path, os.O_RDONLY)
            try:
                cli.load_dataset_from_file(name, dtype, fd, nbytes)
            finally:
                os.close(fd)
                os.unlink(path)

        todo, self._forwarded = \
            self._written[self._forwarded:], len(self._written)
        for name, dtype, nbytes in todo:
            self._fwd_pool.submit(forward, name, dtype, nbytes,
                                  name=f"fwd-{name}")
        self._fwd_pool.sync(timeout)

    def close(self) -> None:
        self._pool.stop()
        self._fwd_pool.stop()
        if self._group is not None:
            self._group.close()
        self._srv.stop()
        self._close_ctrl()
        shutil.rmtree(self._store, ignore_errors=True)


@register_transport("scp_mem")
class ScpMemTransport(_ScpTransport):
    storage = "mem"


@register_transport("scp_disk")
class ScpDiskTransport(_ScpTransport):
    storage = "disk"


@register_transport("ssh_direct")
class SshDirectTransport(_CopyTransportBase):
    """SSH-tunnel emulation: compute -> staging hop -> SAVIME, userspace
    copies + CRC at both hops, no staging store (paper §4 last baseline).
    Data reaches SAVIME synchronously with each write, so sync == drained."""

    def open(self) -> None:
        self._hop2 = _CopyServerFwdToSavime(self.cfg.savime_addr)
        self._hop1 = _CopyServer(store_dir=None, fsync=False,
                                 forward_addr=self._hop2.addr)
        self._pool = self._make_pool(self.name)
        # stripes ride the first (compute->staging) hop; hop1 reassembles
        # and forwards whole datasets to the SAVIME hop as before
        self._group = self._make_group(self._hop1.addr)

    def write(self, name: str, dtype: str, buf):
        buf = _host(buf)
        if self._group is not None:
            return self._pool.submit(self._group.send_dataset, name, dtype,
                                     buf, name=f"ssh-{name}")
        return self._pool.submit(_copy_send, self._socks, self._hop1.addr,
                                 name, dtype, buf, name=f"ssh-{name}")

    def drain(self, timeout: Optional[float] = None) -> None:
        self.sync(timeout)   # no staging store: synced data is already in

    def close(self) -> None:
        self._pool.stop()
        if self._group is not None:
            self._group.close()
        self._hop1.stop()
        self._hop2.stop()
        self._close_ctrl()
