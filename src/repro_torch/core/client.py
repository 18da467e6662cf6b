"""libstaging — the paper's client library (§3.2: server / communicator /
dataset), Python/NumPy edition of the C++ API in Listing 1:

    st = StagingClient("127.0.0.1:3221", io_threads=1, block_size=256 << 20)
    st.run_savime("create_tar(...);")
    ds = Dataset("D", "float64", st)
    ds.write(v)            # non-blocking: enqueue + return
    st.sync()              # block until all writes reached staging
    st.run_savime("load_subtar(...);")

Since the transport API redesign both ``StagingClient`` and ``Dataset``
are thin facades over :class:`repro_torch.transport.TransferSession` with the
``rdma_staged`` transport — pinning, backpressure and per-dataset futures
come from the session (see DESIGN.md §7).  ``Communicator`` remains the
low-level engine room the staged transport drives directly.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.core.blocks import plan_blocks
from repro_torch.core.queues import FCFSPool, TaskHandle
from repro_torch.core.rdma import writer_for_reply
from repro_torch.core.retry import RetryPolicy
from repro_torch.tensors import to_host

Buf = Union[np.ndarray, bytes, bytearray, memoryview]


class Communicator:
    """Manages the task queue + I/O thread pool (not user-facing).

    With ``n_channels > 1`` each dataset is striped across a shared
    :class:`~repro_torch.transport.channels.ChannelGroup` (concurrent
    connections + credit-based flow control) instead of the single
    per-thread connection; the FCFS queue/sync semantics are unchanged —
    only the per-dataset data plane widens.

    Two small-regime levers (DESIGN.md §10), both off by default:
    ``wire_format="bin1"`` negotiates the struct-packed fast path per
    connection (per-block ``reg_block``/ack frames skip JSON and ride
    single ``sendmsg`` calls); ``coalesce_bytes > 0`` routes datasets
    below the threshold through a :class:`~repro_torch.transport.coalesce.
    Coalescer` that packs them into one ``batch_open`` + ``batch_write``
    round-trip instead of 2+ control RTTs each.

    ``submit`` takes a torch tensor as well as a host buffer. With a codec
    that encodes tensors where they lie (int8-block) the tensor reaches
    the central encode as it is, so a CUDA tensor is quantized on the card
    and only the reduced bytes cross to the host; otherwise it is copied
    to the host first, as the reference's ``np.asarray`` does. Everything
    after the encode (coalescer, stripes, gateway) sees host bytes.
    """

    def __init__(self, addr: str, io_threads: int, block_size: int,
                 straggler_timeout: Optional[float] = None,
                 n_channels: int = 1, stripe_bytes: Optional[int] = None,
                 credits: int = 4, wire_format: str = wire.WIRE_JSON,
                 coalesce_bytes: int = 0, linger_ms: float = 2.0,
                 gateway: bool = False, tenant: Optional[str] = None,
                 codec: str = "none", decode_at: str = "staging",
                 retry: int = 3, deadline_s: Optional[float] = None):
        if wire_format not in wire.SUPPORTED_WIRE:
            raise ValueError(f"unknown wire_format {wire_format!r}; "
                             f"supported: {', '.join(wire.SUPPORTED_WIRE)}")
        if decode_at not in ("staging", "query"):
            raise ValueError(f"unknown decode_at {decode_at!r}; "
                             "supported: staging, query")
        self.addr = addr
        self.block_size = block_size
        self.wire_format = wire_format
        # shared transfer retry policy (DESIGN.md §15): exponential
        # backoff + full jitter, optional per-write deadline budget
        self._retry = RetryPolicy(retries=retry, deadline_s=deadline_s)
        # egress reduction codec (DESIGN.md §13): encode happens centrally
        # in submit() so the block, coalesced and striped paths all ship
        # the same reduced bytes. The codec only activates once the peer
        # advertised it in the hello handshake (_codec_active); against an
        # old server we silently fall back to raw bytes.
        self._codec = None
        self._decode_at = decode_at
        if codec != "none":
            from repro_torch import codec as codec_mod
            self._codec = codec_mod.create(codec)   # raises on unknown name
        self._codec_lock = threading.Lock()          # chain/order + counters
        self._codec_ok: Optional[bool] = None
        self._codec_counts = {"raw_bytes": 0, "wire_bytes": 0,
                              "encode_s": 0.0, "datasets": 0, "fallbacks": 0}
        self._pool = None
        self._socks = wire.ConnCache()   # one conn (≈ RC QP) per I/O thread
        self._channels = None
        self._coalescer = None
        self._gateway = None
        if gateway:
            # redirect protocol (DESIGN.md §12): one control RTT per
            # dataset resolves placement + tenancy; data goes straight
            # to the admitted backend, never through the gateway
            from repro_torch.gateway.client import GatewayClient
            self._gateway = GatewayClient(addr, tenant=tenant)
        if coalesce_bytes > 0:
            # imported lazily: repro_torch.transport imports this module
            from repro_torch.transport.coalesce import Coalescer
            self._coalescer = Coalescer(self._flush_batch, coalesce_bytes,
                                        linger_ms=linger_ms)
        self._channel_opts = {"n_channels": n_channels,
                              "stripe_bytes": stripe_bytes or block_size,
                              "credits": credits, "wire_format": wire_format,
                              "retry": self._retry}
        self._groups: dict[str, object] = {}   # backend addr -> ChannelGroup
        self._groups_lock = threading.Lock()
        if n_channels > 1:
            # striped mode bypasses the I/O pool entirely — don't start
            # worker threads that would only ever idle. Behind a gateway
            # the groups open lazily per admitted backend instead.
            if not gateway:
                self._channels = self._group_for(addr)
        else:
            self._pool = FCFSPool(io_threads, "libstaging-io",
                                  straggler_timeout=straggler_timeout)

    def _connect(self, addr: str):
        sock = wire.connect(addr)
        codecs = (self._codec.name,) if self._codec is not None else ()
        if self.wire_format == wire.WIRE_BIN1:
            # per-connection handshake; an old server leaves us on JSON
            wire.negotiate(sock, codecs=codecs, caps=wire.SUPPORTED_CAPS)
        elif codecs:
            # codec negotiation without a wire upgrade: offer JSON only
            wire.negotiate(sock, formats=(wire.WIRE_JSON,), codecs=codecs,
                           caps=wire.SUPPORTED_CAPS)
        return sock

    def _conn(self, addr: Optional[str] = None):
        return self._socks.get(addr or self.addr, factory=self._connect)

    def _group_for(self, addr: str):
        """Get-or-open the striped ChannelGroup bound to ``addr`` (one
        per backend when a gateway spreads datasets across a pool)."""
        with self._groups_lock:
            grp = self._groups.get(addr)
            if grp is None:
                from repro_torch.transport.channels import ChannelGroup
                grp = ChannelGroup(addr, **self._channel_opts).open()
                self._groups[addr] = grp
            return grp

    def _request(self, header: dict, payload=None,
                 addr: Optional[str] = None) -> dict:
        h, _ = wire.request(self._conn(addr), header, payload)
        if not h.get("ok"):
            from repro_torch.gateway.tenancy import error_from_reply
            raise error_from_reply(h, "staging error")
        return h

    # -- egress codec stage (DESIGN.md §13) ------------------------------
    def _codec_active(self) -> bool:
        """True once the peer has accepted our codec in a hello handshake.

        Probed lazily on the main address (the gateway answers for its
        whole pool); a peer that never advertised the codec leaves the
        sender on raw bytes — recorded as a fallback, not an error."""
        if self._codec is None:
            return False
        if self._codec_ok is None:
            with self._codec_lock:
                if self._codec_ok is None:
                    try:
                        sock = self._conn(self.addr)
                        ok = self._codec.name in wire.negotiated_codecs(sock)
                    except (OSError, RuntimeError):
                        ok = False
                    if not ok:
                        self._codec_counts["fallbacks"] += 1
                    self._codec_ok = ok
        return self._codec_ok

    def _encode(self, name: str, dtype: str, buf):
        """Encode one dataset (a host buffer, or a tensor for a codec that
        takes tensors); returns (wire_buf, codec header fields).

        Serialized under the codec lock: chained codecs (delta-rle) must
        observe submissions in order even when I/O threads race."""
        t0 = time.perf_counter()
        with self._codec_lock:
            payload, meta = self._codec.encode(buf, dtype=dtype, key=name)
            enc = payload if isinstance(payload, np.ndarray) else \
                np.frombuffer(memoryview(payload).cast("B"), np.uint8)
            c = self._codec_counts
            c["raw_bytes"] += buf.nbytes
            c["wire_bytes"] += enc.nbytes
            c["encode_s"] += time.perf_counter() - t0
            c["datasets"] += 1
        cinfo = {"codec": self._codec.name, "cmeta": meta,
                 "raw_size": int(meta.get("raw_size", buf.nbytes)),
                 "decode_at": self._decode_at}
        return enc, cinfo

    def codec_stats(self) -> dict:
        if self._codec is None:
            return {}
        with self._codec_lock:
            return dict(self._codec_counts, name=self._codec.name)

    # -- the transfer task (runs on an I/O thread) -----------------------
    def _send(self, name: str, dtype: str, buf: np.ndarray,
              addr: Optional[str] = None, cinfo: Optional[dict] = None,
              epoch: Optional[str] = None) -> int:
        """Block-path transfer with connection-level retry: a broken conn
        is dropped from the cache, the write restarts from ``write_req``
        after a jittered backoff (the epoch makes the restart idempotent —
        a server that already finished this epoch just acks ``dup``)."""
        for attempt in self._retry.attempts(f"write {name!r}"):
            tgt = addr
            try:
                if tgt is None and self._gateway is not None:
                    # re-admit on every attempt: after a backend fail-out
                    # the gateway routes the retry onto the rebuilt ring
                    tgt = self._gateway.admit(name, buf.nbytes, epoch=epoch)
                return self._send_once(name, dtype, buf, tgt, cinfo, epoch)
            except (ConnectionError, TimeoutError, OSError) as e:
                self._socks.invalidate(tgt or self.addr)
                attempt.backoff(e)   # raises RetryExhausted when spent

    def _send_once(self, name: str, dtype: str, buf: np.ndarray,
                   addr: Optional[str], cinfo: Optional[dict],
                   epoch: Optional[str]) -> int:
        nbytes = buf.nbytes
        # NB: "nbytes" is reserved by the wire framing; use "size"
        req = dict({"op": "write_req", "name": name,
                    "dtype": dtype, "size": nbytes}, **(cinfo or {}))
        if epoch is not None:
            req["epoch"] = epoch
        h = self._request(req, addr=addr)
        if h.get("dup"):
            return nbytes     # server already holds this epoch in full
        conn = self._conn(addr)
        use_bin = wire.negotiated(conn) == wire.WIRE_BIN1
        writer = writer_for_reply(h, nbytes)
        try:
            flat = buf.reshape(-1).view(np.uint8)
            for off, size in plan_blocks(nbytes, self.block_size):
                # ask for the remote block (server registers on demand)...
                hdr = {"op": "reg_block", "file_id": h["file_id"],
                       "offset": off, "size": size}
                if use_bin:     # fast path: packed header, one sendmsg
                    wire.send_frame_bin(conn, hdr)
                    grant, _ = wire.recv_frame(conn)
                    if not grant.get("ok"):
                        raise RuntimeError(
                            f"staging error: {grant.get('error')}")
                else:
                    grant = self._request(hdr, addr=addr)
                # ...then one-sided RDMA write, no server CPU involved
                writer.write(grant["offset"], flat[off:off + size],
                             grant["rkey"])
            # two-sided sync message: no more remote ops on this MR
            self._request({"op": "client_sync", "file_id": h["file_id"]},
                          addr=addr)
        finally:
            writer.close()
        return nbytes

    # -- the coalesced batch flush (runs on the coalescer worker) --------
    def _flush_one_batch(self, addr: str, items) -> None:
        """Pipelined ``batch_open`` + ``batch_write`` against one server,
        pushed in a single vectored ``sendmsg`` — nothing is concatenated
        in user space, the payload iovec list is the item buffers.

        A broken connection is dropped from the cache before the error
        propagates (the batch's items then replay one by one): the
        reference keeps it, so every later batch fails on the dead socket
        and is replayed too."""
        try:
            self._flush_batch_frames(self._conn(addr), items)
        except (ConnectionError, OSError):
            self._socks.invalidate(addr)
            raise

    def _flush_batch_frames(self, sock, items) -> None:
        open_hdr = {"op": "batch_open",
                    "items": [dict({"name": it.name, "dtype": it.dtype,
                                    "size": it.nbytes}, **(it.extra or {}))
                              for it in items]}
        write_hdr = {"op": "batch_write", "count": len(items)}
        payload = [it.buf for it in items if it.nbytes]
        wire.send_frames_vectored(
            sock, [(open_hdr, None), (write_hdr, payload)],
            fmt=wire.negotiated(sock))
        oh, _ = wire.recv_frame(sock)
        wh, _ = wire.recv_frame(sock)
        if not oh.get("ok"):
            raise RuntimeError(f"batch_open failed: {oh.get('error')}")
        if not wh.get("ok"):
            raise RuntimeError(f"batch_write failed: {wh.get('error')}")

    def _flush_batch(self, items) -> None:
        """One round-trip for N small datasets (two behind a gateway:
        ``admit_batch`` resolves tenancy + placement for the whole batch
        first, then one vectored flush per admitted backend)."""
        if self._gateway is None:
            self._flush_one_batch(self.addr, items)
            return
        # all-or-nothing admission: a quota rejection fails every item's
        # future before any backend sees a byte
        addrs = self._gateway.admit_batch([(it.name, it.nbytes)
                                           for it in items])
        by_addr: dict[str, list] = {}
        for addr, it in zip(addrs, items):
            by_addr.setdefault(addr, []).append(it)
        for addr, group in by_addr.items():
            self._flush_one_batch(addr, group)

    def submit(self, name: str, dtype: str, buf,
               epoch: Optional[str] = None,
               replay: bool = False) -> TaskHandle:
        """Encode (when a codec is active) and queue one dataset. ``buf`` is
        a host buffer or a torch tensor on any device; a replay encodes a
        tensor again."""
        cinfo = None
        active = self._codec_active()
        if isinstance(buf, torch.Tensor) and not (
                active and getattr(self._codec, "takes_tensors", False)):
            buf = to_host(buf)
        if active:
            if replay:
                # a replayed write cannot assume the server's decode chain
                # saw the original: break the chain so this encode is
                # self-contained (base=None), whatever landed before
                with self._codec_lock:
                    self._codec.reset(name)
            # one central encode feeds all three egress paths; downstream
            # decisions (coalescing threshold, striping plan) see the
            # *wire* size — that is the point of reducing first
            buf, cinfo = self._encode(name, dtype, buf)
        if not replay and self._coalescer is not None and \
                buf.nbytes < self._coalescer.coalesce_bytes:
            # replays skip the coalescer: recovery wants the write on the
            # wire now, with its epoch checked individually, not parked
            # behind a linger window in a batch that could fail as a unit
            extra = cinfo if epoch is None else dict(cinfo or {},
                                                     epoch=epoch)
            flat = buf.reshape(-1).view(np.uint8)
            return self._coalescer.add(name, dtype, flat, buf.nbytes,
                                       extra=extra)
        if self._channel_opts["n_channels"] > 1:
            # striped mode bypasses the I/O pool entirely: stripes are
            # enqueued onto the channels right away and datasets pipeline
            # back-to-back (no per-dataset drain between transfers); the
            # ack-driven completion feeds the same TaskHandle contract
            h = TaskHandle(self._send, (name, dtype, buf),
                           name=f"write-{name}")
            h.started_at = time.perf_counter()
            h.attempts = 1
            if self._gateway is not None:
                try:
                    group = self._group_for(
                        self._gateway.admit(name, buf.nbytes, epoch=epoch))
                except Exception as e:  # noqa: BLE001 — typed quota/auth
                    h.complete(error=e)
                    return h
            else:
                group = self._channels
            try:
                tr = group.submit_dataset(name, dtype, buf,
                                          codec_info=cinfo, epoch=epoch)
            except (ConnectionError, OSError) as e:
                h.complete(error=e)      # RetryExhausted after reopens
                return h
            tr.add_done_callback(
                lambda t, h=h: h.complete(result=t.nbytes)
                if t.error is None else h.complete(error=t.error))
            return h
        return self._pool.submit(self._send, name, dtype, buf, None, cinfo,
                                 epoch, name=f"write-{name}")

    def _all_groups(self) -> list:
        with self._groups_lock:
            return list(self._groups.values())

    def sync(self, timeout: Optional[float] = None) -> None:
        if self._coalescer is not None:
            self._coalescer.sync(timeout)
        for grp in self._all_groups():
            grp.sync(timeout)
        if self._pool is not None:
            self._pool.sync(timeout)

    def stop(self) -> None:
        if self._coalescer is not None:
            self._coalescer.close()      # flushes buffered small datasets
        if self._pool is not None:
            self._pool.stop()            # joins in-flight transfers first
        self._socks.close_all()          # per-thread QPs die with the pool
        for grp in self._all_groups():
            grp.close()                  # drains in-flight stripes first
        if self._gateway is not None:
            self._gateway.close()

    def channel_stats(self) -> list[dict]:
        out: list[dict] = []
        for grp in self._all_groups():
            out.extend(grp.channel_stats())
        return out


class StagingClient:
    """The paper's ``staging::server`` handle (now a TransferSession facade)."""

    def __init__(self, addr: str, io_threads: int = 1,
                 block_size: int = 64 << 20,
                 straggler_timeout: Optional[float] = None,
                 max_inflight_bytes: Optional[int] = None,
                 n_channels: int = 1, stripe_bytes: Optional[int] = None,
                 credits: int = 4, wire_format: str = wire.WIRE_JSON,
                 coalesce_bytes: int = 0, linger_ms: float = 2.0,
                 codec: str = "none", decode_at: str = "staging"):
        # imported lazily: repro_torch.transport's engine modules import this
        # module for Communicator
        from repro_torch.transport import TransferSession, TransportConfig
        self.session = TransferSession("rdma_staged", TransportConfig(
            staging_addr=addr, io_threads=io_threads, block_size=block_size,
            straggler_timeout=straggler_timeout,
            max_inflight_bytes=max_inflight_bytes,
            n_channels=n_channels, stripe_bytes=stripe_bytes,
            credits=credits, wire_format=wire_format,
            coalesce_bytes=coalesce_bytes, linger_ms=linger_ms,
            codec=codec, decode_at=decode_at)).open()

    @property
    def comm(self) -> Communicator:
        return self.session.transport.comm

    def run_savime(self, q: str):
        """Proxy a SAVIME operator through staging (compute nodes cannot
        reach the analytical network directly — paper §3.1)."""
        return self.session.run_savime(q)

    def sync(self, timeout: Optional[float] = None) -> None:
        """Block until all queued writes are fully received by staging."""
        self.session.sync(timeout)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until staging finished forwarding to SAVIME (benchmarks)."""
        self.session.drain(timeout)

    def stats(self) -> dict:
        return self.session.server_stats()

    def close(self) -> None:
        self.session.close()


class Dataset:
    """The paper's ``staging::dataset``."""

    def __init__(self, name: str, dtype: str, server: StagingClient):
        self.name = name
        self.dtype = dtype
        self.server = server
        self._handles: list = []

    def write(self, buf: Buf, nbytes: Optional[int] = None):
        """Non-blocking; buffer pinned (by the session) until completion.
        Returns a :class:`repro_torch.transport.DatasetFuture`."""
        fut = self.server.session.write(self.name, buf, dtype=self.dtype,
                                        nbytes=nbytes)
        self._handles.append(fut)
        return fut
