"""Wire protocol shared by SAVIME / staging / clients.

Two frame encodings share every connection (DESIGN.md §10):

  * **JSON** (legacy, the control/compat path) —
    8-byte big-endian header length | JSON header | raw payload
    (payload size in header["nbytes"], 0 if none).
  * **bin1** (the data fast path) — a fixed 48-byte struct-packed header
    for the hot data ops (``stripe``, ``reg_block``, ``ack``,
    ``credit``) followed by the raw payload. The first byte is the
    ``BIN_MAGIC`` discriminator: JSON frames always start with 0x00
    (their header length is capped at ``MAX_HEADER_LEN``), so both
    encodings interleave safely on one stream — binary for the per-block
    hot loop, JSON for everything else.

A peer may only *send* bin1 after :func:`negotiate` (the ``hello`` op)
confirmed the other side speaks it; a pre-bin1 server answers ``hello``
with an unknown-op error and the connection stays on JSON. Receivers
need no negotiation — the magic byte is self-describing.

``send_frame_from_file`` streams the payload with ``os.sendfile`` — on Linux
this is the splice/sendfile zero-copy path the paper uses for the
staging→SAVIME hop (§2: "SAVIME uses standard TCP for control operations
combined with the splice syscall for sending data").

``send_frames_vectored`` scatter-gathers many frames (and multi-buffer
payloads) into single ``sendmsg`` calls — the small-frame regime pays one
syscall for a burst of stripes instead of two per frame.

Receive is split into ``recv_header`` / ``recv_payload`` /
``recv_payload_into`` so servers can parse the header first and land the
payload straight into its destination buffer (the striped staging path
recv's into the mmap'd memory region — one copy, like the RDMA path).
Header bytes land in a per-thread scratch buffer and payloads can be
leased from a :class:`BufferPool`, so the per-frame ``bytearray``
allocations are gone from the hot loops.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import weakref
import zlib
from typing import Any, Iterable, Optional, Sequence

_LEN = struct.Struct(">Q")
CHUNK = 1 << 20

# ---------------------------------------------------------------------------
# fault-injection hook (repro_torch.faults installs / uninstalls it)
# ---------------------------------------------------------------------------

# When non-None, every frame sent on a socket *registered* with the
# injector (wire.connect registers new sockets while a hook is up) passes
# through it first — the injector may delay, duplicate, corrupt a copy of
# the payload, or sever the connection (drop / partition).  None (the
# default) is a zero-branch fast path.
_FAULT_INJECTOR = None


def set_fault_injector(inj) -> None:
    global _FAULT_INJECTOR
    _FAULT_INJECTOR = inj


def fault_injector():
    return _FAULT_INJECTOR

# JSON headers are small dicts; a length prefix beyond this is a corrupt
# or hostile stream, not a real frame — without the cap a bad 8-byte
# prefix makes the header recv allocate gigabytes before failing.  The
# cap also guarantees byte 0 of a JSON frame is 0x00, which is what lets
# BIN_MAGIC discriminate the binary encoding in-band.
MAX_HEADER_LEN = 1 << 20
# Payloads are bounded by staging capacity / block sizes in practice; a
# declared size beyond this is corrupt, and the allocation would happen
# before a single payload byte arrives.
MAX_PAYLOAD_LEN = 8 << 30

# ---------------------------------------------------------------------------
# binary fast path (bin1)
# ---------------------------------------------------------------------------

WIRE_JSON = "json"
WIRE_BIN1 = "bin1"
SUPPORTED_WIRE = (WIRE_BIN1, WIRE_JSON)     # preference order

BIN_MAGIC = 0xB1
BIN_VERSION = 1
# magic | version | op | flags | stripe_idx | file_id/rkey | n_stripes |
# credits | offset | size | payload nbytes  — 48 bytes, no padding
_BIN = struct.Struct(">BBBBI8sIIQQQ")
BIN_HEADER_LEN = _BIN.size

OP_STRIPE, OP_BLOCK, OP_ACK, OP_CREDIT = 1, 2, 3, 4
_OP_NAME = {OP_STRIPE: "stripe", OP_BLOCK: "reg_block", OP_ACK: "ack",
            OP_CREDIT: "credit"}
# low nibble: op flags; high nibble: id length in bytes (0-8), so an id
# whose raw bytes end in 0x00 survives the fixed-width padding exactly
F_SIDED, F_DUP, F_DONE, F_OK = 1, 2, 4, 8
# F_ENC shares bit 1 with F_DUP: F_DUP is only meaningful on acks, F_ENC
# only on stripes (the payload carries codec-encoded bytes), so the bit is
# unambiguous per op and the 48-byte layout stays frozen.
F_ENC = 2


class ProtocolError(ConnectionError):
    """The byte stream is not a valid frame (framing unrecoverable)."""


def _pack_id(tok: str) -> Optional[tuple[bytes, int]]:
    """Hex token (file_id / rkey) -> (8 padded raw bytes, true length),
    or None if it doesn't fit the fixed layout (caller falls back to
    JSON)."""
    if not tok:
        return b"\0" * 8, 0
    try:
        raw = bytes.fromhex(tok)
    except (ValueError, TypeError):
        return None
    if len(raw) > 8:
        return None
    return raw.ljust(8, b"\0"), len(raw)


def encode_bin_header(header: dict[str, Any], nbytes: int) -> Optional[bytes]:
    """Pack one hot-op header into the fixed bin1 layout.

    Returns ``None`` when the header does not fit the fast path (unknown
    op, oversized identifier) — the caller must fall back to JSON.  The
    four ops mirror the dict shapes the servers already produce, so the
    binary path is purely an encoding change.
    """
    op = header.get("op")
    flags = idx = n_stripes = credits = offset = size = 0
    packed = (b"\0" * 8, 0)
    if op == "stripe":
        code = OP_STRIPE
        packed = _pack_id(header.get("file_id", ""))
        idx = int(header.get("stripe_idx", 0))
        n_stripes = int(header.get("n_stripes", 0))
        offset = int(header.get("offset", 0))
        if header.get("sided"):
            flags |= F_SIDED
            size = int(header.get("size", 0))
        else:
            # non-sided stripes never used `size`; under CAP_CRC it
            # carries the payload checksum (0 when crc is off — exactly
            # what pre-crc senders always put there)
            size = int(header.get("crc", 0))
        if header.get("enc"):
            flags |= F_ENC
    elif op == "reg_block":
        code = OP_BLOCK
        packed = _pack_id(header.get("file_id", ""))
        offset = int(header.get("offset", 0))
        size = int(header.get("size", 0))
    elif op == "ack":
        code = OP_ACK
        flags |= F_OK if header.get("ok") else 0
        flags |= F_DUP if header.get("dup") else 0
        flags |= F_DONE if header.get("done") else 0
        idx = int(header.get("stripe_idx") or 0)
        credits = int(header.get("credits") or 0)
        offset = int(header.get("offset") or 0)
        size = int(header.get("size") or 0)
        packed = _pack_id(header.get("rkey", ""))
    elif op == "credit":
        code = OP_CREDIT
        credits = int(header.get("credits") or 0)
    else:
        return None
    if packed is None:
        return None
    fid, id_len = packed
    try:
        return _BIN.pack(BIN_MAGIC, BIN_VERSION, code, flags | (id_len << 4),
                         idx, fid, n_stripes, credits, offset, size, nbytes)
    except struct.error:        # out-of-range field (negative / too wide)
        return None


def decode_bin_header(buf) -> dict[str, Any]:
    """Unpack a 48-byte bin1 header into the equivalent JSON-header dict.

    The resulting dict carries ``"_bin": True`` so servers can reply in
    kind; the marker is stripped before any JSON re-encoding.
    """
    (magic, ver, code, flags, idx, fid, n_stripes, credits, offset, size,
     nbytes) = _BIN.unpack_from(buf, 0)
    if magic != BIN_MAGIC:
        raise ProtocolError(f"bad binary frame magic 0x{magic:02x}")
    if ver != BIN_VERSION:
        raise ProtocolError(f"unsupported binary wire version {ver}")
    op = _OP_NAME.get(code)
    if op is None:
        raise ProtocolError(f"unknown binary op {code}")
    ident = fid[:flags >> 4].hex()
    h: dict[str, Any] = {"op": op, "nbytes": nbytes, "_bin": True}
    if op == "stripe":
        h.update(file_id=ident, stripe_idx=idx, n_stripes=n_stripes,
                 offset=offset)
        if flags & F_SIDED:
            h.update(sided=1, size=size)
        elif size:
            # `size` on a non-sided stripe is the CAP_CRC checksum; the
            # receiver only *verifies* it on connections that negotiated
            # the capability, so a stray value from a buggy peer is inert
            h["crc"] = size
        if flags & F_ENC:
            h["enc"] = 1
    elif op == "reg_block":
        h.update(file_id=ident, offset=offset, size=size)
    elif op == "ack":
        h.update(ok=bool(flags & F_OK), dup=bool(flags & F_DUP),
                 done=bool(flags & F_DONE), stripe_idx=idx, credits=credits,
                 offset=offset, size=size)
        if ident:
            h["rkey"] = ident
    elif op == "credit":
        h.update(credits=credits)
    return h


# -- per-connection negotiation (the hello handshake) -----------------------

# Sockets that completed a hello handshake, mapped to the agreed format.
# Weak keys: entries die with their sockets, no unbounded registry.
_NEGOTIATED: "weakref.WeakKeyDictionary[socket.socket, str]" = \
    weakref.WeakKeyDictionary()
# Sockets mapped to the codec names the peer accepted (DESIGN.md §13).
# Absent / empty means "no codec": a pre-codec server ignores the offer
# (or errors on hello entirely) and the sender falls back to `none`.
_NEGOTIATED_CODECS: "weakref.WeakKeyDictionary[socket.socket, tuple]" = \
    weakref.WeakKeyDictionary()
# Sockets mapped to extra capability names both peers agreed on (today
# just CAP_CRC — payload checksums on stripe frames, DESIGN.md §15).
_NEGOTIATED_CAPS: "weakref.WeakKeyDictionary[socket.socket, tuple]" = \
    weakref.WeakKeyDictionary()

# With CAP_CRC agreed, every non-sided stripe frame carries a CRC32 of
# its payload: JSON stripes in header["crc"], bin1 stripes in the `size`
# struct field (unused for non-sided stripes — sided stripes keep `size`
# for the real region size and skip the checksum; their payload doesn't
# ride this socket).  The capability gate is what keeps the 48-byte bin1
# layout frozen: old peers never see a repurposed field.
CAP_CRC = "crc32"
SUPPORTED_CAPS = (CAP_CRC,)


def crc32(payload) -> int:
    """CRC32 over a payload (bytes-like or list of bytes-like)."""
    parts = (payload if isinstance(payload, (list, tuple))
             else [] if payload is None else [payload])
    c = 0
    for p in parts:
        c = zlib.crc32(memoryview(p).cast("B"), c)
    return c & 0xFFFFFFFF


def negotiate(sock: socket.socket,
              formats: Sequence[str] = SUPPORTED_WIRE,
              codecs: Sequence[str] = (),
              caps: Sequence[str] = ()) -> str:
    """Wire-format (+ codec) handshake: offer, adopt the server's pick.

    A server that predates the handshake answers the unknown ``hello`` op
    with an error — that *is* the negotiation: the connection stays on
    JSON. Likewise a pre-codec server simply omits ``codecs`` from its
    reply and the sender keeps shipping raw bytes (codec ``none``). The
    results are recorded per socket (:func:`negotiated`,
    :func:`negotiated_codecs`)."""
    offer: dict[str, Any] = {"op": "hello", "wire": list(formats)}
    if codecs:
        offer["codecs"] = list(codecs)
    if caps:
        offer["caps"] = list(caps)
    h, _ = request(sock, offer)
    fmt = h.get("wire") if h.get("ok") else None
    if fmt not in formats:
        fmt = WIRE_JSON
    _NEGOTIATED[sock] = fmt
    accepted = h.get("codecs") if h.get("ok") else None
    _NEGOTIATED_CODECS[sock] = tuple(
        c for c in (accepted or ()) if c in codecs)
    agreed = h.get("caps") if h.get("ok") else None
    _NEGOTIATED_CAPS[sock] = tuple(
        c for c in (agreed or ()) if c in caps)
    return fmt


def negotiated(sock: socket.socket) -> str:
    """The format agreed on ``sock`` (JSON when never negotiated)."""
    return _NEGOTIATED.get(sock, WIRE_JSON)


def negotiated_codecs(sock: socket.socket) -> tuple:
    """Codec names both peers speak (empty when never negotiated)."""
    return _NEGOTIATED_CODECS.get(sock, ())


def negotiated_caps(sock: socket.socket) -> tuple:
    """Extra capabilities both peers agreed on (empty pre-handshake)."""
    return _NEGOTIATED_CAPS.get(sock, ())


def set_negotiated_caps(sock: socket.socket, caps: Sequence[str]) -> None:
    """Record the agreed capability set server-side (the server learns
    the intersection when it builds its ``hello`` reply)."""
    _NEGOTIATED_CAPS[sock] = tuple(caps)


def hello_reply(header: dict[str, Any],
                supported: Sequence[str] = SUPPORTED_WIRE,
                codecs: Sequence[str] = (),
                caps: Sequence[str] = ()) -> dict[str, Any]:
    """Server side of the handshake: pick the client's most-preferred
    format this server also speaks (JSON is always common ground), and
    echo the subset of offered codecs this server can decode. Old clients
    never send ``codecs``; old servers never reply with it — either way
    the connection degrades to codec ``none`` silently."""
    reply: dict[str, Any] = {"ok": True, "wire": WIRE_JSON}
    for fmt in header.get("wire") or ():
        if fmt in supported:
            reply["wire"] = fmt
            break
    offered = header.get("codecs")
    if offered and codecs:
        reply["codecs"] = [c for c in offered if c in codecs]
    offered_caps = header.get("caps")
    if offered_caps and caps:
        reply["caps"] = [c for c in offered_caps if c in caps]
    return reply


# ---------------------------------------------------------------------------
# buffer reuse: per-thread header scratch + payload pool
# ---------------------------------------------------------------------------


class _Scratch(threading.local):
    """Per-thread reusable receive buffer for frame headers and drains."""

    def get(self, n: int) -> bytearray:
        buf = getattr(self, "buf", None)
        if buf is None or len(buf) < n:
            buf = self.buf = bytearray(max(n, 4096))
        return buf


_scratch = _Scratch()


class BufferPool:
    """Reusable payload buffers, power-of-two buckets, bounded.

    ``acquire(n)`` leases a length-``n`` memoryview over a pooled
    bytearray; ``release(view)`` returns the backing buffer for reuse.
    Never-released leases degrade to plain allocation — only callers that
    fully consume a payload before the next frame should release, so a
    handler that retains the payload simply keeps it.
    """

    def __init__(self, max_per_bucket: int = 8, max_bytes: int = 64 << 20):
        self._buckets: dict[int, list[bytearray]] = {}
        self._lock = threading.Lock()
        self._max_per_bucket = max_per_bucket
        self._max_bytes = max_bytes
        self._held_bytes = 0

    def acquire(self, n: int) -> memoryview:
        if n <= 0:
            return memoryview(bytearray())
        size = 1 << (n - 1).bit_length()
        with self._lock:
            bucket = self._buckets.get(size)
            if bucket:
                buf = bucket.pop()
                self._held_bytes -= size
            else:
                buf = None
        return memoryview(buf if buf is not None else bytearray(size))[:n]

    def release(self, view: memoryview) -> None:
        buf = view.obj
        view.release()
        if not isinstance(buf, bytearray):
            return
        size = len(buf)
        if size & (size - 1):           # not one of our pow2 buffers
            return
        with self._lock:
            bucket = self._buckets.setdefault(size, [])
            if len(bucket) < self._max_per_bucket and \
                    self._held_bytes + size <= self._max_bytes:
                bucket.append(buf)
                self._held_bytes += size


# ---------------------------------------------------------------------------
# send side
# ---------------------------------------------------------------------------


def _payload_views(payload) -> list[memoryview]:
    """Normalize a payload (None | bytes-like | list of bytes-like) into
    contiguous byte views for scatter-gather I/O."""
    if payload is None:
        return []
    parts = payload if isinstance(payload, (list, tuple)) else [payload]
    views = []
    for p in parts:
        v = p if isinstance(p, memoryview) else memoryview(p)
        v = v.cast("B")
        if len(v):
            views.append(v)
    return views


def encode_frame(header: dict[str, Any], payload=None,
                 fmt: str = WIRE_JSON) -> list:
    """Encode one frame into an iovec list (header bytes + payload views,
    payload never copied). ``fmt=bin1`` uses the fixed fast-path layout
    for hot ops and falls back to JSON for everything else — JSON remains
    the control path on binary connections."""
    views = _payload_views(payload)
    nbytes = sum(len(v) for v in views)
    if fmt == WIRE_BIN1:
        hb = encode_bin_header(header, nbytes)
        if hb is not None:
            # binary error acks carry the message as their payload
            if header.get("op") == "ack" and not header.get("ok") \
                    and not views and header.get("error"):
                err = str(header["error"]).encode("utf-8", "replace")
                hb = encode_bin_header(header, len(err))
                return [hb, err]
            return [hb, *views]
    clean = {k: v for k, v in header.items() if not k.startswith("_")}
    hb = json.dumps(dict(clean, nbytes=nbytes)).encode()
    return [_LEN.pack(len(hb)) + hb, *views]


_HAS_SENDMSG = hasattr(socket.socket, "sendmsg")
_IOV_CAP = 512      # stay well under IOV_MAX (1024 on Linux)


def sendmsg_all(sock: socket.socket, bufs: Sequence) -> None:
    """Send every buffer, scatter-gather, handling partial sends."""
    views = [v for v in (b if isinstance(b, memoryview) else memoryview(b)
                         for b in bufs) if len(v)]
    if not _HAS_SENDMSG:
        for v in views:
            sock.sendall(v)
        return
    i, off = 0, 0
    while i < len(views):
        batch = [views[i][off:] if off else views[i]]
        batch.extend(views[i + 1:i + _IOV_CAP])
        n = sock.sendmsg(batch)
        if n == 0:
            raise ConnectionError("sendmsg: peer closed")
        while n and i < len(views):
            rem = len(views[i]) - off
            if n >= rem:
                n -= rem
                i += 1
                off = 0
            else:
                off += n
                n = 0


def send_frame(sock: socket.socket, header: dict[str, Any],
               payload: Optional[memoryview | bytes] = None) -> None:
    """Legacy JSON frame send (byte-identical to the pre-bin1 wire)."""
    inj = _FAULT_INJECTOR
    frames = [(header, payload)]
    if inj is not None:
        frames = inj.on_send(sock, frames)
    for header, payload in frames:
        payload = b"" if payload is None else payload
        clean = {k: v for k, v in header.items() if not k.startswith("_")}
        hb = json.dumps(dict(clean, nbytes=len(payload))).encode()
        sock.sendall(_LEN.pack(len(hb)) + hb)
        if len(payload):
            sock.sendall(payload)


def send_frame_bin(sock: socket.socket, header: dict[str, Any],
                   payload=None) -> None:
    """Send one frame on the bin1 fast path (one ``sendmsg`` for header +
    payload); non-hot headers transparently ride JSON."""
    inj = _FAULT_INJECTOR
    frames = [(header, payload)]
    if inj is not None:
        frames = inj.on_send(sock, frames)
    bufs: list = []
    for h, p in frames:
        bufs.extend(encode_frame(h, p, WIRE_BIN1))
    sendmsg_all(sock, bufs)


def send_frames_vectored(sock: socket.socket,
                         frames: Iterable[tuple], fmt: str = WIRE_JSON) -> int:
    """Scatter-gather many ``(header, payload)`` frames into as few
    ``sendmsg`` calls as possible (one, below the iovec cap).  ``payload``
    may itself be a list of buffers — nothing is concatenated in user
    space.  Returns the number of frames sent."""
    inj = _FAULT_INJECTOR
    if inj is not None:
        frames = inj.on_send(sock, list(frames))
    bufs: list = []
    n = 0
    for header, payload in frames:
        bufs.extend(encode_frame(header, payload, fmt))
        n += 1
    if bufs:
        sendmsg_all(sock, bufs)
    return n


def send_frame_from_file(sock: socket.socket, header: dict[str, Any],
                         fd: int, count: int, offset: int = 0,
                         timeout: float = 30.0) -> None:
    """Zero-copy payload path (os.sendfile == splice on Linux).

    Sockets with a timeout are internally non-blocking: sendfile raises
    EAGAIN when the send buffer fills — wait for writability and resume.
    A peer that never drains makes writability never arrive; that is a
    ``TimeoutError``, not a spin.
    """
    import select
    header = dict(header, nbytes=count)
    hb = json.dumps(header).encode()
    sock.sendall(_LEN.pack(len(hb)) + hb)
    sent = 0
    while sent < count:
        try:
            n = os.sendfile(sock.fileno(), fd, offset + sent, count - sent)
        except BlockingIOError:
            _, writable, _ = select.select([], [sock], [], timeout)
            if not writable:
                raise TimeoutError(
                    f"sendfile: peer not writable for {timeout}s "
                    f"({sent}/{count} bytes sent)") from None
            continue
        if n == 0:
            raise ConnectionError("sendfile: peer closed")
        sent += n


# ---------------------------------------------------------------------------
# receive side
# ---------------------------------------------------------------------------


def recv_into(sock: socket.socket, view) -> None:
    """Receive exactly ``len(view)`` bytes into a writable buffer."""
    mv = memoryview(view).cast("B")
    n = len(mv)
    got = 0
    while got < n:
        r = sock.recv_into(mv[got:], min(n - got, CHUNK))
        if r == 0:
            raise ConnectionError("recv: peer closed")
        got += r


def recv_header(sock: socket.socket) -> dict[str, Any]:
    """Read one frame header — bin1 (magic-discriminated) or JSON.

    Header bytes land in a per-thread scratch buffer: no per-frame
    allocation, and the JSON text is decoded straight from the scratch
    view (the old path materialized the buffer twice via ``bytes()``).
    Binary headers set ``"_bin": True`` so servers can reply in kind.
    """
    scratch = _scratch.get(BIN_HEADER_LEN)
    recv_into(sock, memoryview(scratch)[:8])
    if scratch[0] == BIN_MAGIC:
        recv_into(sock, memoryview(scratch)[8:BIN_HEADER_LEN])
        return decode_bin_header(scratch)
    hlen = _LEN.unpack_from(scratch, 0)[0]
    if hlen > MAX_HEADER_LEN:
        raise ProtocolError(
            f"frame header length {hlen} exceeds {MAX_HEADER_LEN} "
            "(corrupt or hostile length prefix)")
    scratch = _scratch.get(hlen)
    recv_into(sock, memoryview(scratch)[:hlen])
    return json.loads(str(memoryview(scratch)[:hlen], "utf-8"))


def recv_payload(sock: socket.socket, header: dict[str, Any],
                 pool: Optional[BufferPool] = None):
    """Receive a frame's payload. With ``pool``, the buffer is leased
    from it (caller releases when done); otherwise a fresh bytearray."""
    n = int(header.get("nbytes") or 0)
    if n > MAX_PAYLOAD_LEN:
        raise ProtocolError(
            f"frame payload length {n} exceeds {MAX_PAYLOAD_LEN} "
            "(corrupt or hostile header)")
    if pool is not None:
        buf = pool.acquire(n)
        if n:
            recv_into(sock, buf)
        return buf
    buf = bytearray(n)
    if n:
        recv_into(sock, buf)
    return buf


def drain_payload(sock: socket.socket, header: dict[str, Any]) -> None:
    """Consume and discard a frame's payload in bounded chunks — for
    rejecting a frame whose declared size should not be trusted with a
    single up-front allocation. Reuses the per-thread scratch buffer
    instead of allocating per call."""
    n = int(header.get("nbytes") or 0)
    if n > MAX_PAYLOAD_LEN:
        raise ProtocolError(
            f"frame payload length {n} exceeds {MAX_PAYLOAD_LEN} "
            "(corrupt or hostile header)")
    if not n:
        return
    view = memoryview(_scratch.get(min(n, CHUNK)))
    got = 0
    while got < n:
        r = sock.recv_into(view[:min(n - got, CHUNK)])
        if r == 0:
            raise ConnectionError("recv: peer closed")
        got += r


def recv_frame(sock: socket.socket,
               pool: Optional[BufferPool] = None) -> tuple[dict[str, Any], Any]:
    header = recv_header(sock)
    inj = _FAULT_INJECTOR
    if inj is not None:
        inj.on_recv(sock, header)
    payload = recv_payload(sock, header, pool)
    # binary error acks carry their message as the payload
    if header.get("_bin") and header.get("op") == "ack" \
            and not header.get("ok") and len(payload):
        header["error"] = bytes(payload).decode("utf-8", "replace")
    return header, payload


def request(sock: socket.socket, header: dict[str, Any],
            payload: Optional[memoryview | bytes] = None):
    send_frame(sock, header, payload)
    return recv_frame(sock)


def connect(addr: str, timeout: float = 30.0) -> socket.socket:
    inj = _FAULT_INJECTOR
    if inj is not None:
        inj.check_connect(addr)      # active partition => ConnectionError
    host, port = addr.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=timeout)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    if inj is not None:
        inj.register(s, addr)        # bring the new conn into fault scope
    return s


class ConnCache:
    """One cached connection per (calling thread, addr), tracked for close.

    The I/O pools want one connection per worker thread (≈ an RC QP, or
    an ssh session in the copy emulation); ``close_all`` is hooked to the
    owner's stop path so no connection outlives its pool.  ``factory``
    may build anything with a ``close()`` method (sockets, clients).

    The per-thread cache is keyed by ``addr``: a thread that talks to two
    endpoints gets two connections — it used to silently reuse whichever
    connection it opened first, sending frames to the wrong server.
    """

    def __init__(self):
        import threading
        self._local = threading.local()
        self._all: list = []
        self._lock = threading.Lock()

    def get(self, addr: str, factory=connect):
        objs = getattr(self._local, "objs", None)
        if objs is None:
            objs = self._local.objs = {}
        obj = objs.get(addr)
        if obj is None:
            obj = objs[addr] = factory(addr)
            with self._lock:
                self._all.append(obj)
        return obj

    def invalidate(self, addr: str) -> None:
        """Drop (and close) the *calling thread's* cached connection to
        ``addr`` — the reconnect path after a send/recv error, so the next
        ``get`` builds a fresh one instead of reusing a dead socket."""
        objs = getattr(self._local, "objs", None)
        obj = objs.pop(addr, None) if objs else None
        if obj is None:
            return
        with self._lock:
            try:
                self._all.remove(obj)
            except ValueError:
                pass
        try:
            obj.close()
        except (OSError, RuntimeError):
            pass

    def close_all(self) -> None:
        with self._lock:
            objs, self._all = self._all, []
        for o in objs:
            try:
                o.close()
            except (OSError, RuntimeError):
                pass
