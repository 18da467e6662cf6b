"""Striped multi-channel transfers with credit-based flow control.

The paper's block-size experiment (§3–4) probes how transfer granularity
amortizes per-block costs; this module adds the orthogonal axis the
bandwidth-saturation regime needs: **parallelism across connections**
(Catalyst-ADIOS2 stripes in-transit traffic across concurrent streams;
SDN-for-Big-Data shows multi-path transfer as the scaling lever).

    ChannelGroup(addr, n_channels=4, stripe_bytes=4 << 20, credits=4)

splits each dataset into stripes round-robined across N concurrent
connections. Per channel the sender pipelines up to ``window`` unacked
stripes; every ack replenishes one credit and carries the receiver's new
grant, so a receiver under pressure (staging memory filling because the
SAVIME hop is slow) shrinks the window toward 1 and the producers slow
down instead of ballooning staging memory. The receiver reassembles
stripes out of order — each stripe frame carries ``(name, stripe_idx,
n_stripes, offset)`` and lands at its offset whatever channel or order it
arrives in.

Wire protocol (speaks the generic frame format in :mod:`repro_torch.core.wire`;
both the staging server and the copy-emulation servers implement it):

    stripe_open  {name, dtype, size, n_stripes, credits}
                 -> {ok, file_id, credits[, path]}   (control connection)
    stripe       {file_id, name, stripe_idx, n_stripes, offset} + payload
                 -> {ok, stripe_idx, done, dup, credits}   (data channels,
                 pipelined; acks return in order per channel)

The server must always grant >= 1 credit: a zero grant with an empty
pipeline would leave no ack to ever raise it again.

With ``wire_format="bin1"`` (negotiated on the control connection at
open — the handshake with an old server falls back to JSON) the stripe
and ack frames ride the struct-packed fast path of
:mod:`repro_torch.core.wire`, the sender scatter-gathers every credit-admitted
stripe waiting in its queue into a single ``sendmsg``
(``send_frames_vectored``), and the receiver honours unsolicited
``credit`` frames the staging server pushes when a SAVIME forward frees
memory (window update without consuming an ack). Engines that plug in a
custom ``send_frame`` (the copy emulations and their 16K-copy + CRC cost
model) never negotiate binary and never vector — their measured per-frame
overhead *is* the baseline.

Two data planes per stripe, chosen automatically per dataset:

  * **one-sided** — when ``stripe_open`` returns a ``path`` that exists
    locally (the staging server's tmpfs region, reachable because client
    and server share the emulated RDMA fabric), the sender performs the
    stripe as a one-sided mmap write at its offset and the channel frame
    is control-only (``sided=1``, no payload). Per-byte cost equals the
    block path's single memcpy; the credit window plays the role of a
    QP's send-queue depth.
  * **payload** — otherwise the stripe's bytes ride the channel socket
    and the receiver reassembles them at their offset (the copy-emulation
    engines, or a staging server across a real network).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core import wire
from repro_torch.core.blocks import plan_blocks
from repro_torch.core.rdma import RdmaWriter, writer_for_reply
from repro_torch.core.retry import RetryPolicy

DEFAULT_STRIPE_BYTES = 4 << 20
DEFAULT_CREDITS = 4

# consecutive CRC-rejected stripes before a bin1 channel falls back to
# JSON frames (persistent corruption on the binary path — DESIGN.md §15)
_CRC_FALLBACK_AFTER = 3


@dataclasses.dataclass
class ChannelStats:
    """Per-channel byte/latency breakdown (surfaced in TransferStats)."""

    channel: int
    nbytes: int = 0             # payload bytes acked on this channel
    n_stripes: int = 0          # stripes acked
    stripe_s: float = 0.0       # sum of send->ack wall time per stripe
    credit_wait_s: float = 0.0  # time the sender blocked waiting for credit
    peak_unacked: int = 0       # high-water mark of in-flight stripes
    window: int = 0             # last grant from the receiver
    failed_over: int = 0        # stripes re-homed away when this chan died
    adopted: int = 0            # stripes re-homed onto this channel
    crc_retries: int = 0        # stripes resent after a CRC rejection
    wire_fallbacks: int = 0     # bin1 -> JSON downgrades (persistent CRC)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Transfer:
    """Completion tracker for one striped dataset."""

    _GUARDED_BY = {
        "_remaining": "_lock",
        "_finished": "_lock",
        "_callbacks": "_lock",
    }

    def __init__(self, name: str, n_stripes: int, nbytes: int,
                 on_done: Optional[Callable[["_Transfer"], None]] = None,
                 writer: Optional[RdmaWriter] = None):
        self.name = name
        self.nbytes = nbytes
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self._remaining = n_stripes
        self._lock = threading.Lock()
        self._finished = False
        self._callbacks: list[Callable[["_Transfer"], None]] = \
            [on_done] if on_done else []
        self._writer = writer
        if n_stripes == 0:
            self._finished = True
            self._finish()

    def stripe_done(self) -> None:
        with self._lock:
            self._remaining -= 1
            if self._remaining != 0 or self._finished:
                return
            self._finished = True
        self._finish()

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self.error is None:
                self.error = exc
            if self._finished:
                return
            self._finished = True
        self._finish()

    def add_done_callback(self, fn: Callable[["_Transfer"], None]) -> None:
        with self._lock:
            if not self._finished:
                self._callbacks.append(fn)
                return
        fn(self)

    def _finish(self) -> None:
        # release the one-sided mapping before signalling: a producer that
        # frees/mutates the region file on completion must not race a
        # still-open writer view
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:  # noqa: BLE001 — completion must not throw
                pass
            self._writer = None
        with self._lock:
            callbacks, self._callbacks = self._callbacks, []
        self.event.set()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — callbacks must not break acks
                pass


class _Stripe:
    __slots__ = ("transfer", "file_id", "name", "idx", "n_stripes",
                 "offset", "view", "writer", "enc")

    def __init__(self, transfer, file_id, name, idx, n_stripes, offset,
                 view, writer=None, enc=False):
        self.transfer = transfer
        self.file_id = file_id
        self.name = name
        self.idx = idx
        self.n_stripes = n_stripes
        self.offset = offset
        self.view = view
        self.writer = writer        # RdmaWriter => one-sided data plane
        self.enc = enc              # payload is codec-encoded (F_ENC flag)


_MAX_VECTOR = 64        # frames per sendmsg burst (2 iovecs each, < IOV cap)


class _Channel:
    """One connection + sender/receiver thread pair with a credit window."""

    # ``_dead`` is deliberately *not* declared: it is published under both
    # _inflight_lock and _cond (see _fail) and the sender's top-of-loop
    # read is a benign racy fast-path — the authoritative check-and-append
    # happens under _inflight_lock.
    _GUARDED_BY = {
        "_unacked": "_cond",
        "_window": "_cond",
        "_closing": "_cond",
        "_inflight": "_inflight_lock",
    }

    def __init__(self, index: int, addr: str, credits: int,
                 connect: Callable, send_frame: Callable,
                 wire_format: str = wire.WIRE_JSON,
                 on_fail: Optional[Callable] = None):
        self.index = index
        self.stats = ChannelStats(channel=index, window=credits)
        self._send_frame = send_frame
        self._fmt = wire_format
        # when a channel dies, its queued + in-flight stripes are handed
        # to this group hook for re-homing on surviving channels instead
        # of failing their transfers (None keeps the fail-fast behaviour)
        self._on_fail = on_fail
        # vectored bursts re-encode frames; only safe on the stock frame
        # writer (a custom send_frame carries an engine's own cost model)
        self._can_vector = send_frame is wire.send_frame
        self.sock = connect(addr)
        # data channels block until shutdown, not until an idle timeout:
        # an idle receiver parked in recv must not kill a healthy channel
        self.sock.settimeout(None)
        self._crc = False
        if self._can_vector:
            # per-connection handshake *before* the receiver thread owns
            # the socket: CRC verification is gated on this connection's
            # negotiated caps (an old server just leaves caps empty)
            try:
                wire.negotiate(self.sock, formats=(self._fmt,),
                               caps=wire.SUPPORTED_CAPS)
            except (ConnectionError, OSError):
                pass          # stays uncapped; frames still self-describe
            self._crc = wire.CAP_CRC in wire.negotiated_caps(self.sock)
        self._consecutive_crc = 0
        self.q: queue.Queue = queue.Queue()
        self._cond = threading.Condition()
        self._window = max(1, credits)
        self._unacked = 0
        self._inflight: collections.deque = collections.deque()
        self._inflight_lock = threading.Lock()
        self._dead: Optional[BaseException] = None
        self._closing = False
        self._sender = threading.Thread(target=self._send_loop,
                                        name=f"chan{index}-send", daemon=True)
        self._receiver = threading.Thread(target=self._recv_loop,
                                          name=f"chan{index}-recv",
                                          daemon=True)
        self._sender.start()
        self._receiver.start()

    # -- sender ---------------------------------------------------------
    _ADMITTED, _FAILED, _DEFER = range(3)

    def _admit(self, item, block: bool) -> int:
        """Acquire one credit for ``item`` (blocking or opportunistic).

        Tri-state so the caller's requeue decision is unambiguous:
        ``_FAILED`` means the channel is dead or closing (the caller
        hands the untouched item to ``_handoff``); ``_DEFER``
        (non-blocking only) means no credit was free and the item is
        untouched."""
        t0 = time.perf_counter()
        with self._cond:
            if self._dead is None and not self._closing \
                    and not block and self._unacked >= self._window:
                return self._DEFER
            while self._unacked >= self._window and self._dead is None \
                    and not self._closing:
                self._cond.wait(0.5)
            if self._dead is not None or self._closing:
                return self._FAILED
            self._unacked += 1
            self.stats.peak_unacked = max(self.stats.peak_unacked,
                                          self._unacked)
        self.stats.credit_wait_s += time.perf_counter() - t0
        return self._ADMITTED

    def _release_credit(self) -> None:
        with self._cond:
            self._unacked -= 1
            self._cond.notify_all()

    def _prepare(self, item) -> Optional[tuple]:
        """Build one stripe frame; performs the one-sided mmap store for
        sided items. Returns ``(header, payload)`` or None on an
        item-local failure (credit released, transfer failed)."""
        header = {"op": "stripe", "file_id": item.file_id,
                  "name": item.name, "stripe_idx": item.idx,
                  "n_stripes": item.n_stripes, "offset": item.offset}
        if item.enc:
            header["enc"] = 1       # rides the F_ENC flag on bin1
        payload = item.view
        if item.writer is not None:
            # one-sided plane: the stripe is a raw mmap store (numpy
            # copyto releases the GIL, so channels copy concurrently);
            # only the control frame rides the socket
            try:
                item.writer.write(item.offset, item.view)
            except Exception as e:  # noqa: BLE001 — item-local failure
                self._release_credit()
                item.transfer.fail(e)
                return None
            header["sided"] = 1
            header["size"] = len(item.view)
            payload = None
        elif self._crc and len(item.view):
            header["crc"] = wire.crc32(item.view)
        return header, payload

    def _handoff(self, items, exc: BaseException) -> None:
        """Route stripes a dead channel cannot carry: re-home them via the
        group hook (degrade to fewer channels), or fail their transfers
        when there is no hook / the group is closing."""
        if not items:
            return
        with self._cond:
            closing = self._closing
        if self._on_fail is not None and not closing:
            self.stats.failed_over += len(items)
            self._on_fail(self, exc, items)
            return
        for it in items:
            it.transfer.fail(exc)

    def _send_loop(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            if self._dead is not None:
                self._handoff([item], self._dead)
                continue
            if self._admit(item, block=True) is not self._ADMITTED:
                self._handoff([item], self._dead
                              or ConnectionError("channel closed"))
                continue
            batch = [item]
            # opportunistic burst: drain further queued stripes while the
            # credit window allows, so a run of small stripes becomes one
            # scatter-gather sendmsg instead of 2 syscalls per stripe
            if self._can_vector:
                while len(batch) < _MAX_VECTOR:
                    try:
                        nxt = self.q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:           # shutdown sentinel: requeue
                        self.q.put(None)
                        break
                    admitted = self._admit(nxt, block=False)
                    if admitted is self._DEFER:
                        # out of credits, item untouched: requeue so it is
                        # either sent later or re-homed by the top-of-loop
                        # dead-check — never silently dropped
                        self.q.put(nxt)
                        break
                    if admitted is self._FAILED:
                        self._handoff([nxt], self._dead
                                      or ConnectionError("channel closed"))
                        break
                    batch.append(nxt)
            frames = []
            admitted = []
            for it in batch:
                prep = self._prepare(it)
                if prep is not None:
                    frames.append(prep)
                    admitted.append(it)
            if not frames:
                continue
            # append before sending: one sender per channel, so deque order
            # matches wire order and the receiver can match acks FIFO.
            # The dead-check must share the inflight lock with _fail's
            # drain — otherwise an item appended just after the receiver
            # failed the channel is never failed and its transfer (and any
            # untimed sync on it) hangs forever.
            with self._inflight_lock:
                if self._dead is not None:
                    for it in admitted:
                        self._release_credit()
                        it.transfer.fail(self._dead)
                    continue
                now = time.perf_counter()
                for it in admitted:
                    self._inflight.append((it, now))
            try:
                if len(frames) == 1:
                    header, payload = frames[0]
                    if self._fmt == wire.WIRE_BIN1:
                        wire.send_frame_bin(self.sock, header, payload)
                    else:
                        self._send_frame(self.sock, header, payload)
                else:
                    wire.send_frames_vectored(self.sock, frames,
                                              fmt=self._fmt)
            except (OSError, ValueError) as e:
                self._fail(e)

    # -- receiver -------------------------------------------------------
    def _recv_loop(self) -> None:
        while True:
            try:
                h, _ = wire.recv_frame(self.sock)
            except (ConnectionError, OSError) as e:
                # fail any stripes still awaiting acks even on a shutdown
                # race — a sender parked on credits must not wait forever
                with self._cond:
                    closing = self._closing
                self._fail(e if not closing
                           else ConnectionError("channel closed"))
                return
            if h.get("op") == "credit":
                # unsolicited server push (staging memory freed): adopt
                # the new grant without consuming an ack
                with self._cond:
                    self._window = max(1, int(h.get("credits",
                                                    self._window)))
                    self.stats.window = self._window
                    self._cond.notify_all()
                continue
            with self._inflight_lock:
                head = self._inflight[0][0] if self._inflight else None
                # a dup ack that does not match the FIFO head is
                # *unsolicited*: the server deduped a duplicated frame
                # (fault-injected, or a stripe delivered both on its dying
                # channel and on the one it was re-homed to). That frame
                # never consumed a credit here, so skip it without popping
                # or decrementing — popping would desync every later ack.
                unsolicited = bool(h.get("dup")) and (
                    head is None or head.idx != h.get("stripe_idx"))
                item, t_sent = (None, None) if unsolicited else (
                    self._inflight.popleft() if self._inflight
                    else (None, None))
            with self._cond:
                if not unsolicited:
                    self._unacked -= 1
                self._window = max(1, int(h.get("credits", self._window)))
                self.stats.window = self._window
                self._cond.notify_all()
            if unsolicited:
                continue
            if item is None:       # ack with no matching stripe: corrupt
                self._fail(wire.ProtocolError("unmatched stripe ack"))
                return
            self.stats.stripe_s += time.perf_counter() - t_sent
            if h.get("ok"):
                self._consecutive_crc = 0
                self.stats.nbytes += len(item.view)
                self.stats.n_stripes += 1
                item.transfer.stripe_done()
            elif h.get("code") == "corrupt" or \
                    "crc mismatch" in str(h.get("error") or ""):
                # CRC rejection: the server dropped the stripe (it is NOT
                # in stripes_seen), so resending is safe and required.
                # After a run of consecutive rejections the binary path
                # itself is suspect — degrade this channel to JSON frames
                # (DESIGN.md §15 degradation ladder).
                self.stats.crc_retries += 1
                self._consecutive_crc += 1
                if self._consecutive_crc >= _CRC_FALLBACK_AFTER \
                        and self._fmt == wire.WIRE_BIN1:
                    self._fmt = wire.WIRE_JSON
                    self.stats.wire_fallbacks += 1
                self.q.put(item)
            else:
                item.transfer.fail(
                    RuntimeError(f"stripe rejected: {h.get('error')}"))

    def set_window(self, grant: int) -> None:
        """Adopt a receiver grant arriving out of band (stripe_open)."""
        with self._cond:
            self._window = max(1, int(grant))
            self.stats.window = self._window
            self._cond.notify_all()

    # -- failure / shutdown --------------------------------------------
    def _fail(self, exc: BaseException) -> None:
        with self._inflight_lock:
            # _dead is published under the inflight lock so the sender's
            # check-and-append is atomic against this drain
            with self._cond:
                if self._dead is None:
                    self._dead = exc
                self._cond.notify_all()
            inflight, self._inflight = list(self._inflight), \
                collections.deque()
        orphans = [item for item, _t in inflight]
        # queued-but-unsent stripes would otherwise wait for the sender's
        # top-of-loop dead-check; drain them now so re-homing is prompt
        while True:
            try:
                nxt = self.q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                self.q.put(None)    # keep the shutdown sentinel
                break
            orphans.append(nxt)
        self._handoff(orphans, exc)

    def close(self) -> None:
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        self.q.put(None)
        # close() can run on this channel's own sender/receiver thread:
        # when the *last* live channel dies, its _fail -> _adopt_orphans
        # -> _rebuild_channels chain closes the old set (including
        # itself) before the failing thread unwinds. Joining yourself
        # raises and strands the orphans mid-handoff, so skip the
        # self-join — the thread exits as soon as the unwind finishes.
        me = threading.current_thread()
        if self._sender is not me:
            self._sender.join(5.0)
        try:
            self.sock.shutdown(2)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if self._receiver is not me:
            self._receiver.join(5.0)


class ChannelGroup:
    """N concurrent striped channels + one control connection.

    ``send_dataset`` is thread-safe and blocking (it returns when every
    stripe is acked), which makes it a drop-in task body for the FCFS I/O
    pools — sync()/TaskHandle semantics are unchanged while each dataset's
    stripes fan out across all channels.

    ``connect`` / ``send_frame`` are pluggable so the copy-emulation
    engines can keep their cost model (16K userspace chunk copies + CRC
    per stripe) while reusing the striping/credit machinery.
    """

    _GUARDED_BY = {
        "_rr": "_ctrl_lock",
        "_outstanding": "_outstanding_cond",
    }

    def __init__(self, addr: str, n_channels: int,
                 stripe_bytes: int = DEFAULT_STRIPE_BYTES,
                 credits: int = DEFAULT_CREDITS,
                 connect: Callable = wire.connect,
                 send_frame: Callable = wire.send_frame,
                 transfer_timeout: float = 300.0,
                 wire_format: str = wire.WIRE_JSON,
                 retry: Optional[RetryPolicy] = None):
        if n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {n_channels}")
        if stripe_bytes < 1:
            raise ValueError(f"stripe_bytes must be >= 1, got {stripe_bytes}")
        self.addr = addr
        self.n_channels = n_channels
        self.stripe_bytes = stripe_bytes
        self.credits = max(1, credits)
        self.transfer_timeout = transfer_timeout
        self._connect = connect
        self._send_frame = send_frame
        # engines with a custom frame writer (copy emulations) keep their
        # cost model: they never negotiate the binary fast path
        self.wire_format = wire_format \
            if send_frame is wire.send_frame else wire.WIRE_JSON
        self._retry = retry or RetryPolicy()
        self._channels: list[_Channel] = []
        self._ctrl = None                     # set once in open()
        self._ctrl_lock = threading.Lock()
        self._rebuild_lock = threading.Lock()
        self._retired: list[dict] = []        # stats of replaced channels
        self._rr = 0
        self._opened = False
        self._closed = False
        self._outstanding = 0                 # submitted, not yet finished
        self._outstanding_cond = threading.Condition()

    # -- lifecycle ------------------------------------------------------
    def open(self) -> "ChannelGroup":
        if self._opened:
            return self
        self._ctrl = self._connect(self.addr)
        if self.wire_format == wire.WIRE_BIN1:
            # per-connection handshake on the control conn: an old server
            # answers the unknown hello op with an error and every
            # connection of this group stays on JSON
            self.wire_format = wire.negotiate(self._ctrl)
        self._channels = [
            _Channel(i, self.addr, self.credits, self._connect,
                     self._send_frame, wire_format=self.wire_format,
                     on_fail=self._adopt_orphans)
            for i in range(self.n_channels)
        ]
        self._opened = True
        return self

    def close(self, drain_timeout: float = 30.0) -> None:
        if self._closed:
            return
        self._closed = True
        # let in-flight transfers finish before tearing the sockets down —
        # a write that was going to succeed must still succeed when the
        # producer closes immediately after submitting (pool-stop parity)
        try:
            self.sync(drain_timeout)
        except TimeoutError:
            pass
        for ch in self._channels:
            ch.close()
        if self._ctrl is not None:
            try:
                self._ctrl.close()
            except OSError:
                pass

    # -- failover -------------------------------------------------------
    def _live_channels(self) -> list[_Channel]:
        return [ch for ch in self._channels if ch._dead is None]

    def _adopt_orphans(self, dead_ch: _Channel, exc: BaseException,
                       items: list) -> None:
        """Re-home a dead channel's queued + in-flight stripes onto the
        survivors — the striped transfer collapses to fewer channels
        instead of failing. A re-sent stripe the server already holds
        comes back as a dup ack (idempotent), so replaying
        maybe-delivered in-flight stripes is safe. Only when *every*
        channel is dead is the set rebuilt from scratch; if that fails
        too, the transfers fail with the rebuild error."""
        if self._closed:
            for it in items:
                it.transfer.fail(exc)
            return
        live = self._live_channels()
        if not live:
            try:
                live = self._rebuild_channels()
            except (ConnectionError, OSError) as e:
                for it in items:
                    it.transfer.fail(e)
                return
        for i, it in enumerate(items):
            tgt = live[i % len(live)]
            tgt.stats.adopted += 1
            tgt.q.put(it)

    def _rebuild_channels(self) -> list[_Channel]:
        """Every channel is dead: build a fresh set with backoff and swap
        it in. Serialised on its own lock so concurrent handoffs elect one
        rebuilder; latecomers adopt its result."""
        with self._rebuild_lock:
            live = self._live_channels()
            if live:                    # another thread already rebuilt
                return live
            fresh: list[_Channel] = []
            for attempt in self._retry.attempts("channel rebuild"):
                fresh = []
                try:
                    for i in range(self.n_channels):
                        fresh.append(_Channel(
                            i, self.addr, self.credits, self._connect,
                            self._send_frame,
                            wire_format=self.wire_format,
                            on_fail=self._adopt_orphans))
                    break
                except (ConnectionError, OSError) as e:
                    for ch in fresh:    # all-or-nothing construction
                        ch.close()
                    attempt.backoff(e)  # raises RetryExhausted at the end
            old, self._channels = self._channels, fresh
            self._retired.extend(ch.stats.as_dict() for ch in old)
            for ch in old:
                ch.close()
            return fresh

    def _reopen_ctrl(self) -> None:
        """Replace a dead control connection (stripe_open retry path).
        The reconnect + re-handshake round-trip under the lock *is* the
        serialisation against concurrent submitters."""
        with self._ctrl_lock:  # lint: ignore[io-under-lock]
            if self._ctrl is not None:
                try:
                    self._ctrl.close()
                except OSError:
                    pass
                self._ctrl = None
            ctrl = self._connect(self.addr)
            if self._send_frame is wire.send_frame and \
                    self.wire_format == wire.WIRE_BIN1:
                self.wire_format = wire.negotiate(ctrl)
            self._ctrl = ctrl

    # -- data plane -----------------------------------------------------
    def _plan_stripes(self, nbytes: int) -> list[tuple[int, int]]:
        """Stripe plan: at most ``stripe_bytes`` each, but small enough
        that every dataset spans all channels — a dataset shorter than
        ``n_channels * stripe_bytes`` would otherwise leave channels idle
        (64 KiB floor so tiny writes do not shatter into confetti)."""
        per_channel = -(-nbytes // self.n_channels)     # ceil div
        floor = min(self.stripe_bytes, 64 << 10)  # never override the knob
        stripe = max(min(self.stripe_bytes, per_channel), floor, 1)
        return plan_blocks(nbytes, stripe)

    def submit_dataset(self, name: str, dtype: str, buf,
                       codec_info: Optional[dict] = None,
                       epoch: Optional[str] = None) -> _Transfer:
        """Asynchronously stripe one named buffer across all channels.

        Returns the :class:`_Transfer` tracker immediately after the
        stripes are enqueued — datasets pipeline through the channels
        back-to-back (stripes of the next dataset flow while the previous
        one's acks are still in flight), which is where the striped path's
        throughput comes from: a blocking per-dataset send would drain the
        pipeline between datasets.

        ``codec_info`` (codec/cmeta/raw_size/decode_at from the sender's
        encode stage) rides the ``stripe_open`` control frame; the stripes
        themselves are then flagged ``enc`` so receivers can sanity-check
        that encoded payloads only land in codec-opened datasets.
        """
        if not self._opened or self._closed:
            raise RuntimeError("ChannelGroup not open")
        arr = buf if isinstance(buf, np.ndarray) else \
            np.frombuffer(buf, dtype=np.uint8)
        flat = arr.reshape(-1).view(np.uint8)
        nbytes = flat.nbytes
        stripes = self._plan_stripes(nbytes)
        req = dict({"op": "stripe_open", "name": name, "dtype": dtype,
                    "size": nbytes, "n_stripes": len(stripes),
                    "credits": self.credits}, **(codec_info or {}))
        if epoch is not None:
            req["epoch"] = epoch
        for attempt in self._retry.attempts(f"stripe_open {name!r}"):
            try:
                # request/reply on the shared control conn must be
                # serialized; the blocking round-trip under the lock is
                # the serialization itself
                with self._ctrl_lock:  # lint: ignore[io-under-lock]
                    if self._ctrl is None:
                        raise ConnectionError("control connection down")
                    h, _ = wire.request(self._ctrl, req)
                break
            except (ConnectionError, OSError) as e:
                try:
                    self._reopen_ctrl()
                except (ConnectionError, OSError):
                    pass          # next attempt finds _ctrl None, retries
                attempt.backoff(e)  # raises RetryExhausted when spent
        if not h.get("ok"):
            # typed: a gateway's quota/auth rejection surfaces as
            # QuotaExceededError/AuthError, not a generic RuntimeError
            from repro_torch.gateway.tenancy import error_from_reply
            raise error_from_reply(h, "stripe_open failed")
        if h.get("dup"):
            # replayed epoch the server already acked: nothing to send.
            # The zero-stripe transfer completes in its constructor, so
            # account for it *before* building it.
            with self._outstanding_cond:
                self._outstanding += 1
            return _Transfer(name, 0, nbytes, on_done=self._transfer_done)
        file_id = h["file_id"]
        for ch in self._channels:       # adopt the receiver's current grant
            ch.set_window(int(h.get("credits", self.credits)))
        # a locally-reachable region path selects the one-sided data plane
        # (shared emulated-RDMA fabric); otherwise stripes carry payload
        path = h.get("path")
        writer = writer_for_reply(h, nbytes) \
            if nbytes and path and os.path.exists(path) else None
        with self._outstanding_cond:
            self._outstanding += 1
        tr = _Transfer(name, len(stripes), nbytes,
                       on_done=self._transfer_done, writer=writer)
        # round-robin with a moving base so concurrent datasets do not all
        # pile their first (and for short writes, only) stripe on channel 0.
        # Route over live channels only — stripes queued on a dead channel
        # would just bounce through its handoff path.
        live = self._live_channels() or self._channels
        with self._ctrl_lock:
            base, self._rr = self._rr, (self._rr + len(stripes)) \
                % len(live)
        for i, (off, size) in enumerate(stripes):
            ch = live[(base + i) % len(live)]
            ch.q.put(_Stripe(tr, file_id, name, i, len(stripes), off,
                             flat[off:off + size], writer,
                             enc=codec_info is not None))
        return tr

    def _transfer_done(self, _tr: _Transfer) -> None:
        with self._outstanding_cond:
            self._outstanding -= 1
            self._outstanding_cond.notify_all()

    def send_dataset(self, name: str, dtype: str, buf,
                     timeout: Optional[float] = None) -> int:
        """Blocking form of :meth:`submit_dataset` (FCFS-pool task body):
        returns the byte count once every stripe is acked."""
        tr = self.submit_dataset(name, dtype, buf)
        if not tr.event.wait(timeout or self.transfer_timeout):
            raise TimeoutError(
                f"striped transfer {name!r} not acked within "
                f"{timeout or self.transfer_timeout}s")
        if tr.error is not None:
            raise tr.error
        return tr.nbytes

    def sync(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted dataset finished (acked or failed)."""
        deadline = time.monotonic() + timeout if timeout else None
        with self._outstanding_cond:
            while self._outstanding > 0:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"{self._outstanding} striped transfers "
                            "still in flight")
                self._outstanding_cond.wait(remaining)

    # -- introspection --------------------------------------------------
    def channel_stats(self) -> list[dict]:
        """Current channels plus any retired (failed-over) generations."""
        return list(self._retired) + \
            [ch.stats.as_dict() for ch in self._channels]
