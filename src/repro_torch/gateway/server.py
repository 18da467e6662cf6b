"""GatewayServer — one address fronting a pool of StagingServers.

The gateway owns four jobs (DESIGN.md §12):

  * **placement** — every dataset maps to one backend through the
    consistent-hash ring (:mod:`repro_torch.gateway.ring`); membership changes
    (a backend failing health probes, or rejoining) rebuild the ring and
    bump its epoch.
  * **admission** — every ingress path authenticates + charges the
    tenant registry first (:mod:`repro_torch.gateway.tenancy`); quota/auth
    failures are *typed* error replies, and per-backend admitted
    byte/dataset counters feed the accounting-parity check
    (gateway totals == Σ backend ``bytes_in``).
  * **redirect vs proxy** — gateway-aware clients call ``admit`` /
    ``admit_batch`` and ship data straight to the returned backend
    (one control RTT, the one-sided RDMA plane untouched); legacy
    clients speak the unmodified staging wire protocol (JSON *and*
    bin1 — ``hello`` negotiation is answered in kind) and the gateway
    resolves placement per ``write_req``/``stripe_open``/``batch_open``
    and relays the data ops. Even proxied block writes stay one-sided:
    the relayed reservation reply carries the backend's region path, so
    a client sharing the emulated-RDMA fabric mmaps the backend region
    directly and only control frames cross the gateway.
  * **fleet-wide backpressure** — health probes sample each backend's
    ``free_fraction`` (its ``_credit_grant`` pressure signal); every
    credit grant relayed to a client is capped by the *worst* live
    backend's fraction, so one staging server drowning throttles the
    whole pool's producers through the existing credit machinery.

The analytical side is symmetric: ``run_savime`` parses the operator
and routes it through :func:`repro_torch.gateway.router.route_query` — DDL
fans out, ``load_subtar`` follows the dataset's recorded placement,
reads scatter-gather-merge — so an ``AnalysisSession(via=...)`` riding
a gateway-backed transport sees one coherent engine.
"""
from __future__ import annotations

import collections
import math
import socket
import threading
import time
from typing import Iterable, Optional

from repro_torch.core import wire
from repro_torch.core.savime import SavimeClient, _parse_call
from repro_torch.gateway.ring import HashRing, RingNode
from repro_torch.gateway.router import route_query
from repro_torch.gateway.tenancy import (AuthError, QuotaExceededError, Tenant,
                                   TenantRegistry, error_reply)

# wanted-credit guess when a relayed ack has no stripe_open context
DEFAULT_WANTED = 8

# (name, epoch) admit-log bound: replay identities older than the last
# this-many admits can no longer dedup (matches the staging server's cap)
_ADMIT_LOG_CAP = 4096


class Backend:
    """Gateway-side view of one staging backend."""

    def __init__(self, node: RingNode):
        self.node = node
        self.alive = True
        self.fails = 0
        self.free_fraction = 1.0       # last probed pressure signal
        self.last_stats: dict = {}     # last probed server stats snapshot
        self.admitted_bytes = 0        # accounting-parity counters
        self.admitted_datasets = 0

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def addr(self) -> str:
        return self.node.addr

    @property
    def savime_addr(self) -> str:
        return self.node.savime_addr


class GatewayServer:
    """TCP front-end multiplexing the staging wire protocol over a pool."""

    # ``stats`` is deliberately unguarded: plain int-counter bumps under
    # the GIL, read only by the stats op (monitoring tolerates torn reads).
    _GUARDED_BY = {
        "ring": "_lock",
        "_file_map": "_lock",
        "_ds_map": "_lock",
        "_admit_log": "_lock",
        "_threads": "_threads_lock",
        "_conns": "_conn_lock",
    }

    def __init__(self, nodes: Iterable[RingNode], host: str = "127.0.0.1",
                 port: int = 0, *, tenants: Iterable[Tenant] = (),
                 default_quota_bytes: Optional[int] = None,
                 require_auth: bool = False, vnodes: int = 64,
                 health_interval: float = 0.25, probe_fails: int = 2):
        nodes = list(nodes)
        if not nodes:
            raise ValueError("gateway needs at least one backend node")
        self.backends: dict[str, Backend] = {
            n.name: Backend(n) for n in nodes}
        if len(self.backends) != len(nodes):
            raise ValueError("duplicate backend names")
        self.vnodes = vnodes
        self.tenants = TenantRegistry(
            tenants, default_quota_bytes=default_quota_bytes,
            require_auth=require_auth)
        self.health_interval = health_interval
        self.probe_fails = max(1, probe_fails)
        # _lock guards: ring swaps, backend liveness/accounting, the
        # dataset/file placement maps
        self._lock = threading.Lock()
        self.ring = HashRing([b.node for b in self.backends.values()],
                             vnodes)
        self._file_map: dict[str, tuple[str, int]] = {}  # fid -> (backend, wanted)
        self._ds_map: dict[str, str] = {}                # dataset -> backend
        # (name, epoch) -> (backend, size): replay identities already
        # admitted, so a client retry is not double-charged (DESIGN.md §15)
        self._admit_log: collections.OrderedDict = collections.OrderedDict()
        self.stats = {"conns": 0, "admits": 0, "rejects": 0,
                      "redirected_bytes": 0, "proxied_ops": 0,
                      "proxied_bytes": 0, "queries": 0, "readmits": 0,
                      "remaps": 0, "rejoins": 0, "ring_fetches": 0}
        self._savime_local = threading.local()
        self._probe_socks: dict[str, socket.socket] = {}

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(128)
        self.addr = f"{host}:{self._srv.getsockname()[1]}"
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "GatewayServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="gateway-accept", daemon=True)
        self._accept_thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="gateway-health", daemon=True)
        self._health_thread.start()
        return self

    def stop(self, join_timeout: float = 2.0) -> None:
        self._stop.set()
        try:
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
        if self._health_thread is not None:
            self._health_thread.join(join_timeout + self.health_interval)
        deadline = time.monotonic() + join_timeout
        with self._threads_lock:
            threads = list(self._threads)
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        with self._threads_lock:
            self._threads = [t for t in self._threads if t.is_alive()]
        for s in self._probe_socks.values():
            try:
                s.close()
            except OSError:
                pass
        self._probe_socks.clear()

    def live_threads(self) -> int:
        with self._threads_lock:
            return sum(t.is_alive() for t in self._threads)

    # -- ring / placement -----------------------------------------------
    def _rebuild_ring(self) -> None:  # holds: self._lock
        """Swap in a ring over the currently-live backends (caller holds
        ``_lock``)."""
        live = [b.node for b in self.backends.values() if b.alive]
        self.ring = HashRing(live, self.vnodes)

    @property
    def epoch(self) -> str:
        with self._lock:
            return self.ring.epoch

    def _place(self, name: str) -> Backend:
        with self._lock:
            if not len(self.ring):
                raise RuntimeError("no live staging backends")
            return self.backends[self.ring.place(name).name]

    # -- health / fleet pressure ----------------------------------------
    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval):
            for b in list(self.backends.values()):
                if self._stop.is_set():
                    return
                self._probe(b)

    def _probe(self, b: Backend) -> None:
        try:
            sock = self._probe_socks.get(b.name)
            if sock is None:
                sock = wire.connect(b.addr, timeout=2.0)
                sock.settimeout(2.0)
                self._probe_socks[b.name] = sock
            h, _ = wire.request(sock, {"op": "ping"})
            if not h.get("ok"):
                raise ConnectionError("ping rejected")
            s, _ = wire.request(sock, {"op": "stats"})
        except (OSError, ConnectionError, ValueError):
            old = self._probe_socks.pop(b.name, None)
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass
            with self._lock:
                b.fails += 1
                if b.fails >= self.probe_fails and b.alive:
                    b.alive = False
                    self._rebuild_ring()
                    self.stats["remaps"] += 1
            return
        frac = s.get("free_fraction")
        if frac is None:       # older backend: derive from the watermark
            cap = s.get("mem_capacity") or 0
            frac = 1.0 - s.get("mem_used", 0) / cap if cap else 1.0
        with self._lock:
            b.fails = 0
            b.free_fraction = max(0.0, min(1.0, float(frac)))
            b.last_stats = {k: v for k, v in s.items() if k != "ok"}
            if not b.alive:
                b.alive = True
                self._rebuild_ring()
                self.stats["rejoins"] += 1

    def fleet_free_fraction(self) -> float:
        """The *worst* live backend's free fraction — cluster-wide
        admission follows the most-pressured server, so the pool never
        runs hotter than its sickest member."""
        with self._lock:
            fracs = [b.free_fraction for b in self.backends.values()
                     if b.alive]
        return min(fracs) if fracs else 1.0

    def _fleet_credits(self, wanted: int, backend_grant) -> int:
        """Gateway-issued grant: the backend's own grant, additionally
        capped by fleet pressure (same shape as ``_credit_grant``:
        never 0, so a stalled window can always recover)."""
        wanted = max(1, int(wanted))
        cap = max(1, math.ceil(wanted * self.fleet_free_fraction()))
        return max(1, min(int(backend_grant), cap))

    # -- accept / serve --------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._threads_lock:
                self._threads = [t for t in self._threads if t.is_alive()]
                t = threading.Thread(target=self._serve, args=(conn,),
                                     name="gateway-conn", daemon=True)
                t.start()
                self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._conn_lock:
            self._conns.add(conn)
        self.stats["conns"] += 1
        # per-connection state: the authenticated tenant, one relay
        # connection per backend (JSON — the gateway never negotiates
        # bin1 with backends, so unsolicited pushes cannot desync the
        # request/reply relay), and the pending proxied batch
        state: dict = {"tenant": None, "bconns": {}, "gwbatch": None}
        pool = wire.BufferPool(max_per_bucket=2)

        def _reply(reply: dict, is_bin: bool) -> bool:
            try:
                if is_bin:
                    wire.send_frame_bin(conn, dict(reply, op="ack"))
                else:
                    wire.send_frame(conn, reply)
            except OSError:
                return False
            return True

        try:
            with conn:
                while True:
                    try:
                        h = wire.recv_header(conn)
                        is_bin = bool(h.pop("_bin", False))
                        op = h.get("op")
                        if op in ("stripe", "batch_write"):
                            # payload ops: the relay consumes the payload
                            # itself (fully buffered before forwarding, so
                            # a backend failure never desyncs the client's
                            # framing)
                            try:
                                if op == "stripe":
                                    reply = self._op_stripe_relay(
                                        conn, state, h)
                                else:
                                    reply = self._op_batch_write_relay(
                                        conn, state, h)
                            except (ConnectionError, OSError):
                                raise
                            except Exception as e:  # noqa: BLE001
                                reply = error_reply(e)
                        else:
                            payload = wire.recv_payload(conn, h, pool)
                            try:
                                reply = self._handle(state, h)
                            except (AuthError, QuotaExceededError) as e:
                                self.stats["rejects"] += 1
                                reply = error_reply(e)
                            except Exception as e:  # noqa: BLE001
                                reply = error_reply(e)
                            finally:
                                if isinstance(payload, memoryview):
                                    pool.release(payload)
                    except (ConnectionError, OSError):
                        return
                    if not _reply(reply, is_bin):
                        return
        finally:
            for bsock in state["bconns"].values():
                try:
                    bsock.close()
                except OSError:
                    pass
            with self._conn_lock:
                self._conns.discard(conn)

    # -- backend relay plumbing -----------------------------------------
    def _backend_conn(self, state: dict, bname: str) -> socket.socket:
        sock = state["bconns"].get(bname)
        if sock is None:
            sock = wire.connect(self.backends[bname].addr, timeout=10.0)
            state["bconns"][bname] = sock
        return sock

    def _forward(self, state: dict, bname: str, header: dict,
                 payload=None) -> dict:
        """One relayed request/reply; a dead backend becomes a clean
        error reply (and the cached relay conn is dropped so a rejoined
        backend gets a fresh one)."""
        try:
            sock = self._backend_conn(state, bname)
        except OSError as e:
            return {"ok": False, "code": "backend_unreachable",
                    "error": f"backend {bname!r} unreachable: {e}"}
        try:
            if isinstance(payload, (list, tuple)):
                wire.sendmsg_all(sock, wire.encode_frame(header, payload))
                rep, _ = wire.recv_frame(sock)
            else:
                rep, _ = wire.request(sock, header, payload)
            return rep
        except (OSError, ConnectionError) as e:
            state["bconns"].pop(bname, None)
            try:
                sock.close()
            except OSError:
                pass
            return {"ok": False, "code": "backend_unreachable",
                    "error": f"backend {bname!r} unreachable: {e}"}

    # -- op dispatch ------------------------------------------------------
    def _handle(self, state: dict, h: dict) -> dict:
        op = h.get("op")
        if op == "ping":
            return {"ok": True, "gateway": True}
        if op == "hello":
            if h.get("tenant"):
                state["tenant"] = self.tenants.authenticate(h["tenant"])
            # advertise the codec registry on the backends' behalf — every
            # pool member runs the same build, and redirected writers only
            # hello against the gateway (DESIGN.md §13)
            from repro_torch import codec as codec_mod
            return dict(wire.hello_reply(h, codecs=codec_mod.available()),
                        gateway=True, epoch=self.epoch)
        if op == "ring":
            self.stats["ring_fetches"] += 1
            with self._lock:
                ring = self.ring
            return {"ok": True, "ring": ring.encode(), "epoch": ring.epoch}
        if op == "admit":
            return self._op_admit(state, h)
        if op == "admit_batch":
            return self._op_admit_batch(state, h)
        if op in ("write_req", "stripe_open"):
            return self._op_proxy_open(state, h)
        if op == "batch_open":
            return self._op_batch_open_relay(state, h)
        if op in ("reg_block", "client_sync"):
            return self._op_file_relay(state, h)
        if op == "run_savime":
            return self._op_run_savime(h)
        if op == "drain":
            return self._op_drain(state, h)
        if op == "stats":
            return self._op_stats()
        raise ValueError(f"unknown op {op!r}")

    # -- tenancy ----------------------------------------------------------
    def _auth(self, state: dict, h: dict) -> Tenant:
        token = h.get("tenant")
        if token:
            return self.tenants.authenticate(token)
        if state["tenant"] is not None:
            return state["tenant"]
        return self.tenants.authenticate(None)

    def _record_admit(self, b: Backend, name: str, size: int) -> None:
        """Caller already charged the tenant; update placement records +
        parity counters (holds ``_lock``)."""
        with self._lock:
            b.admitted_bytes += size
            b.admitted_datasets += 1
            self._ds_map[name] = b.name

    # -- redirect protocol ------------------------------------------------
    def _op_admit(self, state: dict, h: dict) -> dict:
        tenant = self._auth(state, h)
        size = int(h.get("size", 0))
        name = h["name"]
        epoch = h.get("epoch")
        b = self._place(name)
        if epoch is not None:
            rep = self._readmit(name, str(epoch), size, b)
            if rep is not None:
                return rep
        self.tenants.charge(tenant, size)
        self._record_admit(b, name, size)
        if epoch is not None:
            with self._lock:
                self._admit_log[(name, str(epoch))] = (b.name, size)
                while len(self._admit_log) > _ADMIT_LOG_CAP:
                    self._admit_log.popitem(last=False)
        self.stats["admits"] += 1
        self.stats["redirected_bytes"] += size
        return {"ok": True, "addr": b.addr, "backend": b.name,
                "epoch": self.epoch}

    def _readmit(self, name: str, epoch: str, size: int,
                 b: Backend) -> Optional[dict]:
        """Handle an admit whose (name, epoch) was already admitted — a
        journal replay after a reconnect or a backend fail-out. The
        tenant was charged the first time, so only the parity accounting
        moves: the original backend's counters are reversed and the new
        placement charged (a no-op when placement is unchanged — the
        backend itself dedups the replayed write)."""
        with self._lock:
            prev = self._admit_log.get((name, epoch))
            if prev is None:
                return None
            old_name, old_size = prev
            old_b = self.backends.get(old_name)
            if old_name != b.name:
                if old_b is not None:
                    old_b.admitted_bytes -= old_size
                    old_b.admitted_datasets -= 1
                b.admitted_bytes += size
                b.admitted_datasets += 1
            self._ds_map[name] = b.name
            self._admit_log[(name, epoch)] = (b.name, size)
        self.stats["readmits"] += 1
        return {"ok": True, "addr": b.addr, "backend": b.name,
                "dup": True, "epoch": self.epoch}

    def _op_admit_batch(self, state: dict, h: dict) -> dict:
        tenant = self._auth(state, h)
        items = h.get("items")
        if not isinstance(items, list) or not items:
            raise ValueError("admit_batch needs a non-empty items list")
        placed = [self._place(it["name"]) for it in items]
        total = sum(int(it.get("size", 0)) for it in items)
        # all-or-nothing: the whole batch fits the budget or none lands
        self.tenants.charge(tenant, total, datasets=len(items))
        for b, it in zip(placed, items):
            self._record_admit(b, it["name"], int(it.get("size", 0)))
        self.stats["admits"] += len(items)
        self.stats["redirected_bytes"] += total
        return {"ok": True, "addrs": [b.addr for b in placed],
                "backends": [b.name for b in placed], "epoch": self.epoch}

    # -- proxy protocol ---------------------------------------------------
    def _op_proxy_open(self, state: dict, h: dict) -> dict:
        """Relayed ``write_req`` / ``stripe_open``: place, charge,
        forward, remember the file_id→backend binding for the data ops
        that follow (possibly on other connections — stripes ride the
        channel sockets, not the control socket that opened them)."""
        tenant = self._auth(state, h)
        size = int(h.get("size", 0))
        b = self._place(h["name"])
        self.tenants.charge(tenant, size)
        fwd = {k: v for k, v in h.items() if k != "tenant"}
        rep = self._forward(state, b.name, fwd)
        self.stats["proxied_ops"] += 1
        if not rep.get("ok"):
            return rep
        self._record_admit(b, h["name"], size)
        wanted = max(1, int(h.get("credits", 4)))
        with self._lock:
            self._file_map[rep["file_id"]] = (b.name, wanted)
        if "credits" in rep:
            rep["credits"] = self._fleet_credits(wanted, rep["credits"])
        return rep

    def _op_file_relay(self, state: dict, h: dict) -> dict:
        """Relay an op addressed by ``file_id`` (reg_block/client_sync)."""
        with self._lock:
            ent = self._file_map.get(h.get("file_id"))
        if ent is None:
            return {"ok": False, "code": "bad_request",
                    "error": f"unknown file_id {h.get('file_id')!r}"}
        bname, _wanted = ent
        rep = self._forward(state, bname, h)
        self.stats["proxied_ops"] += 1
        if rep.get("ok") and h.get("op") == "client_sync":
            with self._lock:
                self._file_map.pop(h["file_id"], None)
        return rep

    def _op_stripe_relay(self, conn: socket.socket, state: dict,
                         h: dict) -> dict:
        """Relay one stripe. The payload (if any — one-sided stripes are
        control-only) is buffered, so client framing survives any backend
        failure; the ack's credit grant is re-capped fleet-wide."""
        nbytes = int(h.get("nbytes") or 0)
        with self._lock:
            ent = self._file_map.get(h.get("file_id"))
        if ent is None:
            wire.drain_payload(conn, h)
            return {"ok": False, "code": "bad_request",
                    "error": f"unknown file_id {h.get('file_id')!r}"}
        bname, wanted = ent
        payload = None
        if nbytes:
            payload = bytearray(nbytes)
            wire.recv_into(conn, memoryview(payload))
        rep = self._forward(state, bname, h, payload)
        self.stats["proxied_ops"] += 1
        self.stats["proxied_bytes"] += nbytes
        if "credits" in rep:
            rep["credits"] = self._fleet_credits(wanted, rep["credits"])
        if rep.get("ok") and rep.get("done"):
            with self._lock:
                self._file_map.pop(h.get("file_id"), None)
        return rep

    def _op_batch_open_relay(self, state: dict, h: dict) -> dict:
        """Partition a coalesced batch by placement and open one
        sub-batch per backend; the client's view stays a single batch."""
        tenant = self._auth(state, h)
        items = h.get("items")
        if not isinstance(items, list) or not items:
            raise ValueError("batch_open needs a non-empty items list")
        placed = [self._place(it["name"]) for it in items]
        total = sum(int(it.get("size", 0)) for it in items)
        self.tenants.charge(tenant, total, datasets=len(items))
        groups: dict[str, list[int]] = {}
        for i, b in enumerate(placed):
            groups.setdefault(b.name, []).append(i)
        replies: list = [None] * len(items)
        for bname, idxs in groups.items():
            rep = self._forward(state, bname, {
                "op": "batch_open", "items": [items[i] for i in idxs]})
            self.stats["proxied_ops"] += 1
            if not rep.get("ok"):
                # backends that already opened roll their reservations
                # back when this relay conn next batch_opens (or closes)
                # — the staging server's own abandoned-batch handling
                state["gwbatch"] = None
                return rep
            for i, item_rep in zip(idxs, rep.get("items", ())):
                replies[i] = item_rep
        for b, it in zip(placed, items):
            self._record_admit(b, it["name"], int(it.get("size", 0)))
        state["gwbatch"] = (items, sorted(groups.items()))
        return {"ok": True, "items": replies}

    def _op_batch_write_relay(self, conn: socket.socket, state: dict,
                              h: dict) -> dict:
        """Scatter one jumbo batch payload into per-backend sub-batches.

        Item payloads arrive in client batch order; they are buffered
        per item and re-vectored into one ``batch_write`` per backend,
        in the exact order that backend's ``batch_open`` declared."""
        binfo = state.get("gwbatch")
        state["gwbatch"] = None
        declared = int(h.get("nbytes") or 0)
        if binfo is None:
            wire.drain_payload(conn, h)
            return {"ok": False, "code": "bad_request", "error":
                    "batch_write without a preceding successful batch_open"}
        items, groups = binfo
        sizes = [int(it.get("size", 0)) for it in items]
        if int(h.get("count", -1)) != len(items) or sum(sizes) != declared:
            wire.drain_payload(conn, h)
            return {"ok": False, "code": "bad_request", "error":
                    f"batch_write mismatch (count={h.get('count')}, "
                    f"declared={declared} bytes)"}
        bufs: list[bytearray] = []
        for n in sizes:
            buf = bytearray(n)
            if n:
                wire.recv_into(conn, memoryview(buf))
            bufs.append(buf)
        self.stats["proxied_bytes"] += declared
        count = 0
        credits: Optional[int] = None
        for bname, idxs in groups:
            payload = [memoryview(bufs[i]) for i in idxs if sizes[i]]
            rep = self._forward(state, bname,
                                {"op": "batch_write", "count": len(idxs)},
                                payload)
            self.stats["proxied_ops"] += 1
            if not rep.get("ok"):
                return rep
            count += int(rep.get("count", len(idxs)))
            grant = self._fleet_credits(4, rep.get("credits", 4))
            credits = grant if credits is None else min(credits, grant)
        return {"ok": True, "count": count,
                "credits": credits if credits is not None else 1}

    # -- analytical routing ----------------------------------------------
    def _savime_clients(self) -> tuple[list[SavimeClient], list[str]]:
        """One analytical connection per backend, per gateway thread.

        Deliberately *not* filtered by staging liveness: a dead staging
        server's SAVIME usually survives it, and the subtars it already
        ingested must stay queryable (no lost acked datasets)."""
        cache = getattr(self._savime_local, "clis", None)
        if cache is None:
            cache = self._savime_local.clis = {}
        clis, names = [], []
        for b in self.backends.values():
            if not b.savime_addr:
                continue
            cli = cache.get(b.name)
            if cli is None:
                try:
                    cli = SavimeClient(b.savime_addr)
                except OSError:
                    continue
                cache[b.name] = cli
            clis.append(cli)
            names.append(b.name)
        return clis, names

    def _op_run_savime(self, h: dict) -> dict:
        q = h["q"]
        clis, names = self._savime_clients()
        fn, args = _parse_call(q)
        dataset = args[1] if fn == "load_subtar" and len(args) > 1 else None

        def place(ds: str) -> Optional[int]:
            with self._lock:
                bname = self._ds_map.get(ds)
            if bname is None:
                try:
                    bname = self._place(ds).name
                except RuntimeError:
                    return None
            return names.index(bname) if bname in names else None

        res = route_query(clis, q, place=place)
        if dataset is not None:
            with self._lock:
                self._ds_map.pop(dataset, None)   # consumed (move semantics)
        if hasattr(res, "tolist"):
            res = res.tolist()
        self.stats["queries"] += 1
        return {"ok": True, "result": res}

    # -- control ops ------------------------------------------------------
    def _op_drain(self, state: dict, h: dict) -> dict:
        """Fan the drain barrier to every live backend."""
        with self._lock:
            live = [b.name for b in self.backends.values() if b.alive]
        for bname in live:
            rep = self._forward(state, bname,
                                {"op": "drain", "timeout": h.get("timeout")})
            if not rep.get("ok"):
                return rep
        return {"ok": True, "backends": len(live)}

    def _op_stats(self) -> dict:
        """GatewayStats: fleet view + tenancy snapshot + parity totals."""
        with self._lock:
            ring = self.ring
            backends = {
                b.name: {"addr": b.addr, "savime_addr": b.savime_addr,
                         "weight": b.node.weight, "alive": b.alive,
                         "free_fraction": b.free_fraction,
                         "admitted_bytes": b.admitted_bytes,
                         "admitted_datasets": b.admitted_datasets,
                         "server": dict(b.last_stats)}
                for b in self.backends.values()}
            totals = {
                "admitted_bytes": sum(b.admitted_bytes
                                      for b in self.backends.values()),
                "admitted_datasets": sum(b.admitted_datasets
                                         for b in self.backends.values())}
        return {"ok": True, "gateway": True, "epoch": ring.epoch,
                "n_backends": len(backends),
                "live_backends": sum(1 for d in backends.values()
                                     if d["alive"]),
                "fleet_free_fraction": self.fleet_free_fraction(),
                "backends": backends, "totals": totals,
                "tenants": self.tenants.snapshot(), **self.stats}
