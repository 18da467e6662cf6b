"""SAVIME — in-memory array DBMS for simulation data (stub-faithful build).

Implements the subset of SAVIME the paper exercises:
  * named byte *datasets* ingested over TCP (fast path: the staging server
    streams them with sendfile);
  * a TARS catalogue: ``create_tar`` / ``load_subtar`` attach datasets as
    subtar payloads;
  * analytical reads: ``select`` (dimension/range filter) and ``aggregate``
    — "SAVIME API already allows filtering stored data by dimensions and by
    range" (§6);
  * concurrent analytical readers (thread-per-connection + TAR RLocks).

The mini query language mirrors the paper's Listing 1 usage:
    create_tar(velocity, "x:0:200, y:0:500, z:0:500", "v:float64")
    load_subtar(velocity, D, "0,0,0", "201,501,501", v)
    select(velocity, v, "0,0,0", "10,10,10")
    aggregate(velocity, v, mean)
    drop_tar(velocity)
"""
from __future__ import annotations

import queue
import re
import select
import socket
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.tars import TAR, Attribute, Dimension
from repro_torch.core import wire
from repro_torch.tensors import BF16, bf16_to_f32, np_dtype


class SavimeError(RuntimeError):
    pass


_ARG_RE = re.compile(r'"([^"]*)"|([^,()\s][^,()]*)')


def _parse_call(q: str) -> tuple[str, list[str]]:
    q = q.strip().rstrip(";")
    m = re.match(r"(\w+)\s*\((.*)\)\s*$", q, re.S)
    if not m:
        raise SavimeError(f"cannot parse query: {q!r}")
    fn, argstr = m.group(1), m.group(2)
    args = [a or b for a, b in _ARG_RE.findall(argstr)]
    return fn, [a.strip() for a in args]


class SavimeEngine:
    """In-process engine (the TCP server wraps this)."""

    # enforced by `python -m repro.lint` (DESIGN.md §14); _lock is an
    # RLock so query handlers can nest under run()
    _GUARDED_BY = {
        "tars": "_lock",
        "datasets": "_lock",
        "_listeners": "_lock",
        "stats": "_lock",
    }

    def __init__(self):
        self.tars: dict[str, TAR] = {}
        self.datasets: dict[str, np.ndarray] = {}
        self._lock = threading.RLock()
        self._listeners: list[Callable[[dict], None]] = []
        self.stats = {"bytes_ingested": 0, "datasets": 0, "queries": 0,
                      "subtars": 0}

    # -- subtar-arrival listeners (feed the subscribe/notify push path) ----
    def add_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify(self, event: dict) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(event)
            except Exception:  # noqa: BLE001 — listeners must not break ingest
                pass

    # -- dataset ingestion (binary path) -----------------------------------
    def load_dataset(self, name: str, dtype: str, payload) -> None:
        arr = np.frombuffer(payload, dtype=np_dtype(dtype))
        with self._lock:
            self.datasets[name] = arr
            self.stats["bytes_ingested"] += arr.nbytes
            self.stats["datasets"] += 1

    # -- stat snapshots (the server must not read `stats` unlocked) --------
    def subtar_seq(self) -> int:
        with self._lock:
            return self.stats["subtars"]

    def stats_snapshot(self) -> dict:
        with self._lock:
            return dict(self.stats)

    # -- query language ------------------------------------------------------
    def run(self, q: str) -> Any:
        with self._lock:
            self.stats["queries"] += 1
        fn, args = _parse_call(q)
        handler = getattr(self, f"_q_{fn}", None)
        if handler is None:
            raise SavimeError(f"unknown operator {fn!r}")
        return handler(*args)

    def result_dtype(self, q: str, res: np.ndarray) -> str:
        """The wire dtype of a query's array: a selected attribute's DDL
        type (bfloat16 is held as uint16 bits), else the array's own."""
        fn, args = _parse_call(q)
        if fn == "select":
            return self._tar(args[0]).attrs[args[1]].dtype
        return str(res.dtype)

    def _q_create_tar(self, name: str, dims: str, attrs: str) -> str:
        dl = []
        for d in dims.split(","):
            parts = d.strip().split(":")
            dname, lo, hi = parts[0], int(parts[1]), int(parts[2])
            off = float(parts[3]) if len(parts) > 3 else 0.0
            stride = float(parts[4]) if len(parts) > 4 else 1.0
            dl.append(Dimension(dname, lo, hi, off, stride))
        al = [Attribute(*a.strip().split(":")) for a in attrs.split(",")]
        with self._lock:
            if name in self.tars:
                raise SavimeError(f"tar {name!r} exists")
            self.tars[name] = TAR(name, dl, al)
        return "ok"

    def _q_load_subtar(self, tar: str, dataset: str, origin: str,
                       shape: str, attr: str) -> str:
        t = self._tar(tar)
        with self._lock:
            if dataset not in self.datasets:
                raise SavimeError(f"dataset {dataset!r} not loaded")
            arr = self.datasets.pop(dataset)  # move: staging frees its copy too
        o = tuple(int(x) for x in origin.split(","))
        s = tuple(int(x) for x in shape.split(","))
        t.load_subtar(o, s, {attr: arr})
        with self._lock:
            self.stats["subtars"] += 1
            seq = self.stats["subtars"]
        self._notify({"tar": tar, "origin": list(o), "shape": list(s),
                      "attr": attr, "seq": seq})
        return "ok"

    def _q_select(self, tar: str, attr: str, lo: str = "", hi: str = ""):
        t = self._tar(tar)
        lo_t = tuple(int(x) for x in lo.split(",")) if lo else None
        hi_t = tuple(int(x) for x in hi.split(",")) if hi else None
        return t.select(attr, lo_t, hi_t)

    def _q_aggregate(self, tar: str, attr: str, op: str,
                     lo: str = "", hi: str = "") -> float:
        t = self._tar(tar)
        lo_t = tuple(int(x) for x in lo.split(",")) if lo else None
        hi_t = tuple(int(x) for x in hi.split(",")) if hi else None
        return t.aggregate(attr, op, lo_t, hi_t)

    def _q_data_box(self, tar: str):
        """Loaded bounding box ``[lo, hi]`` (inclusive), or None when the
        TAR holds no subtars — the scatter-gather router unions these to
        resolve unbounded queries to the same clip box a single server
        would use (DESIGN.md §12)."""
        box = self._tar(tar).data_box()
        if box is None:
            return None
        return [list(box[0]), list(box[1])]

    def _q_drop_tar(self, name: str) -> str:
        with self._lock:
            self.tars.pop(name, None)
        return "ok"

    def _q_list_tars(self) -> str:
        with self._lock:
            return ",".join(sorted(self.tars))

    def _tar(self, name: str) -> TAR:
        with self._lock:
            if name not in self.tars:
                raise SavimeError(f"no tar {name!r}")
            return self.tars[name]


class SavimeServer:
    """TCP front-end. Ops: query | load_dataset | subscribe | stats | ping.

    ``subscribe`` turns a connection into a push channel: the server acks
    ``{ok, seq}`` and then sends one ``{op: "notify", tar, origin, shape,
    attr, seq}`` frame per subtar loaded into the watched TAR (name match;
    ``""`` matches all, a trailing ``*`` matches by prefix) until the
    client closes the socket — the paper's query-while-running goal (§6)
    without analytical clients polling ``select``.
    """

    _GUARDED_BY = {
        "_threads": "_threads_lock",
        "_conns": "_conn_lock",
    }

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.engine = SavimeEngine()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.addr = f"{host}:{self._srv.getsockname()[1]}"
        self._stop = threading.Event()
        # appended by the accept loop, walked by stop()/live_threads() —
        # the same prune-while-join race StagingServer fixed in PR 7
        self._threads: list[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "SavimeServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="savime-accept", daemon=True)
        self._accept_thread.start()
        return self

    def stop(self, join_timeout: float = 2.0) -> None:
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
        # unblock connection threads parked in recv, then join them
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

    def live_threads(self) -> int:
        with self._threads_lock:
            return sum(t.is_alive() for t in self._threads)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            # prune finished connection threads so a long-running server
            # stays bounded by *live* connections, not total ever accepted
            with self._threads_lock:
                self._threads = [t for t in self._threads if t.is_alive()]
                t = threading.Thread(target=self._serve, args=(conn,),
                                     name="savime-conn", daemon=True)
                t.start()
                self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._conn_lock:
            self._conns.add(conn)
        try:
            with conn:
                while True:
                    try:
                        header, payload = wire.recv_frame(conn)
                    except (ConnectionError, OSError):
                        return
                    if header.get("op") == "subscribe":
                        self._serve_subscription(conn, header)
                        return
                    try:
                        reply, data = self._handle(header, payload)
                    except Exception as e:  # noqa: BLE001 — report to client
                        reply, data = {"ok": False, "error": str(e),
                                       "code": "error"}, None
                    try:
                        wire.send_frame(conn, reply, data)
                    except OSError:
                        return
        finally:
            with self._conn_lock:
                self._conns.discard(conn)

    def _serve_subscription(self, conn: socket.socket, header) -> None:
        """Push-mode connection: forward matching subtar events until the
        subscriber (or the server) goes away."""
        pattern = header.get("tar", "")
        # bounded: a stalled subscriber must not grow server memory with
        # ingest; drop-oldest keeps the most recent events for the reader
        events: queue.Queue = queue.Queue(maxsize=1024)

        def listener(ev: dict) -> None:
            t = ev["tar"]
            if not (not pattern or t == pattern or
                    (pattern.endswith("*") and t.startswith(pattern[:-1]))):
                return
            while True:
                try:
                    events.put_nowait(ev)
                    return
                except queue.Full:
                    try:
                        events.get_nowait()
                    except queue.Empty:
                        pass

        self.engine.add_listener(listener)
        try:
            # a reader that stops draining must eventually free this
            # thread: a stalled send times out and ends the subscription
            conn.settimeout(30.0)
            wire.send_frame(conn, {"ok": True, "tar": pattern,
                                   "seq": self.engine.subtar_seq()})
            while not self._stop.is_set():
                try:
                    ev = events.get(timeout=0.25)
                except queue.Empty:
                    # no event to push — check for subscriber EOF, or an
                    # idle disconnected watcher leaks this thread and its
                    # engine listener until server stop
                    r, _, _ = select.select([conn], [], [], 0)
                    if r and not conn.recv(1, socket.MSG_PEEK):
                        return
                    continue
                wire.send_frame(conn, {"op": "notify", "ok": True, **ev})
        except OSError:
            pass
        finally:
            self.engine.remove_listener(listener)

    def _handle(self, header, payload):
        op = header.get("op")
        if op == "ping":
            return {"ok": True}, None
        if op == "load_dataset":
            self.engine.load_dataset(header["name"], header["dtype"], payload)
            return {"ok": True}, None
        if op == "query":
            res = self.engine.run(header["q"])
            if isinstance(res, np.ndarray):
                # range-filtered results may be strided views; memoryview
                # cast("B") requires C-contiguity
                res = np.ascontiguousarray(res)
                return {"ok": True,
                        "dtype": self.engine.result_dtype(header["q"], res),
                        "shape": list(res.shape)}, memoryview(res).cast("B")
            return {"ok": True, "result": res}, None
        if op == "stats":
            return {"ok": True, **self.engine.stats_snapshot()}, None
        raise SavimeError(f"unknown op {op!r}")


class SavimeClient:
    """Thin client used by staging + analytical apps (and tests)."""

    def __init__(self, addr: str):
        self.addr = addr
        self._sock = wire.connect(addr)
        self._lock = threading.Lock()

    def run(self, q):
        """Run one operator. ``q`` may be a typed statement from
        :mod:`repro_torch.analysis.query` (preferred) or raw mini-language text
        (deprecated as a user API — kept as wire plumbing; DESIGN.md §8)."""
        if hasattr(q, "compile"):
            q = q.compile()
        # _lock deliberately serialises whole request/reply round-trips on
        # this one socket — that's its job (same for every ignore below)
        with self._lock:  # lint: ignore[io-under-lock]
            header, payload = wire.request(self._sock, {"op": "query", "q": q})
        if not header.get("ok"):
            raise SavimeError(header.get("error", "?"))
        if "dtype" in header:
            arr = np.frombuffer(payload, np_dtype(header["dtype"]))
            if header["dtype"] == BF16:    # widened to compute with
                arr = bf16_to_f32(arr)
            return arr.reshape(header["shape"])
        return header.get("result")

    def load_dataset(self, name: str, dtype: str, payload) -> None:
        with self._lock:  # lint: ignore[io-under-lock]
            header, _ = wire.request(
                self._sock, {"op": "load_dataset", "name": name,
                             "dtype": dtype}, payload)
        if not header.get("ok"):
            raise SavimeError(header.get("error", "?"))

    def load_dataset_from_file(self, name: str, dtype: str, fd: int,
                               count: int) -> None:
        """Zero-copy ingest path: sendfile(2)/splice from a (tmpfs) file
        straight into the SAVIME socket — the paper's staging→SAVIME hop."""
        with self._lock:  # lint: ignore[io-under-lock]
            wire.send_frame_from_file(
                self._sock, {"op": "load_dataset", "name": name,
                             "dtype": dtype}, fd, count)
            header, _ = wire.recv_frame(self._sock)
        if not header.get("ok"):
            raise SavimeError(header.get("error", "?"))

    def load_dataset_views(self, name: str, dtype: str, views,
                           count: int) -> None:
        """Scatter-gather ingest for paged staging (DESIGN.md §11): one
        vectored send over the dataset's page views — arena slices for
        resident pages, file bytes for spilled ones — with no user-space
        concatenation."""
        total = sum(getattr(v, "nbytes", None) or len(v) for v in views)
        if total != count:
            raise SavimeError(
                f"page views cover {total} bytes, dataset is {count}")
        with self._lock:  # lint: ignore[io-under-lock]
            wire.sendmsg_all(self._sock, wire.encode_frame(
                {"op": "load_dataset", "name": name, "dtype": dtype},
                list(views)))
            header, _ = wire.recv_frame(self._sock)
        if not header.get("ok"):
            raise SavimeError(header.get("error", "?"))

    def stats(self) -> dict:
        with self._lock:  # lint: ignore[io-under-lock]
            header, _ = wire.request(self._sock, {"op": "stats"})
        return header

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
