"""In-transit analysis sink for PyTorch jobs — the paper's technique as a
first-class training/serving feature (the port of ``repro/core/intransit.py``).

The training/serving loop produces *quantities of interest* (simulation
fields, diagnostics tensors, activation samples, checkpoint shards). The
sink ships them through the full paper pipeline without blocking the step:

    tensors --(host copy)--> host --libstaging(async, RDMA-emulated,
    block knob)--> staging tmpfs --(sendfile, FCFS pool)--> SAVIME TARS

With ``codec="int8-block"`` a CUDA float tensor skips the first arrow: the
codec quantizes it on the card (the staging_pack kernel) and only the int8
values and their scales cross to the host, 4x fewer bytes for float32.

DDL is automatic: each staged array gets a TAR whose dimensions mirror its
shape (+ a leading `step` dimension), and a ``load_subtar`` is issued once
the dataset lands in SAVIME — so analytical clients can query any range of
any step while the job keeps running (the paper's §6 goal).

Data reduction (paper §6 future work, implemented): optional int8 block
quantization before egress — 4x/2x wire-volume reduction; scales are staged
as a companion attribute so analysis can dequantize exactly.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.analysis.query import CreateTar, LoadSubtar
from repro_torch.core.tars import Attribute, Dimension
from repro_torch.tensors import dtype_name, host_array
from repro_torch.transport import TransferSession, TransportConfig

MAX_STEPS = 1_000_000  # upper bound of the `step` dimension in DDL


@dataclasses.dataclass(frozen=True)
class InTransitConfig:
    block_size: int = 16 << 20
    io_threads: int = 2
    quantize: str = "none"        # none | int8
    quant_block: int = 4096       # elements per quantization block
    tar_prefix: str = "run"
    straggler_timeout: Optional[float] = None
    transport: str = "rdma_staged"   # any registered transport name
    max_inflight_bytes: Optional[int] = None  # egress backpressure bound
    n_channels: int = 1              # striped egress connections (1 = off)
    stripe_bytes: Optional[int] = None  # stripe size (None = block_size)
    credits: int = 4                 # per-channel credit window request
    wire_format: str = "json"        # "json" (legacy) | "bin1" fast path
    coalesce_bytes: int = 0          # coalesce datasets below this (0 = off)
    linger_ms: float = 2.0           # coalescing flush window
    page_bytes: int = 0              # paged staging page size (0 = flat)
    spill_dir: Optional[str] = None  # cold-page spill tier (paged mode)
    dedup: bool = False              # content-addressed page dedup
    gateway: bool = False            # addr is a staging gateway (pool mode)
    tenant: Optional[str] = None     # tenant token for gateway auth
    codec: str = "none"              # egress reduction codec (DESIGN.md §13)
    decode_at: str = "staging"       # "staging" (ingest) | "query" (lazy)


def quantize_int8_np(x: np.ndarray, block: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-block symmetric int8 quantization (numpy oracle, on the host)."""
    flat = x.reshape(-1).astype(np.float32)
    pad = (-flat.size) % block
    if pad:
        flat = np.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = np.abs(blocks).max(axis=1) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.rint(blocks / scale[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1), scale.astype(np.float32)


def dequantize_int8_np(q: np.ndarray, scale: np.ndarray, shape, block: int):
    blocks = q.reshape(-1, block).astype(np.float32) * scale[:, None]
    return blocks.reshape(-1)[: int(np.prod(shape))].reshape(shape)


def _flatten_with_path(tree: Any, path: tuple = ()) -> list:
    """(path, leaf) pairs in the order ``jax.tree_util`` flattens a tree of
    dicts (sorted keys), lists and tuples; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten_with_path(v, path + (i,))]
    return [(path, tree)]


class InTransitSink:
    """Asynchronous egress of named arrays into SAVIME via a
    :class:`~repro_torch.transport.TransferSession`.

    ``addr`` is the staging server (or, with ``gateway=True``, the staging
    gateway) for the default ``rdma_staged`` transport, or the SAVIME
    address for the copy-emulation transports (``cfg.transport`` names any
    registered engine).
    """

    def __init__(self, addr: str, cfg: InTransitConfig = InTransitConfig()):
        self.cfg = cfg
        staged = cfg.transport == "rdma_staged"
        gateway = staged and cfg.gateway
        self.session = TransferSession(cfg.transport, TransportConfig(
            staging_addr=addr if staged and not gateway else None,
            savime_addr=None if staged else addr,
            gateway_addr=addr if gateway else None, tenant=cfg.tenant,
            io_threads=cfg.io_threads, block_size=cfg.block_size,
            straggler_timeout=cfg.straggler_timeout,
            max_inflight_bytes=cfg.max_inflight_bytes,
            n_channels=cfg.n_channels, stripe_bytes=cfg.stripe_bytes,
            credits=cfg.credits, wire_format=cfg.wire_format,
            coalesce_bytes=cfg.coalesce_bytes,
            linger_ms=cfg.linger_ms, page_bytes=cfg.page_bytes,
            spill_dir=cfg.spill_dir, dedup=cfg.dedup,
            codec=cfg.codec, decode_at=cfg.decode_at)).open()
        self._tars: set[str] = set()
        self._pending: list[LoadSubtar] = []  # typed DDL to run at flush
        self._lock = threading.Lock()
        self.staged_bytes = 0
        self.staged_arrays = 0

    @property
    def client(self):
        """Back-compat alias: the session speaks the old StagingClient
        surface (sync / drain / run_savime / close)."""
        return self.session

    # ------------------------------------------------------------------
    def _ensure_tar(self, tar: str, shape: tuple[int, ...], dtype: str,
                    quantized: bool) -> None:
        if tar in self._tars:
            return
        step = Dimension("step", 0, MAX_STEPS)
        if quantized:  # quantized payloads are flat (block-padded) streams
            n = int(np.prod(shape))
            qlen = n + ((-n) % self.cfg.quant_block)
            dims = (step, Dimension("i", 0, qlen - 1))
            attrs = (Attribute("v", "int8"),)
        else:
            dims = (step,) + tuple(Dimension(f"d{i}", 0, n - 1)
                                   for i, n in enumerate(shape))
            attrs = (Attribute("v", dtype),)
        self.session.run_savime(CreateTar(tar, dims, attrs))
        if quantized:
            self.session.run_savime(CreateTar(
                f"{tar}__scale",
                (step, Dimension("b", 0, MAX_STEPS)),
                (Attribute("s", "float32"),)))
        self._tars.add(tar)

    def stage_array(self, name: str, arr: Any, step: int = 0) -> None:
        """Non-blocking: host copy + enqueue. `arr` is a torch tensor or a
        numpy array; the write itself happens on libstaging I/O threads. A
        CUDA float tensor staged with ``codec="int8-block"`` through
        ``rdma_staged`` (the transport that carries the codec) stays on the
        card: the codec packs it there. Anything else, a copy baseline's
        tensor included, is copied to the host
        here, where the reference calls ``np.asarray``; a bfloat16 tensor
        becomes its bits (``repro_torch.tensors``), staged as "bfloat16" and
        never quantized by ``quantize="int8"``, as the reference's numpy
        bfloat16 is not (it is not of kind "f").

        The buffer contract is the paper's: what is staged must not be
        mutated until ``sync()`` (or ``flush()``) returns. A tensor kept on
        the card, a CPU tensor and a numpy array are held as they are, not
        copied, until the write is acknowledged, and a replayed write
        (after a lost connection) sends or encodes them again as they stand
        then. Only a CUDA tensor copied to the host here may be reused at
        once. Stage a tensor made fresh for the step, or a copy, when the
        producer updates it in place (an optimizer's parameters and
        gradients)."""
        on_card = (isinstance(arr, torch.Tensor) and arr.is_cuda
                   and arr.is_floating_point()
                   and self.cfg.codec == "int8-block"
                   and self.cfg.transport == "rdma_staged"
                   and self.cfg.quantize != "int8")
        x = arr if on_card else host_array(arr)
        shape = tuple(x.shape)
        dtype = dtype_name(arr) if isinstance(arr, torch.Tensor) else str(x.dtype)
        tar = f"{self.cfg.tar_prefix}_{name}"
        quantized = not on_card and self.cfg.quantize == "int8" and \
            x.dtype.kind == "f"
        self._ensure_tar(tar, shape, dtype, quantized)
        ds_name = f"{tar}__{step}"
        if quantized:
            q, scale = quantize_int8_np(x, self.cfg.quant_block)
            self.session.write(ds_name, q, dtype="int8")
            self.session.write(ds_name + "s", scale, dtype="float32")
            with self._lock:
                self._pending.append(LoadSubtar(
                    tar, ds_name, (step, 0), (1, q.size), "v"))
                self._pending.append(LoadSubtar(
                    f"{tar}__scale", ds_name + "s",
                    (step, 0), (1, scale.size), "s"))
            self.staged_bytes += q.nbytes + scale.nbytes
        else:
            self.session.write(ds_name, x if on_card else
                               np.ascontiguousarray(x), dtype=dtype)
            with self._lock:
                self._pending.append(LoadSubtar(
                    tar, ds_name, (step,) + (0,) * len(shape),
                    (1,) + shape, "v"))
            self.staged_bytes += x.nbytes
        self.staged_arrays += 1

    def stage_tree(self, prefix: str, tree: Any, step: int = 0) -> None:
        """Stage every leaf of nested dicts, lists and tuples under the
        reference's names: the keys along the path (dict keys in sorted
        order, list positions), joined with nothing, with "/", "." and ":"
        replaced by "_"."""
        for path, leaf in _flatten_with_path(tree):
            key = prefix + "".join(str(p) for p in path).replace(
                "/", "_").replace(".", "_").replace(":", "_")
            self.stage_array(key, leaf, step)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until staged data is queryable in SAVIME (sync + drain +
        pending load_subtar DDL). The hot loop never calls this; analysis
        clients / checkpoint barriers do."""
        self.session.sync(timeout)
        self.session.drain(timeout)
        with self._lock:
            pending, self._pending = self._pending, []
        seen = set()
        for q in pending:
            # replay-after-restore stages the same step twice: the dataset
            # name is the idempotency token — run its DDL once
            if q in seen:
                continue
            seen.add(q)
            self.session.run_savime(q)

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self.session.close()
