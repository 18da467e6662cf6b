"""``rdma_staged`` — the paper's pipeline as a registered Transport.

compute --libstaging(async, RDMA-emulated one-sided block writes)-->
staging tmpfs --(sendfile, FCFS pool)--> SAVIME.

Connects to an existing staging server (``cfg.staging_addr``) or owns a
fresh one against ``cfg.savime_addr`` (benchmark mode); an owned server is
stopped on close.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.core import wire
from repro_torch.core.client import Communicator
from repro_torch.core.staging import StagingServer
from repro_torch.transport.base import Transport, register_transport


@register_transport("rdma_staged")
class StagedTransport(Transport):
    """Staged-RDMA egress over libstaging's Communicator."""

    # the Communicator threads (name, epoch) through write_req /
    # stripe_open / batch items and the server dedups on it — the
    # session's in-flight journal can replay safely (DESIGN.md §15)
    supports_replay = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self._staging: Optional[StagingServer] = None   # owned, if any
        self.comm: Optional[Communicator] = None
        self._ctrl = None
        self._ctrl_lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------
    def open(self) -> None:
        gateway = self.cfg.gateway_addr is not None
        if gateway:
            # pool mode (DESIGN.md §12): the gateway is the one address —
            # data admits per dataset (redirect protocol) and the control
            # conn rides the gateway so drain/run_savime/stats see the
            # whole fleet
            addr = self.cfg.gateway_addr
        else:
            addr = self.cfg.staging_addr
            if addr is None:
                if self.cfg.savime_addr is None:
                    raise ValueError("rdma_staged needs staging_addr "
                                     "(attach), savime_addr (own a staging "
                                     "server) or gateway_addr (pool)")
                self._staging = StagingServer(
                    self.cfg.savime_addr,
                    mem_capacity=self.cfg.mem_capacity,
                    send_threads=self.cfg.send_threads,
                    straggler_timeout=self.cfg.straggler_timeout,
                    page_bytes=self.cfg.page_bytes,
                    spill_dir=self.cfg.spill_dir,
                    dedup=self.cfg.dedup).start()
                addr = self._staging.addr
        self.comm = Communicator(addr, self.cfg.io_threads,
                                 self.cfg.block_size,
                                 self.cfg.straggler_timeout,
                                 n_channels=self.cfg.n_channels,
                                 stripe_bytes=self.cfg.stripe_bytes,
                                 credits=self.cfg.credits,
                                 wire_format=self.cfg.wire_format,
                                 coalesce_bytes=self.cfg.coalesce_bytes,
                                 linger_ms=self.cfg.linger_ms,
                                 gateway=gateway, tenant=self.cfg.tenant,
                                 codec=self.cfg.codec,
                                 decode_at=self.cfg.decode_at,
                                 retry=self.cfg.retry,
                                 deadline_s=self.cfg.deadline_s)
        self._ctrl = wire.connect(addr)
        if gateway and self.cfg.tenant:
            # bind the control conn to the tenant for proxied/DDL ops
            with self._ctrl_lock:  # lint: ignore[io-under-lock]
                wire.request(self._ctrl, {"op": "hello",
                                          "tenant": self.cfg.tenant})

    def close(self) -> None:
        if self.comm is not None:
            self.comm.stop()
        if self._ctrl is not None:
            try:
                self._ctrl.close()
            except OSError:
                pass
        if self._staging is not None:
            self._staging.stop()

    # -- data plane -----------------------------------------------------
    def write(self, name: str, dtype: str, buf):
        return self.comm.submit(name, dtype, buf)

    def write_epoch(self, name: str, dtype: str, buf, epoch: str,
                    replay: bool = False):
        return self.comm.submit(name, dtype, buf, epoch=epoch,
                                replay=replay)

    def sync(self, timeout: Optional[float] = None) -> None:
        self.comm.sync(timeout)

    def drain(self, timeout: Optional[float] = None) -> None:
        self._ctrl_request({"op": "drain", "timeout": timeout})

    # -- control plane --------------------------------------------------
    def run_savime(self, q: str):
        """Proxy a SAVIME operator through staging (compute nodes cannot
        reach the analytical network directly — paper §3.1)."""
        return self._ctrl_request({"op": "run_savime", "q": q}).get("result")

    def server_stats(self) -> dict:
        return self._ctrl_request({"op": "stats"})

    def channel_stats(self) -> list[dict]:
        return self.comm.channel_stats() if self.comm is not None else []

    def page_stats(self) -> dict:
        """Staging-side page/spill/dedup counters (paged store only)."""
        try:
            return self._ctrl_request({"op": "stats"}).get("pages") or {}
        except (RuntimeError, OSError):
            return {}

    def codec_stats(self) -> dict:
        """Sender-side codec accounting (raw vs wire bytes, encode time);
        empty when ``cfg.codec == "none"``."""
        return self.comm.codec_stats() if self.comm is not None else {}

    def gateway_stats(self) -> dict:
        """Fleet snapshot from the gateway ``stats`` op (placement,
        tenancy, per-backend admission totals); empty off-gateway."""
        if self.cfg.gateway_addr is None:
            return {}
        try:
            h = self._ctrl_request({"op": "stats"})
        except (RuntimeError, OSError):
            return {}
        return {k: v for k, v in h.items()
                if k not in ("ok", "nbytes")}

    def _ctrl_request(self, header: dict) -> dict:
        # the lock serializes request/reply pairs on the shared control
        # conn — blocking under it is the point
        with self._ctrl_lock:  # lint: ignore[io-under-lock]
            h, _ = wire.request(self._ctrl, header)
        if not h.get("ok"):
            from repro_torch.gateway.tenancy import error_from_reply
            raise error_from_reply(h, "staging error")
        return h
