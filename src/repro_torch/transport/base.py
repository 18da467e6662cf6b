"""Transport abstraction — one lifecycle for every egress path.

The paper compares a staged-RDMA pipeline against scp/ssh baselines; the
repo previously exposed three disjoint APIs for the same act of "move
blocks from compute to analysis" (StagingClient+Dataset, the run_* engine
functions, InTransitSink). This module defines the single contract they
all sit on now — in the spirit of ADIOS2's engine-agnostic IO API:

    Transport        abstract lifecycle: open / write / sync / drain / close
    TransportConfig  typed configuration shared by every engine
    TransferStats    per-phase timings (replaces the old TransferResult)
    registry         string-keyed: @register_transport / create / available

Engines register themselves by name; ``create("scp_disk", cfg)`` is the
only way an engine is named. User code goes through
:class:`repro_torch.transport.TransferSession`, which layers buffer pinning,
backpressure and futures on top of any registered transport.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Optional

# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Configuration shared by all transports.

    Engines ignore fields that do not apply to them (e.g. ``disk_bw`` only
    matters to ``scp_disk``); unknown one-off knobs go in ``extra``.
    """

    savime_addr: Optional[str] = None     # analytical endpoint (host:port)
    staging_addr: Optional[str] = None    # existing staging server, if any
    block_size: int = 64 << 20            # RDMA block knob (paper Fig 3)
    io_threads: int = 1                   # client-side FCFS I/O threads
    send_threads: int = 2                 # staging->SAVIME / forward threads
    mem_capacity: int = 8 << 30           # staging tmpfs capacity
    disk_bw: Optional[float] = None       # B/s cap for scp_disk (paper HW)
    straggler_timeout: Optional[float] = None
    max_inflight_bytes: Optional[int] = None  # session backpressure bound
    n_channels: int = 1                   # striped connections (1 = off)
    stripe_bytes: Optional[int] = None    # stripe size (None = block_size)
    credits: int = 4                      # per-channel credit window request
    wire_format: str = "json"             # "json" (legacy) | "bin1" fast path
    coalesce_bytes: int = 0               # datasets below this batch (0 = off)
    linger_ms: float = 2.0                # coalescing flush window
    page_bytes: int = 0                   # paged staging page size (0 = flat)
    spill_dir: Optional[str] = None       # cold-page spill tier (paged mode)
    dedup: bool = False                   # content-addressed page dedup
    gateway_addr: Optional[str] = None    # staging gateway (DESIGN.md §12);
    #                                       set => data admits via the pool
    tenant: Optional[str] = None          # tenant token for gateway auth
    codec: str = "none"                   # egress reduction codec (§13)
    decode_at: str = "staging"            # "staging" (ingest) | "query"
    #                                       (store compressed, lazy decode)
    retry: int = 3                        # transfer retries per write (§15)
    deadline_s: Optional[float] = None    # retry budget per write (None = off)
    journal: bool = True                  # in-flight journal + replay on
    #                                       reconnect (replay-capable engines)
    extra: dict = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "TransportConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class TransferStats:
    """Per-phase timings for one session (replaces ``TransferResult``).

    The first five fields keep the old TransferResult layout so legacy
    positional construction and attribute access keep working.
    """

    engine: str
    nbytes: int = 0
    n_datasets: int = 0
    to_staging_s: float = 0.0       # first write -> sync complete
    end_to_end_s: float = 0.0       # first write -> drain complete
    open_s: float = 0.0             # transport.open() wall time
    close_s: float = 0.0            # transport.close() wall time
    write_wait_s: float = 0.0       # time write() spent blocked (backpressure)
    peak_inflight_bytes: int = 0    # high-water mark of pinned bytes
    # per-channel byte/latency breakdowns when the transport stripes over
    # multiple connections (empty on single-connection paths)
    channels: list = dataclasses.field(default_factory=list)
    # page/spill/dedup counters when the staging area runs the paged
    # store (cfg.page_bytes > 0); empty on the flat path
    pages: dict = dataclasses.field(default_factory=dict)
    # fleet snapshot (placement/tenancy/admission totals) when the session
    # rode a staging gateway (cfg.gateway_addr); empty otherwise
    gateway: dict = dataclasses.field(default_factory=dict)
    # egress-codec accounting (raw vs wire bytes, encode time) when a
    # reduction codec is configured (cfg.codec != "none"); empty otherwise
    codec: dict = dataclasses.field(default_factory=dict)
    # durability accounting (DESIGN.md §15): writes replayed from the
    # in-flight journal after a reconnect, and replays the receiver
    # recognised as already-acked epochs (no double ingest)
    replays: int = 0
    replay_dups: int = 0

    @property
    def staging_gbps(self) -> float:
        return self.nbytes / max(self.to_staging_s, 1e-9) / 1e9

    @property
    def end_to_end_gbps(self) -> float:
        return self.nbytes / max(self.end_to_end_s, 1e-9) / 1e9

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["staging_gbps"] = self.staging_gbps
        d["end_to_end_gbps"] = self.end_to_end_gbps
        return d

    @classmethod
    def merge(cls, stats: "list[TransferStats] | tuple") -> "TransferStats":
        """Combine per-rank/per-session stats into one fleet view.

        Additive fields (bytes, datasets, blocked/open/close time) sum;
        wall-clock phases (``to_staging_s``, ``end_to_end_s``) take the
        max — concurrent sessions overlap, so summing them would invent
        serial time; ``peak_inflight_bytes`` also maxes (a high-water
        mark, not a flow); per-channel rows concatenate.
        """
        stats = list(stats)
        if not stats:
            return cls(engine="merged")
        out = cls(engine=stats[0].engine if len(
            {s.engine for s in stats}) == 1 else "merged")
        for s in stats:
            out.nbytes += s.nbytes
            out.n_datasets += s.n_datasets
            out.open_s += s.open_s
            out.close_s += s.close_s
            out.write_wait_s += s.write_wait_s
            out.to_staging_s = max(out.to_staging_s, s.to_staging_s)
            out.end_to_end_s = max(out.end_to_end_s, s.end_to_end_s)
            out.peak_inflight_bytes = max(out.peak_inflight_bytes,
                                          s.peak_inflight_bytes)
            out.replays += s.replays
            out.replay_dups += s.replay_dups
            out.channels.extend(s.channels)
            if s.gateway:
                out.gateway = dict(s.gateway)   # latest fleet snapshot
            if s.codec:
                c = out.codec
                c["name"] = s.codec.get("name", c.get("name"))
                for k in ("raw_bytes", "wire_bytes", "datasets",
                          "fallbacks"):
                    c[k] = c.get(k, 0) + int(s.codec.get(k, 0))
                c["encode_s"] = c.get("encode_s", 0.0) + \
                    float(s.codec.get("encode_s", 0.0))
        return out


# ---------------------------------------------------------------------------
# transport lifecycle
# ---------------------------------------------------------------------------


class Transport(abc.ABC):
    """Abstract egress engine: open / write / sync / drain / close.

    ``write`` is asynchronous and returns a handle with
    ``wait(timeout)`` / ``done`` / ``add_done_callback`` semantics (the
    FCFS :class:`~repro_torch.core.queues.TaskHandle` satisfies this).  ``sync``
    blocks until every written buffer has reached the staging area (the
    paper's ``st.sync()``); ``drain`` blocks until data is queryable at
    the analytical endpoint.  Transports are single-open: ``close`` ends
    the lifecycle.
    """

    name: str = "abstract"
    # engines that thread a producer-assigned (name, epoch) identity down
    # to the receiver (idempotent replay, DESIGN.md §15) set this True
    # and override write_epoch; the session only journals writes when the
    # engine can actually replay them safely
    supports_replay: bool = False

    def __init__(self, cfg: TransportConfig):
        self.cfg = cfg

    @abc.abstractmethod
    def open(self) -> None:
        """Allocate connections / servers. Idempotence not required."""

    @abc.abstractmethod
    def write(self, name: str, dtype: str, buf) -> Any:
        """Enqueue one named buffer; returns a completion handle."""

    def write_epoch(self, name: str, dtype: str, buf, epoch: str,
                    replay: bool = False) -> Any:
        """``write`` carrying a replay identity. Engines without epoch
        support fall back to a plain write (``supports_replay`` stays
        False, so the session never journals against them)."""
        return self.write(name, dtype, buf)

    @abc.abstractmethod
    def sync(self, timeout: Optional[float] = None) -> None:
        """Block until all written buffers reached staging."""

    @abc.abstractmethod
    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until all staged data is queryable at the endpoint."""

    @abc.abstractmethod
    def close(self) -> None:
        """Release sockets, pools and owned servers."""

    # -- optional control-plane hooks ----------------------------------
    def run_savime(self, q: str):
        """Run an analytical (SAVIME) operator, if this transport has a
        control path to the endpoint."""
        raise NotImplementedError(
            f"transport {self.name!r} has no analytical control path")

    def server_stats(self) -> dict:
        """Remote-side counters, when the transport exposes them."""
        return {}

    def channel_stats(self) -> list[dict]:
        """Per-channel breakdowns when this transport stripes across
        multiple connections (``cfg.n_channels > 1``); empty otherwise."""
        return []

    def page_stats(self) -> dict:
        """Page/spill/dedup counters when the staging side runs the paged
        store (``cfg.page_bytes > 0``); empty otherwise."""
        return {}

    def gateway_stats(self) -> dict:
        """Fleet snapshot (placement, tenancy, admission totals) when the
        transport rides a staging gateway (``cfg.gateway_addr``); empty
        otherwise."""
        return {}

    def codec_stats(self) -> dict:
        """Egress-codec accounting (raw vs wire bytes, encode time) when a
        reduction codec is configured (``cfg.codec != "none"``); empty
        otherwise."""
        return {}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class UnknownTransportError(KeyError):
    pass


_REGISTRY: dict[str, type] = {}


def register_transport(name: str) -> Callable[[type], type]:
    """Class decorator: ``@register_transport("scp_mem")``."""

    def deco(cls: type) -> type:
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"transport {name!r} already registered "
                             f"({_REGISTRY[name].__name__})")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available() -> tuple[str, ...]:
    """Registered engine names, sorted."""
    return tuple(sorted(_REGISTRY))


def get(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownTransportError(
            f"unknown transport {name!r}; available: {', '.join(available())}"
        ) from None


def create(name: str, cfg: TransportConfig) -> Transport:
    """Instantiate a registered transport (does not open it)."""
    return get(name)(cfg)
