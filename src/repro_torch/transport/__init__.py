# The port's copy of the reference's egress subsystem. It registers the
# staged transport only: striped channels, coalescing and the scp/ssh
# copy-emulation baselines come with a later slice.
#
# Unified egress subsystem: one Transport lifecycle (open/write/sync/
# drain/close) behind a string-keyed registry, and TransferSession — the
# single user-facing way to move blocks from compute to analysis.
# See DESIGN.md §7 for the API and the migration table from the old
# entry points (StagingClient+Dataset / run_* / InTransitSink internals).
#
# NB: base and session must be imported before the engine modules — the
# engine modules pull in repro_torch.core, which re-enters this package for
# TransferSession/TransportConfig.
from repro_torch.transport.base import (  # noqa: F401
    Transport, TransportConfig, TransferStats, UnknownTransportError,
    available, create, get, register_transport,
)
from repro_torch.transport.session import (  # noqa: F401
    DatasetFuture, TransferSession, run_engine,
)
from repro_torch.transport import staged as _staged  # noqa: F401  (registers rdma_staged)
