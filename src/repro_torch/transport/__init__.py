# Unified egress subsystem: one Transport lifecycle (open/write/sync/
# drain/close) behind a string-keyed registry, and TransferSession — the
# single user-facing way to move blocks from compute to analysis. The
# paper's staged-RDMA pipeline and its scp/ssh baselines are peers here;
# `create("scp_disk", cfg)` is the only way an engine is named.
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
from repro_torch.transport.channels import (  # noqa: F401
    ChannelGroup, ChannelStats,
)
from repro_torch.transport import staged as _staged  # noqa: F401  (registers rdma_staged)
from repro_torch.transport import copyemu as _copyemu  # noqa: F401  (registers scp_*, ssh_direct)
