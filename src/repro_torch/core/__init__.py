# The paper's primary contribution: asynchronous in-transit staging from
# compute jobs to an in-memory analytical array DBMS (SAVIME/TARS), with
# RDMA-emulated one-sided block writes, tmpfs staging + disk fallback,
# FCFS send pools, and sendfile/splice forwarding. See DESIGN.md.
from repro_torch.core.blocks import TransferCostModel, plan_blocks, vmem_tile  # noqa: F401
from repro_torch.core.client import Dataset, StagingClient  # noqa: F401
from repro_torch.core.intransit import InTransitConfig, InTransitSink  # noqa: F401
from repro_torch.core.savime import SavimeClient, SavimeEngine, SavimeServer  # noqa: F401
from repro_torch.core.staging import StagingServer  # noqa: F401
from repro_torch.core.tars import TAR, Attribute, Dimension  # noqa: F401
