from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    InjectedFailure, RestartBudgetExceeded, Supervisor, SupervisorConfig,
    plan_mesh,
)
