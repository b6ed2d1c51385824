"""Runtime: typed faults and their injection, the straggler watchdog,
the supervised recovery loop (RunSupervisor) and the multi-process farm
(`coordinator.FarmCoordinator` over `worker` processes); port of
`repro/runtime`."""
from repro_torch.runtime.fault import (  # noqa: F401
    FAULT_KINDS,
    DeviceLost,
    EngineCrash,
    EngineStall,
    FailureInjector,
    FailurePlan,
    InvariantViolation,
    RecoverableError,
)
