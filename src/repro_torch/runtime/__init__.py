"""Runtime: typed faults and their injection, the straggler watchdog,
and the supervised recovery loop (RunSupervisor); port of
`repro/runtime` (the multi-process farm, its coordinator and workers,
is queue 1 item 16)."""
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
