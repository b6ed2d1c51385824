"""repro_torch.api — the declarative experiment layer of the port.

    from repro_torch.api import Ensemble, Experiment, Schedule, simulate
    from repro_torch.core.cwc.models import MODELS

    result = simulate(Experiment(
        model=MODELS["lv8"](),
        ensemble=Ensemble.make(replicas=1 << 20),
        schedule=Schedule(t_end=4.0, n_windows=8),
        use_kernel=True,
    ))                      # on the CUDA device; device="cpu" for the CPU
    result.means()          # (windows, n_obs)
"""
from repro_torch.api.result import SimulationResult, Telemetry
from repro_torch.api.run import build_engine, observable_names, simulate
from repro_torch.api.spec import (
    Ensemble,
    Experiment,
    ExperimentError,
    Method,
    Partitioning,
    Policy,
    Recovery,
    Reduction,
    Schedule,
    Schema,
    SketchSpec,
    Steering,
)
from repro_torch.core.stream import CsvSink
from repro_torch.core.sweep import SweepSpec
from repro_torch.runtime.fault import FailurePlan

__all__ = [
    "CsvSink",
    "Ensemble",
    "Experiment",
    "ExperimentError",
    "FailurePlan",
    "Method",
    "Partitioning",
    "Policy",
    "Recovery",
    "Reduction",
    "Schedule",
    "Schema",
    "SimulationResult",
    "SketchSpec",
    "Steering",
    "SweepSpec",
    "Telemetry",
    "build_engine",
    "observable_names",
    "simulate",
]
