"""Adaptive steering: the between-block controller; port of
`repro/steer`.

Reads the sketches (repro_torch/stats) and per-point statistics at
superstep boundaries and decides — deterministically from (seed,
policy) — which sweep points to early-stop, where to reallocate their
freed replicas, which lanes to pin to exact SSA, and which
distributions to flag as bimodal.
"""
from repro_torch.steer.policy import Steering, SteeringActions, SteeringPolicy

__all__ = ["Steering", "SteeringActions", "SteeringPolicy"]
