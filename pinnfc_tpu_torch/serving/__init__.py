"""Serving: the streaming monitor (``OnlineMonitor`` with its optional
``DiagnosisHead``) and the fleet replay of the 12 risk conditions.

The JAX package's exported monitor step and its HTTP server
(``serving/exported.py``, ``serving/server.py``) are not ported yet."""

from pinnfc_tpu_torch.serving.monitor import (
    DiagnosisHead,
    MonitorOutput,
    MonitorState,
    OnlineMonitor,
)
from pinnfc_tpu_torch.serving.replay import FleetConditionResult, fleet_replay

__all__ = [
    "DiagnosisHead",
    "FleetConditionResult",
    "MonitorOutput",
    "MonitorState",
    "OnlineMonitor",
    "fleet_replay",
]
