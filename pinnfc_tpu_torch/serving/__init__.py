"""Serving: the streaming monitor (``OnlineMonitor`` with its optional
``DiagnosisHead``), the fleet replay of the 12 risk conditions, the
``torch.export`` artifacts (the scorer, the monitor's block step and its
fleet step) and the HTTP server."""

from pinnfc_tpu_torch.serving.exported import (
    export_monitor_fleet_step,
    export_monitor_step,
    export_scorer,
    load_scorer,
    monitor_from_artifact,
)
from pinnfc_tpu_torch.serving.monitor import (
    DiagnosisHead,
    MonitorOutput,
    MonitorState,
    OnlineMonitor,
)
from pinnfc_tpu_torch.serving.replay import FleetConditionResult, fleet_replay
from pinnfc_tpu_torch.serving.server import make_server, serve

__all__ = [
    "DiagnosisHead",
    "FleetConditionResult",
    "MonitorOutput",
    "MonitorState",
    "OnlineMonitor",
    "export_monitor_fleet_step",
    "export_monitor_step",
    "export_scorer",
    "fleet_replay",
    "load_scorer",
    "make_server",
    "monitor_from_artifact",
    "serve",
]
