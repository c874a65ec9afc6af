"""Greedy serving: the step, the batching front end, the serving
artifact (``python -m t2omca_tpu_torch.serve export|info|refresh``) and
the fault-tolerant fleet of engines over it (``fleet.py``)."""

from .export import (ARTIFACT_FORMAT, DEFAULT_BUCKETS, export_artifact,
                     load_acting_params)
from .fleet import (FleetConfig, FleetResult, RefreshRefused, ServeFleet,
                    check_refresh)
from .frontend import ServeFrontend, SessionStore, pad_request, pick_bucket
from .program import build_serve_step

__all__ = [
    "ARTIFACT_FORMAT", "DEFAULT_BUCKETS", "FleetConfig", "FleetResult",
    "RefreshRefused", "ServeFleet", "ServeFrontend", "SessionStore",
    "build_serve_step", "check_refresh", "export_artifact",
    "load_acting_params", "pad_request", "pick_bucket",
]
