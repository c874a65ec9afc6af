"""Greedy serving: the step, the batching front end and the serving
artifact (``python -m t2omca_tpu_torch.serve export|info``)."""

from .export import (ARTIFACT_FORMAT, DEFAULT_BUCKETS, export_artifact,
                     load_acting_params)
from .frontend import ServeFrontend, SessionStore, pad_request, pick_bucket
from .program import build_serve_step

__all__ = [
    "ARTIFACT_FORMAT", "DEFAULT_BUCKETS", "ServeFrontend", "SessionStore",
    "build_serve_step", "export_artifact", "load_acting_params",
    "pad_request", "pick_bucket",
]
