"""Device-memory memwatch: per-device snapshots with phase attribution (the
port of ``t2omca_tpu/obs/memwatch.py``).

* :class:`MemWatch` — reads the CUDA caching allocator's counters
  (``torch.cuda.memory_stats(device)``) at PHASE BOUNDARIES the driver
  already owns (startup, log cadence, checkpoint save), tracking
  per-device high water **attributed to the phase that first reached
  it** — so an OOM or wedge post-mortem says "the high water was N GiB,
  first seen at the ``checkpoint.save`` boundary at t_env=M", not just a
  number.
* the report rides the existing artifacts: the driver merges
  ``report()`` into ``flight_recorder.json`` and
  ``stall_diagnosis.json`` (``spans.SpanRecorder.persist(extra=)`` /
  ``watchdog.write_diagnosis(extra=)``). During a stall only the
  CACHED high water is reported — a snapshot would touch the wedged
  device from the diagnostic path.

Where the port differs from the JAX module: the counters are the
allocator's ``allocated_bytes.all.current`` and ``.peak`` (bytes held by
tensors, not the allocator's reserved pool), reported under JAX's
``bytes_in_use`` and ``peak_bytes_in_use`` names, plus ``num_allocs``
(``allocation.all.allocated``); and the report has no
``budgets_audit_peak_bytes`` (those are XLA program audits, which the
port does not have). A CPU-only process reports ``supported: false``,
as the JAX CPU client does.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from .spans import NULL_RECORDER

#: torch.cuda.memory_stats key -> the JAX allocator name it is reported as
_STAT_KEYS = {"allocated_bytes.all.current": "bytes_in_use",
              "allocated_bytes.all.peak": "peak_bytes_in_use",
              "allocation.all.allocated": "num_allocs"}


def _cuda_devices() -> list:
    """``[(id, stats_fn)]`` of the visible CUDA devices (empty without a
    card)."""
    import torch
    if not torch.cuda.is_available():
        return []
    return [(i, lambda i=i: torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())]


class MemWatch:
    """Phase-boundary device-memory snapshots + high-water attribution.
    Thread-safe: the driver snapshots from the main thread while the
    stall path reads ``report()`` from the watchdog thread."""

    enabled = True

    def __init__(self, rec=NULL_RECORDER,
                 _devices: Optional[Callable[[], list]] = None) -> None:
        self._rec = rec
        self._devices_fn = _devices or _cuda_devices   # test hook
        self._lock = threading.Lock()
        # device id -> {"bytes_in_use", ..., "high_water_bytes",
        #               "high_water_phase", "high_water_t_env"}
        self._dev: Dict[str, Dict[str, Any]] = {}
        self.snapshots = 0
        #: None until the first snapshot; False when no device reports
        #: allocator stats (a CPU-only process) — the report states it
        #: instead of showing an empty table with no explanation
        self.supported: Optional[bool] = None

    def snapshot(self, phase: str, t_env: int = 0
                 ) -> Optional[Dict[str, Dict[str, int]]]:
        """One per-device read at a phase boundary. Returns the raw
        per-device stats (None when unsupported) and folds the high
        water — attributed to ``phase``/``t_env`` when this read is the
        new maximum. Spanned (``memwatch.snapshot``) so its cost shows
        up in the phase table like any other boundary."""
        with self._rec.span("memwatch.snapshot", t_env=t_env, at=phase):
            try:
                devices = self._devices_fn()
            except Exception:  # noqa: BLE001 — telemetry only
                with self._lock:
                    if not self._dev:
                        self.supported = False
                return None
            out: Dict[str, Dict[str, int]] = {}
            for did, stats in devices:
                try:
                    ms = stats()
                except Exception:  # noqa: BLE001 — per-device degrade
                    ms = None
                if not ms:
                    continue
                out[str(did)] = {name: int(ms[k])
                                 for k, name in _STAT_KEYS.items()
                                 if k in ms}
            with self._lock:
                self.snapshots += 1
                self.supported = bool(out) or bool(self._dev)
                for did, snap in out.items():
                    rec = self._dev.setdefault(did, {
                        "high_water_bytes": -1,
                        "high_water_phase": None,
                        "high_water_t_env": 0})
                    rec.update(snap)
                    # prefer the allocator's own peak counter (it sees
                    # between-boundary spikes); fall back to in-use
                    hw = snap.get("peak_bytes_in_use",
                                  snap.get("bytes_in_use", 0))
                    if hw > rec["high_water_bytes"]:
                        rec["high_water_bytes"] = hw
                        rec["high_water_phase"] = phase
                        rec["high_water_t_env"] = int(t_env)
            return out or None

    def report(self) -> Dict[str, Any]:
        """The post-mortem block merged into flight/stall artifacts.
        Pure cached state — safe to call from the stall path over a
        wedged device (no device reads)."""
        with self._lock:
            devices = {did: dict(rec) for did, rec in self._dev.items()}
            return {"supported": self.supported,
                    "snapshots": self.snapshots,
                    "devices": devices}


class NullMemWatch:
    """The disabled memwatch: every operation a no-op, so call sites
    stay unconditional (the NullRecorder pattern)."""

    enabled = False
    supported = None
    snapshots = 0

    def snapshot(self, phase: str, t_env: int = 0):
        return None

    def report(self) -> Dict[str, Any]:
        return {}


NULL_MEMWATCH = NullMemWatch()


def make_memwatch(obs_cfg, rec=NULL_RECORDER):
    """:data:`NULL_MEMWATCH` unless ``obs.enabled`` AND
    ``obs.memwatch`` (sanity_check enforces the pairing)."""
    if obs_cfg is None or not getattr(obs_cfg, "enabled", False) \
            or not getattr(obs_cfg, "memwatch", False):
        return NULL_MEMWATCH
    return MemWatch(rec=rec)
