"""Tracing / profiling (port of ``t2omca_tpu/utils/profiling.py``).

* ``StageTimer`` — per-stage wall-clock accumulation (rollout / train /
  superstep / test) logged with the metrics as ``time_<stage>_ms``. It
  reads the host clock only: the driver's dispatched functions end in a
  device synchronize under ``profile_stages`` or ``profile_dir`` (as the
  JAX driver's do), so the stages are device times then and enqueue
  times otherwise.
* ``TraceWindow`` — a ``torch.profiler`` capture (CPU and, on a card,
  CUDA activity) over a configured ``t_env`` window, written as a Chrome
  trace (``trace_<t_env>.json``, viewable in Perfetto) under
  ``profile_dir``. Subclass hook: ``_on_stop(logger, t_env)`` runs once
  the trace is written; ``obs.device_time.ProgramTraceWindow`` (built for
  ``obs.program_trace`` by :func:`make_trace_window`) attributes it to the
  named programs there.

On a card, CUPTI stays attached to the process once a window has run:
each later CUDA-graph launch then costs more host time (README,
``obs.program_trace``; ``PERF.md`` §7).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)
        self._n: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            self._n[name] += 1

    def log_and_reset(self, logger, t_env: int) -> None:
        for name, total in self._acc.items():
            n = max(self._n[name], 1)
            logger.log_stat(f"time_{name}_ms", 1000.0 * total / n, t_env)
        self._acc.clear()
        self._n.clear()


class TraceWindow:
    """Start a ``torch.profiler`` capture when ``t_env`` reaches
    ``start_t_env``; stop after ``n_iterations`` driver dispatches and
    write ``<trace_dir>/trace_<t_env>.json``. No-op when ``trace_dir`` is
    empty."""

    def __init__(self, trace_dir: str, start_t_env: int = 0,
                 n_iterations: int = 3):
        self.trace_dir = trace_dir
        self.start_t_env = start_t_env
        self.n_iterations = n_iterations
        self._active: Optional[int] = None   # iterations remaining
        self._done = False
        self._prof = None
        self.path: Optional[str] = None
        self.export_s: Optional[float] = None   # stop + Chrome export

    def maybe_start(self, t_env: int) -> None:
        if (not self.trace_dir or self._done or self._active is not None
                or t_env < self.start_t_env):
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._active = self.n_iterations

    def tick(self, logger=None, t_env: int = 0) -> None:
        if self._active is None:
            return
        self._active -= 1
        if self._active <= 0:
            t0 = time.perf_counter()
            self._prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            self.path = os.path.join(self.trace_dir,
                                     f"trace_{int(t_env)}.json")
            self._prof.export_chrome_trace(self.path)
            self.export_s = time.perf_counter() - t0
            self._prof = None
            self._active = None
            self._done = True
            self._on_stop(logger, t_env)

    def _on_stop(self, logger, t_env: int) -> None:
        if logger is not None:
            logger.console_logger.info(
                f"profiler trace written to {self.path} (stop and export "
                f"{self.export_s:.2f} s)")


def make_trace_window(cfg, out_dir: Optional[str] = None) -> TraceWindow:
    """The driver's trace window for ``cfg``: with ``obs.program_trace``
    a ``ProgramTraceWindow`` writing ``device_times.json`` into
    ``out_dir`` (the run directory)."""
    if cfg.obs.program_trace:
        from ..obs.device_time import ProgramTraceWindow
        return ProgramTraceWindow(cfg.profile_dir, cfg.profile_start,
                                  cfg.profile_iterations, out_dir=out_dir)
    return TraceWindow(cfg.profile_dir, cfg.profile_start,
                       cfg.profile_iterations)
