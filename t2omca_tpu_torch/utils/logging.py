"""Logger facade (M9); the port's copy of ``t2omca_tpu/utils/logging.py``.

Contract from the call sites (the reference's ``per_run.py:8,29,45-53``):
wraps a console logger; ``setup_tb(dir)``; ``log_stat(key, value, t)``;
``print_recent_stats()``; exposes ``.console_logger``. The sacred observer
(``setup_sacred``) has no equivalent here — the experiment registry is the
run directory plus TensorBoard; a ``log_json`` sink writes the same scalars
as JSONL for offline analysis (replacing sacred's FileStorageObserver).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import defaultdict
from typing import Optional


def get_console_logger(name: str = "t2omca") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "[%(levelname)s %(asctime)s] %(name)s %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    return logger


class Logger:
    #: default per-key in-memory history cap. ``self.stats`` used to
    #: keep every (t, value) pair for the life of the run — unbounded
    #: host-RAM growth on long runs, for a structure whose only reader
    #: (``print_recent_stats``) looks at the last 5 entries. The JSONL
    #: sink is the durable record; this cap bounds the live mirror.
    #: Overridable per instance (``config.ObsConfig.stats_history``
    #: threads through ``run.run``); 0 = unbounded (the old behavior).
    DEFAULT_MAX_HISTORY = 1024

    def __init__(self, console_logger: Optional[logging.Logger] = None,
                 max_history: Optional[int] = None):
        self.console_logger = console_logger or get_console_logger()
        self.stats = defaultdict(list)       # key -> [(t, value)]
        self.max_history = (self.DEFAULT_MAX_HISTORY
                            if max_history is None else int(max_history))
        self._tb = None
        self._jsonl = None
        # the sebulba driver logs from two threads (the actor thread's
        # runner-log/test cadences, the learner's log cadence): a key
        # inserted into self.stats while print_recent_stats iterates it
        # is a RuntimeError out of the diagnostics layer, and two
        # unsynchronized _jsonl writes can interleave mid-line — one
        # uncontended lock covers both (single-thread drivers pay an
        # uncontended acquire per cadence, not per step)
        self._lock = threading.Lock()

    # ---- sinks -----------------------------------------------------------
    def setup_tb(self, dirname: str) -> None:
        """TensorBoard via torch's bundled writer (the image has torch;
        gated so a torch-free install still runs)."""
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception:
            self.console_logger.warning(
                "tensorboard writer unavailable; TB logging disabled")
            return
        os.makedirs(dirname, exist_ok=True)
        self._tb = SummaryWriter(log_dir=dirname)

    def setup_json(self, dirname: str) -> None:
        os.makedirs(dirname, exist_ok=True)
        self._jsonl = open(os.path.join(dirname, "metrics.jsonl"), "a")

    # ---- scalar API ------------------------------------------------------
    def log_stat(self, key: str, value, t: int) -> None:
        """Log one stat. Scalars are the contract; a VECTOR value (the
        graftsight fixed-bin histograms, per-layer attention entropies)
        degrades gracefully instead of crashing the diagnostics layer:
        ``metrics.jsonl`` keeps the full-fidelity list, while the
        in-memory history (the ``print_recent_stats`` console path) and
        TensorBoard get the mean as a scalar summary."""
        vector = None
        nd = getattr(value, "ndim", None)
        if isinstance(value, (list, tuple)) or (nd is not None and nd > 0):
            import numpy as _np
            arr = _np.asarray(value, dtype=_np.float64).reshape(-1)
            vector = [float(v) for v in arr]
            # console/TB summary: the mean (NaN-safe — a poisoned bin
            # must not blank the whole console line). Size-1 vectors
            # stay vectors deliberately: a (1,)-shaped stat is schema,
            # not a scalar that happens to be boxed.
            value = float(_np.nanmean(arr)) if arr.size else 0.0
        else:
            value = float(value)
        with self._lock:
            hist = self.stats[key]
            hist.append((t, value))
            if self.max_history and len(hist) > self.max_history:
                # amortized trim: drop down to half the cap so the
                # O(cap) del runs once per cap/2 appends, not on every
                # append — but never below the 5 entries
                # print_recent_stats reads (a cap of 5-9 must stay
                # observationally identical to the unbounded behavior),
                # and never above the cap itself
                keep = min(max(self.max_history // 2, 5),
                           self.max_history)
                del hist[:len(hist) - keep]
            if self._tb is not None:
                self._tb.add_scalar(key, value, t)
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(
                    {"key": key,
                     "value": value if vector is None else vector,
                     "t": t}) + "\n")
                self._jsonl.flush()

    def print_recent_stats(self) -> None:
        """Mirrors the reference's periodic stat dump
        (``per_run.py:283-286``): latest value per key at the newest t."""
        with self._lock:
            if not self.stats:
                return
            t = max(ts[-1][0] for ts in self.stats.values())
            items = [f"t_env: {t}"]
            for k in sorted(self.stats):
                window = self.stats[k][-5:]
                mean = sum(v for _, v in window) / len(window)
                items.append(f"{k}: {mean:.4f}")
            line = "Recent stats | " + " | ".join(items)
        self.console_logger.info(line)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
