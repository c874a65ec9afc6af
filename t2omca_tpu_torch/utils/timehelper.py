"""ETA estimation and human-readable durations (M10).

The port's copy of ``t2omca_tpu/utils/timehelper.py``. Contract from the
call sites (the reference's ``per_run.py:9,207-208,246-251``):
``time_left(last_time, last_T, t_current, t_max)`` extrapolates remaining
wall-clock from the recent rate; ``time_str(seconds)`` renders a duration.
"""

from __future__ import annotations

import time


def time_str(s: float) -> str:
    """Seconds → ``Xd Xh Xm Xs`` (largest nonzero units)."""
    s = int(s)
    days, s = divmod(s, 86400)
    hours, s = divmod(s, 3600)
    minutes, s = divmod(s, 60)
    out = []
    if days:
        out.append(f"{days}d")
    if hours or days:
        out.append(f"{hours}h")
    if minutes or hours or days:
        out.append(f"{minutes}m")
    out.append(f"{s}s")
    return " ".join(out)


def time_left(start_time: float, t_start: int, t_current: int,
              t_max: int) -> str:
    """Extrapolated remaining time from the rate since ``start_time``."""
    if t_current >= t_max:
        return "-"
    elapsed = time.time() - start_time
    if t_current <= t_start or elapsed <= 0:
        return "?"
    rate = (t_current - t_start) / elapsed
    return time_str((t_max - t_current) / rate)
