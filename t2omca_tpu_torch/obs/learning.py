"""The learning-health report of a recorded run: ``python -m
t2omca_tpu_torch.obs learning <run_dir>`` and the learning section of
``obs report`` (the CLI half of the JAX package's ``obs/sight.py``).

It reads the run's ``metrics.jsonl`` only, and imports the standard
library and numpy, never torch or jax: the post-mortem host may have
neither. ``obs/sight.py`` (the probes and the detector monitor) imports
``learning_main`` back.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

#: tiny epsilon of the trend's ratio denominator (``sight._EPS``)
_EPS = 1e-12

#: scenario family names of the learning curves' and the report's slice
#: columns: a copy of ``envs/graftworld.FAMILY_NAMES``, which imports
#: torch (the JAX package's ``obs/report.SCENARIO_FAMILY_NAMES``)
SCENARIO_FAMILY_NAMES = ("baseline", "hetfleet", "interference", "surge")


#: ASCII sparkline ramp for histogram cells
_RAMP = " .:-=+*#%@"

#: health-table rows: (label, metrics key, decimals)
_HEALTH_ROWS = (
    ("loss", "loss", 4),
    ("grad norm (total)", "grad_norm", 3),
    ("grad norm agent-tf", "sight_grad_norm_agent_tf", 4),
    ("grad norm embed", "sight_grad_norm_embed", 4),
    ("grad norm mixer", "sight_grad_norm_mixer", 4),
    ("update norm agent-tf", "sight_update_norm_agent_tf", 5),
    ("update norm embed", "sight_update_norm_embed", 5),
    ("update norm mixer", "sight_update_norm_mixer", 5),
    ("q_taken mean", "q_taken_mean", 3),
    ("target mean", "target_mean", 3),
    ("PER weight ESS (of batch)", "sight_per_ess", 3),
    ("PER priority entropy / log n", "sight_priority_entropy_norm", 3),
    ("target drift (rel)", "sight_target_drift", 4),
    ("td error |mean|", "td_error_abs", 4),
)


def _series_from_metrics(events: List[dict]) -> Dict[str, list]:
    series: Dict[str, list] = {}
    for ev in events:
        if isinstance(ev, dict) and "key" in ev:
            series.setdefault(ev["key"], []).append(
                (ev.get("t", 0), ev.get("value")))
    return series


def _spark(vec) -> str:
    """ASCII sparkline; non-finite cells render ``!`` — the Logger
    deliberately keeps poisoned bins at full fidelity in the metric
    stream, and the post-mortem reader must survive (and SHOW) them,
    since pathological runs are exactly its use case."""
    v = np.asarray(vec, float).reshape(-1)
    finite = np.isfinite(v)
    if v.size == 0 or not finite.any():
        return "-"
    hi = float(np.max(v[finite]))
    out = []
    for x, ok in zip(v, finite):
        if not ok:
            out.append("!")
        elif hi <= 0:
            out.append(".")
        else:
            out.append(_RAMP[min(max(int(x / hi * (len(_RAMP) - 1)), 0),
                                 len(_RAMP) - 1)])
    return "".join(out)


def _downsample(points: list, n: int = 12) -> list:
    if len(points) <= n:
        return points
    idx = np.linspace(0, len(points) - 1, n).round().astype(int)
    return [points[i] for i in idx]


def render_learning(run_dir: str, series: Dict[str, list]) -> List[str]:
    """The learning-health report body (shared by the ``learning`` CLI
    and the ``report`` section): health table, histograms, detector
    verdicts, learning curves per scenario slice, and the one-line
    "is this run learning?" read."""
    lines: List[str] = []
    lines.append(f"graftsight learning report — {run_dir}")
    last_t = max((pts[-1][0] for pts in series.values() if pts), default=0)
    lines.append(f"newest cadence: t_env={last_t}")

    lines.append("")
    lines.append("learning health (newest value per key)")
    hdr = f"{'metric':<30}{'value':>14}{'trend (last 12)':>20}"
    lines.append(hdr)
    lines.append("-" * len(hdr))
    any_row = False
    for label, key, nd in _HEALTH_ROWS:
        pts = series.get(key)
        if not pts:
            continue
        any_row = True
        v = pts[-1][1]
        cell = f"{v:,.{nd}f}" if isinstance(v, (int, float)) else str(v)
        trend = _spark([abs(p[1]) for p in _downsample(pts)
                        if isinstance(p[1], (int, float))])
        lines.append(f"{label:<30}{cell:>14}{trend:>20}")
    for side in ("agent", "mixer"):
        pts = series.get(f"sight_attn_entropy_{side}")
        if pts and isinstance(pts[-1][1], (list, tuple)):
            any_row = True
            ents = ", ".join(f"{float(e):.3f}" for e in pts[-1][1])
            lines.append(f"{'attn entropy ' + side + ' (per layer)':<30}"
                         f"{ents:>14}")
    if not any_row:
        lines.append("(no learner metrics — was the run recorded with "
                     "obs.sight.enabled?)")

    hists = [(k, series[k]) for k in
             ("sight_td_hist", "sight_q_taken_hist", "sight_target_hist")
             if series.get(k)]
    if hists:
        lines.append("")
        lines.append("value histograms (newest cadence; fixed bins, "
                     "outliers clip into the edge bins)")
        for k, pts in hists:
            v = pts[-1][1]
            if isinstance(v, (list, tuple)):
                lines.append(f"  {k[len('sight_'):]:<16}|{_spark(v)}|")

    alerts = {k[len("sight_alert_"):]: pts for k, pts in series.items()
              if k.startswith("sight_alert_")}
    lines.append("")
    lines.append("detector verdicts (sight_alert_* stream)")
    if alerts:
        for name in sorted(alerts):
            pts = alerts[name]
            tripped = pts[-1][1] not in (0, 0.0)
            last_trip = max((t for t, v in pts if v not in (0, 0.0)),
                            default=None)
            state = "TRIPPED" if tripped else "clear"
            extra = (f" (last trip t_env={last_trip})"
                     if last_trip is not None and not tripped else "")
            lines.append(f"  {name:<22}{state}{extra}")
    else:
        lines.append("  (no detector transitions recorded)")

    # per-member health of a population: pop<i>_* rows in
    # the metric stream mean a population > 1 ran — one line per member
    # joining its newest return/loss/health values and standing alerts
    pop_ids = sorted({
        int(k[3:k.index("_")]) for k in series
        if k.startswith("pop") and "_" in k
        and k[3:k.index("_")].isdigit()})
    if pop_ids:
        lines.append("")
        lines.append(f"population members ({len(pop_ids)} — newest "
                     f"value per member)")
        hdr = (f"{'member':<8}{'return':>12}{'loss':>12}"
               f"{'q_taken':>12}{'PER ESS':>10}  alerts")
        lines.append(hdr)
        lines.append("-" * len(hdr))

        def _newest(key):
            pts = series.get(key)
            v = pts[-1][1] if pts else None
            return v if isinstance(v, (int, float)) else None

        for m in pop_ids:
            cells = []
            for key, nd in ((f"pop{m}_return_mean", 2),
                            (f"pop{m}_loss", 4)):
                v = _newest(key)
                cells.append(f"{v:>12,.{nd}f}" if v is not None
                             else f"{'-':>12}")
            v = _newest(f"pop{m}_q_taken_mean")
            cells.append(f"{v:>12,.3f}" if v is not None else f"{'-':>12}")
            v = _newest(f"pop{m}_sight_per_ess")
            cells.append(f"{v:>10,.3f}" if v is not None else f"{'-':>10}")
            standing = sorted(
                k[len(f"pop{m}_sight_alert_"):]
                for k, pts in series.items()
                if k.startswith(f"pop{m}_sight_alert_") and pts
                and pts[-1][1] not in (0, 0.0))
            cells.append("  " + (", ".join(standing) or "none"))
            lines.append(f"pop{m:<5}" + "".join(cells))

    curve_keys = []
    for prefix in ("", "test_"):
        if series.get(prefix + "return_mean"):
            curve_keys.append((prefix + "return_mean",
                               "test" if prefix else "train"))
    slice_fams = sorted({
        int(k.split("_", 1)[0][len("slice"):])
        for k in series
        if k.startswith("slice") and k.endswith("_return_mean")
        and k[len("slice"):k.index("_")].isdigit()})
    if curve_keys or slice_fams:
        lines.append("")
        lines.append("learning curves (return_mean; downsampled)")
        cols = [label for _, label in curve_keys]
        cols += [(SCENARIO_FAMILY_NAMES[f]
                  if 0 <= f < len(SCENARIO_FAMILY_NAMES)
                  else f"family{f}") for f in slice_fams]
        hdr = f"{'t_env':>10}" + "".join(f"{c:>14}" for c in cols)
        lines.append(hdr)
        lines.append("-" * len(hdr))
        base = series.get("return_mean") or next(
            (series[k] for k, _ in curve_keys), [])
        for t, _ in _downsample(base):
            row = f"{t:>10}"
            for key, _label in curve_keys:
                row += _cell_at(series[key], t)
            for f in slice_fams:
                row += _cell_at(series.get(f"slice{f}_return_mean", []), t)
            lines.append(row)

    verdict = _learning_verdict(series)
    lines.append("")
    lines.append(f"verdict: {verdict}")
    return lines


def _cell_at(pts: list, t: int) -> str:
    """Newest value at-or-before ``t`` (the curves log on different
    cadences; exact-t joins would leave holes)."""
    best = None
    for pt, pv in pts:
        if pt <= t:
            best = pv
        else:
            break
    if best is None or not isinstance(best, (int, float)):
        return f"{'-':>14}"
    return f"{best:>14,.2f}"


def _learning_verdict(series: Dict[str, list]) -> str:
    """The "is this run learning?" one-liner: return trend (first vs
    last third of the curve) + standing detector alerts."""
    tripped = sorted(
        k[len("sight_alert_"):] for k, pts in series.items()
        if k.startswith("sight_alert_") and pts
        and pts[-1][1] not in (0, 0.0))
    pts = [v for _, v in (series.get("return_mean") or [])
           if isinstance(v, (int, float))]
    if len(pts) < 3:
        trend = "too little return data to call a trend"
    else:
        third = max(len(pts) // 3, 1)
        early, late = float(np.mean(pts[:third])), float(
            np.mean(pts[-third:]))
        span = max(abs(early), abs(late), _EPS)
        if late - early > 0.05 * span:
            trend = (f"return improving ({early:,.2f} -> {late:,.2f})")
        elif early - late > 0.05 * span:
            trend = (f"return REGRESSING ({early:,.2f} -> {late:,.2f})")
        else:
            trend = f"return flat around {late:,.2f}"
    if tripped:
        return f"{trend}; standing alerts: {', '.join(tripped)}"
    return f"{trend}; no standing alerts"


def _warn_torn(path: str):
    """on_bad hook for the tolerant JSONL reader: a torn FINAL line is
    the expected artifact of a killed run — skipped with a warning,
    never raised on; a torn mid-file line is flagged as the oddity it
    is (the JAX package's ``obs/report._warn_torn``)."""
    def _on_bad(line_no: int, is_last: bool) -> None:
        what = ("torn final line — the artifact a killed run leaves"
                if is_last else "unparseable mid-file line")
        print(f"graftscope: warning: {path}:{line_no}: {what}; skipped",
              file=sys.stderr)
    return _on_bad


def learning_main(run_dir: str) -> int:
    """The ``learning`` subcommand body (``obs/__main__.py``). Exit
    codes match the obs CLI convention: 0 = report printed, 2 = usage
    error. Reads no device; reads ``metrics.jsonl`` through the
    tolerant reader — the torn final line a killed run leaves is
    skipped with a warning, never raised on."""
    from ..utils.ioutil import read_jsonl_tolerant
    if not os.path.isdir(run_dir):
        print(f"graftsight: error: {run_dir!r} is not a directory",
              file=sys.stderr)
        return 2
    path = os.path.join(run_dir, "metrics.jsonl")
    try:
        events = read_jsonl_tolerant(path, on_bad=_warn_torn(path))
    except OSError as e:
        print(f"graftsight: error: no metrics.jsonl in {run_dir!r} "
              f"({e}); the learning report reads the run's metric "
              f"stream", file=sys.stderr)
        return 2
    print("\n".join(render_learning(
        run_dir, _series_from_metrics(events))))
    return 0
