"""The per-program report of a recorded run (port of
``t2omca_tpu/obs/report.py``): ``python -m t2omca_tpu_torch.obs report
<run_dir>``.

It reads the run's span telemetry (``spans.jsonl``, written by the
driver with ``obs.enabled``) and its optional device-time attribution
(``device_times.json``, written by ``obs/device_time.
ProgramTraceWindow`` under ``obs.program_trace``), and prints JAX's
roofline-style table: wall (and device) time per dispatch of each
program beside its FLOPs and bytes at the run's shapes, its arithmetic
intensity and the achieved FLOP/s, then the other phases, the
per-scenario-slice table of a mixture run and, for a run recorded with
``obs.sight.enabled``, the learning section (``obs/learning.py``). For
the same run directory and the same budgets its output is JAX's, byte
for byte, degraded inputs included (a torn final JSONL line, a run
directory holding only ``flight_recorder.json``, no
``device_times.json``).

**Budgets.** JAX joins ``analysis/programs.json``, graftprog's XLA cost
analysis at its frozen audit config (B = 2, T = 6, K = 2, train batch 4:
:data:`AUDIT_SHAPES`, a copy pinned by the tests), scaled linearly to the
run's shapes. The port has no program budgets of its own: ``report``
takes ``--programs-json`` (that schema, read by this module's own copy of
the loader). Without it every budget column renders ``-`` and one line
says so; the collective census renders only from a given file.

Imports the standard library (and, through ``obs/learning.py``, numpy),
never torch or jax: the post-mortem host may have neither.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

from ..utils.ioutil import read_jsonl_tolerant
# scenario-family id -> name: the copy of ``envs/graftworld.FAMILY_NAMES``
# (which imports torch) that the learning report keeps; pinned by
# tests/test_torch_report.py
from .learning import SCENARIO_FAMILY_NAMES

#: the frozen audit config's shapes the JAX budgets were measured at
#: (``t2omca_tpu/analysis/registry.audit_config`` and
#: ``AUDIT_SUPERSTEP_K``), copied: pinned by the tests
AUDIT_SHAPES = {"batch_size_run": 2, "episode_limit": 6, "batch_size": 4,
                "superstep": 2}

#: the programs-file schema version this reader takes (``t2omca_tpu/
#: analysis/baseline.PROGRAMS_VERSION``)
PROGRAMS_VERSION = 1

#: span phase -> graftprog program name (analysis/programs.json key).
#: ``dispatch.test`` dispatches the same compiled rollout program as
#: the train rollout (test_mode is a static arg of one jitted fn), so
#: it joins the same budgets on its own row.
PHASE_PROGRAMS = {
    "dispatch.superstep": "superstep",
    "dispatch.rollout": "rollout",
    "dispatch.train": "train_iter",
    "dispatch.test": "rollout",
    # serving runs (serve/frontend.py): the dispatch span joins the
    # serve program's graftprog budgets on its own row
    "serve.dispatch": "serve_step",
    # sebulba decoupled runs (run.run_sebulba): the re-homed rollout and
    # train dispatches join their own audit entries (2+2-device split)
    "actor.dispatch": "actor_step",
    "learner.dispatch": "learner_step",
}


#: per-slice metric columns, (header, metrics-key) in render order: the
#: return plus the port's ``utils/stats.SLICE_KEYS`` (copied, pinned by
#: tests/test_torch_report.py)
SLICE_METRICS = (("return", "return_mean"),
                 ("conflict", "conflict_ratio_mean"),
                 ("complete", "task_completion_rate_mean"),
                 ("dl-miss", "deadline_miss_rate_mean"))


def _warn_torn(path: str):
    """on_bad hook for the tolerant JSONL readers: a torn FINAL line is
    the expected artifact of a killed run (crash / SIGKILL / hard
    watchdog exit mid-write) — skipped with a warning, never raised on;
    a torn mid-file line is flagged as the oddity it is."""
    def _on_bad(line_no: int, is_last: bool) -> None:
        what = ("torn final line — the artifact a killed run leaves"
                if is_last else "unparseable mid-file line")
        print(f"graftscope: warning: {path}:{line_no}: {what}; skipped",
              file=sys.stderr)
    return _on_bad


def load_events(run_dir: str) -> List[dict]:
    path = os.path.join(run_dir, "spans.jsonl")
    events = read_jsonl_tolerant(path, on_bad=_warn_torn(path))
    return [e for e in events if isinstance(e, dict)]


def load_flight_events(run_dir: str) -> Optional[List[dict]]:
    """Degraded-input fallback: a run that died before (or without)
    flushing ``spans.jsonl`` may still have persisted its flight ring
    (``flight_recorder.json``, same event schema, bounded tail). None
    when absent/unreadable."""
    path = os.path.join(run_dir, "flight_recorder.json")
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    events = payload.get("events")
    if not isinstance(events, list):
        return None
    return [e for e in events if isinstance(e, dict)]


def load_device_times(run_dir: str) -> Dict[str, dict]:
    path = os.path.join(run_dir, "device_times.json")
    try:
        with open(path) as f:
            return dict(json.load(f).get("programs", {}))
    except (OSError, ValueError):
        return {}


def scenario_slices(run_dir: str) -> Dict[str, Dict[int, dict]]:
    """Per-scenario-slice eval metrics from the run's ``metrics.jsonl``
    (graftworld, docs/ENVS.md): the newest value of every
    ``[test_]slice<fam>_*`` key the stats accumulators logged, grouped
    as ``{prefix: {family_id: {metric: value}}}``. Empty when the run
    trained a single scenario (the accumulators only emit slice rows
    when more than one family was observed)."""
    path = os.path.join(run_dir, "metrics.jsonl")
    out: Dict[str, Dict[int, dict]] = {}
    try:
        events = read_jsonl_tolerant(path, on_bad=_warn_torn(path))
    except OSError:
        return out
    for ev in events:
        if isinstance(ev, dict):
            key = ev.get("key", "")
            prefix = ""
            if key.startswith("test_"):
                prefix, key = "test", key[5:]
            if not key.startswith("slice"):
                continue
            fam_s, _, metric = key[5:].partition("_")
            if not fam_s.isdigit() or not metric:
                continue
            out.setdefault(prefix, {}).setdefault(
                int(fam_s), {})[metric] = ev.get("value")
    return out


def render_slices(slices: Dict[str, Dict[int, dict]]) -> List[str]:
    """The per-scenario-slice table: one block per train/test prefix,
    one row per family — the generalization read a mixture run needs
    (mean return alone hides a family the policy sacrificed)."""

    def cell(v, nd=1):
        # NOT _fmt: that helper renders negatives as '-' (its callers
        # use -1 as an absent sentinel), but slice returns are routinely
        # negative (reward = delay gain - deadline penalties) and the
        # worst families are exactly the rows this table exists to show
        if v is None:
            return "-"
        return f"{v:,.{nd}f}" if isinstance(v, float) else str(v)

    lines: List[str] = []
    for prefix in sorted(slices):
        fams = slices[prefix]
        if not fams:
            continue
        lines.append("")
        lines.append(f"scenario slices ({prefix or 'train'}; newest "
                     f"cadence, graftworld per-family eval)")
        hdr = f"{'family':<16}{'n':>7}" + "".join(
            f"{label:>11}" for label, _ in SLICE_METRICS)
        lines.append(hdr)
        lines.append("-" * len(hdr))
        for fam in sorted(fams):
            m = fams[fam]
            name = (SCENARIO_FAMILY_NAMES[fam]
                    if 0 <= fam < len(SCENARIO_FAMILY_NAMES)
                    else f"family{fam}")
            row = f"{name:<16}{cell(m.get('n'), 0):>7}"
            for label, key in SLICE_METRICS:
                nd = 1 if key == "return_mean" else 3
                row += f"{cell(m.get(key), nd):>11}"
            lines.append(row)
    return lines


def run_header(events: List[dict]) -> Optional[dict]:
    for ev in events:
        if ev.get("event") == "mark" and ev.get("kind") == "run":
            return ev
    return None


def phase_summary(events: List[dict]) -> Dict[str, dict]:
    """Per-phase aggregate from raw span events (same shape as
    ``SpanRecorder.summary()``, recomputed from the durable JSONL)."""
    out: Dict[str, dict] = {}
    for ev in events:
        if ev.get("event") != "span" or ev.get("open"):
            continue
        phase, ms = ev.get("phase"), ev.get("wall_ms")
        if not isinstance(phase, str) or not isinstance(ms, (int, float)):
            continue
        a = out.setdefault(phase, {"n": 0, "total_ms": 0.0, "max_ms": 0.0,
                                   "first_ms": -1.0, "errors": 0})
        a["n"] += 1
        a["total_ms"] += ms
        a["max_ms"] = max(a["max_ms"], ms)
        if ev.get("first"):
            a["first_ms"] = ms
        if str(ev.get("outcome", "ok")).startswith("error"):
            a["errors"] += 1
    for a in out.values():
        rest_n = a["n"] - (1 if a["first_ms"] >= 0 else 0)
        rest_total = a["total_ms"] - max(a["first_ms"], 0.0)
        a["steady_ms"] = rest_total / rest_n if rest_n > 0 else -1.0
    return out


def load_programs(path: Optional[str]) -> dict:
    """A programs file (``analysis/programs.json``'s schema) →
    ``{"platform", "programs", "transfers"}`` (the JAX loader's, copied);
    None or a missing file is an empty baseline."""
    if path is None or not os.path.exists(path):
        return {"platform": None, "programs": {}, "transfers": {}}
    with open(path) as f:
        data = json.load(f)
    if data.get("version") != PROGRAMS_VERSION:
        raise ValueError(
            f"programs baseline {path} has version "
            f"{data.get('version')!r}, this tool reads version "
            f"{PROGRAMS_VERSION}")
    return {"platform": data.get("platform"),
            "programs": dict(data.get("programs", {})),
            "transfers": dict(data.get("transfers", {}))}


def scale_factor(program: str, header: Optional[dict],
                 audit: dict) -> Optional[float]:
    """First-order budget scale: run per-dispatch work / audit
    per-dispatch work. None when the header lacks the needed shapes."""
    if not header:
        return None
    try:
        b = float(header["batch_size_run"]) / audit["batch_size_run"]
        t = float(header["episode_limit"]) / audit["episode_limit"]
        if program in ("rollout", "insert", "actor_step"):
            return b * t
        if program in ("train_iter", "learner_step"):
            return (float(header["batch_size"]) / audit["batch_size"]) * t
        if program == "superstep":
            k = float(header.get("superstep", 1)) / audit["superstep"]
            return k * b * t
    except (KeyError, TypeError, ZeroDivisionError):
        return None
    return None


def build_rows(phases: Dict[str, dict], device_times: Dict[str, dict],
               programs: Dict[str, dict], header: Optional[dict]
               ) -> List[dict]:
    audit = AUDIT_SHAPES
    rows: List[dict] = []
    for phase, prog_name in PHASE_PROGRAMS.items():
        p = phases.get(phase)
        if p is None or p["n"] == 0:
            continue
        entry = programs.get(prog_name, {})
        dev = device_times.get(prog_name, {})
        sf = scale_factor(prog_name, header, audit)
        flops = entry.get("flops")
        bytes_ = entry.get("bytes_accessed")
        row = {
            "phase": phase, "program": prog_name, "n": p["n"],
            "first_ms": p["first_ms"], "steady_ms": p["steady_ms"],
            "total_ms": p["total_ms"],
            "device_ms": dev.get("device_ms"),
            "device_events": dev.get("events"),
            "flops_audit": flops, "bytes_audit": bytes_,
            "intensity": (flops / bytes_ if flops and bytes_ else None),
            "gflop_disp": (flops * sf / 1e9
                           if flops is not None and sf else None),
            "gb_disp": (bytes_ * sf / 1e9
                        if bytes_ is not None and sf else None),
        }
        # achieved rate: device time when attributed, else the steady
        # wall per dispatch (which includes dispatch overhead — an
        # upper bound on time, lower bound on rate, stated in the table
        # legend). The trace window covers only its OWN dispatches (not
        # the whole run's span count), so per-dispatch device time is
        # the window's median event duration — robust to the compile-
        # inclusive first call on host tracks; mean over the window's
        # events is the fallback for older device_times.json files.
        per_disp_ms = None
        if dev.get("median_ms"):
            per_disp_ms = dev["median_ms"]
            row["time_source"] = "device"
        elif row["device_ms"] and row["device_events"]:
            per_disp_ms = row["device_ms"] / row["device_events"]
            row["time_source"] = "device"
        elif p["steady_ms"] and p["steady_ms"] > 0:
            per_disp_ms = p["steady_ms"]
            row["time_source"] = "wall"
        row["per_disp_ms"] = per_disp_ms
        row["achieved_gflops"] = (
            row["gflop_disp"] / (per_disp_ms / 1000.0)
            if row["gflop_disp"] and per_disp_ms else None)
        rows.append(row)
    # device-attributed programs with no dispatch span of their own —
    # the fused Pallas kernels (attn_pallas etc.) show up only as device
    # kernel launches inside a larger program's dispatch. Without this
    # they would silently vanish from the table (their device time
    # dropped into the unattributed bucket); budgets stay unscaled (no
    # run-shape mapping for a kernel fragment — stated via sf=None).
    spanned = {r["program"] for r in rows}
    for prog_name in sorted(set(device_times) - spanned):
        dev = device_times[prog_name]
        entry = programs.get(prog_name, {})
        flops = entry.get("flops")
        bytes_ = entry.get("bytes_accessed")
        per_disp_ms = dev.get("median_ms") or (
            dev["device_ms"] / dev["events"] if dev.get("events") else None)
        rows.append({
            "phase": "(trace-only)", "program": prog_name,
            "n": dev.get("events", 0), "first_ms": -1.0,
            "steady_ms": -1.0, "total_ms": dev.get("device_ms", 0.0),
            "device_ms": dev.get("device_ms"),
            "device_events": dev.get("events"),
            "flops_audit": flops, "bytes_audit": bytes_,
            "intensity": (flops / bytes_ if flops and bytes_ else None),
            "gflop_disp": None, "gb_disp": None,
            "per_disp_ms": per_disp_ms, "time_source": "device",
            "achieved_gflops": None,
        })
    return rows


def _fmt(v, nd=1, dash="-") -> str:
    if v is None or (isinstance(v, (int, float)) and v < 0):
        return dash
    if isinstance(v, float):
        return f"{v:,.{nd}f}"
    return str(v)


def render(run_dir: str, events: List[dict], rows: List[dict],
           phases: Dict[str, dict], header: Optional[dict],
           peak_gflops: Optional[float], peak_gbps: Optional[float]
           ) -> str:
    lines: List[str] = []
    lines.append(f"graftscope report — {run_dir}")
    if header:
        keys = ("backend", "batch_size_run", "episode_limit",
                "batch_size", "superstep")
        lines.append("run: " + "  ".join(
            f"{k}={header[k]}" for k in keys if k in header))
    else:
        lines.append("run: (no run header mark in spans.jsonl — budget "
                     "scaling disabled)")
    n_spans = sum(1 for e in events if e.get("event") == "span")
    lines.append(f"events: {len(events)} ({n_spans} spans)")
    lines.append("")
    if rows:
        hdr = (f"{'program':<13}{'phase':<20}{'n':>6}{'first ms':>10}"
               f"{'ms/disp':>10}{'src':>5}{'~GFLOP/d':>10}{'~GB/d':>8}"
               f"{'FLOP/B':>8}{'~GFLOP/s':>10}")
        lines.append(hdr)
        lines.append("-" * len(hdr))
        for r in rows:
            per_disp = r["per_disp_ms"]
            lines.append(
                f"{r['program']:<13}{r['phase']:<20}{r['n']:>6}"
                f"{_fmt(r['first_ms']):>10}{_fmt(per_disp):>10}"
                f"{r.get('time_source', '-'):>5}"
                f"{_fmt(r['gflop_disp'], 3):>10}{_fmt(r['gb_disp'], 3):>8}"
                f"{_fmt(r['intensity']):>8}"
                f"{_fmt(r['achieved_gflops']):>10}")
            if peak_gflops and peak_gbps and r["intensity"] \
                    and r["achieved_gflops"]:
                bound = min(peak_gflops, r["intensity"] * peak_gbps)
                lines.append(
                    f"{'':<11}  roofline bound {bound:,.1f} GFLOP/s "
                    f"({'compute' if bound == peak_gflops else 'memory'}"
                    f"-bound) — achieved "
                    f"{100.0 * r['achieved_gflops'] / bound:.1f}%")
        lines.append("")
        lines.append("~ = audit-config budgets (analysis/programs.json) "
                     "scaled linearly to the run shapes; src=wall "
                     "includes dispatch overhead (device attribution "
                     "off — obs.program_trace + profile_dir enable it)")
    else:
        lines.append("no program dispatch spans found (was the run "
                     "recorded with obs.enabled?)")
    other = {ph: a for ph, a in sorted(phases.items())
             if ph not in PHASE_PROGRAMS}
    if other:
        lines.append("")
        hdr = (f"{'phase':<22}{'n':>6}{'first ms':>10}{'mean ms':>10}"
               f"{'max ms':>10}{'total ms':>11}{'errors':>7}")
        lines.append(hdr)
        lines.append("-" * len(hdr))
        for ph, a in other.items():
            mean = a["total_ms"] / a["n"] if a["n"] else None
            lines.append(
                f"{ph:<22}{a['n']:>6}{_fmt(a['first_ms']):>10}"
                f"{_fmt(mean):>10}{_fmt(a['max_ms']):>10}"
                f"{_fmt(a['total_ms']):>11}{a['errors']:>7}")
    seb = sebulba_utilization(events, phases)
    if seb:
        lines.append("")
        lines.append("sebulba utilization (decoupled actor/learner run)")
        hdr = (f"{'side':<9}{'busy ms':>12}{'idle ms':>12}{'util %':>8}")
        lines.append(hdr)
        lines.append("-" * len(hdr))
        for side in ("actor", "learner"):
            u = seb[side]
            lines.append(f"{side:<9}{_fmt(u['busy_ms']):>12}"
                         f"{_fmt(u['idle_ms']):>12}"
                         f"{_fmt(u['util_pct']):>8}")
        lines.append(f"queue depth (last log cadence): "
                     f"{_fmt(seb.get('queue_depth'), 0)} "
                     f"of {_fmt(seb.get('queue_slots'), 0)} slots")
        lines.append("busy = dispatch span wall; idle = queue-wait span "
                     "wall (put = actor backpressure, get = learner "
                     "starvation); params.sync mixes the learner "
                     "publish with the actor's staleness wait and is "
                     "counted on neither side")
    slices = scenario_slices(run_dir)
    if any(slices.values()):
        lines.extend(render_slices(slices))
    else:
        # degraded input honesty: a metrics.jsonl that exists but holds
        # no slice rows (empty file, or a run killed before the first
        # cadence) renders a stated "no data" instead of silently
        # omitting the section a graftworld run's reader expects
        mpath = os.path.join(run_dir, "metrics.jsonl")
        try:
            empty = os.path.getsize(mpath) == 0
        except OSError:
            empty = False               # no metrics.jsonl at all: a
            # single-scenario run — the section stays absent, as before
        if empty:
            lines.append("")
            lines.append("scenario slices: no data (metrics.jsonl is "
                         "empty — run killed before the first log "
                         "cadence?)")
    return "\n".join(lines)


def sebulba_utilization(events: List[dict],
                        phases: Dict[str, dict]) -> Optional[dict]:
    """Actor/learner utilization for a decoupled run, from the span
    stream alone: each side's dispatch spans are its busy time and its
    queue-end waits its idle time (``run.run_sebulba`` records the
    waits inside the ``queue.put``/``queue.get`` spans). None when the
    run has no sebulba phases (classic/fused runs keep their report
    unchanged)."""
    a = phases.get("actor.dispatch")
    l = phases.get("learner.dispatch")
    if a is None and l is None and "queue.put" not in phases:
        return None
    zero = {"total_ms": 0.0}

    def util(busy, idle):
        busy_ms = busy.get("total_ms", 0.0)
        idle_ms = idle.get("total_ms", 0.0)
        denom = busy_ms + idle_ms
        return {"busy_ms": round(busy_ms, 1), "idle_ms": round(idle_ms, 1),
                "util_pct": (round(100.0 * busy_ms / denom, 1)
                             if denom > 0 else None)}

    test = phases.get("dispatch.test", zero)
    actor_busy = {"total_ms": (a or zero).get("total_ms", 0.0)
                  + test.get("total_ms", 0.0)}
    out = {"actor": util(actor_busy, phases.get("queue.put", zero)),
           "learner": util(l or zero, phases.get("queue.get", zero))}
    # queue depth / config from the run header + the last log-cadence
    # sebulba mark (the driver emits one per log interval)
    for ev in events:
        if ev.get("event") != "mark":
            continue
        if ev.get("kind") == "run" and "queue_slots" in ev:
            out["queue_slots"] = ev["queue_slots"]
        if ev.get("kind") == "sebulba":
            out["queue_depth"] = ev.get("queue_depth")
    return out


def render_comms_census(base: dict) -> List[str]:
    """Per-program collective census from the graftshard ``comms``
    sections of programs.json plus its ``transfers`` table — the static
    interconnect view joined into the report so "where did the time go"
    sits next to "what moves between devices each dispatch". Purely a
    baseline read (no jax, nothing compiled); empty when the baseline
    predates the comms audit (``--comms --write-programs``)."""
    comms = {n: e["comms"]
             for n, e in sorted(base.get("programs", {}).items())
             if "comms" in e}
    transfers = base.get("transfers", {})
    if not comms and not transfers:
        return []
    lines = ["", "collective census (graftshard --comms: static, "
                 "per dispatch, on the fixed audit meshes)"]
    hdr = (f"{'program':<17}{'mesh':<16}"
           f"{'collectives (count x kind[axes])':<40}{'bytes':>9}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for name, c in comms.items():
        cols = ", ".join(
            f"{e['count']}x {kind}[{'/'.join(e['axes'])}]"
            for kind, e in sorted(c.get("collectives", {}).items())) \
            or "none"
        lines.append(f"{name:<17}{c.get('mesh', '-'):<16}{cols:<40}"
                     f"{c.get('bytes', 0):>9}")
    for name, t in sorted(transfers.items()):
        what = f"{t.get('leaves', 0)} leaves, {t.get('kind', '?')}"
        lines.append(f"{name:<17}{'transfer':<16}{what:<40}"
                     f"{t.get('bytes', 0):>9}")
    return lines


def report_main(run_dir: str, programs_json: Optional[str] = None,
                peak_gflops: Optional[float] = None,
                peak_gbps: Optional[float] = None) -> int:
    """The ``report`` subcommand body. Exit codes match the analysis
    CLI convention: 0 = report printed, 2 = usage error (missing run
    dir / unreadable telemetry)."""
    if not os.path.isdir(run_dir):
        print(f"graftscope: error: {run_dir!r} is not a directory",
              file=sys.stderr)
        return 2
    try:
        events = load_events(run_dir)
    except OSError as e:
        # degraded-input fallback: a run dir holding only the persisted
        # flight ring (crash before any spans flush) still reports from
        # that bounded tail — stated, so nobody mistakes it for the run
        events = load_flight_events(run_dir)
        if events is None:
            print(f"graftscope: error: no spans.jsonl in {run_dir!r} "
                  f"({e}) and no flight_recorder.json fallback; record "
                  f"the run with obs.enabled=true", file=sys.stderr)
            return 2
        print(f"graftscope: note: no spans.jsonl — reporting from the "
              f"flight-recorder tail ({len(events)} events; bounded "
              f"ring, not the full run)", file=sys.stderr)
    try:
        base = load_programs(programs_json)
    except (OSError, ValueError, KeyError, TypeError) as e:
        print(f"graftscope: error: unreadable programs baseline: {e}",
              file=sys.stderr)
        return 2
    phases = phase_summary(events)
    rows = build_rows(phases, load_device_times(run_dir),
                      base["programs"], run_header(events))
    print(render(run_dir, events, rows, phases, run_header(events),
                 peak_gflops, peak_gbps))
    if programs_json is None:
        print("budgets: none given (--programs-json takes a file of "
              "analysis/programs.json's schema); the budget columns "
              "read '-'")
    census = render_comms_census(base)
    if census:
        print("\n".join(census))
    # graftsight section: a run recorded with obs.sight.enabled carries
    # learning-dynamics keys in metrics.jsonl — append the learning-
    # health read so one `obs report` answers both "where did the time
    # go" and "was it learning" (full detail: `obs learning <run_dir>`)
    from .learning import _series_from_metrics, render_learning
    mpath = os.path.join(run_dir, "metrics.jsonl")
    try:
        mevents = read_jsonl_tolerant(mpath, on_bad=_warn_torn(mpath))
    except OSError:
        mevents = []
    series = _series_from_metrics(mevents)
    if any(k.startswith("sight_") for k in series):
        print()
        print("\n".join(render_learning(run_dir, series)))
    return 0
