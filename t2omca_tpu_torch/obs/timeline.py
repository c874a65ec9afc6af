"""The longitudinal perf-trajectory table (port of
``t2omca_tpu/obs/timeline.py``): ``python -m t2omca_tpu_torch.obs
timeline [BENCH_r*.json ...] [--runs <run_dir> ...] [--json]``.

One row per BENCH record (a wrapper ``{n, cmd, rc, tail, parsed}``
or a bare record line, every historical shape
tolerated), one row per run directory (the newest ``env_steps_per_sec``
of its ``metrics.jsonl``), rendered measured-against-wedged so a partial
never passes for a number. A torn final JSONL line is skipped with a
warning. For the same inputs its output is JAX's, byte for byte.

Imports the standard library only, never torch or jax.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

from ..utils.ioutil import read_jsonl_tolerant

#: record keys surfaced in the note column when present — the leg
#: identity that distinguishes one matrix record from another
_CONTEXT_KEYS = ("config", "superstep", "kernels", "acting", "dp",
                 "population", "sebulba", "leg", "n_envs")


def _warn(msg: str) -> None:
    print(f"graftpulse: warning: {msg}", file=sys.stderr)


def _extract_record(data: Any) -> Optional[dict]:
    """The measurement record inside one BENCH_r*.json: the round
    driver's wrapper carries it under ``parsed`` (possibly null —
    fall back to the last JSON-looking stdout line in ``tail``); a
    bare record file IS the record."""
    if not isinstance(data, dict):
        return None
    if "parsed" in data or "tail" in data or "cmd" in data:
        rec = data.get("parsed")
        if isinstance(rec, dict):
            return rec
        tail = data.get("tail")
        if isinstance(tail, str):
            for line in reversed(tail.strip().splitlines()):
                line = line.strip()
                if line.startswith("{"):
                    try:
                        return json.loads(line)
                    except ValueError:
                        continue
        return None
    if "metric" in data or "value" in data:
        return data
    return None


def bench_row(path: str) -> Dict[str, Any]:
    """→ one timeline row for a BENCH record file (never raises: an
    unreadable file becomes an ``unreadable`` row — the table must
    render the whole series even when one round's artifact is junk)."""
    name = os.path.basename(path)
    if name.endswith(".json"):
        name = name[:-5]
    row: Dict[str, Any] = {"kind": "bench", "name": name, "n": None,
                           "status": "unreadable", "metric": None,
                           "value": None, "unit": None,
                           "vs_baseline": None, "platform": None,
                           "schema": None, "note": ""}
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        row["note"] = f"unreadable: {e}"
        return row
    if isinstance(data, dict):
        row["n"] = data.get("n")
    rec = _extract_record(data)
    if rec is None:
        row["status"] = "no-record"
        rc = data.get("rc") if isinstance(data, dict) else None
        row["note"] = f"no parseable record (rc={rc})"
        return row
    row["metric"] = rec.get("metric")
    row["value"] = rec.get("value")
    row["unit"] = rec.get("unit")
    row["vs_baseline"] = rec.get("vs_baseline")
    row["schema"] = rec.get("schema")
    row["platform"] = rec.get("platform") or rec.get("backend")
    if row["value"] is None:
        # the wedged-partial class (r03–r07): value never landed — the
        # note says which phase died, which is the record's whole point
        row["status"] = "wedged"
        note = []
        if rec.get("phase"):
            note.append(f"phase={rec['phase']}")
        if rec.get("error"):
            note.append(str(rec["error"])[:80])
        row["note"] = " ".join(note) or "no value recorded"
    else:
        row["status"] = "measured"
        ctx = [f"{k}={rec[k]}" for k in _CONTEXT_KEYS
               if rec.get(k) not in (None, False)]
        row["note"] = " ".join(ctx)
    return row


def run_rows(run_dir: str) -> List[Dict[str, Any]]:
    """→ timeline rows for one recorded run directory: the newest
    ``env_steps_per_sec`` from its ``metrics.jsonl`` — torn-tolerant,
    jax-free. (Serving latency lives in BENCH ``--serve`` records, not
    in run-dir metrics — those join the table as bench rows.)"""
    path = os.path.join(run_dir, "metrics.jsonl")
    name = os.path.basename(os.path.normpath(run_dir))
    base = {"kind": "run", "name": name, "n": None, "metric": None,
            "value": None, "unit": None, "vs_baseline": None,
            "platform": None, "schema": None, "note": ""}
    if not os.path.exists(path):
        return [dict(base, status="no-metrics",
                     note="no metrics.jsonl in run dir")]
    try:
        events = read_jsonl_tolerant(
            path, on_bad=lambda ln, last: _warn(
                f"{path} line {ln} unparseable"
                f"{' (torn tail from a killed run?)' if last else ''}"
                f" — skipped"))
    except OSError as e:
        return [dict(base, status="unreadable", note=str(e))]
    newest: Dict[str, Any] = {}
    t_max = 0
    for ev in events:
        if not isinstance(ev, dict):
            continue        # a corrupt line can parse to a bare scalar
        key = ev.get("key")
        if isinstance(key, str):
            newest[key] = ev.get("value")
            t = ev.get("t")
            if isinstance(t, (int, float)):
                t_max = max(t_max, int(t))
    if "env_steps_per_sec" not in newest:
        return [dict(base, status="no-rate",
                     note=f"{len(events)} metric events, no "
                          f"env_steps_per_sec (run died before the "
                          f"second log cadence?)")]
    return [dict(base, status="run", metric="env_steps_per_sec",
                 value=newest["env_steps_per_sec"],
                 unit="env-steps/s (live)",
                 note=f"newest log cadence at t_env={t_max}")]


def _fmt(v, nd=1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:,.{nd}f}"
    return str(v)


def render(rows: List[Dict[str, Any]]) -> str:
    lines: List[str] = []
    lines.append("graftpulse timeline — perf trajectory "
                 "(BENCH records + run metrics)")
    hdr = (f"{'record':<22}{'status':<11}{'metric':<26}{'value':>12}"
           f"{'vs_base':>9}  {'platform':<9}{'note'}")
    lines.append(hdr)
    lines.append("-" * max(len(hdr), 100))
    for r in rows:
        lines.append(
            f"{r['name']:<22}{r['status']:<11}"
            f"{(r['metric'] or '-'):<26}{_fmt(r['value']):>12}"
            f"{_fmt(r['vs_baseline'], 3):>9}  "
            f"{(r['platform'] or '-'):<9}{r['note']}")
    measured = sum(1 for r in rows if r["status"] == "measured")
    wedged = sum(1 for r in rows if r["status"] == "wedged")
    bench_n = sum(1 for r in rows if r["kind"] == "bench")
    lines.append("")
    lines.append(f"{measured}/{bench_n} bench records carry a measured "
                 f"value; {wedged} wedged partial(s)"
                 + (" — the r03+ backend-init class, ROADMAP open "
                    "item 1 (bench.py --daemon waits those out)"
                    if wedged else ""))
    return "\n".join(lines)


def timeline_main(paths: List[str], runs: List[str],
                  as_json: bool = False) -> int:
    """The ``timeline`` subcommand body. Exit 0 = table printed
    (wedged rows are CONTENT, not errors), 2 = nothing to read."""
    if not paths and not runs:
        # bare invocation: the repo-root default. With --runs alone the
        # caller asked about runs, not the cwd's records
        paths = sorted(_glob.glob("BENCH_r*.json"))
    rows: List[Dict[str, Any]] = []
    bench = sorted(paths, key=lambda p: (os.path.basename(p), p))
    for p in bench:
        rows.append(bench_row(p))
    # stable longitudinal order: the round counter when present wins
    # over filename (BENCH_r10 must sort after BENCH_r9)
    rows.sort(key=lambda r: (r["n"] if isinstance(r["n"], int)
                             else 10**9, r["name"]))
    for rd in runs:
        rows.extend(run_rows(rd))
    if not rows:
        print("graftpulse: error: no BENCH_r*.json found and no --runs "
              "given — pass record paths or run from the repo root",
              file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps({"version": 1, "rows": rows}))
    else:
        print(render(rows))
    return 0
