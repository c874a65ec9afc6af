"""graftscope span tracing: the host-side runtime telemetry recorder (the
port's copy of ``t2omca_tpu/obs/spans.py``; the one change is the import
of the port's own ``utils/ioutil``).

* :class:`SpanRecorder` — a low-overhead span recorder. The driver
  wraps every device-facing boundary it already stamps for the
  watchdog (``run.run_sequential`` ``_watched``/``_sync_point`` sites,
  the checkpoint save) in ``rec.span(phase, t_env=..., **meta)``; each
  completed span becomes one structured JSONL event in
  ``<run_dir>/spans.jsonl`` alongside the ``Logger`` sinks. Overhead is
  a couple of ``perf_counter`` calls, a dict build and a deque append
  per span.
* **flight recorder** — the same recorder keeps a bounded in-memory
  ring of the last ``ring_size`` events plus every still-open span.
  ``tail()`` returns them completed-first, open-last (so the hanging
  span of a stalled dispatch is the LAST entry), and
  ``persist(path)`` writes the tail atomically (tmp + rename) — the
  driver calls it on stall, crash, non-finite trip and SIGTERM, and
  merges it into the watchdog's ``stall_diagnosis.json``.
* :class:`NullRecorder` — the default. Telemetry is opt-in
  (``config.ObsConfig.enabled``); with it off every ``span()`` returns
  a shared no-op context and the driver path is behaviorally identical
  to a build without this module.

Event schema: every line is one JSON object.

``{"event": "span", "seq": N, "phase": str, "t_env": int, "t0":
<epoch s>, "wall_ms": float, "outcome": "ok" | "error:<Type>",
"depth": <nesting>, ["first": true,] ...meta}``
    one completed span; ``first`` marks the first completion of the
    phase (it includes the one-time warm-up — the watchdog's warm-up
    exemption made measurable, so warm-up-vs-stall is distinguishable
    post-mortem). ``meta`` carries call-site context (``attempt``,
    ``k``, ...).
``{"event": "mark", "seq": N, "kind": str, "t0": <epoch s>, ...meta}``
    one point event (run header, ladder action, non-finite trip,
    shutdown).

Everything here is stdlib-only.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils.ioutil import write_json_atomic

#: The span phases the driver/bench are allowed to use. graftlint rule
#: GL110 checks every ``_watched``/``_sync_point``/``_dispatch`` call
#: site with a literal phase against this set, so a NEW device-facing
#: boundary cannot silently appear without span (and therefore flight-
#: recorder) coverage. Keep in sync with the hook-point table in
#: ``utils/resilience.py`` and docs/RESILIENCE.md §5 — the phase names
#: ARE the fault-injection hook names where both exist.
KNOWN_PHASES = frozenset({
    # driver dispatch boundaries (run.py _dispatch via _watched)
    "dispatch.superstep", "dispatch.rollout", "dispatch.train",
    "dispatch.test",
    # driver sync/fetch boundaries (run.py _sync_point via _watched)
    "dispatch.wait", "fetch.train_infos", "fetch.train_stats",
    "fetch.test_stats",
    # sebulba decoupled-loop boundaries (run.run_sebulba,
    # parallel/sebulba.py): actor-mesh rollout dispatch, the trajectory
    # queue's two ends (put = actor-side d2d copy + slot scatter, its
    # wait is backpressure = actor idle; get = learner-side slot gather
    # + ring insert, its wait is starvation = learner idle), the
    # learner-mesh train dispatch, and the staleness-bounded
    # learner→actor parameter publish/adopt hop
    "actor.dispatch", "queue.put", "queue.get", "learner.dispatch",
    "params.sync",
    # checkpoint + startup boundaries. graftmorph (docs/RESILIENCE.md
    # §6) adds the elastic-resume routing boundary (checkpoint.elastic:
    # host read + topology reshape before placement), the coordinated-
    # preemption peer barrier (preempt.barrier: bounded KV-store
    # rendezvous agreeing on the cut step), and the degraded per-host
    # shard write (checkpoint.shard_save: the collective-free fallback
    # when a peer died mid-preemption)
    "checkpoint.save", "collective.gather", "backend.init",
    "checkpoint.elastic", "preempt.barrier", "checkpoint.shard_save",
    # bench.py phases (bench harness spans; embedded in BENCH_r*.json).
    # bench.probe is the RETRYABLE backend-init phase (per-attempt
    # budget split + backoff ladder); bench.probe.fallback is the
    # JAX_PLATFORMS='' auto-fallback probe that runs after it fails —
    # its outcome lands in the failure record's `fallback` block
    "bench.probe", "bench.probe.fallback", "bench.build",
    "bench.compile", "bench.warm", "bench.measure",
    # graftserve boundaries (serve/export.py, serve/frontend.py): the
    # exporter's lower/compile/export pass, artifact load, and the
    # three per-request front-end stages — `obs report` reads a
    # serving run's spans.jsonl exactly like a training run's
    "serve.export", "serve.load", "serve.pad", "serve.dispatch",
    "serve.unpad",
    # graftfleet multi-engine serving (serve/fleet.py): per-engine
    # artifact load, the supervised per-request dispatch envelope (the
    # watchdog-stamped boundary; serve.* spans nest inside it), the
    # engine health-check dispatch, a quarantined engine's restart
    # reload, and the rolling hot-param-refresh path (fold + roll
    # stages). bench.chaos is the chaos traffic leg's measure window
    # (bench.py --serve --chaos)
    "fleet.load", "fleet.dispatch", "fleet.selfcheck", "fleet.restart",
    "fleet.refresh", "bench.chaos",
    # graftpulse live telemetry plane (obs/pulse.py, obs/memwatch.py):
    # one /metrics-endpoint scrape, one per-device HBM snapshot, the
    # PULSE_TRACE-file / /trace-endpoint arming of a live trace window,
    # and the bench daemon's two orchestration boundaries (the backoff-
    # laddered backend-init probe and one A/B matrix leg subprocess)
    "pulse.scrape", "memwatch.snapshot", "trace.trigger",
    "bench.daemon.probe", "bench.daemon.leg",
    # graftsight (obs/sight.py): the host-side RL-health detector pass
    # over the log-cadence fetched train info — host-only (no device
    # traffic), spanned so a slow sink/detector shows up in the phase
    # tables instead of silently inflating the log cadence
    "sight.detect",
})

_NOOP = contextlib.nullcontext()


class _Span:
    """Stamp/record pair (plain class with slots, same reasoning as
    ``watchdog._Watch``: contextmanager generators hold frames other
    threads would race, and allocation cost is the overhead budget)."""

    __slots__ = ("_rec", "_ev", "_pc0")

    def __init__(self, rec: "SpanRecorder", ev: Dict[str, Any]):
        self._rec = rec
        self._ev = ev
        self._pc0 = 0.0

    def __enter__(self) -> None:
        self._pc0 = self._rec._begin(self._ev)

    def __exit__(self, exc_type, *exc) -> None:
        self._rec._end(self._ev, self._pc0, exc_type)


class _Stacked:
    """Enter ``outer`` then ``inner``; exit in reverse. The driver pairs
    the watchdog stamp (outer — it must cover the span bookkeeping too)
    with the span record (inner) without paying an ExitStack."""

    __slots__ = ("_outer", "_inner", "_entered")

    def __init__(self, outer, inner):
        self._outer, self._inner = outer, inner
        self._entered = False

    def __enter__(self):
        self._outer.__enter__()
        try:
            self._inner.__enter__()
            self._entered = True
        except BaseException:
            self._outer.__exit__(None, None, None)
            raise
        return None

    def __exit__(self, *exc) -> None:
        try:
            if self._entered:
                self._inner.__exit__(*exc)
        finally:
            self._outer.__exit__(*exc)


def stacked(outer, inner) -> _Stacked:
    return _Stacked(outer, inner)


class SpanRecorder:
    """Span + event recorder with a bounded flight ring and an optional
    JSONL sink. Thread-safe: the watchdog/stall threads may record
    marks while the main thread holds open spans."""

    enabled = True

    def __init__(self, ring_size: int = 256,
                 jsonl_path: Optional[str] = None,
                 flush_every: int = 32) -> None:
        self.ring_size = max(int(ring_size), 1)
        self.jsonl_path = jsonl_path
        self.flush_every = max(int(flush_every), 1)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.ring_size)
        self._open: Dict[int, Dict[str, Any]] = {}   # seq -> open span event
        self._open_pc: Dict[int, float] = {}         # seq -> perf_counter at begin
        self._seq = 0
        self._first_pending: set = set()             # phases never completed
        self._depth = threading.local()
        self._file = None
        self._unflushed = 0
        # per-phase aggregation for summary() — O(1) per span, no event
        # replay (the ring may have evicted early spans)
        self._agg: Dict[str, Dict[str, float]] = {}

    # -- recording -------------------------------------------------------

    def span(self, phase: str, t_env: int = 0, _ring: bool = True,
             **meta) -> _Span:
        """Context manager recording one span. ``meta`` must be
        JSON-serializable scalars (attempt counts, K, ...).
        ``_ring=False`` keeps the completed span OUT of the flight ring
        (it still lands in the JSONL sink and the per-phase aggregate):
        for high-frequency decorative spans — the pulse endpoint's
        per-scrape spans — which would otherwise evict the pre-stall
        phase history the ring exists to preserve (a 5 s scrape cadence
        fills a 256-slot ring in ~21 min, shorter than one
        compile-scale hang)."""
        ev: Dict[str, Any] = {"event": "span", "phase": phase,
                              "t_env": int(t_env)}
        if not _ring:
            ev["_ring"] = False
        if meta:
            ev.update(meta)
        return _Span(self, ev)

    def _begin(self, ev: Dict[str, Any]) -> float:
        d = getattr(self._depth, "n", 0)
        self._depth.n = d + 1
        ev["depth"] = d
        ev["t0"] = round(time.time(), 3)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._open[ev["seq"]] = ev
            pc0 = time.perf_counter()
            self._open_pc[ev["seq"]] = pc0
        return pc0

    def _end(self, ev: Dict[str, Any], pc0: float, exc_type) -> None:
        wall_ms = (time.perf_counter() - pc0) * 1000.0
        self._depth.n = getattr(self._depth, "n", 1) - 1
        phase = ev["phase"]
        with self._lock:
            # ev is still registered in _open until the pop below, and
            # tail() (called from the watchdog stall thread) copies
            # open-span dicts under this lock — inserting the
            # completion keys outside it would race that copy
            ev["wall_ms"] = round(wall_ms, 3)
            ev["outcome"] = ("ok" if exc_type is None
                             else f"error:{exc_type.__name__}")
            self._open.pop(ev["seq"], None)
            self._open_pc.pop(ev["seq"], None)
            a = self._agg.get(phase)
            if a is None:
                a = self._agg[phase] = {"n": 0, "total_ms": 0.0,
                                        "max_ms": 0.0, "first_ms": -1.0}
            a["n"] += 1
            a["total_ms"] += wall_ms
            a["max_ms"] = max(a["max_ms"], wall_ms)
            if exc_type is None and a["first_ms"] < 0:
                # first CLEAN completion = the compile-inclusive
                # occurrence (matches the watchdog's compile exemption:
                # an exception is not a completion)
                a["first_ms"] = wall_ms
                ev["first"] = True
            if ev.pop("_ring", True):
                self._ring.append(ev)
            self._sink(ev)

    def mark(self, kind: str, **meta) -> None:
        """Record one point event (run header, ladder action, ...)."""
        ev: Dict[str, Any] = {"event": "mark", "kind": kind,
                              "t0": round(time.time(), 3)}
        if meta:
            ev.update(meta)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
            self._sink(ev)

    # -- sink ------------------------------------------------------------

    def _sink(self, ev: Dict[str, Any]) -> None:
        """Append one event line (lock held). Best-effort: telemetry
        must never be the thing that crashes the run."""
        if self.jsonl_path is None:
            return
        try:
            # default=repr: a non-JSON meta value (numpy scalar, pytree
            # leaf) degrades to its repr instead of a TypeError out of
            # the hot-loop span bookkeeping
            line = json.dumps(ev, default=repr)
        except (TypeError, ValueError):     # circular refs etc.
            return                          # drop the event, keep the sink
        try:
            if self._file is None:
                os.makedirs(os.path.dirname(self.jsonl_path) or ".",
                            exist_ok=True)
                self._file = open(self.jsonl_path, "a")
            self._file.write(line + "\n")
            self._unflushed += 1
            if self._unflushed >= self.flush_every:
                self._file.flush()
                self._unflushed = 0
        except OSError:
            self.jsonl_path = None          # disk trouble: stop trying

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    # -- flight recorder -------------------------------------------------

    def tail(self) -> List[Dict[str, Any]]:
        """Flight-recorder tail: the last ``ring_size`` completed
        events in completion order, then every still-open span (start
        order) marked ``"open": true`` with its wall so far — so a
        stalled dispatch's hanging span is always the LAST entry."""
        now = time.perf_counter()
        with self._lock:
            out = [dict(ev) for ev in self._ring]
            for seq in sorted(self._open):
                ev = dict(self._open[seq])
                ev.pop("_ring", None)   # internal flag, not schema
                ev["open"] = True
                ev["wall_ms"] = round(
                    (now - self._open_pc[seq]) * 1000.0, 3)
                out.append(ev)
        return out

    def current_phase(self) -> Optional[str]:
        """Innermost still-open span's phase (None when idle) — the
        bench failure record's ``phase`` field."""
        with self._lock:
            if not self._open:
                return None
            return self._open[max(self._open)]["phase"]

    def persist(self, path: str,
                extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Atomically write the flight tail as JSON (tmp + rename).
        Best-effort; returns the path or None. ``extra`` is merged into
        the payload next to the events — the driver passes the HBM
        memwatch report (obs/memwatch.py) so an OOM/wedge flight dump
        says what held device memory."""
        try:
            # default=repr lives in the helper, same reason as _sink:
            # the flight dump runs on crash/stall paths where raising
            # is worst-case
            payload: Dict[str, Any] = {"version": 1, "events": self.tail()}
            if extra:
                payload.update(extra)
            return write_json_atomic(path, payload)
        except (OSError, TypeError, ValueError):
            return None

    # -- aggregation -----------------------------------------------------

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase aggregate: ``{phase: {n, total_ms, max_ms,
        first_ms, steady_ms}}``. ``first_ms`` is the compile-inclusive
        first clean completion (-1 when none completed cleanly);
        ``steady_ms`` is the mean over the rest (the warm rate)."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for phase, a in self._agg.items():
                rest_n = a["n"] - (1 if a["first_ms"] >= 0 else 0)
                rest_total = a["total_ms"] - max(a["first_ms"], 0.0)
                out[phase] = {
                    "n": a["n"],
                    "total_ms": round(a["total_ms"], 3),
                    "max_ms": round(a["max_ms"], 3),
                    "first_ms": round(a["first_ms"], 3),
                    "steady_ms": (round(rest_total / rest_n, 3)
                                  if rest_n > 0 else -1.0),
                }
        return out


class NullRecorder:
    """The disabled-telemetry recorder: every operation is a no-op and
    ``span()`` returns one shared ``nullcontext`` — the driver hot loop
    pays a truthiness check and nothing else."""

    enabled = False
    jsonl_path = None

    def span(self, phase: str, t_env: int = 0, **meta):
        return _NOOP

    def mark(self, kind: str, **meta) -> None:
        pass

    def tail(self) -> List[Dict[str, Any]]:
        return []

    def current_phase(self) -> Optional[str]:
        return None

    def persist(self, path: str, extra=None) -> Optional[str]:
        return None

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {}

    def close(self) -> None:
        pass


#: shared disabled recorder (stateless — safe to share process-wide)
NULL_RECORDER = NullRecorder()


def make_recorder(obs_cfg, run_dir: Optional[str] = None):
    """Recorder for a run: :data:`NULL_RECORDER` unless
    ``obs_cfg.enabled``; the JSONL sink lands in
    ``<run_dir>/spans.jsonl`` when a run directory is given."""
    if obs_cfg is None or not getattr(obs_cfg, "enabled", False):
        return NULL_RECORDER
    path = (os.path.join(run_dir, "spans.jsonl")
            if run_dir else None)
    return SpanRecorder(ring_size=obs_cfg.ring_size, jsonl_path=path,
                        flush_every=obs_cfg.flush_every)
