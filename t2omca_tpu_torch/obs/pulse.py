"""The live telemetry plane: metrics endpoint and triggers (port of
``t2omca_tpu/obs/pulse.py``).

* :class:`MetricsHub` — a thread-safe in-memory metric store: gauges,
  counters (both optionally labeled), bounded sliding-sample windows
  for quantile gauges (``<name>_p50``/``_p99`` at scrape time), live
  *probes* (callables evaluated per scrape — the watchdog heartbeat
  reads come from here, so the endpoint shows the armed phase WHILE
  the main thread is wedged inside it), and health checks that drive
  ``/healthz``.
* :class:`PulseServer` — a stdlib-only ``ThreadingHTTPServer``
  (config ``obs.pulse_port``, default 0 = no socket, the driver
  unchanged) with three routes: Prometheus-text ``GET /metrics``,
  JSON ``GET /healthz`` (HTTP 200 ok / 503 degraded), and
  ``GET|POST /trace`` arming the on-demand trace capture below.
* :class:`TraceController` — on-demand capture on a LIVE run: a
  ``<run_dir>/PULSE_TRACE`` file (touch it from any shell) or the
  ``/trace`` endpoint arms one bounded ``utils.profiling.TraceWindow``
  at the next iteration boundary; the capture lands in
  ``<run_dir>/pulse_trace_<n>_t<t_env>/trace_<t_env>.json``.

The hub, the server and the handle are the JAX module's code: the
Prometheus text and the ``/healthz`` body are byte-identical for the
same calls. Where the port differs: a capture is a ``torch.profiler``
Chrome trace (CPU activity, and CUDA activity on a card) taken by the
port's ``obs/device_time.ProgramTraceWindow``, which refreshes
``<run_dir>/device_times.json`` as JAX's captures do; the driver labels
``backend_info`` with the torch device type (``cuda``, ``cpu``).

Stdlib-only at import; the trace controller imports torch's profiler
only when a window starts. Wiring lives in ``run.run_sequential``, each
piece behind a ``pulse is not None`` / ``trc is not None`` gate, so the
off state is unchanged.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from .spans import NULL_RECORDER

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

#: metric-name prefix on the rendered endpoint (Prometheus convention:
#: one namespace per exporter)
PREFIX = "t2omca_"


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _render_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_sanitize(k)}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class MetricsHub:
    """Thread-safe metric store behind the endpoint. All writers are
    hot-path-adjacent (driver cadences, serve requests), so every
    operation is one uncontended lock acquire plus a dict/deque touch;
    rendering and probe evaluation happen on the scrape thread."""

    def __init__(self, window: int = 512) -> None:
        self.window = max(int(window), 16)
        self._lock = threading.Lock()
        # (name, ((k, v), ...)) -> float
        self._gauges: Dict[Tuple[str, tuple], float] = {}
        self._counters: Dict[Tuple[str, tuple], float] = {}
        self._windows: Dict[str, deque] = {}
        # probes: fn() -> iterable of (name, labels_dict, value); read
        # per scrape so the endpoint reports live state (watchdog
        # heartbeat age) even while every writer thread is wedged
        self._probes: List[Callable[[], Any]] = []
        self._health: Dict[str, Callable[[], Tuple[bool, str]]] = {}
        self._trace_req = threading.Event()
        self._beat = time.monotonic()

    # -- writers ---------------------------------------------------------

    @staticmethod
    def _key(name: str, labels: Dict[str, Any]) -> Tuple[str, tuple]:
        return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    def set(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = float(value)

    def inc(self, name: str, delta: float = 1.0, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(delta)

    def observe(self, name: str, value: float) -> None:
        """One sample into the bounded sliding window behind the
        ``<name>_p50``/``_p99``/``_count`` quantile gauges."""
        with self._lock:
            w = self._windows.get(name)
            if w is None:
                w = self._windows[name] = deque(maxlen=self.window)
            w.append(float(value))

    def beat(self) -> None:
        """Liveness heartbeat from a writer loop (the driver beats once
        per iteration; ``beat_age_seconds`` on the endpoint then reads
        as 'how long since the loop last moved')."""
        with self._lock:
            self._beat = time.monotonic()

    # -- probes / health -------------------------------------------------

    def probe(self, fn: Callable[[], Any]) -> None:
        """Register a scrape-time metric source: ``fn()`` returns an
        iterable of ``(name, labels_dict, value)`` rows (or None).
        Exceptions are swallowed per probe — telemetry must never take
        the endpoint down."""
        with self._lock:
            self._probes.append(fn)

    def health(self, name: str,
               fn: Callable[[], Tuple[bool, str]]) -> None:
        """Register one ``/healthz`` check: ``fn() -> (ok, detail)``."""
        with self._lock:
            self._health[name] = fn

    # -- trace trigger ---------------------------------------------------

    def request_trace(self) -> None:
        self._trace_req.set()

    def take_trace_request(self) -> bool:
        """Consume a pending ``/trace`` request (one window per arm)."""
        if self._trace_req.is_set():
            self._trace_req.clear()
            return True
        return False

    # -- scrape-side reads -----------------------------------------------

    def _probe_rows(self) -> List[Tuple[str, dict, float]]:
        with self._lock:
            probes = list(self._probes)
        rows: List[Tuple[str, dict, float]] = []
        for fn in probes:
            try:
                for name, labels, value in (fn() or ()):
                    rows.append((str(name), dict(labels), float(value)))
            except Exception:  # noqa: BLE001 — scrape must not crash
                continue
        return rows

    def render_prometheus(self) -> str:
        """The ``/metrics`` body: gauges + counters + quantile gauges
        from the windows + live probe rows, ``t2omca_``-prefixed and
        name-sanitized. Samples are grouped per metric FAMILY with
        exactly one ``# TYPE`` line each — the text-format parser
        rejects a second TYPE line for the same name, which would fail
        the whole scrape the first time a metric carries two label sets
        (two devices, actor+learner watchdog sides, two buckets)."""
        with self._lock:
            gauges = dict(self._gauges)
            counters = dict(self._counters)
            windows = {k: list(v) for k, v in self._windows.items()}
            beat_age = time.monotonic() - self._beat
        # family name -> (kind, [(labels_tuple, value), ...])
        families: Dict[str, Tuple[str, list]] = {}

        def add(name: str, labels, value, kind: str = "gauge") -> None:
            fam = families.setdefault(_sanitize(name), (kind, []))
            fam[1].append((labels, value))

        for (name, labels), v in gauges.items():
            add(name, labels, v)
        for (name, labels), v in counters.items():
            add(name, labels, v, kind="counter")
        for name, samples in windows.items():
            if not samples:
                continue
            s = sorted(samples)
            add(f"{name}_p50", (), s[len(s) // 2])
            add(f"{name}_p99", (), s[min(len(s) - 1,
                                         int(len(s) * 0.99))])
            add(f"{name}_count", (), float(len(s)))
        for name, labels, value in self._probe_rows():
            add(name, tuple(sorted((k, str(v))
                            for k, v in labels.items())), value)
        add("beat_age_seconds", (), beat_age)
        lines: List[str] = []
        for fam in sorted(families):
            kind, rows = families[fam]
            full = PREFIX + fam
            lines.append(f"# TYPE {full} {kind}")
            for labels, value in sorted(rows):
                lines.append(f"{full}{_render_labels(labels)} {value:g}")
        return "\n".join(lines) + "\n"

    def healthz(self) -> Tuple[bool, dict]:
        """→ ``(ok, payload)`` for ``/healthz``: every registered check
        evaluated now; a check that RAISES reports degraded with the
        error (a dead check must read as trouble, not as green)."""
        with self._lock:
            checks = dict(self._health)
            beat_age = time.monotonic() - self._beat
        results: Dict[str, dict] = {}
        ok = True
        for name, fn in sorted(checks.items()):
            try:
                c_ok, detail = fn()
            except Exception as e:  # noqa: BLE001 — degraded, not down
                c_ok, detail = False, f"check failed: {type(e).__name__}: {e}"
            ok = ok and bool(c_ok)
            results[name] = {"ok": bool(c_ok), "detail": str(detail)}
        return ok, {"status": "ok" if ok else "degraded",
                    "beat_age_s": round(beat_age, 3),
                    "checks": results}


def _watched(phase, rec, **meta):
    """One spanned endpoint boundary (every literal phase here is in
    ``obs/spans.KNOWN_PHASES``)."""
    return rec.span(phase, **meta)


class _PulseHandler(BaseHTTPRequestHandler):
    server_version = "graftpulse/1"
    protocol_version = "HTTP/1.1"

    # silence the default per-request stderr line — the scrape cadence
    # would spam the training console
    def log_message(self, fmt, *args):  # noqa: D102 — stdlib override
        pass

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _route(self) -> None:
        hub: MetricsHub = self.server.hub          # type: ignore[attr-defined]
        rec = self.server.rec                      # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            # _ring=False: a 5 s scrape cadence must not evict the
            # pre-stall phase history from the bounded flight ring
            with _watched("pulse.scrape", rec, endpoint="/metrics",
                          _ring=False):
                self._reply(200, hub.render_prometheus(),
                            "text/plain; version=0.0.4")
        elif path == "/healthz":
            with _watched("pulse.scrape", rec, endpoint="/healthz",
                          _ring=False):
                ok, payload = hub.healthz()
                self._reply(200 if ok else 503, json.dumps(payload),
                            "application/json")
        elif path == "/trace":
            if not getattr(self.server, "trace_supported", True):
                # no TraceController behind this endpoint: acking
                # would leave the caller waiting
                # on a capture that can never happen
                self._reply(501, json.dumps(
                    {"armed": False,
                     "error": "no trace consumer on this endpoint"}),
                    "application/json")
                return
            with _watched("trace.trigger", rec, source="endpoint"):
                hub.request_trace()
                self._reply(200, json.dumps({"armed": True}),
                            "application/json")
        else:
            self._reply(404, json.dumps(
                {"error": f"unknown path {path!r}",
                 "routes": ["/metrics", "/healthz", "/trace"]}),
                "application/json")

    def do_GET(self) -> None:           # noqa: N802 — stdlib naming
        try:
            self._route()
        except (BrokenPipeError, ConnectionResetError):
            pass                        # scraper went away mid-reply

    do_POST = do_GET                    # /trace accepts both verbs


class PulseServer:
    """The endpoint: a daemon-threaded stdlib HTTP server over one
    :class:`MetricsHub`. ``port=0`` binds an ephemeral port (tests);
    the config layer only constructs a server for ``pulse_port > 0``.
    ``close()`` is idempotent and bounded — shutting the plane down
    must never hang the run's exit path."""

    def __init__(self, hub: MetricsHub, port: int,
                 host: str = "127.0.0.1", rec=NULL_RECORDER,
                 trace_supported: bool = True) -> None:
        self.hub = hub
        self._srv = ThreadingHTTPServer((host, port), _PulseHandler)
        self._srv.daemon_threads = True
        self._srv.hub = hub             # type: ignore[attr-defined]
        self._srv.rec = rec             # type: ignore[attr-defined]
        # False = no TraceController consumes this hub's trace
        # requests: /trace then reports 501 instead of acking
        self._srv.trace_supported = trace_supported  # type: ignore[attr-defined]
        self.port = self._srv.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PulseServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        kwargs={"poll_interval": 0.2},
                                        daemon=True, name="t2omca-pulse")
        self._thread.start()
        return self

    def close(self) -> None:
        try:
            if self._thread is not None:
                # shutdown() handshakes with the serve_forever loop —
                # calling it on a constructed-but-never-started server
                # would block forever on an event only that loop sets
                self._srv.shutdown()
            self._srv.server_close()
        except Exception:  # noqa: BLE001 — exit path stays orderly
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class PulseHandle:
    """What the driver holds: the hub, the server, and the wiring
    helpers. Every method is a no-op-safe single call so the driver's
    hot loop stays one ``if pulse is not None`` away from byte-
    identical."""

    def __init__(self, hub: MetricsHub, server: PulseServer) -> None:
        self.hub = hub
        self.server = server
        self._t0 = time.monotonic()
        self._start_t_env: Optional[int] = None

    # -- writers (driver cadences) --------------------------------------

    def set(self, name: str, value, **labels) -> None:
        self.hub.set(name, value, **labels)

    def tick_iteration(self, t_env: int, episode: int) -> None:
        """Once per driver iteration: liveness beat + the cheap
        cumulative-rate gauges, so ``/metrics`` answers before the
        first log cadence ever fires."""
        self.hub.beat()
        if self._start_t_env is None:
            self._start_t_env = int(t_env)
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        self.hub.set("t_env", t_env)
        self.hub.set("episode", episode)
        self.hub.set("env_steps_per_sec_avg",
                     (int(t_env) - self._start_t_env) / elapsed)

    def set_memwatch(self, snap: Optional[dict]) -> None:
        """Per-device HBM gauges from one memwatch snapshot."""
        if not snap:
            return
        for dev, s in snap.items():
            self.hub.set("hbm_bytes_in_use", s.get("bytes_in_use", 0),
                         device=dev)
            self.hub.set("hbm_peak_bytes", s.get("peak_bytes_in_use", 0),
                         device=dev)

    # -- wiring ----------------------------------------------------------

    def wire_watchdog(self, wd, side: str = "main") -> None:
        """Live watchdog gauges + a health check: the armed phase and
        its in-flight seconds are read PER SCRAPE from the watchdog's
        own lock-bounded snapshot — visible while the main thread is
        wedged inside the armed call (the read this plane exists for).
        ``/healthz`` degrades the moment a stall fires."""
        def rows():
            hb = wd.heartbeat()
            out = [("watchdog_heartbeat_age_seconds", {"side": side},
                    hb["beat_age_s"]),
                   ("watchdog_stalls_total", {"side": side},
                    hb["stall_count"]),
                   ("watchdog_armed", {"side": side},
                    1.0 if hb["armed_phase"] else 0.0)]
            if hb["armed_phase"]:
                out.append(("watchdog_armed_seconds",
                            {"side": side, "phase": hb["armed_phase"]},
                            hb["armed_s"]))
            return out

        self.hub.probe(rows)
        self.hub.health(
            f"watchdog-{side}",
            lambda: (wd.stall_count == 0,
                     f"stalls={wd.stall_count} "
                     f"armed={wd.heartbeat()['armed_phase']}"))

    def wire_guard(self, guard) -> None:
        self.hub.health(
            "shutdown-guard",
            lambda: (not guard.triggered,
                     f"triggered={guard.triggered} "
                     f"signame={getattr(guard, 'signame', None)}"))

    def close(self) -> None:
        self.server.close()


def make_pulse(obs_cfg, rec=NULL_RECORDER, log=None) -> Optional[PulseHandle]:
    """The driver's constructor: None unless ``obs.pulse_port`` is set
    (the byte-identical off state). Bind failures degrade to a warning
    — a busy port must not take training down. The default bind is
    LOOPBACK: ``/trace`` is an unauthenticated state-changing route
    (it arms profiler captures on the live run), so exposing it beyond
    the host is an explicit ``obs.pulse_host: 0.0.0.0`` decision, not
    a default."""
    port = int(getattr(obs_cfg, "pulse_port", 0) or 0)
    if port <= 0:
        return None
    host = getattr(obs_cfg, "pulse_host", "") or "127.0.0.1"
    hub = MetricsHub(window=getattr(obs_cfg, "pulse_window", 512))
    try:
        server = PulseServer(hub, port, host=host, rec=rec).start()
    except OSError as e:
        if log is not None:
            log.warning(f"graftpulse: could not bind {host}:{port} "
                        f"({e}); metrics endpoint disabled for this run")
        return None
    if log is not None:
        log.info(f"graftpulse: metrics endpoint on {host}:{server.port} "
                 f"(/metrics, /healthz, /trace)")
    return PulseHandle(hub, server)


class TraceController:
    """On-demand trace capture on a live run. ``poll(t_env)`` (called
    once per driver iteration, one ``os.path.exists`` when idle) arms a
    bounded ``obs.device_time.ProgramTraceWindow`` (``torch.profiler``)
    when either trigger fires; ``tick`` drives the active window exactly
    like the static profiler window. Each capture lands in its own
    ``pulse_trace_<n>_t<t_env>`` directory as a Chrome trace and
    refreshes ``<run_dir>/device_times.json`` (the newest capture wins).
    A new trigger is accepted once the previous window closed."""

    #: hard bound on iterations per capture — a fat-fingered config
    #: must not leave the profiler running for the rest of the run
    MAX_ITERATIONS = 20

    def __init__(self, results_dir: str, rec=NULL_RECORDER,
                 hub: Optional[MetricsHub] = None, n_iterations: int = 3,
                 window_factory=None) -> None:
        self.results_dir = results_dir
        self.trigger_path = os.path.join(results_dir, "PULSE_TRACE")
        self._rec = rec
        self._hub = hub
        self.n_iterations = min(max(int(n_iterations), 1),
                                self.MAX_ITERATIONS)
        self._factory = window_factory
        self._win = None
        self.captures = 0

    def _make_window(self, trace_dir: str):
        if self._factory is not None:
            return self._factory(trace_dir, out_dir=self.results_dir,
                                 n_iterations=self.n_iterations)
        from .device_time import ProgramTraceWindow
        return ProgramTraceWindow(trace_dir, start_t_env=0,
                                  n_iterations=self.n_iterations,
                                  out_dir=self.results_dir)

    def poll(self, t_env: int) -> None:
        if self._win is not None:
            return
        source = None
        if self._hub is not None and self._hub.take_trace_request():
            source = "endpoint"
        elif os.path.exists(self.trigger_path):
            try:
                os.remove(self.trigger_path)    # consume the trigger
            except OSError:
                pass
            source = "file"
        if source is None:
            return
        self.captures += 1
        trace_dir = os.path.join(
            self.results_dir, f"pulse_trace_{self.captures:02d}_t{t_env}")
        with _watched("trace.trigger", self._rec, t_env=t_env,
                      source=source, capture=self.captures):
            try:
                win = self._make_window(trace_dir)
                win.maybe_start(t_env)
            except Exception:  # noqa: BLE001 — telemetry never kills a run
                return
        self._win = win
        if self._hub is not None:
            self._hub.set("trace_captures_total", self.captures)

    def tick(self, logger=None, t_env: int = 0) -> None:
        win = self._win
        if win is None:
            return
        try:
            win.tick(logger, t_env)
        except Exception:  # noqa: BLE001 — profiler stop must not crash
            self._win = None
            return
        if getattr(win, "_done", False):
            self._win = None            # window closed: accept new triggers
