"""Port parity of the live telemetry plane (``t2omca_tpu_torch.obs.
pulse``) against the JAX package's ``obs/pulse.py``, and the plane on a
running port driver (the port form of ``tests/test_pulse.py``'s live
acceptance cases).

* the hub's Prometheus text and ``/healthz`` body are byte-equal to
  JAX's for the same call sequence, but for the time-dependent rows
  (``beat_age_seconds``, ``beat_age_s``); so are the server's routes
  (status, content type and body);
* ``make_pulse``: off at port 0, a failed bind degrades to a warning;
* ``TraceController``: the file and endpoint triggers arm one
  ``torch.profiler`` window whose Chrome trace lands in
  ``pulse_trace_<n>_t<t_env>``;
* on a running port driver (CPU, the driver tests' tiny config):
  ``/metrics`` and ``/healthz`` answer with the watchdog, guard and
  detector checks, a chaos-injected hang flips ``/healthz`` to 503
  while the run is wedged, ``PULSE_TRACE`` captures a trace, and a
  second run in the same process binds the same port again.
"""

import glob
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from t2omca_tpu.obs import pulse as jpulse
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.obs import pulse
from t2omca_tpu_torch.obs.spans import KNOWN_PHASES
from t2omca_tpu_torch.run import run
from t2omca_tpu_torch.utils import resilience
from t2omca_tpu_torch.utils.logging import Logger

import test_torch_driver as drv


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timeless_text(text):
    return "\n".join(l for l in text.splitlines()
                     if "beat_age_seconds" not in l)


def _timeless_health(body):
    payload = json.loads(body) if isinstance(body, str) else dict(body)
    assert isinstance(payload.pop("beat_age_s"), float)
    return payload


def _fill(hub):
    """One call sequence: gauges (labeled and not), counters, windows,
    probes (one raising) and health checks (one raising, one failing)."""
    hub.set("env_steps_per_sec", 123.5)
    hub.set("hbm_bytes_in_use", 10, device="0")
    hub.set("hbm_bytes_in_use", 2 ** 40, device="1")
    hub.set("backend_info", 1, backend="cuda")
    hub.inc("serve_requests_total")
    hub.inc("serve_rows_total", 5, bucket=8)
    hub.inc("serve_rows_total", 2.5, bucket=8)
    for v in (1.0, 2.0, 3.0, 100.0, 1e-7):
        hub.observe("serve_select_ms", v)
    hub.probe(lambda: [("watchdog_armed_seconds",
                        {"side": "main", "phase": "dispatch.train"}, 2.5),
                       ("weird name-x", {"a b": 'q"'}, float("inf"))])
    hub.probe(lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    hub.health("watchdog-main", lambda: (True, "stalls=0 armed=None"))
    hub.health("sight-q_divergence", lambda: (False, "|q|=2e4"))
    hub.health("dead", lambda: (_ for _ in ()).throw(ValueError("x")))


def test_hub_text_and_health_equal_jax():
    jhub, hub = jpulse.MetricsHub(window=64), pulse.MetricsHub(window=64)
    for h in (jhub, hub):
        _fill(h)
    got, want = hub.render_prometheus(), jhub.render_prometheus()
    assert "t2omca_beat_age_seconds" in got
    assert _timeless_text(got) == _timeless_text(want)
    (ok, body), (jok, jbody) = hub.healthz(), jhub.healthz()
    assert ok is jok is False
    assert _timeless_health(body) == _timeless_health(jbody)
    assert json.dumps(_timeless_health(body)) == \
        json.dumps(_timeless_health(jbody))


def test_server_routes_equal_jax():
    servers = []
    try:
        for mod in (pulse, jpulse):
            for supported in (True, False):
                hub = mod.MetricsHub()
                _fill(hub)
                servers.append(mod.PulseServer(
                    hub, 0, trace_supported=supported).start())
        replies = []
        for srv in servers:
            base = f"http://127.0.0.1:{srv.port}"
            r = {p: _get(base + p) for p in ("/metrics", "/healthz",
                                             "/trace", "/nope?x=1")}
            code, ctype, body = r["/metrics"]
            r["/metrics"] = (code, ctype, _timeless_text(body))
            code, ctype, body = r["/healthz"]
            r["/healthz"] = (code, ctype, _timeless_health(body))
            replies.append(r)
        port_on, port_off, jax_on, jax_off = replies
        assert port_on == jax_on and port_off == jax_off
        assert port_on["/healthz"][0] == 503
        assert port_on["/trace"][:2] == (200, "application/json")
        assert port_off["/trace"][0] == 501
        assert port_on["/nope?x=1"][0] == 404
        # the trace request reached the hub once
        assert servers[0].hub.take_trace_request()
        assert not servers[0].hub.take_trace_request()
    finally:
        for srv in servers:
            srv.close()


class _Log:
    def __init__(self):
        self.lines = []

    def warning(self, msg):
        self.lines.append(("warning", msg))

    def info(self, msg):
        self.lines.append(("info", msg))


def test_make_pulse_off_and_failed_bind():
    from t2omca_tpu_torch.config import ObsConfig
    assert pulse.make_pulse(ObsConfig()) is None
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = s.getsockname()[1]
        log = _Log()
        assert pulse.make_pulse(ObsConfig(pulse_port=port), log=log) is None
        assert log.lines[0][0] == "warning"
        assert "could not bind" in log.lines[0][1]
    log = _Log()
    handle = pulse.make_pulse(ObsConfig(pulse_port=port), log=log)
    try:
        assert handle is not None and handle.server.port == port
        assert "metrics endpoint on 127.0.0.1" in log.lines[0][1]
        handle.tick_iteration(100, 3)
        handle.set_memwatch({"0": {"bytes_in_use": 7,
                                   "peak_bytes_in_use": 9}})
        code, _, text = _get(f"http://127.0.0.1:{port}/metrics")
        assert code == 200 and "t2omca_t_env 100" in text
        assert 't2omca_hbm_bytes_in_use{device="0"} 7' in text
        assert 't2omca_hbm_peak_bytes{device="0"} 9' in text
    finally:
        if handle is not None:
            handle.close()
    # closed: the port binds again
    handle = pulse.make_pulse(ObsConfig(pulse_port=port), log=_Log())
    assert handle is not None
    handle.close()


def test_trace_controller_file_and_endpoint_triggers(tmp_path):
    """Each trigger arms one torch.profiler window of ``n_iterations``
    ticks; its Chrome trace lands in ``pulse_trace_<n>_t<t_env>``."""
    import torch
    hub = pulse.MetricsHub()
    trc = pulse.TraceController(str(tmp_path), hub=hub, n_iterations=2)
    trc.poll(0)
    assert trc.captures == 0                       # idle: nothing armed
    open(tmp_path / "PULSE_TRACE", "w").close()
    trc.poll(12)
    assert not os.path.exists(tmp_path / "PULSE_TRACE")
    hub.request_trace()
    trc.poll(12)                  # a window is open: the request waits
    for t in (24, 36):
        torch.ones(8).sum()
        trc.tick(None, t)
    trc.poll(48)                  # now the endpoint request arms one
    for t in (60, 72):
        trc.tick(None, t)
    assert trc.captures == 2
    for n, t in ((1, 36), (2, 72)):
        (path,) = glob.glob(str(tmp_path / f"pulse_trace_0{n}_t*"
                                / f"trace_{t}.json"))
        with open(path) as f:
            assert "traceEvents" in json.load(f)
    assert "t2omca_trace_captures_total 2" in hub.render_prometheus()


# ------------------------------------------------------- a live driver

class _Poller(threading.Thread):
    """Scrapes /metrics and /healthz while a run goes on."""

    def __init__(self, port):
        super().__init__(daemon=True)
        self.base = f"http://127.0.0.1:{port}"
        self.stop = threading.Event()
        self.metrics, self.health = [], []

    def run(self):
        while not self.stop.is_set():
            for path, out in (("/metrics", self.metrics),
                              ("/healthz", self.health)):
                try:
                    out.append(_get(self.base + path, timeout=1))
                except OSError:
                    pass
            time.sleep(0.02)


def _cfg(path, port, **kw):
    obs = dict(enabled=True, flush_every=1, memwatch=True, pulse_port=port,
               sight=dict(enabled=True))
    obs.update(kw.pop("obs", {}))
    res = dict(dispatch_timeout=30.0, stall_grace_s=0.0)
    res.update(kw.pop("resilience", {}))
    return from_dict(drv.tiny(path, obs=obs, resilience=res, **kw))


def _run_polled(cfg, port):
    poller = _Poller(port)
    poller.start()
    try:
        return run(cfg, Logger(), device="cpu"), poller
    finally:
        poller.stop.set()
        poller.join(timeout=5)
        assert not poller.is_alive()


def _run_dir(root):
    (d,) = [p for p in glob.glob(os.path.join(str(root), "*"))
            if os.path.isdir(p) and os.path.basename(p) != "models"]
    return d


def test_live_scrape_during_a_port_run_and_the_port_binds_again(tmp_path):
    port = _free_port()
    for i in range(2):          # the second run binds the same port
        root = tmp_path / f"run{i}"
        _, poller = _run_polled(_cfg(root, port), port)
        assert poller.metrics, "the endpoint never answered"
        text = "\n".join(body for code, _, body in poller.metrics)
        for name in ("t2omca_t_env", "t2omca_env_steps_per_sec",
                     "t2omca_watchdog_heartbeat_age_seconds",
                     'backend_info{backend="cpu"}', "t2omca_superstep_k"):
            assert name in text, name
        checks = set()
        for code, _, body in poller.health:
            checks |= set(json.loads(body)["checks"])
        assert checks == {"watchdog-main", "shutdown-guard"} | {
            f"sight-{d}" for d in ("loss_plateau", "q_divergence",
                                   "priority_collapse",
                                   "attention_collapse", "grad_starvation")}
        assert any(code == 200 for code, _, _ in poller.health)
    with open(os.path.join(_run_dir(root), "spans.jsonl")) as f:
        phases = {e.get("phase") for e in map(json.loads, f)
                  if e["event"] == "span"}
    assert {"pulse.scrape", "memwatch.snapshot", "sight.detect"} <= phases
    assert phases <= KNOWN_PHASES, phases - KNOWN_PHASES


def test_healthz_degrades_on_an_injected_hang(tmp_path):
    resilience.clear_faults()
    port = _free_port()
    hung = []

    def _hang(t_env, **kw):
        if t_env >= 24 and not hung:
            hung.append(t_env)
            time.sleep(2.5)

    resilience.register_fault("dispatch.rollout", _hang)
    try:
        _, poller = _run_polled(
            _cfg(tmp_path, port, save_model=False,
                 resilience=dict(dispatch_timeout=0.75)), port)
    finally:
        resilience.clear_faults()
    assert hung == [24]
    degraded = [json.loads(b) for code, _, b in poller.health
                if code == 503]
    assert degraded, "/healthz never flipped to degraded during the hang"
    assert any(not chk["ok"] and "stalls=" in chk["detail"]
               for p in degraded for name, chk in p["checks"].items()
               if name == "watchdog-main")


def test_pulse_trace_file_on_a_running_port_driver(tmp_path):
    resilience.clear_faults()
    armed = []

    def _touch(t_env, **kw):
        if t_env >= 24 and not armed:
            open(os.path.join(_run_dir(tmp_path), "PULSE_TRACE"),
                 "w").close()
            armed.append(t_env)

    resilience.register_fault("driver.iteration", _touch)
    try:      # the plane off: the file trigger alone (spans arm it)
        run(_cfg(tmp_path, 0, profile_iterations=1), Logger(), device="cpu")
    finally:
        resilience.clear_faults()
    assert armed == [24]
    run_dir = _run_dir(tmp_path)
    (trace,) = glob.glob(os.path.join(run_dir, "pulse_trace_01_t24",
                                      "trace_*.json"))
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    assert not os.path.exists(os.path.join(run_dir, "PULSE_TRACE"))
    with open(os.path.join(run_dir, "spans.jsonl")) as f:
        assert any(e.get("phase") == "trace.trigger"
                   for e in map(json.loads, f))
