"""Port parity of the serving fleet (``t2omca_tpu_torch/serve/fleet.py``)
and the front end's telemetry (``serve/frontend.py``).

* ``tests/test_fleet.py``'s 18 in-gate tests, ported: a real
  ``ServeFleet`` (threads, watchdogs, supervisor) over the same stub
  front end, injected through ``frontend_factory``;
* a cross-check: one scripted scenario set through JAX's ``ServeFleet``
  and the port's with one stub — the ladder's rungs and moves over a
  fixed fill series, shed counts with every engine paused, and the
  refresh statuses — equal exactly;
* a real front end on the CPU: a 2-engine fleet over a tiny port
  artifact (``use_qslice=false``, ``pallas``: K1's plain version)
  serves bit for bit what one ``ServeFrontend`` serves, and what JAX's
  front end serves on the same flax params at ``test_torch_serve.py``'s
  tolerances (actions equal, hiddens within 1e-5);
* refresh on that artifact: ok (the actions change to the new
  checkpoint's), refused (another width), rolled back (a
  ``fleet.selfcheck`` fault), busy; the ``serve refresh`` CLI's 0 and 2;
* the front end's hub series and span sequence against JAX's for the
  same requests (latency values excepted).

Every wait is a bounded poll (``_until``) or a bounded ``wait``.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from t2omca_tpu import config as jax_config
from t2omca_tpu.controllers.basic_mac import BasicMAC as JaxMAC
from t2omca_tpu.envs.registry import make_env as jax_make_env
from t2omca_tpu.obs.pulse import MetricsHub as JaxHub
from t2omca_tpu.obs.spans import NULL_RECORDER as JAX_NULL
from t2omca_tpu.obs.spans import SpanRecorder as JaxRecorder
from t2omca_tpu.serve import fleet as jax_fleet
from t2omca_tpu.serve.frontend import ServeFrontend as JaxFrontend
from t2omca_tpu.utils import resilience as jax_resilience
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.convert import agent_state_from_flax
from t2omca_tpu_torch.obs.pulse import MetricsHub
from t2omca_tpu_torch.obs.spans import KNOWN_PHASES, SpanRecorder
from t2omca_tpu_torch.serve import __main__ as serve_cli
from t2omca_tpu_torch.serve import fleet as port_fleet
from t2omca_tpu_torch.serve.export import export_artifact
from t2omca_tpu_torch.serve.fleet import (REFRESH_TRIGGER, FleetConfig,
                                          FleetLadder, RefreshRefused,
                                          ServeFleet, check_refresh)
from t2omca_tpu_torch.serve.frontend import ServeFrontend, SessionStore
from t2omca_tpu_torch.utils import resilience
from t2omca_tpu_torch.utils.checkpoint import flatten_state, save_checkpoint

REPO = os.path.join(os.path.dirname(__file__), "..")

A, D, NA, EMB = 2, 3, 4, 2      # stub model surface


@pytest.fixture(autouse=True)
def _no_fault_leaks():
    resilience.clear_faults()
    jax_resilience.clear_faults()
    yield
    resilience.clear_faults()
    jax_resilience.clear_faults()


# ---------------------------------------------------------------------------
# stub engines (no model, no artifact)
# ---------------------------------------------------------------------------


class _StubFrontend:
    """Duck-typed front end: instant selects, params-observable actions
    (``actions == int(params['w']) % n_actions``), dispatch batch sizes
    recorded. ``params`` is the port's attribute, ``_params`` JAX's: one
    stub drives both fleets."""

    def __init__(self, dtype="float32", buckets=(1, 2, 4)):
        self.dtype = dtype
        self.buckets = list(buckets)
        self.n_agents, self.obs_dim = A, D
        self.n_actions, self.emb = NA, EMB
        self.params = {"w": np.float32(1.0)}
        self.sizes = []                     # per-dispatch batch sizes
        self.calls = 0

    @property
    def _params(self):
        return self.params

    @_params.setter
    def _params(self, v):
        self.params = v

    def select(self, obs, avail, hidden=None):
        self.calls += 1
        n = np.asarray(obs).shape[0]
        self.sizes.append(n)
        if hidden is None:
            hidden = np.zeros((n, self.n_agents, self.emb), np.float32)
        act = int(np.asarray(self.params["w"])) % self.n_actions
        return (np.full((n, self.n_agents), act, np.int32),
                np.asarray(hidden, np.float32) + 1.0)

    def warmup(self):
        pass


def _cfg(mod=port_fleet, **kw):
    base = dict(poll_s=0.005, deadline_s=3.0, dispatch_timeout_s=0.6,
                request_retries=1, retry_backoff_s=0.005,
                restart_backoff_s=0.02, restart_backoff_max_s=0.1,
                hedge_min_s=0.02, ladder_cooldown_s=0.05)
    base.update(kw)
    return mod.FleetConfig(**base)


def _mk_fleet(n=2, cfg=None, factory=None, hub=None, artifact_dir=None,
              meta=None, mod=port_fleet):
    fleet = mod.ServeFleet(artifact_dir, n_engines=n, cfg=cfg or _cfg(mod),
                           hub=hub,
                           frontend_factory=factory
                           or (lambda dtype: _StubFrontend(dtype)))
    if meta is not None:
        fleet.meta = meta
    return fleet


def _req(n=2):
    return (np.zeros((n, A, D), np.float32), np.ones((n, A, NA), np.bool_))


def _until(pred, timeout=5.0, poll=0.005):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(poll)
    return False


# ---------------------------------------------------------------------------
# fleet phases are registered serving boundaries
# ---------------------------------------------------------------------------


def test_fleet_phases_registered():
    from test_obs import _literal_phases
    base = os.path.join(REPO, "t2omca_tpu_torch", "serve")
    phases = _literal_phases(os.path.join(base, "fleet.py"),
                             fn_names=("_watched",))
    assert {"fleet.load", "fleet.dispatch", "fleet.selfcheck",
            "fleet.restart", "fleet.refresh"} <= phases
    assert phases <= KNOWN_PHASES, phases - KNOWN_PHASES
    assert "bench.chaos" in KNOWN_PHASES
    front = _literal_phases(os.path.join(base, "frontend.py"),
                            fn_names=("_watched",))
    assert front == {"serve.load", "serve.pad", "serve.dispatch",
                     "serve.unpad"}


# ---------------------------------------------------------------------------
# the pressure ladder (unit)
# ---------------------------------------------------------------------------


def test_fleet_ladder_rungs_and_hysteresis():
    lad = FleetLadder([1, 2, 4], "float32", "bfloat16",
                      high=0.75, low=0.25, cooldown_s=0.0,
                      max_bucket_steps=2)
    assert lad.rungs == [(None, "float32"), (2, "float32"),
                         (1, "float32"), (1, "bfloat16")]
    assert lad.current() == (None, "float32")
    for want in ((2, "float32"), (1, "float32"), (1, "bfloat16")):
        assert lad.update(0.9, time.monotonic()) == "degrade"
        assert lad.current() == want
    assert lad.update(1.0, time.monotonic()) is None     # floor
    assert lad.update(0.5, time.monotonic()) is None     # hysteresis band
    for _ in range(3):
        assert lad.update(0.1, time.monotonic()) == "restore"
    assert lad.current() == (None, "float32")
    assert lad.update(0.0, time.monotonic()) is None     # ceiling
    assert lad.degrades == 3 and lad.restores == 3
    lad2 = FleetLadder([1, 2], "float32", None, 0.75, 0.25,
                       cooldown_s=100.0)
    assert lad2.rungs[-1] == (1, "float32")      # no alt → no dtype rung
    assert lad2.update(1.0, now=0.0) == "degrade"
    assert lad2.update(1.0, now=1.0) is None


# ---------------------------------------------------------------------------
# admission, deadlines, retries (stub engines)
# ---------------------------------------------------------------------------


def test_fleet_select_ok_and_hidden_carry():
    with _mk_fleet(n=2) as fleet:
        assert fleet.serving_engines() == 2
        r = fleet.select(*_req(3))
        assert r.ok and r.status == "ok"
        assert r.actions.shape == (3, A) and (r.actions == 1).all()
        assert r.hidden.shape == (3, A, EMB)
        r2 = fleet.select(*_req(3), hidden=r.hidden)
        assert (r2.hidden == r.hidden + 1.0).all()
        st = fleet.stats()
        assert st["serving"] == 2
        assert st["fleet_requests_total"] == 2


def test_fleet_sheds_past_queue_bound_never_blocks():
    with _mk_fleet(n=2, cfg=_cfg(queue_depth=2)) as fleet:
        for e in fleet.engines:
            e.pause_ev.set()
        admitted = [fleet.submit(*_req()) for _ in range(2)]
        t0 = time.monotonic()
        shed = fleet.submit(*_req())
        assert time.monotonic() - t0 < 0.5       # shed is immediate
        assert shed.done
        assert shed.result.status == "shed"
        assert "queue full" in shed.result.error
        for e in fleet.engines:
            e.pause_ev.clear()
        assert all(r.wait(5.0).ok for r in admitted)
        assert fleet.stats()["fleet_shed_total"] == 1


def test_fleet_deadline_resolves_even_with_all_engines_paused():
    with _mk_fleet(n=1) as fleet:
        fleet.engines[0].pause_ev.set()            # nothing will dispatch
        t0 = time.monotonic()
        r = fleet.select(*_req(), deadline_s=0.3)
        assert r.status == "deadline"
        assert time.monotonic() - t0 < 2.0       # bounded, not hung
        assert fleet.stats()["fleet_deadline_total"] >= 1


def test_fleet_transient_fault_retried_in_place():
    attempts = []

    def flaky(engine, attempt, rid, **kw):
        attempts.append((rid, attempt))
        if attempt == 1:
            raise RuntimeError("chaos: connection reset by peer")

    resilience.register_fault("fleet.dispatch", flaky)
    with _mk_fleet(n=1) as fleet:
        r = fleet.select(*_req())
        assert r.ok                              # retried on the same engine
        st = fleet.stats()
        assert st.get("fleet_restarts_total", 0) == 0   # no quarantine
        assert fleet.engines[0].restarts == 0
    rids = {rid for rid, _ in attempts}
    assert any((rid, 1) in attempts and (rid, 2) in attempts
               for rid in rids)


def test_fleet_crash_quarantines_bounces_and_rejoins():
    killed = []

    def killer(engine, attempt, rid, **kw):
        if engine == 0 and not killed:
            killed.append(rid)
            raise RuntimeError("chaos: engine killed (injected)")

    resilience.register_fault("fleet.dispatch", killer)
    with _mk_fleet(n=2) as fleet:
        fleet.engines[1].pause_ev.set()    # engine 0 must take the request
        r = fleet.select(*_req(), deadline_s=5.0)
        assert r.ok and r.engine == 0
        assert killed
        assert _until(lambda: fleet.engines[0].state == "serving")
        assert fleet.engines[0].restarts == 1
        assert fleet.recoveries                 # quarantine→rejoin timed
        st = fleet.stats()
        assert st["fleet_engine_failures_total"] == 1
        assert st["fleet_restarts_total"] == 1


def test_fleet_stall_is_hedged_and_stalled_engine_restarts():
    hung = []

    def hanger(engine, attempt, rid, **kw):
        if engine == 0 and not hung:
            hung.append(rid)
            time.sleep(1.2)                     # >> dispatch_timeout_s

    resilience.register_fault("fleet.dispatch", hanger)
    with _mk_fleet(n=2, cfg=_cfg(dispatch_timeout_s=0.3,
                                 deadline_s=5.0)) as fleet:
        fleet.engines[1].pause_ev.set()
        req = fleet.submit(*_req())
        assert _until(lambda: hung, timeout=2.0)
        fleet.engines[1].pause_ev.clear()          # the hedge target
        r = req.wait(6.0)
        assert r.ok and r.engine == 1
        assert r.hedged
        assert _until(lambda: fleet.stats().get("fleet_stalls_total",
                                                0) >= 1)
        assert fleet.stats()["fleet_hedges_total"] >= 1
        assert _until(lambda: fleet.engines[0].state == "serving"
                      and fleet.engines[0].restarts == 1)


def test_fleet_bounce_cap_resolves_error_not_hang():
    def always_fail(engine, attempt, rid, **kw):
        raise RuntimeError("chaos: engine killed (injected)")

    resilience.register_fault("fleet.dispatch", always_fail)
    with _mk_fleet(n=2, cfg=_cfg(max_bounces=2, deadline_s=6.0)) as fleet:
        r = fleet.select(*_req())
        assert r.status == "error"
        assert "failed on 3 engines" in r.error
        assert "chaos: engine killed" in r.error
        assert fleet.stats()["fleet_engine_failures_total"] == 3


def test_fleet_permanent_eject_after_restart_cap():
    def always_fail(engine, attempt, rid, **kw):
        raise RuntimeError("chaos: engine killed (injected)")

    resilience.register_fault("fleet.dispatch", always_fail)
    with _mk_fleet(n=1, cfg=_cfg(max_restarts=1, max_bounces=5,
                                 deadline_s=1.0)) as fleet:
        r = fleet.select(*_req())
        assert r.status in ("deadline", "error")
        assert _until(lambda: fleet.engines[0].state == "ejected")
        assert fleet.stats()["fleet_ejected_total"] == 1
        ok, detail = fleet._fleet_health()
        assert not ok and "0/1" in detail
        r2 = fleet.submit(*_req())
        assert r2.done and r2.result.status == "error"
        assert "all ejected" in r2.result.error


def test_fleet_ladder_caps_dispatch_and_falls_back_to_bf16():
    made = {}

    def factory(dtype):
        fe = _StubFrontend(dtype=dtype)
        made.setdefault(dtype, []).append(fe)
        return fe

    meta = {"buckets": [1, 2, 4],
            "params": {"float32": {}, "bfloat16": {}}}
    with _mk_fleet(n=1, factory=factory, meta=meta,
                   cfg=_cfg(ladder_cooldown_s=3600.0)) as fleet:
        lad = fleet._ladder
        # hold the rung set below: an empty queue would otherwise let the
        # supervisor restore it a poll later, racing the request
        lad._moved_at = time.monotonic()
        assert lad.rungs == [(None, "float32"), (2, "float32"),
                             (1, "float32"), (1, "bfloat16")]
        fe = made["float32"][0]
        fe.sizes.clear()                        # drop the selfcheck batch
        lad.level = 1                           # cap buckets at 2
        r = fleet.select(*_req(6))
        assert r.ok and r.actions.shape == (6, A)
        assert fe.sizes and max(fe.sizes) <= 2  # chunked under the cap
        lad.level = 3                           # bf16 rung, cap 1
        r = fleet.select(*_req(3))
        assert r.ok
        assert "bfloat16" in made               # alt variant lazily loaded
        alt = made["bfloat16"][0]
        assert alt.sizes and max(alt.sizes) <= 1


# ---------------------------------------------------------------------------
# hot refresh (fold check stubbed; the real fold is below)
# ---------------------------------------------------------------------------


def test_fleet_refresh_rolls_all_engines_and_swaps_params():
    with _mk_fleet(n=2) as fleet:
        new = {"w": np.float32(2.0)}
        fleet._fold_check = lambda ck: (new, {"t_env": 7,
                                              "leaves_checked": 0})
        out = fleet.refresh("ckpt")
        assert out["status"] == "ok"
        assert out["engines"] == 2 and out["t_env"] == 7
        assert all(e.fe.params is new for e in fleet.engines)
        assert fleet._live_params is new
        assert fleet.serving_engines() == 2
        r = fleet.select(*_req())
        assert r.ok and (r.actions == 2).all()  # traffic sees new params
        assert fleet.stats()["fleet_refresh_total"] == 1


def test_fleet_refresh_rolled_back_when_selfcheck_trips():
    def tripper(engine, stage, **kw):
        if stage == "refresh":
            raise RuntimeError("chaos: poisoned selfcheck (injected)")

    resilience.register_fault("fleet.selfcheck", tripper)
    with _mk_fleet(n=2) as fleet:
        old = [e.fe.params for e in fleet.engines]
        fleet._fold_check = lambda ck: ({"w": np.float32(3.0)},
                                        {"t_env": 9, "leaves_checked": 0})
        out = fleet.refresh("ckpt")
        assert out["status"] == "rolled_back"
        assert "poisoned selfcheck" in out["reason"]
        assert [e.fe.params for e in fleet.engines] == old
        assert fleet.serving_engines() == 2     # never stopped serving
        assert fleet.select(*_req()).ok
        assert fleet.stats()["fleet_refresh_rollback_total"] == 1


def test_fleet_refresh_refused_keeps_serving():
    with _mk_fleet(n=2) as fleet:
        old = [e.fe.params for e in fleet.engines]

        def refuse(ck):
            raise RefreshRefused("leaf drift")

        fleet._fold_check = refuse
        out = fleet.refresh("ckpt")
        assert out["status"] == "refused"
        assert "leaf drift" in out["reason"]
        assert [e.fe.params for e in fleet.engines] == old
        assert fleet.serving_engines() == 2
        assert fleet.select(*_req()).ok
        assert fleet.stats()["fleet_refresh_refused_total"] == 1


def test_fleet_refresh_aborts_below_n_minus_1_and_reports_busy():
    with _mk_fleet(n=2) as fleet:
        fleet._fold_check = lambda ck: ({"w": np.float32(4.0)},
                                        {"t_env": 1, "leaves_checked": 0})
        assert fleet._refresh_lock.acquire(blocking=False)
        try:
            assert fleet.refresh("ckpt") == {"status": "busy"}
        finally:
            fleet._refresh_lock.release()
        eng1 = fleet.engines[1]
        with eng1.lock:
            eng1.gen += 1                       # supersede its worker
            eng1.state = "quarantined"
            eng1.restart_at = time.monotonic() + 60.0
        old0 = fleet.engines[0].fe.params
        out = fleet.refresh("ckpt")
        assert out["status"] == "aborted"
        assert "N-1" in out["reason"]
        assert fleet.engines[0].fe.params is old0


def test_fleet_refresh_trigger_file_arms_refresh(tmp_path):
    meta = {"buckets": [1], "params": {"float32": {}}}
    with _mk_fleet(n=1, artifact_dir=str(tmp_path), meta=meta) as fleet:
        seen = []

        def fold(ck):
            seen.append(ck)
            return {"w": np.float32(3.0)}, {"t_env": 5,
                                            "leaves_checked": 0}

        fleet._fold_check = fold
        trig = tmp_path / REFRESH_TRIGGER
        trig.write_text(str(tmp_path / "ck") + "\n")
        assert _until(lambda: fleet.stats().get("fleet_refresh_total",
                                                0) == 1)
        assert not trig.exists()                # consumed, not re-armed
        assert seen == [str(tmp_path / "ck")]


# ---------------------------------------------------------------------------
# lifecycle + pulse wiring
# ---------------------------------------------------------------------------


def test_fleet_stop_resolves_everything_outstanding():
    fleet = _mk_fleet(n=2).start()
    for e in fleet.engines:
        e.pause_ev.set()
    reqs = [fleet.submit(*_req()) for _ in range(5)]
    fleet.stop()
    for req in reqs:
        r = req.wait(1.0)
        assert r.status == "error" and "shutdown" in r.error
    late = fleet.submit(*_req())
    assert late.done and late.result.status == "error"
    assert "stopped" in late.result.error
    fleet.stop()                                # idempotent


def test_fleet_health_on_pulse_hub():
    hub = MetricsHub()
    fleet = _mk_fleet(n=2, hub=hub).start()
    try:
        ok, payload = hub.healthz()
        checks = payload["checks"]
        assert checks["fleet"]["ok"]
        assert "2/2 engines serving" in checks["fleet"]["detail"]
        assert checks["fleet_engine0"]["ok"] and checks["fleet_engine1"]["ok"]
        assert _until(lambda: "t2omca_fleet_queue_depth"
                      in hub.render_prometheus())
        assert 't2omca_fleet_engine_state{engine="0"}' \
            in hub.render_prometheus()
        eng1 = fleet.engines[1]
        with eng1.lock:
            eng1.gen += 1
            eng1.state = "quarantined"
            eng1.last_error = "injected"
            eng1.restart_at = time.monotonic() + 60.0
        ok, payload = hub.healthz()
        assert not payload["checks"]["fleet_engine1"]["ok"]
        assert payload["checks"]["fleet"]["ok"]
    finally:
        fleet.stop()
    ok, payload = hub.healthz()
    assert not ok and not payload["checks"]["fleet"]["ok"]


# ---------------------------------------------------------------------------
# the cross-check: one scenario set through JAX's fleet and the port's
# ---------------------------------------------------------------------------


def _scenarios(mod):
    """Deterministic outcomes of one fleet module: the ladder's rungs and
    moves over a fixed fill series, shed counts with every engine paused,
    and the refresh statuses (ok, refused, rolled back, aborted, busy)."""
    out = {}
    lad = mod.FleetLadder([1, 2, 4, 8], "float32", "bfloat16", high=0.75,
                          low=0.25, cooldown_s=0.5, max_bucket_steps=2)
    fills = (0.1, 0.8, 0.9, 0.95, 1.0, 1.0, 0.5, 0.2, 0.1, 0.3, 0.0, 0.9)
    out["rungs"] = lad.rungs
    out["moves"] = [(lad.update(f, now=0.3 * i), lad.level)
                    for i, f in enumerate(fills)]
    out["ladder"] = (lad.degrades, lad.restores, lad.describe())
    fleet = _mk_fleet(n=2, cfg=_cfg(mod, queue_depth=3), mod=mod)
    for e in fleet.engines:
        e.pause_ev.set()                # paused before any worker polls
    with fleet:
        reqs = [fleet.submit(*_req()) for _ in range(7)]
        out["admission"] = [r.done and r.result.status for r in reqs]
        for e in fleet.engines:
            e.pause_ev.clear()
        out["served"] = [r.wait(5.0).status for r in reqs]
        st = fleet.stats()
        out["shed"] = (st.get("fleet_shed_total"),
                       st.get("fleet_requests_total"))
    statuses = []
    with _mk_fleet(n=2, mod=mod) as fleet:
        fleet._fold_check = lambda ck: ({"w": np.float32(2.0)}, {})
        statuses.append(fleet.refresh("a")["status"])

        def refuse(ck):
            raise mod.RefreshRefused("no")

        fleet._fold_check = refuse
        statuses.append(fleet.refresh("b")["status"])
        fleet._fold_check = lambda ck: ({"w": np.float32(3.0)}, {})

        def trip(engine, stage, **kw):
            if stage == "refresh" and engine == 1:
                raise RuntimeError("poisoned")

        res_mod = resilience if mod is port_fleet else jax_resilience
        res_mod.register_fault("fleet.selfcheck", trip)
        statuses.append(fleet.refresh("c")["status"])
        res_mod.clear_faults("fleet.selfcheck")
        statuses.append(fleet.select(*_req()).actions.tolist())
        assert fleet._refresh_lock.acquire(blocking=False)
        statuses.append(fleet.refresh("d")["status"])
        fleet._refresh_lock.release()
        eng1 = fleet.engines[1]
        with eng1.lock:
            eng1.gen += 1
            eng1.state = "quarantined"
            eng1.restart_at = time.monotonic() + 60.0
        statuses.append(fleet.refresh("e")["status"])
        statuses.append(sorted((k, v) for k, v in fleet.stats().items()
                               if k.startswith("fleet_refresh")))
    out["refresh"] = statuses
    return out


def test_fleet_cross_check_against_jax():
    got = _scenarios(port_fleet)
    want = _scenarios(jax_fleet)
    assert got == want
    assert got["refresh"][:3] == ["ok", "refused", "rolled_back"]
    assert got["refresh"][4:6] == ["busy", "aborted"]
    assert got["shed"] == (4, 7)


# ---------------------------------------------------------------------------
# a real front end on the CPU: a tiny port artifact
# ---------------------------------------------------------------------------

AGVS = 3


def _model_dict(emb=16):
    return {"env_args": {"agv_num": AGVS, "mec_num": 2, "num_channels": 2,
                         "episode_limit": 6},
            "model": {"emb": emb, "heads": 2, "depth": 2, "mixer_emb": emb,
                      "mixer_heads": 2, "use_qslice": False},
            "kernels": {"attention": "pallas"},
            "batch_size_run": 2, "batch_size": 4,
            "replay": {"buffer_size": 8}}


def _flax_agent(d, seed):
    jcfg = jax_config.from_dict(d)
    info = jax_make_env(jcfg.env_args).get_env_info()
    jmac = JaxMAC.build(jcfg, info)
    variables = jmac.init_params(jax.random.PRNGKey(seed), info["obs_shape"])
    return jmac, variables, info


def _checkpoint(root, d, seed, t_env):
    """A port checkpoint holding only the agent's leaves (what the export
    and the refresh read), from a flax init carried by ``convert.py``."""
    _, variables, _ = _flax_agent(d, seed)
    sd = agent_state_from_flax(jax.tree.map(np.asarray, variables),
                               device="cpu")
    ck = str(root)
    save_checkpoint(ck, t_env, {"learner": {"params": {"agent": sd}}})
    return ck, sd


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet_art")
    d = _model_dict()
    ck, sd = _checkpoint(root / "ck", d, 0, 128)
    ck2, sd2 = _checkpoint(root / "ck2", d, 1, 256)
    wide, _ = _checkpoint(root / "wide", _model_dict(emb=24), 2, 64)
    out = str(root / "art")
    export_artifact(from_dict(d), ck, out, buckets=(1, 2, 4),
                    device="cpu")
    return dict(d=d, ck=ck, sd=sd, ck2=ck2, sd2=sd2, wide=wide, art=out)


def _requests(rng, n, fe):
    obs = rng.standard_normal((n, fe.n_agents, fe.obs_dim)
                              ).astype(np.float32)
    avail = rng.random((n, fe.n_agents, fe.n_actions)) < 0.7
    avail[..., 0] = True
    return obs, avail


def _fleet(art, **kw):
    return ServeFleet(art["art"], n_engines=2, device="cpu",
                      cfg=FleetConfig(poll_s=0.005), **kw).start()


def test_fleet_real_frontend_equals_one_frontend_and_jax(art):
    one = ServeFrontend.load(art["art"], device="cpu")
    jmac, variables, _ = _flax_agent(art["d"], 0)
    jfe = JaxFrontend(None, {"buckets": [1, 2, 4], "n_agents": AGVS,
                             "obs_dim": one.obs_dim,
                             "n_actions": one.n_actions, "emb": one.emb},
                      jmac, jmac.prepare_acting_params(variables),
                      "float32", use_exported=False, rec=JAX_NULL)
    fleet = _fleet(art)
    try:
        assert fleet.serving_engines() == 2
        assert all(e.stream is None for e in fleet.engines)   # the CPU
        rng = np.random.default_rng(5)
        hidden = None
        for n in (1, 3, 7):
            obs, avail = _requests(rng, n, one)
            r = fleet.select(obs, avail, hidden)
            assert r.ok, r.error
            a1, h1 = one.select(obs, avail, hidden)
            np.testing.assert_array_equal(r.actions, a1)
            np.testing.assert_array_equal(r.hidden, h1)
            aj, hj = jfe.select(obs, avail, hidden)
            np.testing.assert_array_equal(r.actions, aj)
            np.testing.assert_allclose(r.hidden, hj, rtol=1e-5, atol=1e-5)
            hidden = r.hidden if n == 3 else None
            if hidden is not None:
                hidden = np.concatenate([hidden] * 3)[:7]
    finally:
        fleet.stop()


def test_fleet_refresh_on_a_real_artifact(art, capsys):
    fleet = _fleet(art)
    try:
        fe = fleet.engines[0].fe
        rng = np.random.default_rng(9)
        obs, avail = _requests(rng, 4, fe)
        before = fleet.select(obs, avail)
        assert before.ok
        # ok: the actions become those of the new checkpoint's params
        out = fleet.refresh(art["ck2"])
        assert out["status"] == "ok", out
        assert out["engines"] == 2 and out["t_env"] == 256
        assert out["leaves_checked"] == len(flatten_state(fe.params)[0])
        want = ServeFrontend(from_dict(art["d"]), art["sd2"], (1, 2, 4),
                             device="cpu").select(obs, avail)
        for _ in range(4):                      # both engines take some
            after = fleet.select(obs, avail)
            assert after.ok
            np.testing.assert_array_equal(after.actions, want[0])
            np.testing.assert_array_equal(after.hidden, want[1])
        # refused: another width; serving goes on, on the new params
        bad = fleet.refresh(art["wide"])
        assert bad["status"] == "refused"
        assert "different MODEL" in bad["reason"]
        missing = fleet.refresh(os.path.join(art["art"], "_none"))
        assert missing["status"] == "refused"
        assert fleet.serving_engines() == 2
        np.testing.assert_array_equal(fleet.select(obs, avail).actions,
                                      want[0])
        # rolled back: a poisoned post-swap selfcheck
        resilience.register_fault(
            "fleet.selfcheck", lambda engine, stage, **kw: (_ for _ in ())
            .throw(RuntimeError("poisoned")) if stage == "refresh" else None)
        rb = fleet.refresh(art["ck"])
        resilience.clear_faults("fleet.selfcheck")
        assert rb["status"] == "rolled_back"
        np.testing.assert_array_equal(fleet.select(obs, avail).actions,
                                      want[0])
        # busy
        assert fleet._refresh_lock.acquire(blocking=False)
        try:
            assert fleet.refresh(art["ck"]) == {"status": "busy"}
        finally:
            fleet._refresh_lock.release()
        st = fleet.stats()
        assert (st["fleet_refresh_total"], st["fleet_refresh_refused_total"],
                st["fleet_refresh_rollback_total"]) == (1, 2, 1)
    finally:
        fleet.stop()
    # the dry run and its CLI: 0 compatible, 2 refused / not an artifact
    assert check_refresh(art["art"], art["ck2"], device="cpu")["status"] \
        == "compatible"
    assert serve_cli.main(["refresh", art["art"], art["ck2"],
                           "--device", "cpu"]) == 0
    assert "refresh compatible" in capsys.readouterr().out
    assert serve_cli.main(["refresh", art["art"], art["wide"],
                           "--device", "cpu"]) == 2
    assert "REFUSED" in capsys.readouterr().err
    assert serve_cli.main(["refresh", os.path.dirname(art["art"]),
                           art["ck"], "--device", "cpu"]) == 2
    assert "not a serve artifact" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# front end telemetry against JAX's
# ---------------------------------------------------------------------------


def _span_seq(path):
    with open(path) as f:
        evs = [json.loads(line) for line in f]
    keep = ("phase", "bucket", "n", "outcome")
    return [{k: e.get(k) for k in keep} for e in evs
            if e.get("event") == "span"]


def _prom(hub):
    """The hub's text without its clock-valued series (the latency window
    and the hub's own beat age)."""
    return [line for line in hub.render_prometheus().splitlines()
            if "serve_select_ms" not in line
            and "beat_age_seconds" not in line]


def test_frontend_telemetry_matches_jax(art, tmp_path):
    jmac, variables, _ = _flax_agent(art["d"], 0)
    fe_meta = ServeFrontend.load(art["art"], device="cpu")
    meta = {"buckets": [1, 2, 4], "n_agents": AGVS,
            "obs_dim": fe_meta.obs_dim, "n_actions": fe_meta.n_actions,
            "emb": fe_meta.emb}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    (tmp_path / "load").mkdir()
    jrec = JaxRecorder(jsonl_path=str(tmp_path / "jax" / "spans.jsonl"))
    prec = SpanRecorder(jsonl_path=str(tmp_path / "port" / "spans.jsonl"))
    jhub, phub = JaxHub(), MetricsHub()
    jfe = JaxFrontend(None, meta, jmac, jmac.prepare_acting_params(variables),
                      "float32", use_exported=False, rec=jrec, hub=jhub)
    pfe = ServeFrontend(from_dict(art["d"]), art["sd"], (1, 2, 4),
                        device="cpu", rec=prec, hub=phub)
    rng = np.random.default_rng(2)
    for n in (1, 3, 9):
        obs, avail = _requests(rng, n, pfe)
        jfe.select(obs, avail)
        pfe.select(obs, avail)
    jst = SessionStore(jfe, max_sessions=3)
    pst = SessionStore(pfe, max_sessions=3)
    for ids in (["a", "b"], ["c", "d"], ["a"]):
        obs, avail = _requests(rng, len(ids), pfe)
        jst.select(ids, obs, avail)
        pst.select(ids, obs, avail)
    assert pst.evicted == jst.evicted == 2
    jrec.close()
    prec.close()
    got = _span_seq(tmp_path / "port" / "spans.jsonl")
    assert got == _span_seq(tmp_path / "jax" / "spans.jsonl")
    assert [e["phase"] for e in got[:3]] == ["serve.pad", "serve.dispatch",
                                             "serve.unpad"]
    assert _prom(phub) == _prom(jhub)
    text = phub.render_prometheus()
    for name in ("serve_dispatches_total", "serve_rows_total",
                 "serve_requests_total", "serve_select_ms_p50",
                 "serve_sessions", "serve_session_lru_fill",
                 "serve_session_evicted"):
        assert f"t2omca_{name}" in text, name
    # the load span, with the warm-up dispatches outside the telemetry
    lrec = SpanRecorder(jsonl_path=str(tmp_path / "load" / "spans.jsonl"))
    lhub = MetricsHub()
    ServeFrontend.load(art["art"], device="cpu", rec=lrec, hub=lhub)
    lrec.close()
    assert [e["phase"] for e in _span_seq(tmp_path / "load" / "spans.jsonl")
            ] == ["serve.load"]
    assert "serve_requests_total" not in lhub.render_prometheus()
