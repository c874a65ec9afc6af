"""Fault-tolerant multi-engine serving (port of
``t2omca_tpu/serve/fleet.py``).

One :class:`~.frontend.ServeFrontend` is one set of params on one card,
and a single wedged dispatch stalls every caller forever. The fleet is
the layer over it: N share-nothing engines behind one bounded admission
queue.

* **supervision** — each engine thread owns its own
  ``utils/watchdog.Watchdog`` (a shared one would let two engines'
  stamps overwrite each other), and engine health is the predicate the
  pulse ``/healthz`` endpoint serves (``MetricsHub.health``). A stalled
  or crashed engine is quarantined, its in-flight request hedged onto a
  healthy peer, and it is restarted from the artifact with exponential
  backoff (``backoff_delay``) up to a permanent-eject cap.
* **request-level resilience** — per-request deadlines enforced by the
  supervisor (a request completes, sheds or deadline-errors even with
  every engine wedged), bounded in-place retry of transient faults
  (``retry_call``/``is_transient``) and hedged dispatch after a
  p99-derived delay (the slow engine's request is duplicated onto a
  peer; first writer wins).
* **graceful degradation** — admission past the queue bound returns an
  explicit ``SHED`` result at once; before that, a pressure ladder
  (:class:`FleetLadder`) caps the dispatch bucket and then falls back
  from the f32 to the bf16 param variant.
* **hot param refresh** — :meth:`ServeFleet.refresh`: fold the new
  checkpoint off the request path, check it against the artifact (refuse
  and keep serving on any mismatch), then swap the engines one at a time,
  never fewer than N−1 serving, with a health check after each swap that
  rolls the whole refresh back if it trips. A ``FLEET_REFRESH`` file in
  the artifact directory (content: a checkpoint directory) arms the same
  path from outside the process.

What the card changes against the JAX fleet:

* **Each engine is a** ``ServeFrontend`` **of its own** (own params on the
  card, own watchdog) **on its own CUDA stream**: its load, warm-up,
  dispatches and self-checks run under ``torch.cuda.stream(eng.stream)``,
  so one engine's dispatch does not queue behind another's and a hedge
  can win. A dispatch ends in the front end's ``.cpu()``, which waits for
  that stream only. A restart builds a new front end on a new stream; a
  stale worker's late result is dropped by the generation counter.
* **The refresh check.** JAX refuses a checkpoint whose refolded
  per-bucket program fingerprint differs from the artifact's; the port's
  artifact holds no programs. :meth:`ServeFleet._fold_check` instead
  refolds the checkpoint's agent leaves with the artifact's own train
  config (``serve/export.load_acting_params``, which refuses a checkpoint
  of another model: leaf shapes against the config's), checks the
  checkpoint's replay against the artifact's agents and actions, casts
  the variant, and refuses unless its flat ``(path, shape, dtype)`` list
  equals the artifact variant's. Param values never cause a refusal; a
  different model always does. The swap assigns ``fe.params`` (JAX:
  ``fe._params``).
* An engine whose kernel fails to build or launch raises in its
  self-check or dispatch and is quarantined and counted as failed. There
  is no fallback to the plain version or to the CPU.

Telemetry: the ``fleet.load`` / ``fleet.dispatch`` / ``fleet.selfcheck``
/ ``fleet.restart`` / ``fleet.refresh`` spans (``obs/spans.KNOWN_PHASES``),
the hub's queue depth, ladder level, per-engine state and restarts and
the ``fleet_*_total`` counters, and the ``fleet`` and
``fleet_engine<i>`` ``/healthz`` checks. Chaos hooks
(``utils/resilience.register_fault``): ``fleet.dispatch``,
``fleet.selfcheck``, ``fleet.refresh``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import logging
import os
import threading
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs.spans import NULL_RECORDER
from ..utils import resilience
from ..utils.watchdog import (Watchdog, backoff_delay, is_transient,
                              retry_call)
from .frontend import ServeFrontend

logger = logging.getLogger(__name__)


def _watched(phase, rec, **meta):
    """One spanned fleet boundary (module-level like the driver's
    wrapper: every literal phase here is in ``KNOWN_PHASES``)."""
    return rec.span(phase, **meta)


# ---------------------------------------------------------------- statuses

#: request outcomes — every admitted request resolves to exactly one
OK = "ok"
SHED = "shed"            # admission control: queue past its bound
DEADLINE = "deadline"    # per-request deadline expired (queued or in flight)
ERROR = "error"          # non-transient failure after bounded bouncing

#: engine lifecycle states (gauge codes: ``fleet_engine_state``)
ENGINE_STATES = ("starting", "serving", "refreshing", "quarantined",
                 "restarting", "ejected", "stopped")
_STATE_CODE = {s: i for i, s in enumerate(ENGINE_STATES)}

#: drop a checkpoint path into ``<artifact>/FLEET_REFRESH`` and the
#: supervisor arms one rolling refresh from it
REFRESH_TRIGGER = "FLEET_REFRESH"


class RefreshRefused(RuntimeError):
    """A hot param refresh that must not be applied: a missing or
    mismatched checkpoint, a refolded variant whose leaves differ from
    the artifact's. The fleet keeps serving the old params."""


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet policy knobs (all host-side)."""

    queue_depth: int = 64            # admission bound → SHED past it
    deadline_s: float = 10.0         # default per-request deadline
    dispatch_timeout_s: float = 10.0  # per-engine watchdog (warm phases)
    first_dispatch_timeout_s: float = 0.0  # 0 = the first one unbounded
    request_retries: int = 1         # extra in-place tries on transient
    retry_backoff_s: float = 0.02
    max_bounces: int = 2             # cross-engine re-dispatches per request
    hedge_after_s: float = 0.0       # 0 = derive from the p99 window
    hedge_p99_mult: float = 4.0
    hedge_min_s: float = 0.05
    restart_backoff_s: float = 0.1   # engine restart: exponential backoff
    restart_backoff_max_s: float = 5.0
    max_restarts: int = 5            # permanent-eject cap per engine
    ladder_high: float = 0.75        # queue fill fraction → step down
    ladder_low: float = 0.25         # queue fill fraction → step back up
    ladder_cooldown_s: float = 0.5   # min dwell between ladder moves
    max_bucket_steps: int = 2        # bucket-cap rungs before dtype rung
    selfcheck_timeout_s: float = 0.0  # 0 = unbounded selfcheck
    poll_s: float = 0.02             # supervisor/worker poll cadence


@dataclasses.dataclass
class FleetResult:
    """One resolved request. ``status`` is always one of
    ``ok``/``shed``/``deadline``/``error``."""

    status: str
    actions: Optional[np.ndarray] = None
    hidden: Optional[np.ndarray] = None
    engine: Optional[int] = None
    error: Optional[str] = None
    hedged: bool = False
    latency_ms: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == OK


class FleetRequest:
    """One admitted request: first completion wins (hedged duplicates
    and late unwedged dispatches resolve against the same slot)."""

    __slots__ = ("rid", "obs", "avail", "hidden", "born", "deadline",
                 "hedges", "bounces", "_event", "_lock", "result")

    def __init__(self, rid: int, obs, avail, hidden,
                 deadline: float) -> None:
        self.rid = rid
        self.obs = obs
        self.avail = avail
        self.hidden = hidden
        self.born = time.monotonic()
        self.deadline = deadline        # absolute monotonic
        self.hedges = 0
        self.bounces = 0
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.result: Optional[FleetResult] = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def complete(self, result: FleetResult) -> bool:
        """First writer wins; → True iff this call resolved the request
        (losers' results are dropped — the hedging contract)."""
        with self._lock:
            if self.result is not None:
                return False
            result.latency_ms = round(
                (time.monotonic() - self.born) * 1000.0, 3)
            result.hedged = self.hedges > 0
            self.result = result
        self._event.set()
        return True

    def wait(self, timeout: Optional[float] = None) -> FleetResult:
        """Block until resolved; the supervisor's deadline sweep bounds
        the wait."""
        self._event.wait(timeout)
        with self._lock:
            if self.result is None:     # timeout raced resolution
                self.result = FleetResult(
                    ERROR, error="request unresolved at wait timeout")
                self._event.set()
            return self.result


class _AdmissionQueue:
    """Unbounded deque + condvar. The admission bound lives in
    :meth:`ServeFleet.submit`; hedges and bounced requests re-enter at
    the front past the bound, because they were admitted once."""

    def __init__(self) -> None:
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()

    def __len__(self) -> int:
        return len(self._dq)

    def put(self, req: FleetRequest, front: bool = False) -> None:
        with self._cv:
            if front:
                self._dq.appendleft(req)
            else:
                self._dq.append(req)
            self._cv.notify()

    def get(self, timeout: float) -> Optional[FleetRequest]:
        with self._cv:
            if not self._dq:
                self._cv.wait(timeout)
            return self._dq.popleft() if self._dq else None

    def drain(self) -> List[FleetRequest]:
        with self._cv:
            out = list(self._dq)
            self._dq.clear()
            return out


class FleetLadder:
    """Pressure ladder. Rung order under sustained queue pressure: cap
    the buckets (dispatch in smaller buckets) for up to
    ``max_bucket_steps`` rungs, then fall back from the primary to the
    alternative param dtype when the artifact ships one; past the last
    rung admission control sheds. High/low watermarks and a dwell keep
    one burst from thrashing the rungs; the counters are cumulative."""

    def __init__(self, buckets: Sequence[int], primary_dtype: str,
                 alt_dtype: Optional[str], high: float, low: float,
                 cooldown_s: float, max_bucket_steps: int = 2) -> None:
        bs = sorted(int(b) for b in buckets)
        rungs: List[Tuple[Optional[int], str]] = [(None, primary_dtype)]
        for cap in list(reversed(bs[:-1]))[:max(int(max_bucket_steps), 0)]:
            rungs.append((cap, primary_dtype))
        if alt_dtype and alt_dtype != primary_dtype:
            rungs.append((rungs[-1][0], alt_dtype))
        self.rungs = rungs
        self.high, self.low = float(high), float(low)
        self.cooldown_s = float(cooldown_s)
        self.level = 0
        self.degrades = 0
        self.restores = 0
        self._moved_at = -float("inf")

    def current(self) -> Tuple[Optional[int], str]:
        """→ ``(bucket_cap | None, dtype)`` for the active rung."""
        return self.rungs[self.level]

    def update(self, fill: float, now: float) -> Optional[str]:
        """Feed one queue-fill observation; → ``'degrade'``/``'restore'``
        when the level moved, else None."""
        if now - self._moved_at < self.cooldown_s:
            return None
        if fill >= self.high and self.level < len(self.rungs) - 1:
            self.level += 1
            self.degrades += 1
            self._moved_at = now
            return "degrade"
        if fill <= self.low and self.level > 0:
            self.level -= 1
            self.restores += 1
            self._moved_at = now
            return "restore"
        return None

    def describe(self) -> str:
        cap, dt = self.current()
        return (f"level={self.level}/{len(self.rungs) - 1} "
                f"cap={cap} dtype={dt} degrades={self.degrades} "
                f"restores={self.restores}")


class _Engine:
    """One supervised engine slot: its own front end(s), stream and
    watchdog, and a generation counter that supersedes wedged workers."""

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.state = "starting"
        self.gen = 0                    # bumped on every (re)start/stall
        self.restarts = 0
        self.thread: Optional[threading.Thread] = None
        self.fe: Optional[ServeFrontend] = None
        self.fe_alt: Dict[str, object] = {}   # dtype -> lazy alt front end
        self.stream = None              # the engine's CUDA stream (card)
        self.wd: Optional[Watchdog] = None
        self.lock = threading.Lock()
        self.current: Optional[Tuple[FleetRequest, float]] = None
        # Event, not a bare bool: set/cleared by the refresh thread,
        # polled by the worker
        self.pause_ev = threading.Event()
        self.idle = threading.Event()
        self.idle.set()
        self.restart_at = 0.0
        self.quarantined_at: Optional[float] = None
        self.last_error: Optional[str] = None

    def healthy(self) -> Tuple[bool, str]:
        """The health predicate, served on ``/healthz`` and read by the
        supervisor."""
        t = self.thread
        if self.state == "serving" and (t is None or not t.is_alive()):
            return False, "worker thread died"
        if self.state in ("serving", "refreshing"):
            return True, self.state
        return False, f"{self.state} ({self.last_error or 'no error'})"


def _artifact_leaves(artifact_dir: str, meta: dict, dtype: str
                    ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """The artifact's ``dtype`` variant as ``{path: (shape, dtype)}``,
    read memory-mapped from its param blob."""
    entry = meta.get("params", {}).get(dtype)
    if entry is None:
        raise RefreshRefused(
            f"artifact ships no {dtype!r} param variant (has: "
            f"{sorted(meta.get('params', {}))})")
    flat = torch.load(os.path.join(artifact_dir, entry["file"]),
                      map_location="cpu", weights_only=True, mmap=True)
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in flat.items()}


class ServeFleet:
    """N share-nothing engines + a supervisor behind one bounded
    admission queue. Construct, :meth:`start`, then :meth:`submit` /
    :meth:`select`; always :meth:`stop` (or use as a context manager).

    ``frontend_factory(dtype) -> frontend`` overrides artifact loading
    (tests inject stub engines); the default is ``ServeFrontend.load(
    artifact_dir, dtype=..., device=...)`` per engine, each with its own
    params. ``device`` None means ``cuda``."""

    def __init__(self, artifact_dir: Optional[str], n_engines: int = 2,
                 dtype: str = "float32",
                 cfg: Optional[FleetConfig] = None,
                 rec=NULL_RECORDER, hub=None,
                 frontend_factory: Optional[Callable] = None,
                 device: DeviceLike = None) -> None:
        if n_engines < 1:
            raise ValueError(f"n_engines must be >= 1, got {n_engines}")
        self.artifact_dir = artifact_dir
        self.n_engines = int(n_engines)
        self.dtype = dtype
        self.cfg = cfg or FleetConfig()
        self._rec = rec
        self._hub = hub
        self.device = device
        # resolved at start: the card unless named (a stub factory with
        # no device named needs none, and gets no streams)
        self._dev: Optional[torch.device] = None
        self._factory = frontend_factory or self._load_frontend
        self.meta: Optional[dict] = None
        self.engines = [_Engine(i) for i in range(self.n_engines)]
        self._q = _AdmissionQueue()
        self._rid = itertools.count()
        self._inflight: Dict[int, FleetRequest] = {}
        self._inflight_lock = threading.Lock()
        self._lat = collections.deque(maxlen=512)   # ok latencies (s)
        self._stop_ev = threading.Event()
        self._sup: Optional[threading.Thread] = None
        self._refresh_lock = threading.Lock()
        self._live_params = None        # post-refresh params
        self._ladder: Optional[FleetLadder] = None
        self.recoveries: List[float] = []   # quarantine→rejoin seconds
        self.counters = collections.Counter()   # shed/hedge/stall/...
        self._counters_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    def start(self, wait_s: float = 120.0) -> "ServeFleet":
        """Spawn the engines + supervisor; block until every engine
        finished its startup attempt (serving or quarantined), at most
        ``wait_s``."""
        if self.artifact_dir is not None and self.meta is None:
            with open(os.path.join(self.artifact_dir, "meta.json")) as f:
                self.meta = json.load(f)
        if self.device is not None or self._factory == self._load_frontend:
            self._dev = resolve_device(self.device)
        alt = None
        if self.meta is not None and self.dtype == "float32" \
                and "bfloat16" in self.meta.get("params", {}):
            alt = "bfloat16"
        buckets = (sorted(int(b) for b in self.meta["buckets"])
                   if self.meta is not None else [1])
        self._ladder = FleetLadder(
            buckets, self.dtype, alt, self.cfg.ladder_high,
            self.cfg.ladder_low, self.cfg.ladder_cooldown_s,
            self.cfg.max_bucket_steps)
        if self._hub is not None:
            for eng in self.engines:
                self._hub.health(f"fleet_engine{eng.idx}", eng.healthy)
            self._hub.health("fleet", self._fleet_health)
        for eng in self.engines:
            with eng.lock:              # _spawn_worker's contract
                self._spawn_worker(eng)
        self._sup = threading.Thread(target=self._supervise, daemon=True,
                                     name="t2omca-fleet-supervisor")
        self._sup.start()
        deadline = time.monotonic() + wait_s
        for eng in self.engines:
            while eng.state == "starting" and time.monotonic() < deadline:
                time.sleep(self.cfg.poll_s)
        return self

    def stop(self) -> None:
        """Resolve everything outstanding (status ``error``,
        ``shutdown``), stop the supervisor, workers and watchdogs.
        Wedged workers are daemon threads: they cannot block exit."""
        if self._stop_ev.is_set():
            return
        self._stop_ev.set()
        for req in self._q.drain():
            req.complete(FleetResult(ERROR, error="fleet shutdown"))
        with self._inflight_lock:
            pending = list(self._inflight.values())
            self._inflight.clear()
        for req in pending:
            req.complete(FleetResult(ERROR, error="fleet shutdown"))
        for eng in self.engines:
            eng.gen += 1                # supersede every worker
            self._set_state(eng, "stopped")
            wd = eng.wd
            if wd is not None:
                wd.stop()
        if self._sup is not None:
            self._sup.join(timeout=2.0)
        for eng in self.engines:
            t = eng.thread
            if t is not None:
                t.join(timeout=0.5)

    def __enter__(self) -> "ServeFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ admission

    def submit(self, obs, avail, hidden=None,
               deadline_s: Optional[float] = None) -> FleetRequest:
        """Admit one request (non-blocking). Past the queue bound the
        request resolves ``SHED`` at once."""
        obs = np.asarray(obs, np.float32)
        avail = np.asarray(avail)
        if hidden is not None:
            hidden = np.asarray(hidden, np.float32)
        ddl = time.monotonic() + float(deadline_s if deadline_s is not None
                                       else self.cfg.deadline_s)
        req = FleetRequest(next(self._rid), obs, avail, hidden, ddl)
        self._count("fleet_requests_total")
        if self._stop_ev.is_set():
            req.complete(FleetResult(ERROR, error="fleet stopped"))
            return req
        if all(e.state in ("ejected", "stopped") for e in self.engines):
            req.complete(FleetResult(
                ERROR, error="no engine can serve (all ejected)"))
            return req
        if len(self._q) >= self.cfg.queue_depth:
            self._count("fleet_shed_total")
            req.complete(FleetResult(SHED, error="admission queue full"))
            return req
        with self._inflight_lock:
            self._inflight[req.rid] = req
        self._q.put(req)
        return req

    def select(self, obs, avail, hidden=None,
               deadline_s: Optional[float] = None) -> FleetResult:
        """Synchronous request: submit + wait, bounded by the request
        deadline plus supervisor slack."""
        req = self.submit(obs, avail, hidden, deadline_s)
        slack = max(req.deadline - time.monotonic(), 0.0) \
            + 10.0 * self.cfg.poll_s + 1.0
        return req.wait(timeout=slack)

    # ------------------------------------------------------------- engines

    def _load_frontend(self, dtype: str):
        fe = ServeFrontend.load(self.artifact_dir, dtype=dtype,
                                device=self._dev, rec=self._rec,
                                hub=self._hub)
        live = self._live_params
        if live is not None and dtype == self.dtype:
            # a restart after a hot refresh comes back with the
            # refreshed params, not the artifact's
            fe.params = live
        return fe

    def _on_stream(self, stream):
        return torch.cuda.stream(stream) if stream is not None \
            else nullcontext()

    def _spawn_worker(self, eng: _Engine) -> None:
        """Caller holds ``eng.lock`` (start() and the supervisor both
        do): the gen bump is a read-modify-write racing the supervisor's
        stall path."""
        eng.gen += 1
        gen = eng.gen
        self._set_state(eng, "starting" if eng.restarts == 0
                        else "restarting")
        t = threading.Thread(target=self._worker, args=(eng, gen),
                             daemon=True,
                             name=f"t2omca-fleet-engine{eng.idx}")
        eng.thread = t
        t.start()

    def _new_stream(self):
        """A stream for a (re)started engine: none on the CPU; on the card
        one of torch's pooled streams (32 a device, handed out in turn)
        that no engine holds, so a restart never queues behind the stalled
        engine's work or a peer's (a fleet of more than 31 engines
        shares)."""
        if self._dev is None or self._dev.type != "cuda":
            return None
        held = [e.stream for e in self.engines if e.stream is not None]
        for _ in range(64):
            stream = torch.cuda.Stream(self._dev)
            if all(stream != h for h in held):
                break
        return stream

    def _worker(self, eng: _Engine, gen: int) -> None:
        stream = self._new_stream()
        with self._on_stream(stream):
            self._work(eng, gen, stream)

    def _work(self, eng: _Engine, gen: int, stream) -> None:
        cfg = self.cfg
        wd = None
        try:
            # two literal call sites, not one computed phase
            if eng.restarts == 0:
                with _watched("fleet.load", self._rec, engine=eng.idx,
                              gen=gen):
                    fe = self._factory(self.dtype)
            else:
                with _watched("fleet.restart", self._rec, engine=eng.idx,
                              gen=gen):
                    fe = self._factory(self.dtype)
            wd = Watchdog(
                timeout_s=cfg.dispatch_timeout_s,
                first_timeout_s=cfg.first_dispatch_timeout_s,
                grace_s=0.0,            # never hard-exit: quarantine+restart
                on_stall=lambda d, e=eng, g=gen: self._on_stall(e, g, d),
            ).start()
            with eng.lock:
                if eng.gen != gen:      # superseded during load
                    wd.stop()
                    return
                eng.fe = fe
                eng.fe_alt = {}
                eng.stream = stream
                eng.wd = wd
            self._selfcheck(eng, wd, fe, stage="start")
        except Exception as e:  # noqa: BLE001 — supervisor handles it
            eng.last_error = f"{type(e).__name__}: {e}"
            logger.warning("fleet engine %d startup failed: %s",
                           eng.idx, eng.last_error)
            if wd is not None:
                wd.stop()
            with eng.lock:
                if eng.gen == gen:
                    self._quarantine(eng, reason="startup")
            return
        with eng.lock:
            if eng.gen != gen:
                wd.stop()
                return
            self._set_state(eng, "serving")
            if eng.quarantined_at is not None:
                rec_s = time.monotonic() - eng.quarantined_at
                self.recoveries.append(rec_s)
                eng.quarantined_at = None
                logger.info("fleet engine %d rejoined after %.3fs",
                            eng.idx, rec_s)

        try:
            while not self._stop_ev.is_set() and eng.gen == gen:
                if eng.pause_ev.is_set():
                    eng.idle.set()
                    time.sleep(cfg.poll_s)
                    continue
                req = self._q.get(timeout=cfg.poll_s)
                if req is None:
                    eng.idle.set()
                    continue
                eng.idle.clear()
                if eng.pause_ev.is_set():  # pause landed mid-dequeue:
                    self._q.put(req, front=True)   # drain must not race
                    eng.idle.set()
                    continue
                if req.done:
                    continue            # hedge winner elsewhere
                now = time.monotonic()
                if now >= req.deadline:
                    req.complete(FleetResult(
                        DEADLINE, error="deadline before dispatch"))
                    self._count("fleet_deadline_total")
                    continue
                with eng.lock:
                    eng.current = (req, now)
                try:
                    actions, hidden2 = self._dispatch(eng, wd, fe, req)
                except Exception as e:  # noqa: BLE001 — engine failure
                    with eng.lock:
                        eng.current = None
                    eng.idle.set()
                    if eng.gen == gen:  # not superseded by a stall
                        self._engine_failed(eng, e, req)
                    return              # this worker generation is done
                with eng.lock:
                    eng.current = None
                eng.idle.set()
                # complete even when superseded mid-dispatch (a late
                # unwedge): the result is valid and first-writer-wins
                # dedupes against the hedge
                if req.complete(FleetResult(OK, actions, hidden2,
                                            engine=eng.idx)) \
                        and eng.gen == gen:
                    self._lat.append(time.monotonic() - now)
                if eng.gen != gen:
                    break
        finally:
            wd.stop()

    def _dispatch(self, eng: _Engine, wd: Watchdog, fe,
                  req: FleetRequest):
        """One request on one engine: chaos hook + watchdog stamp + span
        around the front end's select, with bounded in-place retries of
        transient faults. The ladder's rung picks the bucket cap and the
        param variant."""
        cap, dtype = self._ladder.current() if self._ladder is not None \
            else (None, self.dtype)
        fe_use = fe if dtype == self.dtype else self._alt(eng, wd, dtype)
        attempt = itertools.count(1)

        def once():
            a = next(attempt)
            with wd.watch("fleet.dispatch"):
                with _watched("fleet.dispatch", self._rec,
                              engine=eng.idx, attempt=a,
                              bucket_cap=cap or 0, dtype=dtype):
                    resilience.fire("fleet.dispatch", engine=eng.idx,
                                    attempt=a, rid=req.rid)
                    return self._select_capped(fe_use, req, cap)

        return retry_call(once, attempts=self.cfg.request_retries + 1,
                          backoff_s=self.cfg.retry_backoff_s,
                          retriable=is_transient,
                          label=f"fleet.engine{eng.idx}")

    def _select_capped(self, fe, req: FleetRequest, cap: Optional[int]):
        """Front end select under the ladder's bucket cap: chunks of
        ``<= cap`` rows make every bucket land at or below the cap."""
        if cap is None or cap >= fe.buckets[-1]:
            return fe.select(req.obs, req.avail, req.hidden)
        n = req.obs.shape[0]
        actions = np.empty((n, fe.n_agents), np.int32)
        hidden = np.empty((n, fe.n_agents, fe.emb), np.float32)
        for lo in range(0, n, cap):
            hi = min(lo + cap, n)
            h = req.hidden[lo:hi] if req.hidden is not None else None
            a, h2 = fe.select(req.obs[lo:hi], req.avail[lo:hi], h)
            actions[lo:hi] = a
            hidden[lo:hi] = h2
        return actions, hidden

    def _alt(self, eng: _Engine, wd: Watchdog, dtype: str):
        """Lazy degraded-dtype front end for one engine, loaded and
        warmed off the watchdog clock on the engine's stream."""
        fe2 = eng.fe_alt.get(dtype)
        if fe2 is None:
            with _watched("fleet.load", self._rec, engine=eng.idx,
                          dtype=dtype):
                fe2 = self._factory(dtype)
            self._selfcheck(eng, None, fe2, stage="degrade")
            eng.fe_alt[dtype] = fe2
        return fe2

    def _selfcheck(self, eng: _Engine, wd: Optional[Watchdog], fe,
                   stage: str) -> None:
        """One smallest-bucket dispatch on zero obs, on the engine's
        stream: the health check at engine start, after a restart, on
        the degraded variant's first use and after a refresh swap. Raises
        on anything non-finite or mis-shaped."""
        with _watched("fleet.selfcheck", self._rec, engine=eng.idx,
                      stage=stage), self._on_stream(eng.stream):
            resilience.fire("fleet.selfcheck", engine=eng.idx, stage=stage)
            b = fe.buckets[0]
            obs = np.zeros((b, fe.n_agents, fe.obs_dim), np.float32)
            avail = np.ones((b, fe.n_agents, fe.n_actions), np.bool_)
            if wd is not None:
                # stamped under the dispatch phase: its clean completion
                # marks fleet.dispatch warm, so traffic stalls are
                # bounded from the first real request
                with wd.watch("fleet.dispatch"):
                    actions, hidden = fe.select(obs, avail)
            else:
                actions, hidden = fe.select(obs, avail)
            if actions.shape != (b, fe.n_agents) \
                    or not np.all((actions >= 0)
                                  & (actions < fe.n_actions)):
                raise RuntimeError(
                    f"selfcheck: actions out of range/shape "
                    f"{actions.shape}")
            if not np.all(np.isfinite(np.asarray(hidden, np.float32))):
                raise RuntimeError("selfcheck: non-finite hidden state")

    # ------------------------------------------------------- failure paths

    def _engine_failed(self, eng: _Engine, exc: BaseException,
                       req: FleetRequest) -> None:
        """Non-transient (or retry-exhausted) dispatch failure: the
        engine is quarantined and the request bounces to a peer, at most
        ``max_bounces`` times."""
        eng.last_error = f"{type(exc).__name__}: {exc}"
        logger.warning("fleet engine %d failed dispatching request %d: %s",
                       eng.idx, req.rid, eng.last_error)
        self._count("fleet_engine_failures_total")
        with eng.lock:
            self._quarantine(eng, reason="crash")
        self._bounce(req, eng.last_error)

    def _on_stall(self, eng: _Engine, gen: int, diag) -> None:
        """Watchdog callback (its own thread): supersede the wedged
        worker, hedge its in-flight request onto a peer, quarantine and
        schedule a restart. The stuck thread keeps its stale generation
        and exits if it ever unwedges."""
        with eng.lock:
            if eng.gen != gen or self._stop_ev.is_set():
                return
            eng.last_error = (f"stalled in {diag.phase} after "
                              f"{diag.elapsed_s:.3f}s")
            self._count("fleet_stalls_total")
            cur, eng.current = eng.current, None
            self._quarantine(eng, reason="stall")
        if cur is not None:
            req, _ = cur
            if not req.done:
                self._bounce(req, eng.last_error, front=True)

    def _bounce(self, req: FleetRequest, why: str,
                front: bool = False) -> None:
        req.bounces += 1
        if req.done:
            return
        if req.bounces > self.cfg.max_bounces:
            req.complete(FleetResult(
                ERROR, error=f"failed on {req.bounces} engines; "
                             f"last: {why}"))
            return
        if time.monotonic() >= req.deadline:
            req.complete(FleetResult(DEADLINE, error=why))
            self._count("fleet_deadline_total")
            return
        self._q.put(req, front=front)

    def _quarantine(self, eng: _Engine, reason: str) -> None:
        """Caller holds ``eng.lock``. Supersedes the current worker and
        schedules the restart (or ejects past the cap)."""
        eng.gen += 1
        if eng.quarantined_at is None:
            eng.quarantined_at = time.monotonic()
        if eng.restarts >= self.cfg.max_restarts:
            self._set_state(eng, "ejected")
            self._count("fleet_ejected_total")
            logger.error("fleet engine %d permanently ejected after %d "
                         "restarts (%s)", eng.idx, eng.restarts, reason)
            return
        eng.restarts += 1
        delay = backoff_delay(eng.restarts, self.cfg.restart_backoff_s,
                              max_s=self.cfg.restart_backoff_max_s)
        eng.restart_at = time.monotonic() + delay
        self._set_state(eng, "quarantined")
        self._count("fleet_restarts_total")
        self._rec.mark("fleet.quarantine", engine=eng.idx, reason=reason,
                       restart=eng.restarts, delay_s=round(delay, 3))

    # ----------------------------------------------------------- supervisor

    def _supervise(self) -> None:
        cfg = self.cfg
        while not self._stop_ev.wait(cfg.poll_s):
            now = time.monotonic()
            # 1) deadline sweep: nothing outstanding outlives its
            # deadline, queued or wedged in flight alike
            with self._inflight_lock:
                reqs = list(self._inflight.items())
            for rid, req in reqs:
                if req.done:
                    with self._inflight_lock:
                        self._inflight.pop(rid, None)
                elif now >= req.deadline:
                    if req.complete(FleetResult(
                            DEADLINE, error="deadline exceeded")):
                        self._count("fleet_deadline_total")
            # 2) hedge sweep: duplicate the laggard's request onto a peer
            # after the p99-derived delay (once per request)
            hedge_after = self._hedge_delay()
            healthy = sum(e.state == "serving" for e in self.engines)
            if healthy >= 2:
                for eng in self.engines:
                    with eng.lock:
                        cur = eng.current
                    if cur is None:
                        continue
                    req, t0 = cur
                    if (not req.done and req.hedges == 0
                            and now - t0 >= hedge_after
                            and now < req.deadline):
                        req.hedges += 1
                        self._count("fleet_hedges_total")
                        self._rec.mark("fleet.hedge", rid=req.rid,
                                       engine=eng.idx,
                                       after_s=round(now - t0, 3))
                        self._q.put(req, front=True)
            # 3) restart sweep
            for eng in self.engines:
                with eng.lock:
                    t = eng.thread
                    if eng.state == "serving" \
                            and (t is None or not t.is_alive()):
                        # the worker died without _engine_failed
                        eng.last_error = eng.last_error or "thread died"
                        self._quarantine(eng, reason="thread-death")
                    if eng.state == "quarantined" \
                            and now >= eng.restart_at:
                        self._spawn_worker(eng)
            # 4) pressure ladder
            if self._ladder is not None:
                fill = len(self._q) / max(cfg.queue_depth, 1)
                moved = self._ladder.update(fill, now)
                if moved:
                    self._rec.mark("fleet.ladder", action=moved,
                                   level=self._ladder.level,
                                   fill=round(fill, 3))
                    logger.info("fleet ladder %s → %s", moved,
                                self._ladder.describe())
            # 5) refresh trigger file
            self._poll_refresh_trigger()
            # 6) pulse gauges
            hub = self._hub
            if hub is not None:
                hub.set("fleet_queue_depth", len(self._q))
                if self._ladder is not None:
                    hub.set("fleet_ladder_level", self._ladder.level)
                for eng in self.engines:
                    hub.set("fleet_engine_state",
                            _STATE_CODE.get(eng.state, -1),
                            engine=eng.idx)
                    hub.set("fleet_engine_restarts", eng.restarts,
                            engine=eng.idx)
                with self._counters_lock:
                    for name, v in self.counters.items():
                        hub.set(name, v)

    def _hedge_delay(self) -> float:
        cfg = self.cfg
        if cfg.hedge_after_s > 0:
            return cfg.hedge_after_s
        lats = list(self._lat)
        if len(lats) < 16:
            # a cold fleet has too few samples for an honest p99: wait
            # half the watchdog budget rather than hedge-storm at start
            return max(cfg.dispatch_timeout_s / 2.0, cfg.hedge_min_s)
        p99 = float(np.percentile(np.asarray(lats), 99))
        return min(max(p99 * cfg.hedge_p99_mult, cfg.hedge_min_s),
                   cfg.dispatch_timeout_s)

    def _poll_refresh_trigger(self) -> None:
        if self.artifact_dir is None:
            return
        path = os.path.join(self.artifact_dir, REFRESH_TRIGGER)
        if not os.path.isfile(path):
            return
        try:
            with open(path) as f:
                ckpt = f.read().strip()
            os.unlink(path)
        except OSError:
            return
        if not ckpt:
            return
        threading.Thread(target=self.refresh, args=(ckpt,), daemon=True,
                         name="t2omca-fleet-refresh").start()

    def _fleet_health(self) -> Tuple[bool, str]:
        serving = sum(e.state == "serving" for e in self.engines)
        ok = serving >= max(self.n_engines - 1, 1)
        return ok, f"{serving}/{self.n_engines} engines serving"

    # -------------------------------------------------------------- refresh

    def refresh(self, ckpt_dir: str) -> dict:
        """Hot param refresh: fold the new checkpoint and check it
        against the artifact, then roll the swap across the engines one
        at a time, never fewer than N−1 serving. A refusal or a tripped
        post-swap health check leaves every engine on the params it had.
        → a summary dict with ``status`` in ``ok``/``refused``/
        ``rolled_back``/``aborted``/``busy``."""
        if not self._refresh_lock.acquire(blocking=False):
            return {"status": "busy"}
        try:
            with _watched("fleet.refresh", self._rec, stage="fold",
                          ckpt=ckpt_dir):
                try:
                    resilience.fire("fleet.refresh", stage="fold",
                                    ckpt=ckpt_dir)
                    new_params, info = self._fold_check(ckpt_dir)
                except Exception as e:  # noqa: BLE001 — refusal path
                    self._count("fleet_refresh_refused_total")
                    reason = f"{type(e).__name__}: {e}"
                    logger.warning("fleet refresh REFUSED (%s): %s",
                                   ckpt_dir, reason)
                    self._rec.mark("fleet.refresh_refused", ckpt=ckpt_dir,
                                   reason=reason[:200])
                    return {"status": "refused", "reason": reason}
            swapped: List[Tuple[_Engine, object]] = []
            with _watched("fleet.refresh", self._rec, stage="roll",
                          ckpt=ckpt_dir):
                for eng in self.engines:
                    if eng.state != "serving":
                        continue
                    others = sum(e.state == "serving" for e in self.engines
                                 if e is not eng)
                    if others < self.n_engines - 1:
                        # swapping this engine would drop the fleet
                        # below N-1 serving: abort, restore the swapped
                        self._rollback(swapped)
                        return {"status": "aborted",
                                "reason": "fleet below N-1 serving"}
                    old = getattr(eng.fe, "params", None)
                    if not self._pause(eng):
                        self._rollback(swapped)
                        return {"status": "aborted",
                                "reason": f"engine {eng.idx} did not "
                                          f"drain in time"}
                    self._set_state(eng, "refreshing")
                    try:
                        eng.fe.params = new_params
                        self._selfcheck(eng, eng.wd, eng.fe,
                                        stage="refresh")
                    except Exception as e:  # noqa: BLE001 — rollback path
                        eng.fe.params = old
                        self._set_state(eng, "serving")
                        self._resume(eng)
                        self._rollback(swapped)
                        self._count("fleet_refresh_rollback_total")
                        reason = f"{type(e).__name__}: {e}"
                        logger.warning(
                            "fleet refresh ROLLED BACK at engine %d: %s",
                            eng.idx, reason)
                        self._rec.mark("fleet.refresh_rollback",
                                       engine=eng.idx, reason=reason[:200])
                        return {"status": "rolled_back",
                                "engine": eng.idx, "reason": reason}
                    self._set_state(eng, "serving")
                    self._resume(eng)
                    swapped.append((eng, old))
            self._live_params = new_params
            self._count("fleet_refresh_total")
            self._rec.mark("fleet.refresh_ok", ckpt=ckpt_dir,
                           engines=len(swapped))
            logger.info("fleet refresh OK: %d engines rolled to %s "
                        "(t_env=%s)", len(swapped), ckpt_dir,
                        info.get("t_env"))
            return {"status": "ok", "engines": len(swapped), **info}
        finally:
            self._refresh_lock.release()

    def _fold_check(self, ckpt_dir: str):
        """The host-side half of the refresh, off the request path: read
        and refold the checkpoint's agent leaves with the artifact's own
        train config on the fleet's device, cast to the served variant,
        and refuse (:class:`RefreshRefused`, or the loader's own error)
        unless the checkpoint's replay holds the artifact's agents and
        actions and the variant's flat ``(path, shape, dtype)`` list
        equals the artifact's. The message names the first mismatch."""
        if self.meta is None:
            raise RefreshRefused("fleet has no artifact meta to check "
                                 "a refresh against")
        from ..config import from_dict
        from ..utils.checkpoint import STATE_FILE, flatten_state
        from .export import _cast_variant, load_acting_params
        dev = self._dev if self._dev is not None \
            else resolve_device(self.device)
        cfg = from_dict(self.meta["train_config"])
        acting, _mac, _env_info, ckpt_info = load_acting_params(
            cfg, ckpt_dir, device=dev)
        want_env = (int(self.meta["n_agents"]), int(self.meta["n_actions"]))
        # memory-mapped: the shapes only, no replay bytes read
        state = torch.load(os.path.join(ckpt_info["dir"], STATE_FILE),
                           map_location="cpu", weights_only=True, mmap=True)
        for path, x in state.items():
            if path.startswith("buffer.") and path.endswith("avail_actions") \
                    and tuple(x.shape[-2:]) != want_env:
                raise RefreshRefused(
                    f"checkpoint replay {path} holds (agents, actions) "
                    f"{tuple(x.shape[-2:])}, the artifact {want_env}: the "
                    f"checkpoint is not this artifact's env")
        del state
        variant = _cast_variant(acting, self.dtype)
        got = {k: (tuple(v.shape), str(v.dtype))
               for k, v in flatten_state(variant)[0].items()}
        want = _artifact_leaves(self.artifact_dir, self.meta, self.dtype)
        for path in sorted(set(got) | set(want)):
            if got.get(path) != want.get(path):
                raise RefreshRefused(
                    f"param {path}: refolded {got.get(path)} != artifact "
                    f"{want.get(path)} — the checkpoint is not this "
                    f"artifact's model")
        if dev.type == "cuda":
            # the fold's kernels ran on this thread's stream; the
            # engines read the variant on theirs
            torch.cuda.current_stream(dev).synchronize()
        return variant, {"t_env": ckpt_info.get("t_env"),
                         "leaves_checked": len(got)}

    def _pause(self, eng: _Engine, timeout_s: float = 30.0) -> bool:
        """Take one engine out of rotation and wait until it is drained
        (idle, nothing in flight); two idle observations a poll apart
        close the dequeue→idle.clear() race."""
        eng.pause_ev.set()
        deadline = time.monotonic() + timeout_s
        quiet = 0
        while time.monotonic() < deadline:
            with eng.lock:
                busy = eng.current is not None
            if not busy and eng.idle.is_set():
                quiet += 1
                if quiet >= 2:
                    return True
            else:
                quiet = 0
            time.sleep(self.cfg.poll_s)
        eng.pause_ev.clear()
        return False

    def _resume(self, eng: _Engine) -> None:
        eng.pause_ev.clear()

    def _rollback(self, swapped: List[Tuple[_Engine, object]]) -> None:
        """Restore every already-swapped engine's old params (reverse
        order, pausing each): a partial refresh never survives."""
        for eng, old in reversed(swapped):
            self._pause(eng)
            eng.fe.params = old
            self._resume(eng)

    # ---------------------------------------------------------------- misc

    def _set_state(self, eng: _Engine, state: str) -> None:
        eng.state = state

    def _count(self, name: str, delta: int = 1) -> None:
        with self._counters_lock:
            self.counters[name] += delta
        if self._hub is not None:
            self._hub.inc(name, delta)

    def serving_engines(self) -> int:
        return sum(e.state == "serving" for e in self.engines)

    def warmup(self) -> None:
        """One padded dispatch per bucket on every serving engine, on its
        stream (``ServeFrontend.load`` warmed them already; a stub or
        in-memory front end may not have been)."""
        for eng in self.engines:
            fe = eng.fe
            if fe is not None and eng.state == "serving":
                with self._on_stream(eng.stream):
                    fe.warmup()

    def stats(self) -> dict:
        """Snapshot for benches/tests: counters, ladder, per-engine
        state, recovery times."""
        with self._counters_lock:
            counters = dict(self.counters)
        return {
            "engines": [{"idx": e.idx, "state": e.state,
                         "restarts": e.restarts,
                         "last_error": e.last_error}
                        for e in self.engines],
            "serving": self.serving_engines(),
            "queue_depth": len(self._q),
            "ladder": (self._ladder.describe()
                       if self._ladder is not None else None),
            "ladder_level": (self._ladder.level
                             if self._ladder is not None else 0),
            "recoveries_s": [round(r, 3) for r in self.recoveries],
            **counters,
        }


# -------------------------------------------------------------- CLI helper

def check_refresh(artifact_dir: str, ckpt_dir: str,
                  dtype: str = "float32", device: DeviceLike = None
                  ) -> dict:
    """The refresh dry run (``python -m t2omca_tpu_torch.serve
    refresh``): the fold and check a live fleet's :meth:`ServeFleet.
    refresh` would run, without any engines, on ``device`` (``cuda``
    unless named). → ``{"status": "compatible"|"refused", ...}``."""
    with open(os.path.join(artifact_dir, "meta.json")) as f:
        meta = json.load(f)
    fleet = ServeFleet(artifact_dir, n_engines=1, dtype=dtype,
                       device=device)
    fleet.meta = meta
    try:
        _, info = fleet._fold_check(ckpt_dir)
    except Exception as e:  # noqa: BLE001 — refusal is the result
        return {"status": "refused", "reason": f"{type(e).__name__}: {e}"}
    return {"status": "compatible", **info}
