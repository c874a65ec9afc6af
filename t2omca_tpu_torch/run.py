"""The training and evaluation driver (port of ``t2omca_tpu/run.py``:
``Experiment``, ``run``, the classic ``run_sequential``, ``_DriverKit``
and ``evaluate_sequential``).

``Experiment.build`` assembles env, MAC, learner, runner, episode runner
and replay buffer on one device; ``Experiment.init_state`` starts the JAX
key chain (``k_learner, k_runner = split(PRNGKey(seed))``);
``Experiment.programs`` returns the three programs of one iteration
(rollout, insert, train_iter); ``run_classic`` drives N iterations with
the driver key ``PRNGKey(seed + 1)``, the episode and ``t_env``
accounting and the train gate ``buffer_filled >= batch_size and episode
>= accumulated_episodes``, splitting ``key2, k_sample = split(key)`` only
for iterations that train.

``run`` is the user's entry (``python -m t2omca_tpu_torch train|evaluate|
benchmark``): results directory, ``metrics.jsonl``, the span recorder,
then ``run_sequential`` (training) or ``evaluate_sequential``.
``run_sequential`` is the JAX driver's classic loop with its cadences
and names: a dispatch of K iterations (K = ``superstep`` where eligible,
else 1), then the runner-log, test, animation, save and log cadences;
resume from ``checkpoint_path``; the non-finite streak and its checkpoint
restore; SIGTERM/SIGINT through ``ShutdownGuard`` with an emergency
checkpoint; the watchdog stamping every device-facing region and the
bounded retry of transient failures (never a swap to the plain kernels
or the CPU).

Where the port differs from the JAX driver:

* **K > 1 without the fused program.** A dispatch of K iterations is K
  classic iterations through ``run_classic`` (one ``dispatch.superstep``
  region, ``time_superstep_ms``), then the cadences once, as the JAX
  driver does after its fused program. The JAX contract makes the two
  train identically. The fused program (CUDA-graph capture) is
  ``ROADMAP.md`` item 8; until it exists the degradation ladder's K→1
  rung has nothing to degrade, and failures go to the restore rung.
* **The driver key is checkpointed** (``meta.json`` ``driver.key``): a
  resumed run draws the keys a run that never stopped would draw (the
  JAX driver restarts its key at ``PRNGKey(seed + 1)`` on resume). The
  non-finite restore keeps the live key, as in JAX.
* The learner's params cannot come from the JAX key chain (flax's
  initializers are not ported): they are drawn from a ``torch.Generator``
  seeded with ``seed``, or handed in (``learner_params=``, e.g. carried
  across from flax with ``convert.py``).

Left out, to later slices: the population (item 11), data parallelism
and Sebulba (item 12), the learning-health probes and the live HTTP
plane (``obs.sight``, ``obs.pulse_port``: item 13a), per-program device
time (``obs.program_trace``: item 13b) and the fused superstep (item 8).
Each raises naming its item.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque, namedtuple
from contextlib import nullcontext
from typing import List, Optional

import numpy as np
import torch

from . import prng
from .components.episode_buffer import (PrioritizedReplayBuffer,
                                        ReplayBuffer)
from .config import TrainConfig, sanity_check, unique_token
from .controllers.basic_mac import MAC_REGISTRY
from .device import DeviceLike, resolve_device
from .envs.registry import make_env
from .learners.qmix_learner import LEARNER_REGISTRY
from .obs import memwatch as obs_memwatch
from .obs import spans as obs_spans
from .ops.query_slice import entity_store_eligible
from .runners.episode_runner import EpisodeRunner
from .runners.parallel_runner import RUNNER_REGISTRY, RolloutStats
from .train.program import TrainState, build_train_iter
from .utils import resilience, watchdog
from .utils.checkpoint import (CheckpointFormatError, find_checkpoint,
                               load_checkpoint, load_learner_state,
                               prune_checkpoints, read_meta,
                               save_checkpoint)
from .utils.logging import Logger
from .utils.profiling import StageTimer, make_trace_window
from .utils.stats import StatsAccumulator
from .utils.timehelper import time_left, time_str


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"Queue A: {where})")


def superstep_eligible(cfg: TrainConfig) -> bool:
    """Whether a dispatch runs K = ``superstep`` iterations: K > 1
    requested AND the replay ring on the device (the JAX predicate)."""
    return cfg.superstep > 1 and not cfg.replay.buffer_cpu_only


@dataclasses.dataclass(frozen=True)
class Experiment:
    cfg: TrainConfig
    env: object
    mac: object
    learner: object
    runner: object
    buffer: object
    device: torch.device

    @classmethod
    def build(cls, cfg: TrainConfig, device: DeviceLike = None
              ) -> "Experiment":
        """Everything on ``device`` (``cuda`` unless named; raises when
        no card is present and none was named)."""
        device = resolve_device(device)
        if cfg.prng_impl != "threefry":
            raise _not_ported(f"prng_impl '{cfg.prng_impl}'", "the PRNG "
                              "(the port has threefry2x32)")
        if cfg.replay.buffer_cpu_only:
            raise _not_ported("replay.buffer_cpu_only", "item 9")
        if cfg.population.size or cfg.sebulba.actor_devices:
            raise _not_ported("the population and Sebulba", "items 11, 12")
        env = make_env(cfg.env_args, device)
        env_info = env.get_env_info()
        mac = MAC_REGISTRY[cfg.mac].build(cfg, env_info, device)
        learner = LEARNER_REGISTRY[cfg.learner].build(cfg, mac, env_info,
                                                      device)
        runner = RUNNER_REGISTRY[cfg.runner](env, mac, cfg)
        buf_kw = dict(capacity=cfg.replay.buffer_size,
                      episode_limit=cfg.env_args.episode_limit,
                      n_agents=env_info["n_agents"],
                      n_actions=env_info["n_actions"],
                      obs_dim=env_info["obs_shape"],
                      state_dim=env_info["state_shape"],
                      store_dtype=cfg.replay.store_dtype,
                      compact_obs=entity_store_eligible(cfg), device=device)
        if cfg.replay.prioritized:
            buffer = PrioritizedReplayBuffer(
                alpha=cfg.replay.per_alpha, beta0=cfg.replay.per_beta,
                t_max=cfg.t_max, **buf_kw)
        else:
            buffer = ReplayBuffer(**buf_kw)
        return cls(cfg=cfg, env=env, mac=mac, learner=learner,
                   runner=runner, buffer=buffer, device=device)

    @property
    def episode_runner(self) -> EpisodeRunner:
        """The batch-1 runner of ``evaluate`` and the animation cadence."""
        return EpisodeRunner(self.env, self.mac, self.cfg)

    def init_state(self, seed: int, learner_params=None) -> TrainState:
        """``k_learner, k_runner = split(PRNGKey(seed))``: the runner starts
        from ``k_runner``; the learner from ``learner_params`` (e.g. carried
        from flax by ``convert.learner_params_from_flax``) or from a
        ``torch.Generator`` seeded with ``seed``."""
        _k_learner, k_runner = prng.split(
            prng.PRNGKey(seed, self.device)).unbind(0)
        ls = (self.learner.init_state(params=learner_params)
              if learner_params is not None else
              self.learner.init_state(torch.Generator().manual_seed(seed)))
        return TrainState(learner=ls, buffer=self.buffer.init(), episode=0,
                          runner=self.runner.init_state(k_runner))

    def programs(self):
        """→ (rollout, insert, train_iter)."""
        runner, buffer = self.runner, self.buffer

        def rollout(params, rs, test_mode: bool = False):
            return runner.run(params, rs, test_mode=test_mode)

        return (rollout, buffer.insert_episode_batch,
                build_train_iter(buffer, self.learner, self.cfg))


@dataclasses.dataclass
class LoopCursor:
    """The driver's host-side counters and key, carried between calls of
    ``run_classic``."""

    key: torch.Tensor             # the driver key chain
    t_env: int = 0
    episode: int = 0
    buffer_filled: int = 0


@dataclasses.dataclass
class IterationRecord:
    stats: object                 # RolloutStats of the iteration's rollout
    info: Optional[dict]          # train info, None when the gate held
    t_env: int
    episode: int
    #: host seconds of the rollout + insert and of the train step, each
    #: ending in a device synchronize (only with ``sync=True``)
    rollout_s: Optional[float] = None
    train_s: Optional[float] = None


def run_classic(exp: Experiment, ts: TrainState, n_iterations: int,
                cursor: Optional[LoopCursor] = None, sync: bool = False):
    """``n_iterations`` of the classic loop (rollout → insert → gated
    train) → (ts', cursor', [IterationRecord]). ``cursor`` None starts the
    driver key at ``PRNGKey(cfg.seed + 1)`` with zero counters.
    ``sync=True`` synchronizes the device after each stage and records
    its host time; otherwise nothing in the loop waits on the device."""
    cfg = exp.cfg
    if cursor is None:
        cursor = LoopCursor(key=prng.PRNGKey(cfg.seed + 1, exp.device))
    rollout, insert, train_iter = exp.programs()
    steps_per_rollout = cfg.batch_size_run * cfg.env_args.episode_limit
    capacity = cfg.replay.buffer_size
    c = dataclasses.replace(cursor)
    records: List[IterationRecord] = []

    def lap(t0):
        if not sync:
            return None
        if exp.device.type == "cuda":
            torch.cuda.synchronize(exp.device)
        return time.perf_counter() - t0

    for _ in range(n_iterations):
        t0 = time.perf_counter()
        rs, batch, stats = rollout(ts.learner.params["agent"], ts.runner)
        ts = dataclasses.replace(ts, runner=rs,
                                 buffer=insert(ts.buffer, batch),
                                 episode=ts.episode + cfg.batch_size_run)
        del batch
        rollout_s = lap(t0)
        c.t_env += steps_per_rollout
        c.episode += cfg.batch_size_run
        c.buffer_filled = min(c.buffer_filled + cfg.batch_size_run, capacity)
        info, train_s = None, None
        if (c.buffer_filled >= cfg.batch_size
                and c.episode >= cfg.accumulated_episodes):
            key2, k_sample = prng.split(c.key).unbind(0)
            t0 = time.perf_counter()
            ts, info = train_iter(ts, k_sample, c.t_env)
            train_s = lap(t0)
            c.key = key2
        records.append(IterationRecord(stats=stats, info=info,
                                       t_env=c.t_env, episode=c.episode,
                                       rollout_s=rollout_s,
                                       train_s=train_s))
    return ts, c, records


# ====================================================================== driver

#: what a watchdog stamp holds: the pre-dispatch state and the driver key
#: that goes with it (an emergency checkpoint saves both)
_Stamp = namedtuple("_Stamp", ["ts", "key"])


def _key_meta(key: torch.Tensor) -> dict:
    """The driver key as ``meta.json`` stores it."""
    return {"key": [int(x) for x in key.tolist()]}


def _key_from_meta(meta: dict, device) -> Optional[torch.Tensor]:
    key = meta.get("driver", {}).get("key")
    return (None if key is None else
            torch.tensor(key, dtype=torch.int64, device=device))


def _stack_stats(stats: List[RolloutStats]) -> RolloutStats:
    """K iterations' ``(B,)`` stats → one ``(K, B)`` (the fused
    dispatch's stacked output)."""
    return RolloutStats(**{f.name: torch.stack([getattr(s, f.name)
                                                for s in stats])
                           for f in dataclasses.fields(RolloutStats)})


def _check_driver_scope(cfg: TrainConfig) -> None:
    """Raise for what the port's driver does not have yet."""
    if cfg.dp_devices:
        raise _not_ported("dp_devices (the data-parallel mesh)", "item 12")
    if cfg.population.size:
        raise _not_ported("the population", "item 11")
    if cfg.sebulba.actor_devices:
        raise _not_ported("Sebulba (sebulba.actor_devices)", "item 12")
    if cfg.obs.sight.enabled:
        raise _not_ported("obs.sight (the learning-health probes)",
                          "item 13a")
    if cfg.obs.pulse_port:
        raise _not_ported("obs.pulse_port (the live HTTP plane)",
                          "item 13a")


class _DriverKit:
    """The driver's helper kit (the JAX ``_DriverKit`` of the classic
    loop): watchdog stamps, fault-handled dispatch, sync points, the
    stall response, flight persist and the bounded save lock."""

    def __init__(self, *, cfg, res, log, rec, mw, guard, model_dir,
                 save_lock):
        self.cfg, self.res, self.log, self.rec = cfg, res, log, rec
        self.mw, self.guard = mw, guard
        self.model_dir, self.save_lock = model_dir, save_lock
        self.default_wd = None      # armed by the driver once built
        self.t_env_fn = lambda: 0   # the loop re-binds its cursor
        self.dispatch_faults = 0    # transient dispatch errors seen (stats)

    # ------------------------------------------------------------ telemetry

    def persist_flight(self, path: str) -> None:
        """Flight persist + the memwatch block (cached state only — safe
        on crash/stall paths over a wedged device)."""
        extra = {"memwatch": self.mw.report()} if self.mw.enabled else None
        self.rec.persist(path, extra=extra)

    def watched(self, phase, state=None, t=None, **meta):
        """One watchdog stamp (outer) + span (inner) for a device-facing
        region; a no-op context when both are off."""
        wd = self.default_wd
        if t is None:
            t = self.t_env_fn()
        w = wd.watch(phase, t_env=t, state=state) if wd is not None else None
        if self.rec.enabled:
            s = self.rec.span(phase, t_env=t, **meta)
            return obs_spans.stacked(w, s) if w is not None else s
        return w if w is not None else nullcontext()

    # ------------------------------------------------------------ dispatch

    def dispatch(self, phase, fn, state, t=None, **context):
        """One device-facing dispatch: fault-injection hook + watchdog
        stamp + bounded in-place retry with backoff of transient-classified
        failures (the callers commit their host mirrors only after
        success, so a retry replays an identical dispatch). Deterministic
        errors propagate at once; exhausted retries raise
        ``DispatchFailed`` for the ladder. Nothing here falls back to
        another kernel or device."""
        res = self.res
        if t is None:
            t = self.t_env_fn()
        attempts = 1 + res.dispatch_retries
        for attempt in range(1, attempts + 1):
            try:
                with self.watched(phase, state, t=t, attempt=attempt,
                                  **context):
                    # the hook fires INSIDE the watched region: an
                    # injected sleep here is a hung dispatch to the
                    # watchdog
                    resilience.fire(phase, t_env=t, attempt=attempt,
                                    **context)
                    return fn()
            except Exception as e:  # noqa: BLE001 — classified below
                if not watchdog.is_transient(e):
                    raise
                self.dispatch_faults += 1
                if attempt >= attempts or not watchdog.state_intact(state):
                    raise watchdog.DispatchFailed(phase, attempt, e) from e
                delay = watchdog.backoff_delay(attempt, res.retry_backoff_s)
                self.log.warning(f"{phase}: transient dispatch failure "
                                 f"(attempt {attempt}/{attempts}), "
                                 f"retrying in {delay:.2f}s: "
                                 f"{type(e).__name__}: {e}")
                time.sleep(delay)

    def sync_point(self, phase, fn, state):
        """One blocking sync/fetch boundary (run-ahead wait, cadence stat
        fetch): stamp + hook + transient classification. A transient
        failure raises ``DispatchFailed`` (restore is the only rung that
        can stand on it); deterministic errors propagate unwrapped."""
        try:
            with self.watched(phase, state):
                resilience.fire(phase, t_env=self.t_env_fn())
                return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            if not watchdog.is_transient(e):
                raise
            self.dispatch_faults += 1
            raise watchdog.DispatchFailed(phase, 1, e) from e

    # ------------------------------------------------------------ stalls

    def acquire_save_lock(self, where: str) -> bool:
        """BOUNDED acquire shared by every save site: an emergency save
        wedged on the device can hold the lock forever, and each waiter
        skips with a warning instead of inheriting the hang."""
        if self.save_lock.acquire(timeout=max(self.res.stall_grace_s,
                                              60.0)):
            return True
        self.log.warning(f"{where}: checkpoint skipped — an emergency "
                         f"save still holds the save lock (wedged "
                         f"device?); resume falls back to the newest "
                         f"published checkpoint")
        return False

    def stall_response(self, diag, tag: str = "watchdog") -> None:
        """The watchdog stall callback (on the watchdog's own thread):
        the flight tail and memwatch block folded into
        ``stall_diagnosis.json``, the guard tripped (BEFORE the save
        attempt, which reads device state and may block), then an
        emergency checkpoint of the stamped pre-dispatch state. A stall
        inside the checkpoint write itself skips the save (its staging
        directory is in use). The ring's storage is written in place, so
        slots past the stamped cursor may already hold the stalled
        dispatch's episodes: the save is a valid state (cursor,
        priorities and counters are the stamped ones), not bit for bit
        the pre-dispatch ring."""
        cfg, res, log = self.cfg, self.res, self.log
        extra = {}
        if self.rec.enabled:
            try:
                extra["recent_spans"] = self.rec.tail()
            except Exception:  # noqa: BLE001 — diagnostics only
                log.exception("flight tail unavailable")
        if self.mw.enabled:
            extra["memwatch"] = self.mw.report()
        watchdog.write_diagnosis(diag, self.model_dir, extra=extra or None)
        self.guard.request(tag)
        if (cfg.save_model and res.emergency_checkpoint
                and not diag.phase.startswith("checkpoint")
                and diag.state is not None
                and watchdog.state_intact(diag.state)):
            if not self.acquire_save_lock("watchdog emergency save"):
                return
            try:
                ts, key = diag.state
                save_to = save_checkpoint(
                    self.model_dir, diag.t_env, ts,
                    topology={"loop": "classic"}, driver=_key_meta(key))
                log.warning(f"watchdog: emergency checkpoint saved to "
                            f"{save_to}")
            except Exception as e:  # noqa: BLE001 — device may be wedged
                log.warning(f"watchdog: emergency checkpoint failed "
                            f"({e!r}); resume falls back to the last "
                            f"cadence save")
            finally:
                self.save_lock.release()


class _NonFiniteEscalation(RuntimeError):
    """The non-finite streak hit ``resilience.nonfinite_tolerance`` and no
    restore can stand on it (no checkpoint, or ``max_restores`` spent):
    the run aborts with this diagnosis."""

    def __init__(self, message: str):
        super().__init__(message)


def run(cfg: TrainConfig, logger: Optional[Logger] = None,
        device: DeviceLike = None, learner_params=None) -> TrainState:
    """Top-level entry (reference ``run``): the unique token and sinks,
    then train (or evaluate and exit). Runs on ``cuda`` unless ``device``
    names another (raises when no card is present and none was named).
    ``learner_params`` (``{"agent": ..., "mixer": ...}``) replaces the
    seeded initial params, e.g. weights carried across from flax."""
    logger = logger or Logger()
    cfg = sanity_check(cfg)
    _check_driver_scope(cfg)
    device = resolve_device(device)
    token = unique_token(cfg)
    results_dir = os.path.join(cfg.local_results_path, token)
    if cfg.use_tensorboard:
        logger.setup_tb(os.path.join(cfg.local_results_path, "tb_logs",
                                     token))
    logger.setup_json(results_dir)
    logger.console_logger.info(f"Experiment token: {token}")
    logger.max_history = cfg.obs.stats_history
    rec = obs_spans.make_recorder(cfg.obs, results_dir)
    with rec.span("backend.init"):
        exp = Experiment.build(cfg, device)
    # save_animation alone does NOT divert to evaluation: it enables the
    # in-training animation cadence
    if cfg.evaluate or cfg.save_replay:
        rec.close()
        return evaluate_sequential(exp, logger, results_dir,
                                   learner_params=learner_params)
    return run_sequential(exp, logger, results_dir, rec=rec,
                          learner_params=learner_params)


def run_sequential(exp: Experiment, logger: Logger, results_dir: str,
                   rec=None, learner_params=None) -> TrainState:
    """The train loop (reference ``run_sequential``) on ``exp``'s device."""
    cfg = exp.cfg
    _check_driver_scope(cfg)
    log = logger.console_logger
    if rec is None:
        rec = obs_spans.make_recorder(cfg.obs, results_dir)
    device = exp.device
    env_info = exp.env.get_env_info()
    log.info(f"env_info: {env_info}")
    mw = obs_memwatch.make_memwatch(cfg.obs, rec=rec)
    mw.snapshot("startup", t_env=0)

    found = None
    if cfg.checkpoint_path:
        found = find_checkpoint(cfg.checkpoint_path, cfg.load_step)
        if found is None:
            log.info(f"no checkpoint found in {cfg.checkpoint_path}")
    ts = exp.init_state(cfg.seed, learner_params=learner_params)
    rollout, insert, train_iter = exp.programs()
    K = cfg.superstep if superstep_eligible(cfg) else 1
    if cfg.superstep > 1 and K == 1:
        log.info("superstep requested but ineligible (buffer_cpu_only "
                 "keeps the three-program path)")
    elif K > 1:
        log.info(f"superstep: {K} classic iterations per dispatch")
    key = prng.PRNGKey(cfg.seed + 1, device)

    t_env = 0
    # ---- resume (Q13: t_env cursor restored; the driver key too) -------
    if found is not None:
        dirname, step = found
        # find_checkpoint already hashed this candidate
        ts = load_checkpoint(dirname, ts, verify=False)
        t_env = step
        ts = dataclasses.replace(ts, runner=dataclasses.replace(
            ts.runner, t_env=step))
        saved_key = _key_from_meta(read_meta(dirname), device)
        if saved_key is not None:
            key = saved_key
        log.info(f"resumed from {dirname} at t_env={step}")

    model_dir = os.path.join(cfg.local_results_path, "models",
                             os.path.basename(results_dir))

    # ---- resilience ----------------------------------------------------
    res = cfg.resilience
    guard = (resilience.ShutdownGuard.install() if res.handle_signals
             else resilience.ShutdownGuard())
    nonfinite_streak = 0            # consecutive tripped train steps
    nonfinite_total = 0
    restores = 0                    # guard-triggered checkpoint restores
    # serializes the watchdog thread's emergency save against the main
    # thread's cadence/exit saves (both stage into tmp.<t_env>)
    save_lock = threading.Lock()
    kit = _DriverKit(cfg=cfg, res=res, log=log, rec=rec, mw=mw,
                     guard=guard, model_dir=model_dir, save_lock=save_lock)
    kit.t_env_fn = lambda: t_env
    _persist_flight = kit.persist_flight
    _acquire_save_lock = kit.acquire_save_lock
    _watched = kit.watched
    _dispatch = kit.dispatch

    wd = None
    if res.dispatch_timeout > 0:
        wd = watchdog.Watchdog(
            res.dispatch_timeout, on_stall=kit.stall_response,
            grace_s=res.stall_grace_s, exit_code=res.stall_exit_code,
            first_timeout_s=res.first_dispatch_timeout,
            backend=device.type).start()
        log.info(f"dispatch watchdog armed: timeout="
                 f"{res.dispatch_timeout}s (first occurrence of each "
                 f"phase: {res.first_dispatch_timeout or 'unbounded'}), "
                 f"hard-exit grace={res.stall_grace_s}s "
                 f"(exit {res.stall_exit_code})")
    kit.default_wd = wd
    ladder = watchdog.DegradationLadder(res.max_restores)

    last_test_t = t_env - cfg.test_interval - 1
    last_log_t = t_env
    last_save_t = t_env if t_env else -cfg.save_model_interval - 1
    start_time = last_time = time.time()
    last_log_time = None     # set at the first flush: the first window
    # holds the one-time warm-up and would log a throughput outlier
    last_T = t_env
    n_test_runs = max(1, cfg.test_nepisode // cfg.batch_size_run)
    test_quota = n_test_runs * cfg.batch_size_run        # Q10
    train_infos = []
    train_acc = StatsAccumulator()
    test_acc = StatsAccumulator()
    last_runner_log_t = t_env
    last_anim_t = -cfg.animation_interval - 1
    er_rs = None
    timer = StageTimer()
    tracer = make_trace_window(cfg)
    if rec.enabled:
        rec.mark("run", t_env=t_env, backend=device.type,
                 batch_size_run=cfg.batch_size_run,
                 episode_limit=cfg.env_args.episode_limit,
                 batch_size=cfg.batch_size, superstep=K,
                 host_buffer=False, population=0, scenario="fixed")
    # per-stage device barriers for honest attribution; tracing implies
    # them (an un-synced trace window would capture enqueue, not work)
    sync_stages = cfg.profile_stages or bool(cfg.profile_dir)

    def _sync_device():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # every control scalar of this loop evolves deterministically: t_env
    # advances by B·T a training rollout, the episode counter by B, the
    # ring fill by min(+B, capacity); the host tracks them, and the loop
    # waits on the device only at its cadences and the run-ahead bound
    steps_per_rollout = cfg.batch_size_run * cfg.env_args.episode_limit
    episode = ts.episode
    buffer_filled = ts.buffer.episodes_in_buffer
    buffer_capacity = exp.buffer.capacity
    inflight = deque()              # device events of recent dispatches

    def _restore_checkpoint(dirname, step):
        """Reload a published checkpoint and re-sync every host-side
        mirror of its state (the non-finite escalation and the ladder's
        restore rung). The driver key runs on, as in the JAX driver."""
        nonlocal ts, t_env, episode, buffer_filled, train_infos
        nonlocal last_test_t, last_log_t, last_runner_log_t, last_save_t
        nonlocal nonfinite_streak, train_acc
        ts = load_checkpoint(dirname, ts, verify=False)
        ts = dataclasses.replace(ts, runner=dataclasses.replace(
            ts.runner, t_env=step))
        t_env = step
        episode = ts.episode
        buffer_filled = ts.buffer.episodes_in_buffer
        inflight.clear()
        train_infos = []
        nonfinite_streak = 0
        # pending stats belong to the rolled-back computation; the fetch
        # tally is cumulative and survives
        fetches = train_acc.fetches
        train_acc = StatsAccumulator()
        train_acc.fetches = fetches
        last_test_t = last_log_t = t_env
        last_runner_log_t = last_save_t = t_env

    def _dispatch_ladder(df: watchdog.DispatchFailed) -> None:
        """Rungs above in-place retry: restore the last good checkpoint,
        then abort with the captured diagnosis. The K→1 rung needs the
        fused program (item 8), so it is never taken here."""
        action = ladder.next_action(can_degrade=False)
        logger.log_stat("dispatch_failures", ladder.failures, t_env)
        rec.mark("ladder", action=action, phase=df.phase, t_env=t_env,
                 failures=ladder.failures)
        if action == "restore":
            good = find_checkpoint(model_dir) if cfg.save_model else None
            if good is not None:
                log.warning(f"degradation ladder: {df} — restoring last "
                            f"good checkpoint {good[0]} "
                            f"({ladder.describe()})")
                _restore_checkpoint(*good)
                return
        _persist_flight(os.path.join(model_dir, "flight_recorder.json"))
        diag = wd.take_diagnosis() if wd is not None else None
        raise RuntimeError(
            f"dispatch failure exhausted the degradation ladder at "
            f"t_env={t_env} ({ladder.describe()})"
            + (f"; stall diagnosis: {diag.message()}" if diag else "")
            + ("" if cfg.save_model else
               "; no checkpoints exist to restore (save_model off)")
            + f" — last failure: {df}") from df

    def _sync_point(phase, fn):
        """One blocking sync/fetch boundary, stamped with the loop's
        CURRENT state."""
        return kit.sync_point(phase, fn, _Stamp(ts, key))

    def _save_topology():
        return {"loop": "classic", "superstep": K}

    # signal handlers are process-global state: restore them on EVERY
    # exit (normal, preemption, divergence abort)
    try:
        while t_env <= cfg.t_max:
            # the signal handler only sets a flag; the orderly exit
            # happens here, at a dispatch boundary where ts is complete
            resilience.fire("driver.iteration", t_env=t_env, guard=guard,
                            state=ts, key=key)
            if guard.triggered:
                break
            tracer.maybe_start(t_env)
            if K > 1:
                # ------------ K iterations in one dispatch ---------------
                # the cursor is committed only after the dispatch
                # succeeds, so a retry replays the identical key stream
                cursor = LoopCursor(key=key, t_env=t_env, episode=episode,
                                    buffer_filled=buffer_filled)

                def _fused(ts=ts, cursor=cursor):
                    ts2, c2, recs = run_classic(exp, ts, K, cursor)
                    if sync_stages:
                        _sync_device()
                    return ts2, c2, recs
                try:
                    with timer.stage("superstep"):
                        ts, c2, recs = _dispatch(
                            "dispatch.superstep", _fused, _Stamp(ts, key),
                            k=K)
                except watchdog.DispatchFailed as df:
                    _dispatch_ladder(df)
                    continue
                key, episode, buffer_filled = (c2.key, c2.episode,
                                               c2.buffer_filled)
                t_env += K * steps_per_rollout
                train_infos.extend(r.info for r in recs
                                   if r.info is not None)
                stats = _stack_stats([r.stats for r in recs])
            else:
                # ------------ rollout (no grad by construction) ----------
                def _roll(ts=ts):
                    rs, batch, stats = rollout(ts.learner.params["agent"],
                                               ts.runner)
                    ts = dataclasses.replace(
                        ts, runner=rs, buffer=insert(ts.buffer, batch),
                        episode=ts.episode + cfg.batch_size_run)
                    if sync_stages:
                        _sync_device()
                    return ts, stats
                try:
                    with timer.stage("rollout"):
                        ts, stats = _dispatch("dispatch.rollout", _roll,
                                              _Stamp(ts, key))
                except watchdog.DispatchFailed as df:
                    _dispatch_ladder(df)
                    continue
                t_env += steps_per_rollout
                episode += cfg.batch_size_run
                buffer_filled = min(buffer_filled + cfg.batch_size_run,
                                    buffer_capacity)
                # ------------ train gate ---------------------------------
                if (buffer_filled >= cfg.batch_size
                        and episode >= cfg.accumulated_episodes):
                    key2, k_sample = prng.split(key).unbind(0)

                    def _train_once(ts=ts, k_sample=k_sample):
                        ts, info = train_iter(ts, k_sample, t_env)
                        if sync_stages:
                            _sync_device()
                        return ts, info
                    try:
                        with timer.stage("train"):
                            ts, info = _dispatch("dispatch.train",
                                                 _train_once,
                                                 _Stamp(ts, key))
                    except watchdog.DispatchFailed as df:
                        _dispatch_ladder(df)
                        continue
                    key = key2
                    train_infos.append(info)
            # ONE stats push per dispatch, then the run-ahead bound: wait
            # on the dispatch from two back
            try:
                _sync_point("fetch.train_stats",
                            lambda: train_acc.push(stats))
            except watchdog.DispatchFailed as df:
                _dispatch_ladder(df)
                continue
            if device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
                inflight.append(done)
            if len(inflight) > 2:
                try:
                    _sync_point("dispatch.wait",
                                lambda: inflight.popleft().synchronize())
                except watchdog.DispatchFailed as df:
                    _dispatch_ladder(df)
                    continue
            tracer.tick(logger, t_env)

            # train-stat cadence: runner_log_interval, epsilon alongside
            if t_env - last_runner_log_t >= cfg.runner_log_interval:
                def _flush_train_stats():
                    train_acc.flush(logger, t_env)
                    # cached by the flush's own fold — no second fetch
                    logger.log_stat("epsilon", train_acc.epsilon, t_env)
                try:
                    _sync_point("fetch.train_stats", _flush_train_stats)
                except watchdog.DispatchFailed as df:
                    _dispatch_ladder(df)
                    continue
                last_runner_log_t = t_env

            # ---------------- test cadence ------------------------------
            if (t_env - last_test_t) / cfg.test_interval >= 1.0:
                log.info(f"t_env: {t_env} / {cfg.t_max}")
                log.info(
                    f"Estimated time left: "
                    f"{time_left(last_time, last_T, t_env, cfg.t_max)}. "
                    f"Time passed: {time_str(time.time() - start_time)}")
                last_time, last_T = time.time(), t_env
                try:
                    with timer.stage("test"):
                        for _ in range(n_test_runs):
                            # greedy rollouts on the training runner state:
                            # the same carried envs and key chain
                            def _test_roll(ts=ts):
                                rs, _, s = rollout(
                                    ts.learner.params["agent"], ts.runner,
                                    test_mode=True)
                                return rs, s
                            rs, s = _dispatch("dispatch.test", _test_roll,
                                              _Stamp(ts, key))
                            ts = dataclasses.replace(ts, runner=rs)
                            _sync_point("fetch.test_stats",
                                        lambda s=s: test_acc.push(s))
                            # Q10: flush only on the exact rounded quota
                            if test_acc.n_episodes == test_quota:
                                _sync_point(
                                    "fetch.test_stats",
                                    lambda: test_acc.flush(logger, t_env,
                                                           prefix="test_"))
                except watchdog.DispatchFailed as df:
                    # drop the partial cadence: a sub-quota leftover would
                    # miss the exact-quota flush on every later cadence
                    test_acc = StatsAccumulator()
                    _dispatch_ladder(df)
                    continue
                last_test_t = t_env

            # ---------------- animation cadence -------------------------
            if (cfg.save_animation
                    and (t_env - last_anim_t) / cfg.animation_interval
                    >= 1.0):
                er = exp.episode_runner
                if er_rs is None:
                    er_rs = er.init_state(prng.PRNGKey(cfg.seed + 3,
                                                       device))
                er_rs, _, _, traj = er.run(ts.learner.params["agent"],
                                           er_rs, test_mode=True,
                                           capture_trajectory=True)
                p = er.save_animation(
                    traj, os.path.join(results_dir,
                                       f"animation_{t_env}.gif"))
                if p:
                    log.info(f"animation saved to {p}")
                last_anim_t = t_env

            # ---------------- save cadence ------------------------------
            if (cfg.save_model
                    and (t_env - last_save_t) >= cfg.save_model_interval):
                # the stamp wraps EACH attempt, not the retry loop: a
                # timeout sized for one save must not be eaten by attempt
                # 1's failure + backoff
                def _save_once():
                    with _watched("checkpoint.save", _Stamp(ts, key)):
                        if not _acquire_save_lock("save cadence"):
                            return None
                        try:
                            return save_checkpoint(
                                model_dir, t_env, ts,
                                topology=_save_topology(),
                                driver=_key_meta(key))
                        finally:
                            save_lock.release()
                save_to = watchdog.retry_call(
                    _save_once, attempts=1 + res.dispatch_retries,
                    backoff_s=res.retry_backoff_s, label="checkpoint.save")
                if save_to is not None:
                    log.info(f"Saving models to {save_to}")
                    if res.keep_last:
                        prune_checkpoints(model_dir, res.keep_last,
                                          res.keep_every)
                    mw.snapshot("checkpoint.save", t_env=t_env)
                    # advance the cadence only on a real save
                    last_save_t = t_env

            # ---------------- log cadence -------------------------------
            if (t_env - last_log_t) >= cfg.log_interval:
                if train_infos:
                    # ONE blocking fetch for every flag since the last
                    # cadence and the last info row; after the save
                    # cadence, so the checkpoint just written (finite by
                    # construction: tripped steps are no-ops) is what a
                    # restore wants
                    def _fetch_infos():
                        keys = ("loss", "grad_norm", "td_error_abs",
                                "q_taken_mean", "target_mean")
                        flat = torch.cat([
                            torch.stack([i["all_finite"]
                                         for i in train_infos]).float(),
                            torch.stack([train_infos[-1][k].float()
                                         for k in keys])]).cpu().numpy()
                        n = len(train_infos)
                        return flat[:n] > 0.5, dict(zip(keys, flat[n:]))
                    try:
                        flags, last = _sync_point("fetch.train_infos",
                                                  _fetch_infos)
                    except watchdog.DispatchFailed as df:
                        _dispatch_ladder(df)
                        continue
                    for ok in flags:
                        if ok:
                            nonfinite_streak = 0
                        else:
                            nonfinite_streak += 1
                            nonfinite_total += 1
                    if not flags.all():
                        logger.log_stat("nonfinite_steps", nonfinite_total,
                                        t_env)
                        rec.mark("nonfinite", t_env=t_env,
                                 streak=nonfinite_streak,
                                 total=nonfinite_total)
                        _persist_flight(os.path.join(
                            results_dir, "flight_recorder.json"))
                        log.warning(
                            f"non-finite loss/grads in "
                            f"{int((~flags).sum())}/{len(flags)} train "
                            f"steps since last log (streak="
                            f"{nonfinite_streak}, total={nonfinite_total}); "
                            f"parameter updates were skipped")
                    for k, v in last.items():
                        logger.log_stat(k, float(v), t_env)
                    train_infos = []
                    if (res.nonfinite_tolerance
                            and nonfinite_streak >= res.nonfinite_tolerance):
                        found = (find_checkpoint(model_dir)
                                 if cfg.save_model else None)
                        if found is None or restores >= res.max_restores:
                            raise _NonFiniteEscalation(
                                f"training diverged: {nonfinite_streak} "
                                f"consecutive non-finite train steps at "
                                f"t_env={t_env} (last loss="
                                f"{float(last['loss'])}, grad_norm="
                                f"{float(last['grad_norm'])}), and "
                                + (f"restore limit reached (resilience."
                                   f"max_restores={res.max_restores})"
                                   if found is not None else
                                   "no valid checkpoint exists to restore "
                                   "(save_model off or none written yet)")
                                + " — the NaN source is persistent; "
                                "inspect lr/grad_norm_clip/td_loss before "
                                "rerunning")
                        dirname, step = found
                        log.warning(
                            f"non-finite streak hit resilience."
                            f"nonfinite_tolerance={res.nonfinite_tolerance}"
                            f"; restoring last good checkpoint {dirname} "
                            f"(restore {restores + 1}/{res.max_restores})")
                        _restore_checkpoint(dirname, step)
                        restores += 1
                        nonfinite_streak = 0
                        continue
                if kit.dispatch_faults:
                    logger.log_stat("dispatch_faults",
                                    kit.dispatch_faults, t_env)
                if rec.enabled:
                    # how many blocking stat round-trips the cadences
                    # have cost
                    logger.log_stat("stat_fetches",
                                    train_acc.fetches + test_acc.fetches,
                                    t_env)
                logger.log_stat("episode", episode, t_env)
                # wall-clock throughput including everything (train,
                # logging, cadences)
                now = time.time()
                if last_log_time is not None:
                    rate = ((t_env - last_log_t)
                            / max(now - last_log_time, 1e-9))
                    logger.log_stat("env_steps_per_sec", rate, t_env)
                last_log_time = now
                mw.snapshot("log", t_env=t_env)
                timer.log_and_reset(logger, t_env)
                logger.print_recent_stats()
                last_log_t = t_env

    except BaseException as e:
        # crash path: the flight tail with the failing span last
        rec.mark("crash", t_env=t_env,
                 error=f"{type(e).__name__}: {e}"[:300])
        _persist_flight(os.path.join(results_dir, "flight_recorder.json"))
        rec.close()
        raise
    finally:
        # stop the watchdog FIRST: its hard-exit timer must not kill the
        # process while the orderly emergency checkpoint is written
        if wd is not None:
            wd.stop()
        guard.uninstall()

    if guard.triggered:
        # ---- preemption path: lose at most one dispatch ----------------
        rec.mark("shutdown", t_env=t_env, signame=guard.signame or "")
        _persist_flight(os.path.join(results_dir, "flight_recorder.json"))
        stall = wd.take_diagnosis() if wd is not None else None
        if stall is not None:
            log.warning(f"watchdog: {stall.message()} — the stalled call "
                        f"eventually returned; exiting with the diagnosis "
                        f"persisted to {model_dir}/stall_diagnosis.json")
        log.warning(f"shutdown requested ({guard.signame}) at "
                    f"t_env={t_env} — stopping gracefully")
        if cfg.save_model and res.emergency_checkpoint:
            if _acquire_save_lock("preemption exit"):
                save_to = None
                # the watchdog is stopped: bound the save by a hard
                # deadline instead (watchdog-armed runs only)
                deadline = (watchdog.ExitDeadline(
                                max(res.stall_grace_s, 60.0),
                                res.stall_exit_code,
                                label="preemption-exit emergency "
                                      "checkpoint")
                            if wd is not None else nullcontext())
                try:
                    with deadline:
                        save_to = watchdog.retry_call(
                            lambda: save_checkpoint(
                                model_dir, t_env, ts,
                                topology=_save_topology(),
                                driver=_key_meta(key)),
                            attempts=1 + res.dispatch_retries,
                            backoff_s=res.retry_backoff_s,
                            label="checkpoint.emergency")
                except Exception:  # noqa: BLE001 — exit path stays orderly
                    log.exception(
                        "emergency checkpoint failed on the preemption "
                        "exit — resume falls back to the newest "
                        "published checkpoint")
                finally:
                    save_lock.release()
                if save_to is not None:
                    if res.keep_last:
                        prune_checkpoints(model_dir, res.keep_last,
                                          res.keep_every)
                    log.info(f"emergency checkpoint saved to {save_to}")
        log.info(f"resume with checkpoint_path={model_dir} (newest valid "
                 f"step selected automatically)")
    else:
        log.info("Finished Training")
    rec.close()
    return ts


def evaluate_sequential(exp: Experiment, logger: Logger, results_dir: str,
                        learner_params=None) -> TrainState:
    """Eval/replay/benchmark entry (reference ``evaluate_sequential``):
    greedy episodes on the single-env runner, with optional replay (npz),
    animation (gif, where matplotlib is present) and benchmark CSV
    export. A checkpoint from another config (lane count, ring) falls
    back to the model-only restore."""
    cfg = exp.cfg
    log = logger.console_logger
    ts = exp.init_state(cfg.seed, learner_params=learner_params)
    if cfg.checkpoint_path:
        found = find_checkpoint(cfg.checkpoint_path, cfg.load_step)
        if found is not None:
            dirname, step = found
            try:
                ts = load_checkpoint(dirname, ts, verify=False)
                log.info(f"loaded full state from {dirname}")
            except CheckpointFormatError:
                raise        # unreadable format: no fallback applies
            except ValueError as e:
                log.info(f"full-state restore rejected ({e}); trying "
                         f"model-only restore")
                ts = load_learner_state(dirname, ts)
                log.info(f"loaded learner (model-only) from {dirname}; "
                         f"runner state starts fresh")

    er = exp.episode_runner
    rs = er.init_state(prng.PRNGKey(cfg.seed + 2, exp.device))
    params = ts.learner.params["agent"]

    trajs = []
    returns = []
    for _ in range(cfg.test_nepisode):
        rs, _, stats, traj = er.run(params, rs, test_mode=True,
                                    capture_trajectory=True)
        trajs.append(traj)
        returns.append(float(np.sum(stats.episode_return.cpu().numpy())))
    log.info(f"eval over {len(returns)} episodes: "
             f"return_mean={np.mean(returns):.3f} ± {np.std(returns):.3f}")
    logger.log_stat("test_return_mean", float(np.mean(returns)), 0)

    # in full-evaluate mode only every animation_interval_evaluation-th
    # episode is rendered/animated
    anim_every = max(cfg.animation_interval_evaluation, 1)
    anim_eps = [i for i in range(len(trajs))
                if not cfg.evaluate or i % anim_every == 0]
    if cfg.save_replay:
        for i in anim_eps:
            er.save_replay(trajs[i], os.path.join(
                results_dir, f"replay_episode_{i}.npz"))
        log.info(f"replays saved to {results_dir} ({len(anim_eps)} "
                 f"episodes)")
    if cfg.save_animation:
        p = None
        for i in anim_eps:
            p = er.save_animation(trajs[i], os.path.join(
                results_dir, f"animation_episode_{i}.gif"))
        if p:
            log.info(f"animations saved to {results_dir} "
                     f"({len(anim_eps)} episodes)")
    if cfg.benchmark_mode:
        p = er.benchmark_csv(trajs, os.path.join(results_dir,
                                                 "benchmark.csv"))
        log.info(f"benchmark CSV saved to {p}")
    return ts
