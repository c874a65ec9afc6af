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

``Experiment.superstep_program(k)`` is the fused program of K iterations
(``train/superstep.py``: captured CUDA graphs on the card, its stage
functions eagerly on a CPU device), bit-identical to K iterations of
``run_classic``. ``Experiment.population_superstep_program(k)`` runs K
iterations of every member of a population (``population.size = P``,
``population.py``) a call: one fused program a member, the members on
their own CUDA streams; ``population_rollout_program()`` is the greedy
test rollout of every member.

``run`` is the user's entry (``python -m t2omca_tpu_torch train|evaluate|
benchmark``): results directory, ``metrics.jsonl``, the span recorder,
then ``run_sequential`` (training) or ``evaluate_sequential``.
``run_sequential`` is the JAX driver's classic loop with its cadences
and names: a dispatch of K iterations (K = ``superstep`` where eligible,
else 1; K > 1 is one call of the fused program, ``dispatch.superstep``),
then the runner-log, test, animation, save and log cadences;
resume from ``checkpoint_path``; the non-finite streak and its checkpoint
restore; SIGTERM/SIGINT through ``ShutdownGuard`` with an emergency
checkpoint; the watchdog stamping every device-facing region and the
bounded retry of transient failures (never a swap to the plain kernels
or the CPU); the degradation ladder (K→1, restore, abort); with
``obs.pulse_port`` the live plane (``obs/pulse.py``:
``/metrics``, ``/healthz`` with the watchdog, guard and detector checks,
``/trace`` and the ``PULSE_TRACE`` file trigger), and with
``obs.sight.enabled`` the learning-health detectors (``obs/sight.py``)
over the log cadence's one fetch of the train info.

Under a population (JAX ``run_sequential``'s population branch) the loop
holds the P member states and the ``PopulationSpec``: every dispatch is
one call of the population program (even at ``superstep: 1``; the K→1
rung rebuilds it at K = 1), the driver keeps P key streams split like the
solo one from the one gate mirror, the stats and info carry a leading
``(P,)`` axis (``pop<i>_*`` rows at P > 1, the across-member mean under
the aggregate names), a step counts as finite only if every member's
was, the test cadence runs each member's greedy rollout, checkpoints and
watchdog stamps hold a ``PopState``, and with ``population.pbt.enabled``
PBT runs after each cadence save (``population.pbt_step``, the
``pbt_copies`` row and the ``pbt`` flight mark).

Where the port differs from the JAX driver:

* **The fused program writes its state in place** (JAX donates it): a
  fused dispatch is never retried in place, its watchdog stamp carries
  no state (a stall cannot save what the stalled replays are writing),
  and after a failure that began writing, the ladder skips the K→1 rung
  (JAX's "consumed the donated state"). A restore hands its state to
  the program, which copies it into the captured buffers.
* **The driver key is checkpointed** (``meta.json`` ``driver.key``): a
  resumed run draws the keys a run that never stopped would draw (the
  JAX driver restarts its key at ``PRNGKey(seed + 1)`` on resume). The
  non-finite restore keeps the live key, as in JAX.
* The learner's params cannot come from the JAX key chain (flax's
  initializers are not ported): they are drawn from a ``torch.Generator``
  seeded with ``seed``, or handed in (``learner_params=``, e.g. carried
  across from flax with ``convert.py``).

With ``obs.program_trace`` the ``profile_dir`` window is an
``obs/device_time.ProgramTraceWindow``: the trace's device time by named
program (the ``record_function`` ranges of ``Experiment.programs`` and
``train/superstep.py``) lands in ``device_ms_<program>`` rows and
``<run_dir>/device_times.json``; a pulse trace capture refreshes that
file too.

With ``replay.buffer_cpu_only`` the ring lives in host RAM
(``components/host_replay.py``, JAX's host branches): the state's
``buffer`` is None and checkpoints hold no ring, insert and sample are
host calls (their dispatches are not retried in place), the train gate
asks the buffer, a restore drops its deferred priority feedback, and the
fused superstep is ineligible (``superstep_eligible``).

Left out, to later slices: data parallelism, Sebulba and the population
across them or under another size at restore (item 12). Each raises
naming its item.
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
from torch.profiler import record_function

from . import population as pop
from . import prng
from .components.episode_buffer import (PrioritizedReplayBuffer,
                                        ReplayBuffer)
from .components.host_replay import HostReplayBuffer
from .config import TrainConfig, sanity_check, unique_token
from .controllers.basic_mac import MAC_REGISTRY
from .device import DeviceLike, resolve_device
from .envs.registry import make_env, scenario_config
from .learners.qmix_learner import LEARNER_REGISTRY
from .obs import memwatch as obs_memwatch
from .obs import pulse as obs_pulse
from .obs import sight as obs_sight
from .obs import spans as obs_spans
from .ops.query_slice import entity_store_eligible
from .runners.episode_runner import EpisodeRunner
from .runners.parallel_runner import RUNNER_REGISTRY
from .train.program import (TrainState, build_host_train_iter,
                            build_train_iter)
from .train.superstep import PopulationProgram, SuperstepProgram
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


#: the learner values the log cadence writes itself (the sight_* leaves
#: are the monitor's to log)
LOG_KEYS = ("loss", "grad_norm", "td_error_abs", "q_taken_mean",
            "target_mean")


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
        if cfg.sebulba.actor_devices:
            raise _not_ported("Sebulba (sebulba.actor_devices)", "item 12")
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
                      store_dtype=cfg.replay.store_dtype, device=device)
        if cfg.replay.buffer_cpu_only:
            # host-RAM replay with the device-side PER sample
            buffer = HostReplayBuffer(
                alpha=cfg.replay.per_alpha, beta0=cfg.replay.per_beta,
                t_max=cfg.t_max, prioritized=cfg.replay.prioritized,
                **buf_kw)
        elif cfg.replay.prioritized:
            buffer = PrioritizedReplayBuffer(
                alpha=cfg.replay.per_alpha, beta0=cfg.replay.per_beta,
                t_max=cfg.t_max, compact_obs=entity_store_eligible(cfg),
                **buf_kw)
        else:
            buffer = ReplayBuffer(compact_obs=entity_store_eligible(cfg),
                                  **buf_kw)
        return cls(cfg=cfg, env=env, mac=mac, learner=learner,
                   runner=runner, buffer=buffer, device=device)

    @property
    def host_buffer(self) -> bool:
        """Whether the replay lives in host RAM (``buffer_cpu_only``)."""
        return isinstance(self.buffer, HostReplayBuffer)

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
        return TrainState(learner=ls,
                          buffer=None if self.host_buffer
                          else self.buffer.init(),
                          episode=torch.zeros((), dtype=torch.int32,
                                              device=self.device),
                          runner=self.runner.init_state(k_runner))

    def programs(self):
        """→ (rollout, insert, train_iter), each inside a
        ``record_function`` range of its JAX program name (the names
        ``obs/device_time.py`` attributes device time to). With the ring
        in host RAM, insert and sample are host calls (the state's
        ``buffer`` stays None) and ``train_iter`` hands its key to the
        learner unsplit, as JAX's host path does."""
        runner, buffer = self.runner, self.buffer
        step = (build_host_train_iter(buffer, self.learner, self.cfg)
                if self.host_buffer else
                build_train_iter(buffer, self.learner, self.cfg))
        if self.host_buffer:
            _insert = lambda state, batch: buffer.insert_episode_batch(batch)
        else:
            _insert = buffer.insert_episode_batch

        def rollout(params, rs, test_mode: bool = False):
            with record_function("rollout"):
                return runner.run(params, rs, test_mode=test_mode)

        def insert(state, batch):
            with record_function("insert"):
                return _insert(state, batch)

        def train_iter(ts, key, t_env, **kw):
            with record_function("train_iter"):
                return step(ts, key, t_env, **kw)

        return rollout, insert, train_iter

    def superstep_program(self, k: int) -> SuperstepProgram:
        """→ the fused program of ``k`` iterations (``train/superstep.py``):
        ``superstep(ts, keys, t_env0, gated) -> (ts', stacked_stats,
        stacked_infos)``, the JAX program's arguments plus the host
        mirror's gates."""
        return SuperstepProgram(self, k)

    def population_superstep_program(self, k: int) -> PopulationProgram:
        """→ the population's fused program of ``k`` iterations
        (``train/superstep.py`` ``PopulationProgram``): ``pop(pts, keys,
        t_env0, gated, spec) -> (pts', stats, infos)`` with ``(P, K, 2)``
        keys and ``(P, ...)``-leading outputs. A neutral one-member
        population runs the solo program without the spec seams, as JAX
        does."""
        return PopulationProgram(self, k,
                                 neutral=pop.spec_is_neutral(self.cfg))

    def population_rollout_program(self):
        """→ ``pop_test(pts) -> (runner states, stats)``: the greedy test
        rollout of each member, eagerly, one after another (JAX vmaps
        ``run_raw(test_mode=True)``, without the spec seams); the stats
        stacked on a leading ``(P,)`` axis."""
        runner = self.runner

        def pop_test(pts):
            with record_function("rollout"):
                outs = [runner.run_raw(t.learner.params["agent"], t.runner,
                                       test_mode=True) for t in pts]
            first = outs[0][2]
            stats = type(first)(**{
                f.name: torch.stack([torch.as_tensor(getattr(o[2], f.name),
                                                     device=self.device)
                                     for o in outs])
                for f in dataclasses.fields(first)})
            return [o[0] for o in outs], stats

        return pop_test


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


def _key_meta(key) -> dict:
    """The driver key as ``meta.json`` stores it (a population's P keys
    under ``keys``)."""
    if isinstance(key, list):
        return {"keys": [[int(x) for x in k.tolist()] for k in key]}
    return {"key": [int(x) for x in key.tolist()]}


def _key_from_meta(meta: dict, device, population: int = 0):
    """The checkpointed driver key, or a population's P keys; None where
    the checkpoint holds none of that form (a single-member checkpoint
    lifted into a population starts from ``member_keys``)."""
    drv = meta.get("driver", {})
    if population:
        keys = drv.get("keys")
        if keys is None or len(keys) != population:
            return None
        return [torch.tensor(k, dtype=torch.int64, device=device)
                for k in keys]
    key = drv.get("key")
    return (None if key is None else
            torch.tensor(key, dtype=torch.int64, device=device))



def _check_driver_scope(cfg: TrainConfig) -> None:
    """Raise for what the port's driver does not have yet."""
    if cfg.dp_devices:
        raise _not_ported("dp_devices (the data-parallel mesh)", "item 12")
    if cfg.sebulba.actor_devices:
        raise _not_ported("Sebulba (sebulba.actor_devices)", "item 12")


class _DriverKit:
    """The driver's helper kit (the JAX ``_DriverKit`` of the classic
    loop): watchdog stamps, fault-handled dispatch, sync points, the
    stall response, flight persist and the bounded save lock."""

    def __init__(self, *, cfg, res, log, rec, mw, sight_mon, guard,
                 model_dir, save_lock):
        self.cfg, self.res, self.log, self.rec = cfg, res, log, rec
        self.mw, self.sight_mon, self.guard = mw, sight_mon, guard
        self.model_dir, self.save_lock = model_dir, save_lock
        self.default_wd = None      # armed by the driver once built
        self.t_env_fn = lambda: 0   # the loop re-binds its cursor
        self.dispatch_faults = 0    # transient dispatch errors seen (stats)

    # ------------------------------------------------------------ telemetry

    def persist_flight(self, path: str) -> None:
        """Flight persist + the memwatch high-water and sight-verdict
        blocks (cached state only — safe on crash/stall paths over a
        wedged device)."""
        extra = {}
        if self.mw.enabled:
            extra["memwatch"] = self.mw.report()
        if self.sight_mon is not None:
            extra["sight"] = self.sight_mon.report()
        self.rec.persist(path, extra=extra or None)

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

    def dispatch(self, phase, fn, state, t=None, retryable=True,
                 **context):
        """One device-facing dispatch: fault-injection hook + watchdog
        stamp + bounded in-place retry with backoff of transient-classified
        failures (the callers commit their host mirrors only after
        success, so a retry replays an identical dispatch). Deterministic
        errors propagate at once; exhausted retries raise
        ``DispatchFailed`` for the ladder. ``retryable=False`` (the fused
        program, which writes its state in place) sends the first
        transient failure to the ladder. Nothing here falls back to
        another kernel or device."""
        res = self.res
        if t is None:
            t = self.t_env_fn()
        attempts = (1 + res.dispatch_retries) if retryable else 1
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
        dispatch's episodes: the save is a valid state (cursor and
        counters are the stamped ones), not bit for bit the pre-dispatch
        ring. A fused dispatch stamps no state (it writes all of it in
        place), so its stall saves nothing."""
        cfg, res, log = self.cfg, self.res, self.log
        extra = {}
        if self.rec.enabled:
            try:
                extra["recent_spans"] = self.rec.tail()
            except Exception:  # noqa: BLE001 — diagnostics only
                log.exception("flight tail unavailable")
        if self.mw.enabled:
            extra["memwatch"] = self.mw.report()
        if self.sight_mon is not None:
            extra["sight"] = self.sight_mon.report()
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
    ``learner_params`` (``{"agent": ..., "mixer": ...}``, or under a
    population a list of P such pairs, one a member) replaces the seeded
    initial params, e.g. weights carried across from flax."""
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
    """The train loop (reference ``run_sequential``) on ``exp``'s device.
    → the final ``TrainState``, or under a population the
    ``population.PopState`` of the members and the spec."""
    cfg = exp.cfg
    _check_driver_scope(cfg)
    log = logger.console_logger
    # the population axis (population.py): P member states and the spec;
    # P = 0 leaves the loop below as it was
    P = pop.population_size(cfg)
    if rec is None:
        rec = obs_spans.make_recorder(cfg.obs, results_dir)
    device = exp.device
    env_info = exp.env.get_env_info()
    log.info(f"env_info: {env_info}")
    mw = obs_memwatch.make_memwatch(cfg.obs, rec=rec)
    mw.snapshot("startup", t_env=0)
    # the learning-health monitor: None when obs.sight is off
    sight_mon = obs_sight.make_monitor(cfg.obs, logger=logger, rec=rec,
                                       population=P)

    found = None
    if cfg.checkpoint_path:
        found = find_checkpoint(cfg.checkpoint_path, cfg.load_step)
        if found is None:
            log.info(f"no checkpoint found in {cfg.checkpoint_path}")
    spec = None
    if P:
        ts, spec = pop.init_population(exp, cfg, learner_params)
        log.info(f"population of {P} members per dispatch (seeds "
                 f"{pop.member_seeds(cfg)}, pbt="
                 f"{'on' if cfg.population.pbt.enabled else 'off'})")
    else:
        ts = exp.init_state(cfg.seed, learner_params=learner_params)
    rollout, insert, train_iter = exp.programs()

    def _build_superstep(k):
        return (exp.population_superstep_program(k) if P
                else exp.superstep_program(k))

    # the fused superstep (config.superstep, docs/SPEC.md §8): K > 1
    # swaps the three-program iteration for one fused dispatch of K; a
    # population always dispatches its program, even at K = 1
    K = cfg.superstep if superstep_eligible(cfg) else 1
    pop_test = None
    if P:
        K = max(cfg.superstep, 1)
        superstep = _build_superstep(K)
        pop_test = exp.population_rollout_program()
        log.info(f"population superstep: {P} members x {K} iterations "
                 f"per dispatch")
    else:
        superstep = _build_superstep(K) if K > 1 else None
    if cfg.superstep > 1 and K == 1:
        log.info("superstep requested but ineligible (buffer_cpu_only "
                 "keeps the three-program path)")
    elif K > 1 and not P:
        log.info(f"fused superstep: {K} iterations per dispatch")
    # one driver key chain, or one a member (each split as the solo one)
    key = (pop.member_keys(cfg, device) if P
           else prng.PRNGKey(cfg.seed + 1, device))

    def _ckpt_state():
        """What checkpoints and watchdog stamps hold: the state, or a
        population's ``PopState`` (the spec is PBT's and resumes with
        the members it shaped)."""
        return pop.PopState(ts=ts, spec=spec) if P else ts

    def _set_t_env(state, step):
        return dataclasses.replace(state, runner=dataclasses.replace(
            state.runner, t_env=step))

    t_env = 0
    # ---- resume (Q13: t_env cursor restored; the driver key too) -------
    if found is not None:
        dirname, step = found
        # find_checkpoint already hashed this candidate; a single-member
        # checkpoint lifts into a population (utils/checkpoint.py)
        restored = load_checkpoint(dirname, _ckpt_state(), verify=False)
        if P:
            ts = [_set_t_env(t, step) for t in restored.ts]
            spec = restored.spec
        else:
            ts = _set_t_env(restored, step)
        t_env = step
        saved_key = _key_from_meta(read_meta(dirname), device, P)
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
                     sight_mon=sight_mon, guard=guard, model_dir=model_dir,
                     save_lock=save_lock)
    # the pre-dispatch state a watchdog stamp holds, as a checkpoint
    # would (a PopState under a population)
    _stamp = lambda: _Stamp(_ckpt_state(), key)   # noqa: E731
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
    # Q10; a population tests all P members a cadence, so the quota of
    # the accumulator's total episodes scales by P
    test_quota = n_test_runs * cfg.batch_size_run * max(P, 1)
    train_infos = []
    train_acc = StatsAccumulator(population=P)
    test_acc = StatsAccumulator(population=P)
    last_runner_log_t = t_env
    last_anim_t = -cfg.animation_interval - 1
    er_rs = None
    timer = StageTimer()
    tracer = make_trace_window(cfg, results_dir)
    if rec.enabled:
        rec.mark("run", t_env=t_env, backend=device.type,
                 batch_size_run=cfg.batch_size_run,
                 episode_limit=cfg.env_args.episode_limit,
                 batch_size=cfg.batch_size, superstep=K,
                 host_buffer=exp.host_buffer, population=P,
                 scenario=scenario_config(cfg.env_args).kind)
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
    lead = ts[0] if P else ts
    episode = int(lead.episode)
    # a host ring gates on its own count (can_sample)
    buffer_filled = (0 if exp.host_buffer
                     else int(lead.buffer.episodes_in_buffer))
    del lead
    buffer_capacity = 0 if exp.host_buffer else exp.buffer.capacity
    inflight = deque()              # device events of recent dispatches

    def _restore_checkpoint(dirname, step):
        """Reload a published checkpoint and re-sync every host-side
        mirror of its state (the non-finite escalation and the ladder's
        restore rung). The driver key runs on, as in the JAX driver."""
        nonlocal ts, t_env, episode, buffer_filled, train_infos
        nonlocal last_test_t, last_log_t, last_runner_log_t, last_save_t
        nonlocal nonfinite_streak, train_acc, spec
        restored = load_checkpoint(dirname, _ckpt_state(), verify=False)
        if P:
            ts = [_set_t_env(t, step) for t in restored.ts]
            spec = restored.spec
            lead = ts[0]
        else:
            ts = lead = _set_t_env(restored, step)
        t_env = step
        episode = int(lead.episode)
        if exp.host_buffer:
            # the deferred priority copies came from the rolled-back step
            exp.buffer.drop_pending_update()
        else:
            buffer_filled = int(lead.buffer.episodes_in_buffer)
        inflight.clear()
        train_infos = []
        nonfinite_streak = 0
        # pending stats belong to the rolled-back computation; the fetch
        # tally is cumulative and survives
        fetches = train_acc.fetches
        train_acc = StatsAccumulator(population=P)
        train_acc.fetches = fetches
        last_test_t = last_log_t = t_env
        last_runner_log_t = last_save_t = t_env

    def _dispatch_ladder(df: watchdog.DispatchFailed,
                         can_degrade: Optional[bool] = None) -> None:
        """Rungs above in-place retry: superstep K→1 (drop the graphs, go
        on with the classic loop), restore the last good checkpoint,
        abort with the captured diagnosis. Callers ``continue`` after it
        returns (their host mirrors were never committed). Pass
        ``can_degrade=False`` from sync/fetch points, where only restore
        can stand; a fused dispatch that failed after it began writing
        its state in place cannot degrade either (JAX's consumed donated
        state)."""
        nonlocal K, superstep
        if can_degrade is None:
            can_degrade = (K > 1 and res.degrade_superstep
                           and not (superstep is not None
                                    and superstep.consumed))
        action = ladder.next_action(can_degrade=can_degrade)
        logger.log_stat("dispatch_failures", ladder.failures, t_env)
        rec.mark("ladder", action=action, phase=df.phase, t_env=t_env,
                 failures=ladder.failures)
        if action == "degrade":
            log.warning(f"degradation ladder: {df} — falling back "
                        f"superstep K={K} -> 1 ({ladder.describe()})")
            K = 1
            if superstep is not None:
                superstep.close()
            # a population goes on through its program, rebuilt at K = 1
            # (the classic path has no population)
            superstep = _build_superstep(1) if P else None
            logger.log_stat("superstep_k", 1, t_env)
            if pulse is not None:
                pulse.set("superstep_k", 1)
            return
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
        return kit.sync_point(phase, fn, _stamp())

    def _save_topology():
        return {"loop": "classic", "superstep": K,
                "fused": superstep is not None}

    # the live plane and the on-demand trace trigger: None when their
    # config is off, and the loop below is then unchanged. Bound just
    # before the loop's try, whose finally closes it
    pulse = obs_pulse.make_pulse(cfg.obs, rec=rec, log=log)
    trc = (obs_pulse.TraceController(
               results_dir, rec=rec,
               hub=pulse.hub if pulse is not None else None,
               n_iterations=cfg.profile_iterations)
           if (rec.enabled or pulse is not None) else None)
    if pulse is not None:
        # the watchdog rows are read per scrape (visible while the main
        # thread is wedged); /healthz degrades the moment a stall fires,
        # the guard trips or a detector trips (sight-<detector>)
        if wd is not None:
            pulse.wire_watchdog(wd)
        pulse.wire_guard(guard)
        pulse.set("superstep_k", K)
        pulse.set("backend_info", 1, backend=device.type)
        if sight_mon is not None:
            sight_mon.wire_pulse(pulse.hub)

    # signal handlers are process-global state: restore them on EVERY
    # exit (normal, preemption, divergence abort)
    try:
        while t_env <= cfg.t_max:
            # the signal handler only sets a flag; the orderly exit
            # happens here, at a dispatch boundary where ts is complete
            resilience.fire("driver.iteration", t_env=t_env, guard=guard,
                            state=_ckpt_state(), key=key)
            if guard.triggered:
                break
            if pulse is not None:
                pulse.tick_iteration(t_env, episode)
            if trc is not None:
                # the PULSE_TRACE file / /trace endpoint trigger: one
                # os.path.exists when idle
                trc.poll(t_env)
            tracer.maybe_start(t_env)
            if superstep is not None:
                # ------------ fused superstep (one dispatch = K iters) ---
                # the host mirrors the counters of the K sub-iterations
                # (they evolve deterministically), so it knows which
                # train: it splits the driver key only for those, as the
                # classic loop does, and keeps their info rows. Committed
                # only after the dispatch succeeds
                # Under a population `key` is a list of P member streams:
                # the gate mirror is computed once and each member's
                # stream splits as the solo one does (member 0's is the
                # solo run's)
                ep2, fill2 = episode, buffer_filled
                key2 = list(key) if P else key
                key_rows, gated = [], []
                for _ in range(K):
                    ep2 += cfg.batch_size_run
                    fill2 = min(fill2 + cfg.batch_size_run,
                                buffer_capacity)
                    g = (fill2 >= cfg.batch_size
                         and ep2 >= cfg.accumulated_episodes)
                    gated.append(g)
                    if P:
                        row = []
                        for m in range(P):
                            if g:
                                key2[m], k_s = prng.split(key2[m]).unbind(0)
                                row.append(k_s)
                            else:
                                row.append(torch.zeros_like(key2[m]))
                        key_rows.append(torch.stack(row))
                    elif g:
                        key2, k_sample = prng.split(key2).unbind(0)
                        key_rows.append(k_sample)
                    else:
                        key_rows.append(torch.zeros_like(key2))

                def _fused(ts=ts, key_rows=key_rows, gated=gated):
                    if P:
                        # (P, K, 2): each member reads its own (K,) rows
                        out = superstep(ts, torch.stack(key_rows, dim=1),
                                        t_env, gated, spec)
                    else:
                        out = superstep(ts, torch.stack(key_rows), t_env,
                                        gated)
                    if sync_stages:
                        _sync_device()
                    return out
                try:
                    with timer.stage("superstep"):
                        # written in place: no in-place retry, and no
                        # state in the stamp (see the module docstring)
                        ts, stats, infos = _dispatch(
                            "dispatch.superstep", _fused, None,
                            retryable=False, k=K)
                except watchdog.DispatchFailed as df:
                    _dispatch_ladder(df)
                    continue
                key, episode, buffer_filled = key2, ep2, fill2
                t_env += K * steps_per_rollout
                # a population's infos lead with the (P,) member axis,
                # the K sub-iterations next
                train_infos.extend(
                    {k: (v[:, i] if P else v[i]) for k, v in infos.items()}
                    for i, g in enumerate(gated) if g)
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
                        # a host ring's insert writes host RAM inside
                        # fn: not replayable in place
                        ts, stats = _dispatch("dispatch.rollout", _roll,
                                              _stamp(),
                                              retryable=not exp.host_buffer)
                except watchdog.DispatchFailed as df:
                    _dispatch_ladder(df)
                    continue
                t_env += steps_per_rollout
                episode += cfg.batch_size_run
                buffer_filled = min(buffer_filled + cfg.batch_size_run,
                                    buffer_capacity)
                # ------------ train gate ---------------------------------
                can = (exp.buffer.can_sample(cfg.batch_size)
                       if exp.host_buffer
                       else buffer_filled >= cfg.batch_size)
                if can and episode >= cfg.accumulated_episodes:
                    key2, k_sample = prng.split(key).unbind(0)

                    def _train_once(ts=ts, k_sample=k_sample):
                        ts, info = train_iter(ts, k_sample, t_env)
                        if sync_stages:
                            _sync_device()
                        return ts, info
                    try:
                        with timer.stage("train"):
                            # host sampling advances the host RNG inside
                            # fn: not replayable in place
                            ts, info = _dispatch(
                                "dispatch.train", _train_once, _stamp(),
                                retryable=not exp.host_buffer)
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
                _dispatch_ladder(df, can_degrade=False)
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
                    _dispatch_ladder(df, can_degrade=False)
                    continue
            tracer.tick(logger, t_env)
            if trc is not None:
                trc.tick(logger, t_env)

            # train-stat cadence: runner_log_interval, epsilon alongside
            if t_env - last_runner_log_t >= cfg.runner_log_interval:
                def _flush_train_stats():
                    train_acc.flush(logger, t_env)
                    # cached by the flush's own fold — no second fetch
                    logger.log_stat("epsilon", train_acc.epsilon, t_env)
                try:
                    _sync_point("fetch.train_stats", _flush_train_stats)
                except watchdog.DispatchFailed as df:
                    _dispatch_ladder(df, can_degrade=False)
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
                                if P:
                                    # every member's greedy rollout
                                    return pop_test(ts)
                                rs, _, s = rollout(
                                    ts.learner.params["agent"], ts.runner,
                                    test_mode=True)
                                return rs, s
                            rs, s = _dispatch("dispatch.test", _test_roll,
                                              _stamp())
                            ts = ([dataclasses.replace(t, runner=r)
                                   for t, r in zip(ts, rs)] if P else
                                  dataclasses.replace(ts, runner=rs))
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
                    test_acc = StatsAccumulator(population=P)
                    _dispatch_ladder(df, can_degrade=False)
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
                    with _watched("checkpoint.save", _stamp()):
                        if not _acquire_save_lock("save cadence"):
                            return None
                        try:
                            return save_checkpoint(
                                model_dir, t_env, _ckpt_state(),
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
                    if P and cfg.population.pbt.enabled:
                        # PBT at save boundaries only, after the save:
                        # the checkpoint holds the population before it.
                        # The ranking is the accumulator's per-member
                        # return EMA, host state that is not checkpointed
                        ts, spec, pbt_info = pop.pbt_step(
                            cfg, ts, spec, train_acc.member_return_ema,
                            t_env)
                        if pbt_info is not None:
                            logger.log_stat("pbt_copies",
                                            len(pbt_info["copied"]), t_env)
                            rec.mark("pbt", t_env=t_env, **pbt_info)
                            log.info(f"population PBT: exploited "
                                     f"{pbt_info['copied']} at "
                                     f"t_env={t_env}")

            # ---------------- log cadence -------------------------------
            if (t_env - last_log_t) >= cfg.log_interval:
                if train_infos:
                    # ONE blocking fetch for every flag since the last
                    # cadence and the last info row (its sight_* leaves
                    # too); after the save cadence, so the checkpoint
                    # just written (finite by construction: tripped
                    # steps are no-ops) is what a restore wants
                    def _fetch_infos():
                        last = train_infos[-1]
                        keys = LOG_KEYS + tuple(
                            sorted(k for k in last if k.startswith("sight_")))
                        flags = torch.stack([i["all_finite"]
                                             for i in train_infos]).float()
                        flat = torch.cat(
                            [flags.reshape(-1)]
                            + [last[k].float().reshape(-1)
                               for k in keys]).cpu().numpy()
                        n = flags.numel()
                        out, at = {}, n
                        for k in keys:
                            size = last[k].numel()
                            out[k] = flat[at:at + size].reshape(
                                last[k].shape)
                            at += size
                        # (n, P) member flags under a population: a step
                        # is finite only if every member's update was
                        return (flat[:n].reshape(len(train_infos), -1)
                                > 0.5).all(axis=1), out
                    try:
                        flags, last = _sync_point("fetch.train_infos",
                                                  _fetch_infos)
                    except watchdog.DispatchFailed as df:
                        _dispatch_ladder(df, can_degrade=False)
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
                    for k in LOG_KEYS:
                        if P:
                            # the aggregate row is the members' mean, a
                            # pop<i>_ row each at P > 1 (P = 1 keeps the
                            # solo stream)
                            v = np.asarray(last[k], np.float64)
                            logger.log_stat(k, float(v.mean()), t_env)
                            if P > 1:
                                for m in range(P):
                                    logger.log_stat(f"pop{m}_{k}",
                                                    float(v[m]), t_env)
                        else:
                            logger.log_stat(k, float(last[k]), t_env)
                    if sight_mon is not None:
                        # the detector pass over the SAME fetched info
                        # (the monitor logs the sight_* stats); a fresh
                        # trip persists the flight ring, as a non-finite
                        # trip does
                        with rec.span("sight.detect", t_env=t_env):
                            trips = sight_mon.observe(last, t_env)
                        if trips:
                            log.warning(
                                f"graftsight: detector(s) tripped at "
                                f"t_env={t_env}: {', '.join(trips)} — "
                                f"/healthz degraded; run `python -m "
                                f"t2omca_tpu_torch.obs learning "
                                f"{results_dir}` for the read")
                            _persist_flight(os.path.join(
                                results_dir, "flight_recorder.json"))
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
                                f"{float(np.mean(last['loss']))}, grad_norm="
                                f"{float(np.mean(last['grad_norm']))}), and "
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
                    if pulse is not None:
                        pulse.set("env_steps_per_sec", rate)
                last_log_time = now
                # memwatch phase boundary + the live plane's cadence
                # gauges
                pulse_snap = mw.snapshot("log", t_env=t_env)
                if pulse is not None:
                    pulse.set("nonfinite_streak", nonfinite_streak)
                    pulse.set("nonfinite_total", nonfinite_total)
                    pulse.set("dispatch_faults", kit.dispatch_faults)
                    pulse.set("ladder_failures", ladder.failures)
                    pulse.set("restores", restores)
                    pulse.set("superstep_k", K)
                    pulse.set_memwatch(pulse_snap)
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
        if pulse is not None:
            pulse.close()       # bounded; frees the port for a next run
        if superstep is not None:
            superstep.close()   # the graphs' memory pool

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
                                model_dir, t_env, _ckpt_state(),
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
    return _ckpt_state()


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
