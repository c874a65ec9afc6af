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

With ``dp_devices: N`` the run is one of N ranks of a process group
(``parallel/``: ``torch.distributed``, NCCL or gloo) and trains as
JAX's ``DataParallel`` does: ``Experiment.build(cfg, comm=...)`` holds
the rank's env lanes and ring slots, born sharded; the learner state,
counters and priorities are replicated, bit-identical on every rank; the
sample, the loss and every logged value are global. The driver's loop
is the same on every rank, in lockstep:

* rank 0 alone writes the logs, metrics, spans, traces and checkpoints
  and serves the pulse plane (the others log warnings only); every rank
  runs its watchdog;
* a save gathers every sharded leaf to rank 0 (``DataParallel.gather``),
  which writes the file a one-card run writes, with the topology stamp
  (``process_count``, ``device_count``, ``mesh_shape``); a resume, at any
  rank count, reads the global file and keeps the rank's part
  (``utils/elastic.resume_state``); before each save the replicated
  leaves are checked equal across ranks (``DataParallel.digest``);
* the non-finite restore happens on every rank at once, because the
  finite flags are global;
* SIGTERM on any rank: every rank votes at the top of every dispatch
  (``parallel.distributed.peer_shutdown_requested``), so all of them stop
  at one negotiated ``t_env``, save one checkpoint together and exit 0;
* a failed dispatch is never retried in place and the degradation
  ladder aborts: a rank cannot retry or restore alone while its peers
  wait in a collective. The rank exits with the diagnosis, its peers'
  next collective fails (gloo at once, NCCL at its timeout) or the
  launcher ends them, and the run resumes from its last checkpoint;
* the watchdog's emergency save is skipped (it would need the peers'
  collectives from the watchdog's thread); the diagnosis is written.

Under ``dp_devices`` the driver takes every option JAX's
``DataParallel`` takes. With ``superstep > 1`` a dispatch is one call of
the fused program on every rank (``train/superstep.py``: on the card
each stage is captured as segments split at the rank's collectives), so
the preemption vote, the stop step, the save's gather and the digest
check fall at dispatch boundaries: a SIGTERM loses at most K iterations,
as in JAX. The rollout stats are gathered once a dispatch. The probes
log the global batch's values and rank 0 alone runs the monitor;
dropout draws each rank's rows of the global masks; NoisyNet's noise is
per parameter, the same draw on every rank.

**The shard save.** When the preemption barrier failed (a peer missed
it) or the collective emergency save raised, each rank writes its own
state as a shard of the step's set instead (``checkpoint.
save_checkpoint_shards``, under a ``checkpoint.shard_save`` span) and the
exit stays orderly; a resume takes the set once every shard landed, at
any rank count. In one process the set is 1-of-1.

**A population under** ``dp_devices: N`` (JAX's population-over-dp)
places whole members: rank r holds the members
``parallel.mesh.member_blocks(P, N)[r]`` (``PopulationParallel``), each
built, initialized, keyed and dispatched exactly as the one-card
population does it (``PopulationProgram(members=...)``: each member keeps
its global id for its seed, keys, scenario salt and spec row), with no
collective inside a dispatch. The experiment is built without the rank's
``comm`` (a member's lanes are not split). The host collectives, all
through the control group, are: the log cadence's gather of the members'
info rows and of their rollout stats (``utils/stats.GatheredStats``;
rank 0 logs every member's ``pop<i>_*`` rows and runs the per-member
sight monitor), the save's gather of every member to rank 0 in the
one-card population layout (so a checkpoint written at N ranks restores
at 1, in one process, and under another P), and PBT's cross-rank copies
(``population.pbt_step``). The preemption vote, the stop step and the
ladder are dp's.
"""

from __future__ import annotations

import dataclasses
import logging
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
from .parallel import distributed as dp_dist
from .parallel.mesh import (DataParallel, PopulationParallel, RankComm,
                            partition_devices)
from .runners.episode_runner import EpisodeRunner
from .runners.parallel_runner import RUNNER_REGISTRY
from .train.program import (TrainState, build_host_train_iter,
                            build_train_iter)
from .train.superstep import PopulationProgram, SuperstepProgram
from .utils import elastic, resilience, watchdog
from .utils.checkpoint import (CheckpointFormatError, find_checkpoint,
                               load_checkpoint, load_learner_state,
                               prune_checkpoints, read_meta,
                               save_checkpoint, save_checkpoint_shards)
from .utils.logging import Logger
from .utils.profiling import StageTimer, make_trace_window
from .utils.stats import GatheredStats, StatsAccumulator
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


def sebulba_eligible(cfg: TrainConfig) -> bool:
    """Whether the Sebulba decoupled actor/learner loop serves this config
    (``parallel/sebulba.py``): ``sebulba.actor_devices > 0`` opts in, and
    ``sanity_check`` has already refused what it cannot take."""
    return cfg.sebulba.actor_devices > 0


@dataclasses.dataclass(frozen=True)
class Experiment:
    cfg: TrainConfig
    env: object
    mac: object
    learner: object
    runner: object
    buffer: object
    device: torch.device
    #: a data-parallel rank's collectives (``parallel.mesh.RankComm``):
    #: the runner, the ring and the learner then hold the rank's part
    comm: object = None

    @classmethod
    def build(cls, cfg: TrainConfig, device: DeviceLike = None,
              comm=None) -> "Experiment":
        """Everything on ``device`` (``cuda`` unless named; raises when
        no card is present and none was named). ``comm``: this rank's
        collectives under data parallelism (``parallel/mesh.py``)."""
        device = resolve_device(device)
        env = make_env(cfg.env_args, device, cfg.prng_impl)
        env_info = env.get_env_info()
        mac = MAC_REGISTRY[cfg.mac].build(cfg, env_info, device)
        learner = LEARNER_REGISTRY[cfg.learner].build(cfg, mac, env_info,
                                                      device)
        runner = RUNNER_REGISTRY[cfg.runner](env, mac, cfg)
        if comm is not None:
            learner = dataclasses.replace(learner, comm=comm)
            runner = dataclasses.replace(runner, comm=comm)
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
                comm=comm, **buf_kw)
        else:
            buffer = ReplayBuffer(compact_obs=entity_store_eligible(cfg),
                                  comm=comm, **buf_kw)
        return cls(cfg=cfg, env=env, mac=mac, learner=learner,
                   runner=runner, buffer=buffer, device=device, comm=comm)

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
            prng.PRNGKey(seed, self.device, self.cfg.prng_impl),
            2, self.cfg.prng_impl).unbind(0)
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

    def population_superstep_program(self, k: int, members=None
                                     ) -> PopulationProgram:
        """→ the population's fused program of ``k`` iterations
        (``train/superstep.py`` ``PopulationProgram``): ``pop(pts, keys,
        t_env0, gated, spec) -> (pts', stats, infos)`` with ``(P, K, 2)``
        keys and ``(P, ...)``-leading outputs. A neutral one-member
        population runs the solo program without the spec seams, as JAX
        does. ``members`` (global ids) runs those members only (a
        data-parallel rank's)."""
        return PopulationProgram(self, k,
                                 neutral=pop.spec_is_neutral(self.cfg),
                                 members=members)

    def population_rollout_program(self):
        """→ ``pop_test(pts) -> (runner states, stats)``: the greedy test
        rollout of each member, eagerly, one after another (JAX vmaps
        ``run_raw(test_mode=True)``, without the spec seams); the stats
        stacked on a leading ``(P,)`` axis."""
        runner = self.runner

        def pop_test(pts):
            # under an RngBitGenerator impl every member draws its rows of
            # member 0's draws (JAX's vmap; prng.seat)
            seated = len(pts) > 1 and self.cfg.prng_impl != "threefry"
            leads = [prng.seat(pts[0].runner.key, m) if seated else None
                     for m in range(len(pts))]
            with record_function("rollout"):
                outs = [runner.run_raw(t.learner.params["agent"], t.runner,
                                       test_mode=True, lead=lead)
                        for t, lead in zip(pts, leads)]
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
        cursor = LoopCursor(key=prng.PRNGKey(cfg.seed + 1, exp.device,
                                             cfg.prng_impl))
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
            key2, k_sample = prng.split(c.key, 2, cfg.prng_impl).unbind(0)
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


def _log_info_rows(logger, last: dict, population: int, t_env: int) -> None:
    """The ``LOG_KEYS`` rows of the last train info: under a population
    the aggregate row is the members' mean and each member has a
    ``pop<i>_`` row at P > 1 (P = 1 keeps the solo stream)."""
    for k in LOG_KEYS:
        if population:
            v = np.asarray(last[k], np.float64)
            logger.log_stat(k, float(v.mean()), t_env)
            if population > 1:
                for m in range(population):
                    logger.log_stat(f"pop{m}_{k}", float(v[m]), t_env)
        else:
            logger.log_stat(k, float(last[k]), t_env)


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



class _DriverKit:
    """The driver's helper kit (the JAX ``_DriverKit`` of the classic
    loop): watchdog stamps, fault-handled dispatch, sync points, the
    stall response, flight persist and the bounded save lock."""

    _UNSET = object()

    def __init__(self, *, cfg, res, log, rec, mw, sight_mon, guard,
                 model_dir, save_lock, dp=None, wake=None):
        self.cfg, self.res, self.log, self.rec = cfg, res, log, rec
        self.mw, self.sight_mon, self.guard = mw, sight_mon, guard
        self.model_dir, self.save_lock = model_dir, save_lock
        self.dp = dp                # DataParallel of a rank, else None
        # the Sebulba loop's queue-condition notifier, fired by the stall
        # response so a thread blocked on the queue sees the guard trip
        self.wake = wake
        # armed by the classic driver once built; the Sebulba loop leaves
        # it None and passes each thread's watchdog (``awd=``)
        self.default_wd = None
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

    def watched(self, phase, state=None, t=None, awd=_UNSET, **meta):
        """One watchdog stamp (outer) + span (inner) for a device-facing
        region; a no-op context when both are off. ``awd``: the watchdog
        to stamp (default ``default_wd``; None: span only)."""
        wd = self.default_wd if awd is _DriverKit._UNSET else awd
        if t is None:
            t = self.t_env_fn()
        w = wd.watch(phase, t_env=t, state=state) if wd is not None else None
        if self.rec.enabled:
            s = self.rec.span(phase, t_env=t, **meta)
            return obs_spans.stacked(w, s) if w is not None else s
        return w if w is not None else nullcontext()

    # ------------------------------------------------------------ dispatch

    def dispatch(self, phase, fn, state, t=None, retryable=True,
                 awd=_UNSET, **context):
        """One device-facing dispatch: fault-injection hook + watchdog
        stamp + bounded in-place retry with backoff of transient-classified
        failures (the callers commit their host mirrors only after
        success, so a retry replays an identical dispatch). Deterministic
        errors propagate at once; exhausted retries raise
        ``DispatchFailed`` for the ladder. ``retryable=False`` (the fused
        program, which writes its state in place) sends the first
        transient failure to the ladder, and so does every dispatch of a
        data-parallel rank (its peers wait in a collective). Nothing here
        falls back to another kernel or device."""
        res = self.res
        if t is None:
            t = self.t_env_fn()
        retryable = retryable and self.dp is None
        attempts = (1 + res.dispatch_retries) if retryable else 1
        for attempt in range(1, attempts + 1):
            try:
                with self.watched(phase, state, t=t, awd=awd,
                                  attempt=attempt, **context):
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
        place), so its stall saves nothing, and neither does a
        data-parallel rank (the save is a collective), nor the Sebulba
        loop (its programs write their state in place too)."""
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
        if self.wake is not None:
            self.wake()
        if (cfg.save_model and res.emergency_checkpoint
                and self.dp is None
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
        device: DeviceLike = None, learner_params=None,
        share_cards: bool = False) -> TrainState:
    """Top-level entry (reference ``run``): the unique token and sinks,
    then train (or evaluate and exit). Runs on ``cuda`` unless ``device``
    names another (raises when no card is present and none was named).
    ``learner_params`` (``{"agent": ..., "mixer": ...}``, or under a
    population a list of P such pairs, one a member) replaces the seeded
    initial params, e.g. weights carried across from flax.

    With ``dp_devices: N`` (training) this process must be a rank of an
    initialized process group of N ranks (the CLI launches them, as does
    ``torchrun``; ``parallel.maybe_initialize_distributed`` joins one):
    the run takes the rank's device from it, and the ranks share rank 0's
    token.

    With ``sebulba.actor_devices`` (training) the devices are split into
    the actor and learner sets first (``parallel.mesh.partition_devices``:
    a card each, or with ``share_cards`` a CUDA stream each on one card;
    on the CPU every set is the CPU) and the experiment is built on the
    learner's."""
    logger = logger or Logger()
    cfg = sanity_check(cfg)
    train = not (cfg.evaluate or cfg.save_replay)
    P = pop.population_size(cfg)
    if (P > 1 and cfg.prng_impl != "threefry" and train
            and (cfg.dp_devices or sebulba_eligible(cfg))):
        # JAX vmaps the members, and rng_bit_generator's batching rule
        # draws every member's numbers from member 0's keys: one process
        # seats its members on member 0's (prng.seat), but a rank or a
        # placement without member 0 has no member 0 to draw from
        raise _not_ported(f"prng_impl '{cfg.prng_impl}' with a population "
                          f"of {P} over ranks or Sebulba placements",
                          "item 16, JAX's rng_bit_generator vmap rule "
                          "across members")
    comm = placements = None
    if cfg.dp_devices and train:
        device, comm = _join_ranks(cfg, device)
    elif sebulba_eligible(cfg) and train:
        sb = cfg.sebulba
        placements = partition_devices(sb.actor_devices, sb.learner_devices,
                                       devices=device,
                                       share_cards=share_cards)
        device = placements[1][0].device
    else:
        device = resolve_device(device)
    main = comm is None or comm.rank == 0
    token = unique_token(cfg)
    if comm is not None:
        token = dp_dist.broadcast_object(token)
    results_dir = os.path.join(cfg.local_results_path, token)
    if main:
        if cfg.use_tensorboard:
            logger.setup_tb(os.path.join(cfg.local_results_path,
                                         "tb_logs", token))
        logger.setup_json(results_dir)
    else:
        # the peers' rows would repeat rank 0's: they log warnings only
        logger.console_logger.setLevel(logging.WARNING)
    logger.console_logger.info(f"Experiment token: {token}")
    if comm is not None:
        logger.console_logger.info(
            f"data-parallel: {comm.world} ranks over "
            f"{dp_dist.backend()} (rank 0 on {device}"
            + (", ranks share cards)" if dp_dist.shares_cards() else ")")
            + (f", a population of {P}: {P // comm.world} whole members "
               f"a rank" if P else ""))
    logger.max_history = cfg.obs.stats_history
    rec = obs_spans.make_recorder(cfg.obs if main else None, results_dir)
    with rec.span("backend.init"):
        # a population's members are whole on each rank: their lanes,
        # ring and learner are a one-card member's
        exp = Experiment.build(cfg, device, comm=None if P else comm)
    # save_animation alone does NOT divert to evaluation: it enables the
    # in-training animation cadence
    if cfg.evaluate or cfg.save_replay:
        rec.close()
        return evaluate_sequential(exp, logger, results_dir,
                                   learner_params=learner_params)
    return run_sequential(exp, logger, results_dir, rec=rec,
                          learner_params=learner_params,
                          placements=placements, share_cards=share_cards,
                          comm=comm if P else None)


def _join_ranks(cfg: TrainConfig, device: DeviceLike):
    """→ (this rank's device, its ``RankComm``) of a data-parallel run;
    raises unless the process group has ``dp_devices`` ranks."""
    if not dp_dist.is_initialized():
        raise RuntimeError(
            f"dp_devices={cfg.dp_devices} trains as {cfg.dp_devices} "
            f"processes: launch it with `python -m t2omca_tpu_torch train` "
            f"(which starts the ranks) or torchrun, or join each process "
            f"with parallel.maybe_initialize_distributed() first")
    if dp_dist.world_size() != cfg.dp_devices:
        raise ValueError(f"dp_devices={cfg.dp_devices} but the process "
                         f"group has {dp_dist.world_size()} ranks "
                         f"(WORLD_SIZE must equal dp_devices)")
    rank_dev = dp_dist.rank_device()
    if device is not None and torch.device(device).type != rank_dev.type:
        raise ValueError(f"device {device} asked for, but this rank joined "
                         f"its process group on {rank_dev}")
    return rank_dev, RankComm()


def run_sequential(exp: Experiment, logger: Logger, results_dir: str,
                   rec=None, learner_params=None, placements=None,
                   share_cards: bool = False, comm=None) -> TrainState:
    """The train loop (reference ``run_sequential``) on ``exp``'s device.
    → the final ``TrainState``, or under a population the
    ``population.PopState`` of the members and the spec (of this rank's
    members under population × dp, whose ``RankComm`` is ``comm``). With
    ``sebulba.actor_devices`` the decoupled loop runs instead
    (``run_sebulba``; ``placements`` and ``share_cards`` are its)."""
    cfg = exp.cfg
    if sebulba_eligible(cfg):
        # the decoupled actor/learner loop: its own loop shape below
        return run_sebulba(exp, logger, results_dir, rec=rec,
                           learner_params=learner_params,
                           placements=placements, share_cards=share_cards)
    log = logger.console_logger
    # the population axis (population.py): P member states and the spec;
    # P = 0 leaves the loop below as it was
    P = pop.population_size(cfg)
    # a data-parallel rank (exp built with its comm): rank 0 alone writes
    # the run's files and serves the live plane. Under a population the
    # rank holds whole members instead (pp), with the same votes
    dp = DataParallel(exp) if exp.comm is not None else None
    pp = PopulationParallel(P, comm) if comm is not None else None
    ranks = dp if dp is not None else pp
    main = ranks is None or ranks.comm.rank == 0
    dp_topology = (dp.topology() if dp is not None else
                   pp.topology(exp.device) if pp is not None else {})
    # the global ids of the members this process holds (all P on one card)
    ids = pp.members if pp is not None else list(range(P))
    obs_cfg = cfg.obs if main else None
    if rec is None:
        rec = obs_spans.make_recorder(obs_cfg, results_dir)
    device = exp.device
    env_info = exp.env.get_env_info()
    log.info(f"env_info: {env_info}")
    mw = obs_memwatch.make_memwatch(obs_cfg, rec=rec)
    mw.snapshot("startup", t_env=0)
    # the learning-health monitor: None when obs.sight is off
    # (under population × dp rank 0 observes every member's gathered rows)
    sight_mon = (obs_sight.make_monitor(cfg.obs, logger=logger, rec=rec,
                                        population=P)
                 if main else None)

    found = None
    if cfg.checkpoint_path:
        # rank 0 hashes the candidates; every rank restores its choice
        found = (find_checkpoint(cfg.checkpoint_path, cfg.load_step)
                 if main else None)
        if ranks is not None:
            found = dp_dist.broadcast_object(found)
        if found is None:
            log.info(f"no checkpoint found in {cfg.checkpoint_path}")
    spec = None
    if P:
        ts, spec = pop.init_population(exp, cfg, learner_params,
                                       members=ids)
        log.info(f"population of {P} members per dispatch (seeds "
                 f"{pop.member_seeds(cfg)}, pbt="
                 f"{'on' if cfg.population.pbt.enabled else 'off'})"
                 + (f"; this rank holds members {ids}" if pp else ""))
    else:
        # under dp each rank's state is born sharded (its lanes and slots)
        ts = exp.init_state(cfg.seed, learner_params=learner_params)
    rollout, insert, train_iter = exp.programs()

    def _build_superstep(k):
        return (exp.population_superstep_program(
                    k, members=ids if pp is not None else None) if P
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
    key = ([pop.member_keys(cfg, device)[m] for m in ids] if P
           else prng.PRNGKey(cfg.seed + 1, device, cfg.prng_impl))

    def _ckpt_state():
        """What checkpoints and watchdog stamps hold: the state, or a
        population's ``PopState`` (the spec is PBT's and resumes with
        the members it shaped; a rank's holds its members)."""
        return (pop.PopState(ts=ts, spec=spec,
                             members=ids if pp is not None else None)
                if P else ts)

    def _set_t_env(state, step):
        return dataclasses.replace(state, runner=dataclasses.replace(
            state.runner, t_env=step))

    t_env = 0
    # ---- resume (Q13: t_env cursor restored; the driver key too) -------
    if found is not None:
        dirname, step = found
        # find_checkpoint already hashed this candidate; a single-member
        # checkpoint lifts into a population (utils/checkpoint.py), and a
        # data-parallel rank keeps its part of the global state
        restored = elastic.resume_state(
            dirname, _ckpt_state(), verify=False,
            topology=dict({"loop": "classic"}, **dp_topology),
            place=None if dp is None else dp.place,
            prng_impl=cfg.prng_impl)
        if P:
            ts = [_set_t_env(t, step) for t in restored.ts]
            spec = restored.spec
        else:
            ts = _set_t_env(restored, step)
        t_env = step
        saved_key = _key_from_meta(read_meta(dirname), device, P)
        if saved_key is not None:
            key = [saved_key[m] for m in ids] if P else saved_key
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
                     save_lock=save_lock, dp=ranks)
    # coordinated preemption under dp: the negotiated cut step, and
    # whether every rank met the barrier
    stop_at, stop_ok = None, True
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
    # a data-parallel rank has no rung above the retry: it aborts
    ladder = watchdog.DegradationLadder(0 if ranks is not None
                                        else res.max_restores)

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

    def _accumulator():
        """The stats accumulator: under population × dp the rank's
        members' stats gathered to rank 0 at each flush."""
        return (GatheredStats(pp, exp.device) if pp is not None
                else StatsAccumulator(population=P))
    train_acc = _accumulator()
    test_acc = _accumulator()
    last_runner_log_t = t_env
    last_anim_t = -cfg.animation_interval - 1
    er_rs = None
    timer = StageTimer()
    tracer = make_trace_window(cfg if main else cfg.replace(profile_dir=""),
                               results_dir)
    if rec.enabled:
        rec.mark("run", t_env=t_env, backend=device.type,
                 batch_size_run=cfg.batch_size_run,
                 episode_limit=cfg.env_args.episode_limit,
                 batch_size=cfg.batch_size, superstep=K,
                 host_buffer=exp.host_buffer, population=P,
                 scenario=scenario_config(cfg.env_args).kind,
                 **({"dp_ranks": ranks.comm.world,
                     "dp_backend": dp_dist.backend()} if ranks else {}))
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
        restored = load_checkpoint(dirname, _ckpt_state(), verify=False,
                                   place=None if dp is None else dp.place,
                                   prng_impl=cfg.prng_impl)
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
        train_acc = _accumulator()
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
            # a data-parallel rank does not degrade alone either
            can_degrade = (K > 1 and res.degrade_superstep
                           and ranks is None
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
            + ("; a data-parallel rank neither retries nor restores "
               "alone (its peers wait in a collective): resume the run "
               "from its last checkpoint" if ranks is not None else "")
            + f" — last failure: {df}") from df

    def _sync_point(phase, fn):
        """One blocking sync/fetch boundary, stamped with the loop's
        CURRENT state."""
        return kit.sync_point(phase, fn, _stamp())

    def _save_topology():
        """The stamp's driver facts; under a population the members best
        first by their return EMA once every member has one (what an
        elastic shrink keeps; rank 0's accumulator holds every member's
        under population × dp)."""
        topo = dict({"loop": "classic", "superstep": K,
                     "fused": superstep is not None}, **dp_topology)
        ranking = (pop.member_ranking(train_acc.member_return_ema)
                   if P else None)
        if ranking is not None:
            topo["member_ranking"] = ranking
        return topo

    def _write_checkpoint():
        """One checkpoint at ``t_env`` → its path (None where skipped).
        Under dp a collective: the replicated leaves are checked equal
        across ranks, the sharded ones gathered to rank 0, which writes
        the one-card layout; every rank learns the path. Under population
        × dp rank 0 gathers every member (and every member's key)."""
        state, keys = _ckpt_state(), key
        if dp is not None:
            dp.digest(state)
            state = dp.gather(state)
        elif pp is not None:
            state = pp.gather(state)
            keys = [torch.tensor(k) for part in pp.all_gather(
                [k.tolist() for k in key]) for k in part]
        path, err = None, None
        try:
            if main:
                path = save_checkpoint(model_dir, t_env, state,
                                       topology=_save_topology(),
                                       driver=_key_meta(keys))
        except Exception as e:  # noqa: BLE001 — re-raised below
            err = e
        if ranks is not None:
            path = dp_dist.broadcast_object(path)
        if err is not None:
            raise err
        return path

    def _write_shard():
        """The degraded save: this rank's own state as its shard of the
        step's set, with no collective (1-of-1 in one process). The stamp
        leaves out what only rank 0 knows (the member ranking), so every
        rank writes the same ``meta.json``."""
        topo = _save_topology()
        if ranks is not None:
            topo.pop("member_ranking", None)
        return save_checkpoint_shards(
            model_dir, t_env, _ckpt_state(),
            shard=0 if ranks is None else ranks.comm.rank,
            shards=1 if ranks is None else ranks.comm.world,
            sharded=None if dp is None else dp.sharded,
            topology=topo, driver=_key_meta(key))

    # the live plane and the on-demand trace trigger: None when their
    # config is off, and the loop below is then unchanged. Bound just
    # before the loop's try, whose finally closes it
    pulse = obs_pulse.make_pulse(obs_cfg, rec=rec, log=log)
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
            if ranks is not None:
                # every rank votes here, so a SIGTERM on any of them
                # stops all of them at this t_env (parallel/distributed)
                if (dp_dist.peer_shutdown_requested(guard.triggered)
                        and not guard.triggered):
                    guard.request("peer")
                if guard.triggered:
                    if stop_at is None:
                        if guard.signame != "peer":
                            dp_dist.announce_shutdown(t_env)
                        with rec.span("preempt.barrier", t_env=t_env):
                            stop_at, stop_ok = dp_dist.negotiate_stop_step(
                                t_env, res.preempt_barrier_timeout_s)
                    if not stop_ok or t_env >= stop_at:
                        break
            elif guard.triggered:
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
                        for m in range(len(key2)):
                            if g:
                                key2[m], k_s = prng.split(
                                    key2[m], 2, cfg.prng_impl).unbind(0)
                                row.append(k_s)
                            else:
                                row.append(torch.zeros_like(key2[m]))
                        key_rows.append(torch.stack(row))
                    elif g:
                        key2, k_sample = prng.split(
                            key2, 2, cfg.prng_impl).unbind(0)
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
                    key2, k_sample = prng.split(
                        key, 2, cfg.prng_impl).unbind(0)

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
                    test_acc = _accumulator()
                    _dispatch_ladder(df, can_degrade=False)
                    continue
                last_test_t = t_env

            # ---------------- animation cadence -------------------------
            if (main and cfg.save_animation
                    and (t_env - last_anim_t) / cfg.animation_interval
                    >= 1.0):
                er = exp.episode_runner
                if er_rs is None:
                    er_rs = er.init_state(prng.PRNGKey(cfg.seed + 3, device,
                                                       cfg.prng_impl))
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
                            return _write_checkpoint()
                        finally:
                            save_lock.release()
                # a collective save is not retried one-sidedly
                save_to = watchdog.retry_call(
                    _save_once, attempts=(1 + res.dispatch_retries
                                          if ranks is None else 1),
                    backoff_s=res.retry_backoff_s, label="checkpoint.save")
                if save_to is not None:
                    log.info(f"Saving models to {save_to}")
                    if res.keep_last and main:
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
                        # (rank 0 holds every member's EMA under
                        # population × dp: every rank decides from it)
                        perf = train_acc.member_return_ema
                        if pp is not None:
                            perf = dp_dist.broadcast_object(perf)
                        ts, spec, pbt_info = pop.pbt_step(
                            cfg, ts, spec, perf, t_env,
                            members=ids, placement=pp)
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
                        # (n, P) member flags under a population
                        return flat[:n].reshape(len(train_infos), -1), out
                    try:
                        flags, last = _sync_point("fetch.train_infos",
                                                  _fetch_infos)
                    except watchdog.DispatchFailed as df:
                        _dispatch_ladder(df, can_degrade=False)
                        continue
                    if pp is not None:
                        # every member's rows, in member order, on every
                        # rank (the restore decision is global)
                        every = pp.all_gather((flags, last))
                        flags = np.concatenate([e[0] for e in every], 1)
                        last = {k: np.concatenate([e[1][k] for e in every])
                                for k in last}
                    # a step is finite only if every member's update was
                    flags = (flags > 0.5).all(axis=1)
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
                    _log_info_rows(logger, last, P, t_env)
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
                        if not stop_ok:
                            log.warning(
                                "a peer rank missed the preemption "
                                "barrier: the collective emergency "
                                "checkpoint is skipped; each rank writes "
                                "its own shard")
                        else:
                            # an orderly exit stays orderly: a collective
                            # save that fails degrades to the shard save
                            try:
                                save_to = watchdog.retry_call(
                                    _write_checkpoint,
                                    attempts=(1 + res.dispatch_retries
                                              if ranks is None else 1),
                                    backoff_s=res.retry_backoff_s,
                                    label="checkpoint.emergency")
                            except Exception:  # noqa: BLE001
                                log.exception(
                                    "collective emergency checkpoint "
                                    "failed (a peer died mid-gather?) — "
                                    "degrading to the per-rank shard save")
                        if save_to is None:
                            # no collective: cannot hang on a dead peer;
                            # a resume takes the set once every shard
                            # landed (utils/checkpoint.py)
                            with rec.span("checkpoint.shard_save",
                                          t_env=t_env):
                                save_to = _write_shard()
                except Exception:  # noqa: BLE001 — exit path stays orderly
                    log.exception(
                        "emergency checkpoint failed on the preemption "
                        "exit — resume falls back to the newest "
                        "published checkpoint")
                finally:
                    save_lock.release()
                if save_to is not None:
                    if res.keep_last and main:
                        prune_checkpoints(model_dir, res.keep_last,
                                          res.keep_every)
                    log.info(f"emergency checkpoint saved to {save_to}")
        log.info(f"resume with checkpoint_path={model_dir} (newest valid "
                 f"step selected automatically)")
    else:
        log.info("Finished Training")
    rec.close()
    return _ckpt_state()


def run_sebulba(exp: Experiment, logger: Logger, results_dir: str,
                rec=None, learner_params=None, placements=None,
                share_cards: bool = False) -> TrainState:
    """The Sebulba decoupled train loop (JAX ``run_sebulba``): rollout and
    training on disjoint placements (``parallel/sebulba.py``) with a
    bounded trajectory queue between them, so neither phase idles the
    other's.

    Two host threads enqueue the work:

    * the **actor thread** (``t2omca-sebulba-actor``) adopts the newest
      published params under the ``sebulba.staleness`` bound
      (``params.sync``), runs every shard's rollout (``actor.dispatch``,
      which ends in the shards' barrier, so its span is the rollout's
      device time), puts the emission into the queue with backpressure
      (``queue.put``), and owns the train-stat and test cadences (the test
      cadence drains the queue and adopts the freshest params first, as
      the classic loop tests after the iteration's train step);
    * the **learner (main) thread** gets each batch into the ring
      (``queue.get``), mirrors the train gate and splits the driver key
      exactly as the classic loop does, trains (``learner.dispatch``,
      which ends in the learner stream's barrier), publishes the params,
      and owns the log and save cadences, the non-finite escalation, the
      ladder and every exit path.

    Each thread has its own watchdog. The programs write their state in
    place, so no dispatch is retried in place and no stamp holds state: a
    failure goes to the ladder, whose rungs are restore (the actor thread
    torn down, the newest checkpoint copied into the programs' state, a
    fresh epoch) and abort; there is no superstep to degrade. A stall
    writes the diagnosis and trips the ``ShutdownGuard``, and the run
    ends with the actor thread gone and a resumable checkpoint.

    Checkpoints hold the ``TrainState`` a classic run saves (the runner's
    lanes in global order, the driver key), stamped ``{"loop": "sebulba",
    "sebulba": {...}}``: a classic run resumes a Sebulba save and the other
    way round. Lockstep (``queue_slots=1, staleness=0``) is bit-identical
    to the classic loop at any actor-set size.

    A learner set of n placements (``sebulba.learner_devices: n``) trains
    as ``dp_devices: n`` does, inside this process: placement r holds the
    ring rows ``r::n`` and a replica of the learner, each placement's step
    runs in its own thread, and the collectives between them are a
    ``parallel.mesh.PlacementGroup``'s; lockstep at n actor and n learner
    placements is bit-identical to the classic loop at n ranks. The learner
    thread drives the set as it drives one placement, with the same rows,
    cadences, ladder and exits; a save checks the placements' replicated
    leaves equal and gathers the ring into the one-card layout, which
    resumes at any learner-set size, under dp and under the classic loop.
    When the emergency save raises, the exit writes the state as a 1-of-1
    shard set instead (``checkpoint.save_checkpoint_shards``).

    Under a population (lockstep only, no PBT: ``sanity_check``) the
    programs are ``parallel/sebulba.PopulationSebulba``'s: every member's
    rollout on its actor placement, its learner step on its learner
    placement (whole members a placement), in member order, each member's
    key stream split as the classic population loop splits it; the
    cadences, stats and checkpoints are the classic population loop's (a
    ``PopState``)."""
    from .parallel.sebulba import make_sebulba
    cfg = exp.cfg
    sb = cfg.sebulba
    P = pop.population_size(cfg)
    log = logger.console_logger
    if rec is None:
        rec = obs_spans.make_recorder(cfg.obs, results_dir)
    device = exp.device
    pulse = obs_pulse.make_pulse(cfg.obs, rec=rec, log=log)
    mw = obs_memwatch.make_memwatch(cfg.obs, rec=rec)
    mw.snapshot("startup", t_env=0)
    trc = (obs_pulse.TraceController(
               results_dir, rec=rec,
               hub=pulse.hub if pulse is not None else None,
               n_iterations=cfg.profile_iterations)
           if (rec.enabled or pulse is not None) else None)
    sight_mon = obs_sight.make_monitor(cfg.obs, logger=logger, rec=rec,
                                       population=P)

    seb = make_sebulba(exp, placements, share_cards=share_cards)
    lp = seb.learner_place
    lockstep = sb.queue_slots == 1 and sb.staleness == 0
    log.info(f"sebulba decoupled loop: {seb.describe()}, queue_slots="
             f"{sb.queue_slots}, staleness={sb.staleness}"
             + (" (lockstep)" if lockstep else ""))

    res = cfg.resilience
    guard = (resilience.ShutdownGuard.install() if res.handle_signals
             else resilience.ShutdownGuard())
    model_dir = os.path.join(cfg.local_results_path, "models",
                             os.path.basename(results_dir))
    save_lock = threading.Lock()
    spr = cfg.batch_size_run * cfg.env_args.episode_limit
    n_test_runs = max(1, cfg.test_nepisode // cfg.batch_size_run)
    test_quota = n_test_runs * cfg.batch_size_run * max(P, 1)
    buffer_capacity = exp.buffer.capacity
    actor_step, queue_put, queue_get, learner_step = seb.programs()
    topology = {"loop": "sebulba",
                "sebulba": {"actor_devices": sb.actor_devices,
                            "learner_devices": sb.learner_devices}}

    # ---- cross-thread cells (under `cond`) ------------------------------
    cond = threading.Condition()
    cell = {"rs": None,          # a finished copy of the shards' runners
            "version": 0}        # the newest published params version
    counters = {"put": 0, "got": 0, "consumed": 0, "started": 0}
    idle = {"actor_s": 0.0, "learner_s": 0.0}
    stop_event = threading.Event()
    actor_failure = []
    nonfinite_streak = 0
    nonfinite_total = 0
    restores = 0

    def _wake():
        with cond:
            cond.notify_all()
    kit = _DriverKit(cfg=cfg, res=res, log=log, rec=rec, mw=mw,
                     sight_mon=sight_mon, guard=guard, model_dir=model_dir,
                     save_lock=save_lock, wake=_wake)
    _persist_flight = kit.persist_flight
    _acquire_save_lock = kit.acquire_save_lock
    _watched = kit.watched
    _dispatch = kit.dispatch

    found = None
    if cfg.checkpoint_path:
        found = find_checkpoint(cfg.checkpoint_path, cfg.load_step)
        if found is None:
            log.info(f"no checkpoint found in {cfg.checkpoint_path}")

    def _snapshot_state() -> TrainState:
        """The latest complete state: the learner side as the main thread
        left it, the runners as the actor's last rollout left them (a
        ``PopState`` under a population)."""
        with cond:
            rss = cell["rs"]
        return seb.join(rss)

    def _on_actor_stall(diag) -> None:
        kit.stall_response(diag, tag="watchdog-actor")

    wd = wd_actor = None
    if res.dispatch_timeout > 0:
        wd = watchdog.Watchdog(
            res.dispatch_timeout, on_stall=kit.stall_response,
            grace_s=res.stall_grace_s, exit_code=res.stall_exit_code,
            first_timeout_s=res.first_dispatch_timeout,
            backend=device.type).start()
        wd_actor = watchdog.Watchdog(
            res.dispatch_timeout, on_stall=_on_actor_stall,
            grace_s=res.stall_grace_s, exit_code=res.stall_exit_code,
            first_timeout_s=res.first_dispatch_timeout,
            backend=device.type).start()
        log.info(f"dispatch watchdogs armed (actor + learner): timeout="
                 f"{res.dispatch_timeout}s, grace={res.stall_grace_s}s")
    ladder = watchdog.DegradationLadder(res.max_restores)
    if pulse is not None:
        if wd is not None:
            pulse.wire_watchdog(wd, side="learner")
        if wd_actor is not None:
            pulse.wire_watchdog(wd_actor, side="actor")
        pulse.wire_guard(guard)
        pulse.set("backend_info", 1, backend=device.type)
        pulse.set("queue_slots", sb.queue_slots)
        pulse.set("staleness_bound", sb.staleness)
        if sight_mon is not None:
            sight_mon.wire_pulse(pulse.hub)

    train_acc = StatsAccumulator(population=P)
    test_acc = StatsAccumulator(population=P)

    def _stopping() -> bool:
        return stop_event.is_set() or guard.triggered

    # ---- the actor thread ------------------------------------------------
    def _actor_loop(t_env0):
        a_t = t_env0
        last_test_t = a_t - cfg.test_interval - 1
        last_runner_log_t = t_env0
        try:
            while a_t <= cfg.t_max and not _stopping():
                # params.sync: never act more than `staleness` batches ahead
                # of the learner (span only: the wait is the learner's
                # progress, not the device's health)
                with _watched("params.sync", t=a_t, awd=None):
                    resilience.fire("params.sync", t_env=a_t)
                    with cond:
                        while (counters["started"] - counters["consumed"]
                               > sb.staleness and not _stopping()):
                            t0 = time.monotonic()
                            cond.wait(0.05)
                            idle["actor_s"] += time.monotonic() - t0
                        if _stopping():
                            break
                        seb.adopt(cell["version"])
                tms, stats = _dispatch("actor.dispatch", actor_step, None,
                                       t=a_t, retryable=False,
                                       awd=wd_actor)
                a_t += spr
                rss = seb.runner_snapshot()
                with cond:
                    counters["started"] += 1
                    cell["rs"] = rss
                _dispatch("fetch.train_stats",
                          lambda: train_acc.push(stats), None, t=a_t,
                          retryable=False, awd=wd_actor)

                # queue.put: wait for a free slot (backpressure: span only,
                # a full queue is the learner being slower)
                with _watched("queue.put", t=a_t, awd=None):
                    resilience.fire("queue.put", t_env=a_t)
                    with cond:
                        while (counters["put"] - counters["got"]
                               >= sb.queue_slots and not _stopping()):
                            t0 = time.monotonic()
                            cond.wait(0.05)
                            idle["actor_s"] += time.monotonic() - t0
                        if _stopping():
                            break
                        queue_put(counters["put"] % sb.queue_slots, tms)
                        counters["put"] += 1
                        cond.notify_all()

                if a_t - last_runner_log_t >= cfg.runner_log_interval:
                    def _flush_train_stats():
                        train_acc.flush(logger, a_t)
                        logger.log_stat("epsilon", train_acc.epsilon, a_t)
                    _dispatch("fetch.train_stats", _flush_train_stats, None,
                              t=a_t, retryable=False, awd=wd_actor)
                    last_runner_log_t = a_t

                if (a_t - last_test_t) / cfg.test_interval >= 1.0:
                    # drain first and adopt the freshest params: the
                    # classic loop tests after the iteration's train step
                    with _watched("params.sync", t=a_t, awd=None):
                        resilience.fire("params.sync", t_env=a_t)
                        with cond:
                            while (counters["consumed"]
                                   < counters["started"]
                                   and not _stopping()):
                                t0 = time.monotonic()
                                cond.wait(0.05)
                                idle["actor_s"] += time.monotonic() - t0
                            if _stopping():
                                break
                            seb.adopt(cell["version"])
                    for _ in range(n_test_runs):
                        if _stopping():
                            break
                        _, s = _dispatch(
                            "dispatch.test",
                            lambda: actor_step(test_mode=True), None,
                            t=a_t, retryable=False, awd=wd_actor)
                        _dispatch("fetch.test_stats",
                                  lambda s=s: test_acc.push(s), None,
                                  t=a_t, retryable=False, awd=wd_actor)
                        if test_acc.n_episodes == test_quota:
                            _dispatch(
                                "fetch.test_stats",
                                lambda: test_acc.flush(logger, a_t,
                                                       prefix="test_"),
                                None, t=a_t, retryable=False, awd=wd_actor)
                    rss = seb.runner_snapshot()
                    with cond:
                        cell["rs"] = rss
                    last_test_t = a_t
        except watchdog.DispatchFailed as df:
            log.warning(f"actor thread: {df} — handing to the ladder")
            with cond:
                actor_failure.append(df)
        except Exception as e:  # noqa: BLE001 — surfaced to the ladder
            log.exception("actor thread failed")
            with cond:
                actor_failure.append(
                    watchdog.DispatchFailed("actor.dispatch", 1, e))
        finally:
            with cond:
                cond.notify_all()

    # ---- state init / resume --------------------------------------------
    key = (pop.member_keys(cfg, device) if P
           else prng.PRNGKey(cfg.seed + 1, device, cfg.prng_impl))

    def _at(state, step):
        at = lambda t: dataclasses.replace(  # noqa: E731
            t, runner=dataclasses.replace(t.runner, t_env=step))
        return (dataclasses.replace(state, ts=[at(t) for t in state.ts])
                if P else at(state))

    def _place(found_):
        """→ t_env: the programs' state from a fresh init, or copied from
        the checkpoint ``found_`` (the resume and the ladder's restore)."""
        if found_ is None:
            seb.init_states(cfg.seed, learner_params=learner_params)
            return 0
        dirname, step = found_
        restored = elastic.resume_state(
            dirname, seb.join(), verify=False,
            topology={"loop": "sebulba"}, prng_impl=cfg.prng_impl)
        seb.place(_at(restored, step))
        log.info(f"resumed from {dirname} at t_env={step}")
        return step

    t_env = _place(None)
    if found is not None:
        t_env = _place(found)
        saved_key = _key_from_meta(read_meta(found[0]), device, P)
        if saved_key is not None:
            key = saved_key
    seb.init_queue()
    capture_s = seb.capture()
    if capture_s:
        log.info("sebulba graphs captured: " + ", ".join(
            f"{k} {v:.2f}s" for k, v in capture_s.items()))

    if rec.enabled:
        rec.mark("run", t_env=t_env, backend=device.type,
                 batch_size_run=cfg.batch_size_run,
                 episode_limit=cfg.env_args.episode_limit,
                 batch_size=cfg.batch_size, superstep=1,
                 host_buffer=False, sebulba=True, population=P,
                 actor_devices=sb.actor_devices,
                 learner_devices=sb.learner_devices,
                 queue_slots=sb.queue_slots, staleness=sb.staleness,
                 placement=seb.describe(),
                 scenario=scenario_config(cfg.env_args).kind)

    last_log_t = t_env
    last_save_t = t_env if t_env else -cfg.save_model_interval - 1
    start_time = time.time()
    last_log_time = None
    train_infos = []
    episode = int(seb.ls.episode)
    buffer_filled = int(seb.ls.buffer.episodes_in_buffer)

    def _write_checkpoint():
        ranking = (pop.member_ranking(train_acc.member_return_ema)
                   if P else None)
        return save_checkpoint(
            model_dir, t_env, _snapshot_state(),
            topology=(topology if ranking is None else
                      dict(topology, member_ranking=ranking)),
            driver=_key_meta(key))

    def _epoch(t_env0):
        """One actor-thread lifetime → ``('done' | 'failed', failure)``."""
        nonlocal t_env, episode, buffer_filled, key, train_infos
        stop_event.clear()
        seb.reset_queue()
        rss = seb.runner_snapshot()
        with cond:
            actor_failure.clear()
            counters.update(put=0, got=0, consumed=0, started=0)
            cell["rs"] = rss
            cell["version"] = seb.publish()
        actor = threading.Thread(target=_actor_loop, args=(t_env0,),
                                 daemon=True, name="t2omca-sebulba-actor")
        actor.start()
        failed = None
        try:
            while not guard.triggered:
                resilience.fire("driver.iteration", t_env=t_env,
                                guard=guard)
                if guard.triggered:
                    break
                if pulse is not None:
                    pulse.tick_iteration(t_env, episode)
                if trc is not None:
                    trc.poll(t_env)
                # queue.get: wait for a batch (span only: an empty queue
                # is the actor being slower), then the slot into the ring
                got_item = False
                with _watched("queue.get", t=t_env, awd=None):
                    resilience.fire("queue.get", t_env=t_env)
                    with cond:
                        while (counters["put"] == counters["got"]
                               and actor.is_alive() and not actor_failure
                               and not _stopping()):
                            t0 = time.monotonic()
                            cond.wait(0.05)
                            idle["learner_s"] += time.monotonic() - t0
                        if actor_failure:
                            failed = actor_failure[0]
                            break
                        if counters["put"] > counters["got"]:
                            queue_get(counters["got"] % sb.queue_slots)
                            counters["got"] += 1
                            got_item = True
                            cond.notify_all()
                if not got_item:
                    break               # the actor finished (or stopped)
                t_env += spr
                episode += cfg.batch_size_run
                buffer_filled = min(buffer_filled + cfg.batch_size_run,
                                    buffer_capacity)
                # the train gate: the classic loop's host mirror + split
                if (buffer_filled >= cfg.batch_size
                        and episode >= cfg.accumulated_episodes):
                    if P:
                        # each member's stream split as the solo one
                        pairs = [prng.split(k, 2, cfg.prng_impl).unbind(0)
                                 for k in key]
                        key2 = [k for k, _ in pairs]
                        k_sample = torch.stack([k for _, k in pairs])
                    else:
                        key2, k_sample = prng.split(
                            key, 2, cfg.prng_impl).unbind(0)

                    def _train_once(k_sample=k_sample, t=t_env):
                        info = learner_step(k_sample, t)
                        seb.sync_learner()
                        return info
                    info = _dispatch("learner.dispatch", _train_once, None,
                                     t=t_env, retryable=False, awd=wd)
                    key = key2
                    train_infos.append(info)
                # params.sync: publish for the actor, advance the window
                with _watched("params.sync", t=t_env, awd=wd):
                    resilience.fire("params.sync", t_env=t_env)
                    with cond:
                        cell["version"] = seb.publish()
                        counters["consumed"] += 1
                        cond.notify_all()
                _cadences()
                if trc is not None:
                    trc.tick(logger, t_env)
            return ("failed", failed) if failed is not None else \
                ("done", None)
        except watchdog.DispatchFailed as df:
            return "failed", df
        finally:
            stop_event.set()
            with cond:
                cond.notify_all()
            actor.join(timeout=30.0)
            if actor.is_alive():
                log.warning("actor thread did not exit within 30s "
                            "(wedged dispatch?) — continuing teardown; "
                            "the daemon thread dies with the process")
            else:
                seb.sync_actors()

    def _cadences():
        """The save and log cadences (learner thread)."""
        nonlocal last_save_t, last_log_t, last_log_time, train_infos
        nonlocal nonfinite_streak, nonfinite_total
        if (cfg.save_model
                and (t_env - last_save_t) >= cfg.save_model_interval):
            def _save_once():
                with _watched("checkpoint.save", t=t_env, awd=wd):
                    if not _acquire_save_lock("save cadence"):
                        return None
                    try:
                        return _write_checkpoint()
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
                last_save_t = t_env

        if (t_env - last_log_t) >= cfg.log_interval:
            if train_infos:
                def _fetch_infos():
                    last = train_infos[-1]
                    keys = LOG_KEYS + tuple(
                        sorted(k for k in last if k.startswith("sight_")))
                    # (n, P) under a population: a step is finite only
                    # if every member's update was
                    flags = torch.stack([i["all_finite"]
                                         for i in train_infos]).cpu().numpy()
                    return (flags.reshape(len(train_infos), -1)
                            .astype(bool).all(axis=1),
                            {k: last[k].float().cpu().numpy()
                             for k in keys})
                flags, last = _dispatch("fetch.train_infos", _fetch_infos,
                                        None, t=t_env, retryable=False,
                                        awd=wd)
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
                             streak=nonfinite_streak, total=nonfinite_total)
                    log.warning(
                        f"non-finite loss/grads in {int((~flags).sum())}/"
                        f"{len(flags)} train steps since last log (streak="
                        f"{nonfinite_streak})")
                _log_info_rows(logger, last, P, t_env)
                if sight_mon is not None:
                    with rec.span("sight.detect", t_env=t_env):
                        trips = sight_mon.observe(last, t_env)
                    if trips:
                        log.warning(
                            f"graftsight: detector(s) tripped at t_env="
                            f"{t_env}: {', '.join(trips)} — /healthz "
                            f"degraded")
                        _persist_flight(os.path.join(
                            results_dir, "flight_recorder.json"))
                train_infos = []
                if (res.nonfinite_tolerance
                        and nonfinite_streak >= res.nonfinite_tolerance):
                    raise _NonFiniteEscalation(
                        f"training diverged: {nonfinite_streak} "
                        f"consecutive non-finite train steps")
            with cond:
                depth = counters["put"] - counters["got"]
                ahead = counters["started"] - counters["consumed"]
            logger.log_stat("queue_depth", depth, t_env)
            logger.log_stat("actor_idle_s", round(idle["actor_s"], 3), t_env)
            logger.log_stat("learner_idle_s", round(idle["learner_s"], 3),
                            t_env)
            if rec.enabled:
                rec.mark("sebulba", t_env=t_env, queue_depth=depth,
                         actor_idle_s=round(idle["actor_s"], 3),
                         learner_idle_s=round(idle["learner_s"], 3))
            if kit.dispatch_faults:
                logger.log_stat("dispatch_faults", kit.dispatch_faults,
                                t_env)
            logger.log_stat("episode", episode, t_env)
            now = time.time()
            rate = None
            if last_log_time is not None:
                rate = ((t_env - last_log_t)
                        / max(now - last_log_time, 1e-9))
                logger.log_stat("env_steps_per_sec", rate, t_env)
            last_log_time = now
            pulse_snap = mw.snapshot("log", t_env=t_env)
            if pulse is not None:
                if rate is not None:
                    pulse.set("env_steps_per_sec", rate)
                pulse.set("queue_depth", depth)
                pulse.set("staleness_in_flight", ahead)
                pulse.set("actor_idle_seconds", round(idle["actor_s"], 3))
                pulse.set("learner_idle_seconds",
                          round(idle["learner_s"], 3))
                pulse.set("nonfinite_streak", nonfinite_streak)
                pulse.set("dispatch_faults", kit.dispatch_faults)
                pulse.set("ladder_failures", ladder.failures)
                pulse.set("restores", restores)
                pulse.set_memwatch(pulse_snap)
            logger.print_recent_stats()
            last_log_t = t_env

    # ---- epochs: run; a ladder restore reloads and re-enters -------------
    # the main thread enqueues on the learner's stream throughout
    on_learner = (torch.cuda.stream(lp.stream) if lp.stream is not None
                  else nullcontext())
    try:
        with on_learner:
            while True:
                try:
                    status, failed = _epoch(t_env)
                except _NonFiniteEscalation as nf:
                    status, failed = "failed", watchdog.DispatchFailed(
                        "learner.dispatch", 1, nf)
                if status == "done" or guard.triggered:
                    break
                action = ladder.next_action(can_degrade=False)
                logger.log_stat("dispatch_failures", ladder.failures, t_env)
                rec.mark("ladder", action=action, phase=failed.phase,
                         t_env=t_env, failures=ladder.failures)
                good = (find_checkpoint(model_dir) if cfg.save_model
                        else None)
                if action == "restore" and good is not None:
                    log.warning(f"degradation ladder: {failed} — restoring "
                                f"last good checkpoint {good[0]} "
                                f"({ladder.describe()})")
                    t_env = _place(good)
                    episode = int(seb.ls.episode)
                    buffer_filled = int(seb.ls.buffer.episodes_in_buffer)
                    train_infos = []
                    nonfinite_streak = 0
                    # the torn-down actor may have died mid-cadence: a
                    # partial accumulation would miss every later exact-
                    # quota flush; the fetch tallies are cumulative
                    fetches = train_acc.fetches
                    train_acc = StatsAccumulator(population=P)
                    train_acc.fetches = fetches
                    tfetches = test_acc.fetches
                    test_acc = StatsAccumulator(population=P)
                    test_acc.fetches = tfetches
                    restores += 1
                    last_log_t = last_save_t = t_env
                    continue
                _persist_flight(os.path.join(model_dir,
                                             "flight_recorder.json"))
                diag = wd.take_diagnosis() if wd is not None else None
                raise RuntimeError(
                    f"sebulba dispatch failure exhausted the degradation "
                    f"ladder at t_env={t_env} ({ladder.describe()})"
                    + (f"; stall diagnosis: {diag.message()}" if diag
                       else "")
                    + ("" if cfg.save_model else
                       "; no checkpoints exist to restore (save_model off)")
                    + f" — last failure: {failed}") from failed
    except BaseException as e:
        rec.mark("crash", t_env=t_env,
                 error=f"{type(e).__name__}: {e}"[:300])
        _persist_flight(os.path.join(results_dir, "flight_recorder.json"))
        rec.close()
        raise
    finally:
        stop_event.set()
        with cond:
            cond.notify_all()
        if wd is not None:
            wd.stop()
        if wd_actor is not None:
            wd_actor.stop()
        guard.uninstall()
        if pulse is not None:
            pulse.close()
        seb.close()             # the learner set's threads

    ts = _snapshot_state()
    if guard.triggered:
        rec.mark("shutdown", t_env=t_env, signame=guard.signame or "")
        _persist_flight(os.path.join(results_dir, "flight_recorder.json"))
        stall = ((wd.take_diagnosis() if wd is not None else None)
                 or (wd_actor.take_diagnosis() if wd_actor is not None
                     else None))
        if stall is not None:
            log.warning(f"watchdog: {stall.message()} — diagnosis "
                        f"persisted to {model_dir}/stall_diagnosis.json")
        log.warning(f"shutdown requested ({guard.signame}) at "
                    f"t_env={t_env} — stopping gracefully")
        if cfg.save_model and res.emergency_checkpoint:
            if _acquire_save_lock("preemption exit"):
                save_to = None
                deadline = (watchdog.ExitDeadline(
                                max(res.stall_grace_s, 60.0),
                                res.stall_exit_code,
                                label="sebulba exit emergency checkpoint")
                            if wd is not None else nullcontext())
                try:
                    with deadline:
                        try:
                            save_to = watchdog.retry_call(
                                _write_checkpoint,
                                attempts=1 + res.dispatch_retries,
                                backoff_s=res.retry_backoff_s,
                                label="checkpoint.emergency")
                        except Exception:  # noqa: BLE001
                            log.exception(
                                "emergency checkpoint failed on the "
                                "sebulba exit — degrading to the shard "
                                "save")
                        if save_to is None:
                            # one process: a 1-of-1 set, complete
                            with rec.span("checkpoint.shard_save",
                                          t_env=t_env):
                                save_to = save_checkpoint_shards(
                                    model_dir, t_env, ts,
                                    topology=topology,
                                    driver=_key_meta(key))
                except Exception:  # noqa: BLE001 — exit stays orderly
                    log.exception("emergency checkpoint failed on the "
                                  "sebulba exit path")
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
        log.info(f"sebulba totals: actor idle {idle['actor_s']:.2f}s, "
                 f"learner idle {idle['learner_s']:.2f}s, "
                 f"wall {time.time() - start_time:.2f}s")
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
    rs = er.init_state(prng.PRNGKey(cfg.seed + 2, exp.device,
                                    cfg.prng_impl))
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
