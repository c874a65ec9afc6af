"""The training loop's core (port of the classic ``superstep: 1`` path of
``t2omca_tpu/run.py``: ``Experiment`` and ``run_sequential``).

``Experiment.build`` assembles env, MAC, learner, runner and replay
buffer on one device; ``Experiment.init_state`` starts the JAX key chain
(``k_learner, k_runner = split(PRNGKey(seed))``); ``Experiment.programs``
returns the three programs of one iteration (rollout, insert,
train_iter); ``run_classic`` drives N iterations with the driver key
``PRNGKey(seed + 1)``, the episode and ``t_env`` accounting and the train
gate ``buffer_filled >= batch_size and episode >= accumulated_episodes``,
splitting ``key2, k_sample = split(key)`` only for iterations that train.

The learner's params cannot come from the JAX key chain (flax's
initializers are not ported): they are drawn from a ``torch.Generator``
seeded with ``seed``, or carried across from flax with ``convert.py``.

Left out, to a later slice: logging and the stats accumulator, test
rollouts and their cadence, checkpoints and resume, the watchdog and
signal handling, the population, Sebulba and the fused superstep (the
JAX package's contract makes a superstep of K train exactly as K of
these iterations; ``run_classic`` runs the iterations one by one).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch

from . import prng
from .components.episode_buffer import (PrioritizedReplayBuffer,
                                        ReplayBuffer)
from .config import TrainConfig
from .controllers.basic_mac import MAC_REGISTRY
from .device import DeviceLike, resolve_device
from .envs.registry import make_env
from .learners.qmix_learner import LEARNER_REGISTRY
from .ops.query_slice import entity_store_eligible
from .runners.parallel_runner import RUNNER_REGISTRY
from .train.program import TrainState, build_train_iter


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"Queue A: {where})")


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
