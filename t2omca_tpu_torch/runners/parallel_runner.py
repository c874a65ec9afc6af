"""Batched rollout runner (port of
``t2omca_tpu/runners/parallel_runner.py``).

``batch_size_run`` env lanes step together: the env's ``reset``/``step``
take the lane axis, and the JAX ``lax.scan`` over episode time is a
Python loop over the ``T`` step keys ``split(k_scan, T)``. Semantics
kept from the JAX runner:

* Q15: each step's action is stored with the pre-step observation;
* Q7: time-limit termination is stored as non-terminal
  (``terminated & ~episode_limit``) for bootstrapping;
* Q4: each lane's Welford normalizer carries across episodes;
* reward scaling (``env_args.reward_scaling``) on training rollouts
  only, the scaled reward stored and the raw one in the stats;
* ``t_env`` does not advance in test mode;
* obs and state stored in ``replay.store_dtype``, avail as bool;
* under compact entity storage (``compact_store``) the obs slot holds
  ``CompactEntityObs`` (f32 rows and statistics, the MEC index as int8)
  made from each step's carried env state, and the acting forward reads
  the same compact tuple through the entity tables.

No draw of an episode depends on the env's state, so the rollout draws
them all before the step loop (the env's and the selector's, over keys
``(T, B, 2)`` and ``(T, 2)``), bit for bit the numbers the JAX scan
draws step by step: the threefry hash then runs ~30 times a rollout
instead of ~18 times a step. The step loop makes no host sync:
``t_env`` is a host int, so epsilon lives on the host, and every other
value stays on the device.
The env returns the observation in the form the rollout reads
(``obs_form``): compact alone under the default stack, so the dense
``(B, A, A·F)`` obs is never built, as XLA drops it from the JAX rollout.
``capture=True`` also returns the visualization trajectory of the same
episode (``runners/episode_runner.py``): each step's pre-step positions
and serving MECs, the post-step ACKs, the actions, rewards and step
info, as the JAX runner's scan emits them.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import prng
from ..components.episode_buffer import (CompactEntityObs,
                                        TimeMajorEpisodes, obs_map)
from ..config import TrainConfig
from ..controllers.basic_mac import BasicMAC, torch_dtype
from ..envs.mec_offload import EnvParams, EnvState, MultiAgvOffloadingEnv
from ..envs.normalization import (RewardScaleState, reset_reward_scale,
                                  scale_reward)
from ..envs.registry import make_scenario_distribution
from ..ops.query_slice import entity_store_eligible

#: fold_in salt of the per-rollout scenario-sampling key (folded off the
#: rollout key, never split from it, as in the JAX runner)
_SCENARIO_SALT = 0x5CE7


@dataclasses.dataclass
class RunnerState:
    """Cross-episode carried state."""

    env_states: EnvState          # (B, ...): holds the persistent norms
    key: torch.Tensor             # (2,) key
    t_env: int                    # global env-step cursor (host)
    rscale: RewardScaleState      # reward-scaling state over the lanes
    env_params: EnvParams         # (B, ...) scenario of each lane


@dataclasses.dataclass
class RolloutStats:
    """Terminal-step info of each lane, plus return and length."""

    episode_return: torch.Tensor            # (B,) summed raw reward
    episode_length: torch.Tensor            # (B,)
    reward: torch.Tensor                    # (B,) terminal-step values
    delay_reward: torch.Tensor
    overtime_penalty: torch.Tensor
    channel_utilization_rate: torch.Tensor
    conflict_ratio: torch.Tensor
    episode_limit: torch.Tensor             # (B,) f32
    task_completion_rate: torch.Tensor
    task_completion_delay: torch.Tensor
    deadline_miss_rate: torch.Tensor
    epsilon: torch.Tensor                   # () on the host
    scenario: torch.Tensor                  # (B,) int32 family id


@dataclasses.dataclass(frozen=True)
class ParallelRunner:
    env: MultiAgvOffloadingEnv
    mac: BasicMAC
    cfg: TrainConfig

    @property
    def batch_size(self) -> int:
        return self.cfg.batch_size_run

    @property
    def compact_store(self) -> bool:
        """Store the factored entity obs instead of the dense tensor
        (``ops/query_slice.entity_store_eligible``)."""
        return entity_store_eligible(self.cfg)

    @property
    def obs_form(self) -> str:
        """What the rollout reads of each observation (the env's
        ``obs_form``): compact alone when it acts through the entity
        tables and stores compact obs, both when it acts through the
        tables and stores dense obs, else dense."""
        if self.compact_store:
            return "compact"
        return "both" if self.mac.use_entity_tables else "dense"

    @property
    def scenario(self):
        return make_scenario_distribution(self.cfg.env_args)

    def _sample_scenarios(self, key: torch.Tensor) -> EnvParams:
        """One ``EnvParams`` per lane from the salted side key."""
        keys = prng.split(prng.fold_in(key, _SCENARIO_SALT),
                          self.batch_size)
        return self.scenario.sample(keys, self.env)

    def init_state(self, key: torch.Tensor) -> RunnerState:
        """Initial env states with fresh norms; ``env_args.seed`` folds
        into the key chain (Q8)."""
        key = prng.fold_in(key, self.cfg.env_args.seed)
        key, k_reset = prng.split(key).unbind(-2)
        env_params = self._sample_scenarios(k_reset)
        states = self.env.reset(prng.split(k_reset, self.batch_size),
                                None, env_params, obs_form="compact"
                                if self.compact_store else "dense")[0]
        return RunnerState(
            env_states=states, key=key, t_env=0,
            rscale=RewardScaleState.create(self.cfg.gamma,
                                           self.batch_size,
                                           device=key.device),
            env_params=env_params)

    def run(self, params, rs: RunnerState, test_mode: bool = False,
            capture: bool = False):
        """One synchronous batched episode → (runner state', episode
        batch ``(B, T(+1), ...)``, stats[, viz]). ``viz`` (with
        ``capture``): ``{"pos", "mec_index", "acks", "actions", "reward",
        "info"}`` of ``(T, B, ...)`` tensors, ``info`` a ``StepInfo`` of
        every step."""
        out = self.run_raw(params, rs, test_mode, capture)
        return (out[0], out[1].to_batch()) + tuple(out[2:])

    def run_raw(self, params, rs: RunnerState, test_mode: bool = False,
                capture: bool = False):
        """``run`` before the episode-batch assembly: → (runner state',
        ``TimeMajorEpisodes``, stats[, viz])."""
        env, b, t_len = self.env, self.batch_size, self.env.cfg.episode_limit
        key, k_reset, k_scan = prng.split(rs.key, 3).unbind(-2)
        params = self.mac.prepare_acting_params(params)
        env_params = self._sample_scenarios(rs.key)
        form = self.obs_form
        env_states, obs, gstate, avail = env.reset(
            prng.split(k_reset, b), rs.env_states.norm, env_params,
            obs_form=form)
        hidden = self.mac.init_hidden(b)
        sd = torch_dtype(self.cfg.replay.store_dtype)
        scale_on = self.cfg.env_args.reward_scaling and not test_mode
        rscale = reset_reward_scale(rs.rscale)

        def split_obs(obs):
            """→ (dense obs or None, compact tuple or None)."""
            if form == "compact":
                return None, obs
            return obs if form == "both" else (obs, None)

        def stored(env_states, dense, compact):
            """The obs slot's storage form (Q15: the pre-step obs).
            Compact leaves stay f32 under any store_dtype: raw features
            of O(1e4), which the learner normalizes again."""
            if form != "compact":
                return dense.to(sd)
            rows, _, mean, std = compact
            return CompactEntityObs(
                rows=rows, mec_index=env_states.mec_index.to(torch.int8),
                mean=mean, std=std)

        dense, compact = split_obs(obs)
        dev = avail.device
        seq = lambda x, dtype=None: torch.empty(
            (t_len,) + tuple(x.shape), dtype=dtype or x.dtype, device=dev)
        obs_seq = obs_map(seq, stored(env_states, dense, compact))
        gstate_seq = seq(gstate, sd)
        avail_seq = seq(avail, torch.bool)
        action_seq = torch.empty((t_len, b, env.n_agents), dtype=torch.int32,
                                 device=dev)
        reward_seq = torch.empty((t_len, b), device=dev)
        rec_seq = torch.empty_like(reward_seq) if scale_on else reward_seq
        term_seq = torch.empty((t_len, b), dtype=torch.bool, device=dev)
        # the episode return summed over time in step order, float32, as
        # XLA reduces the time axis (a torch sum over it reassociates)
        ret = torch.zeros(b, device=dev)
        viz = ({"pos": seq(env_states.pos), "mec_index":
                seq(env_states.mec_index), "acks": seq(env_states.last_ack),
                "info": []} if capture else None)
        t_env = rs.t_env
        # every draw of the episode at once: the keys of step t are
        # split(k_scan, T)[t] -> k_act, k_env as in the JAX scan, and no
        # draw depends on the env's state
        k_act, k_env = prng.split(prng.split(k_scan, t_len)).unbind(-2)
        sel = (None if test_mode else
               self.mac.exploration_draws(k_act, b))
        env_draws = env.draw_step(prng.split(k_env, b))      # (T, B, A)
        for t in range(t_len):
            actions, hidden, eps = self.mac.select_actions(
                params, dense, avail, hidden, k_act[t], t_env,
                test_mode=test_mode,
                draws=None if sel is None else (sel[0][t], sel[1][t]),
                compact=compact)
            obs_map(lambda dst, x: dst[t].copy_(x), obs_seq,   # Q15
                    stored(env_states, dense, compact))
            gstate_seq[t] = gstate
            avail_seq[t], action_seq[t] = avail > 0, actions
            if capture:                        # the pre-step placement
                viz["pos"][t] = env_states.pos
                viz["mec_index"][t] = env_states.mec_index
            env_states, reward, terminated, info, obs, gstate, avail = \
                env.step(env_states, actions, None, env_params,
                         draws=env_draws.at(t), obs_form=form)
            if capture:
                viz["acks"][t] = env_states.last_ack
                viz["info"].append(info)
            dense, compact = split_obs(obs)
            reward_seq[t] = reward
            ret = ret + reward
            if scale_on:
                rscale, rec_seq[t] = scale_reward(rscale, reward)
            term_seq[t] = terminated & ~info.episode_limit     # Q7
            if not test_mode:
                t_env += b

        tm = TimeMajorEpisodes(
            obs=obs_seq, state=gstate_seq, avail_actions=avail_seq,
            actions=action_seq, reward=rec_seq, terminated=term_seq,
            last_obs=stored(env_states, dense, compact),
            last_state=gstate.to(sd), last_avail=avail > 0)
        stats = RolloutStats(
            episode_return=ret,
            episode_length=torch.full((b,), float(t_len), device=dev),
            reward=reward, delay_reward=info.delay_reward,
            overtime_penalty=info.overtime_penalty,
            channel_utilization_rate=info.channel_utilization_rate,
            conflict_ratio=info.conflict_ratio,
            episode_limit=info.episode_limit.float(),
            task_completion_rate=info.task_completion_rate,
            task_completion_delay=info.task_completion_delay,
            deadline_miss_rate=info.deadline_miss_rate,
            epsilon=eps, scenario=env_params.family)
        new_rs = RunnerState(env_states=env_states, key=key, t_env=t_env,
                             rscale=rscale if scale_on else rs.rscale,
                             env_params=env_params)
        if capture:
            infos = viz["info"]
            viz.update(actions=action_seq, reward=reward_seq,
                       info=type(infos[0])(**{
                           f.name: torch.stack([getattr(i, f.name)
                                                for i in infos])
                           for f in dataclasses.fields(infos[0])}))
            return new_rs, tm, stats, viz
        return new_rs, tm, stats


RUNNER_REGISTRY = {"parallel": ParallelRunner}
