"""Multi-AGV task-offloading environment (port of
``t2omca_tpu/envs/mec_offload.py``), batched over env lanes.

Every 5 ms slot each AGV computes its head-of-queue job locally (action
0) or transmits it over one of ``num_channels`` uplink channels to its
serving MEC (actions 1..C); two AGVs picking the same channel under the
same MEC collide (Q14). ``reset`` and ``step`` are the JAX package's
functions with the ``jax.vmap`` lane axis made explicit: every state,
param and key leaf carries a leading ``(B,)`` lane dimension, and each
lane's draws use the counters JAX gives one vmapped lane
(``t2omca_tpu_torch.prng``), so lane ``b`` of a port rollout is lane ``b``
of the JAX rollout.

Arithmetic follows what XLA makes of the JAX expressions, where the bits
decide a discrete outcome:

* a division by a compile-time constant is a multiply by its float32
  reciprocal, and a chain of constant factors folds into one factor
  (``_local_delay``'s ``data · 0.00625``; ``_round(x, 2)`` is
  ``round(x · 100) · 0.01``);
* the job compaction and the collision histogram are exact integer work
  (gathers, scatters, counts), never matmuls: a TF32 or bf16 product
  would round payload sizes.

The transcendental functions (``log10``, ``log2``, ``pow``, ``sin``,
``cos``) of torch and of XLA's CPU backend may differ in the last bit,
and a delay rounded to 0.01 ms can then land on the other side of a
rounding boundary; ``tests/test_torch_env.py`` states how far that
reaches.

``compact_obs`` gives the factored form of the entity observation that
the entity-table acting path reads and compact storage keeps. ``reset``
and ``step`` take ``obs_form``: ``"dense"`` returns the normalized
``(B, A, obs_dim)`` obs, ``"compact"`` the ``compact_obs`` tuple without
ever building the dense obs (XLA drops it from the JAX rollout as dead
code when nothing reads it; eager torch has no such pass), ``"both"``
the pair. The normalizer's update is the same in every form.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

#: what ``reset``/``step``/``get_obs`` return as the observation
OBS_FORMS = ("dense", "compact", "both")

import numpy as np
import torch

from .. import prng
from ..components.transforms import one_hot
from ..config import EnvConfig
from ..device import DeviceLike, resolve_device
from ..xla_float import f32, fma, fold, recip, sqrt
from .critic import critic
from .normalization import (NormState, apply_norm, normalize,
                            normalize_batch, select_update,
                            welford_update_batch_factored)


def _round(x: torch.Tensor, decimals: int = 0) -> torch.Tensor:
    """Banker's rounding; ``decimals`` > 0 as ``jnp.round`` lowers it
    (``round(x · 10**d) · float32(10**-d)``)."""
    if decimals == 0:
        return torch.round(x)
    return torch.round(x * float(10 ** decimals)) * recip(10 ** decimals)


@dataclasses.dataclass
class EnvParams:
    """Per-lane scenario knobs (graftworld): leaves ``(B,)`` or ``(B, A)``
    (``compute_scale``, ``tx_scale``). The defaults are the neutral
    elements of the expressions they enter."""

    n_active: torch.Tensor           # int32 active AGVs (rest padded)
    gain_scale: torch.Tensor
    interference_w: torch.Tensor
    mec_scale: torch.Tensor
    teleport_prob: torch.Tensor
    job_prob: torch.Tensor
    surge_amp: torch.Tensor
    surge_period: torch.Tensor
    deadline_ms: torch.Tensor
    mec_compute_scale: torch.Tensor
    compute_scale: torch.Tensor      # (B, A)
    tx_scale: torch.Tensor           # (B, A)
    family: torch.Tensor             # int32

    def agent_mask(self, n_agents: int) -> torch.Tensor:
        """(B, A) bool: True for active agents."""
        idx = torch.arange(n_agents, device=self.n_active.device)
        return idx < self.n_active.unsqueeze(-1)


@dataclasses.dataclass
class EnvState:
    """Per-lane dynamic state, each leaf with a leading ``(B,)``."""

    time_slot: torch.Tensor       # (B,) int32
    mec_index: torch.Tensor       # (B, A) int32
    pos: torch.Tensor             # (B, A, 2) f32
    job_data: torch.Tensor        # (B, A, J) f32
    job_deadline: torch.Tensor    # (B, A, J) f32
    job_valid: torch.Tensor       # (B, A, J) bool
    last_ack: torch.Tensor        # (B, A) int32 in {-1, 0, 1}
    last_action: torch.Tensor     # (B, A) int32
    task_num: torch.Tensor        # (B, A) int32
    task_success: torch.Tensor    # (B, A) int32
    remain_delay: torch.Tensor    # (B, A) f32
    norm: NormState               # per-lane obs Welford stats (Q4)


@dataclasses.dataclass
class StepInfo:
    """The fixed-key ``info`` of a step, each leaf ``(B,)``."""

    reward: torch.Tensor
    delay_reward: torch.Tensor
    overtime_penalty: torch.Tensor
    channel_utilization_rate: torch.Tensor
    conflict_ratio: torch.Tensor
    episode_limit: torch.Tensor          # bool
    task_completion_rate: torch.Tensor
    task_completion_delay: torch.Tensor
    deadline_miss_rate: torch.Tensor


@dataclasses.dataclass
class StepDraws:
    """The random numbers of one env step (or of a reset), per agent:
    leaves ``(..., A)`` with any leading lane (and step) dimensions. They
    depend on the key alone, so a rollout draws all its steps at once
    (``draw_step`` over keys ``(T, B, 2)``) instead of hashing ~15 times
    a step."""

    new_mec: torch.Tensor      # int32 serving MEC after a teleport
    radius_u: torch.Tensor     # uniform, for the radius of the position
    theta: torch.Tensor        # uniform in [0, 2π), its angle
    teleport_u: torch.Tensor   # uniform, against ``teleport_prob``
    job_u: torch.Tensor        # uniform, against the job arrival rate
    job_data: torch.Tensor     # uniform in [data_size_min, data_size_max)

    def at(self, t: int) -> "StepDraws":
        """Step ``t`` of draws made for a whole rollout."""
        return StepDraws(**{f.name: getattr(self, f.name)[t]
                            for f in dataclasses.fields(self)})


def lane_count(keys: torch.Tensor, rows=None) -> int:
    """The lanes of lane keys ``(B, width)`` that ``rows`` (a slice or a
    1-D index tensor of them, None for all) keeps."""
    b = keys.shape[0]
    if rows is None:
        return b
    if isinstance(rows, slice):
        return len(range(*rows.indices(b)))
    return rows.shape[0]


@dataclasses.dataclass(frozen=True)
class MultiAgvOffloadingEnv:
    """Static physics and topology. ``device``: where ``default_params``
    and ``reset`` put their tensors, ``cuda`` unless named; the static
    sizes need no device."""

    cfg: EnvConfig
    device: DeviceLike = None
    #: the run's ``prng_impl`` (``prng.IMPLS``): which ``split`` and
    #: ``fold_in`` the lane keys take
    prng_impl: str = "threefry"

    computation_cycles: float = 31250.0   # cycles/bit
    bandwidth: float = 5e6                # Hz
    noise_power: float = 1e-11            # W
    path_loss_base: float = 3.0           # base-3 linearization (quirk)
    channel_gain_db: float = 5.0
    t_length: float = 5.0                 # ms/slot

    # ---- static sizes

    @property
    def n_agents(self) -> int:
        return self.cfg.agv_num

    @property
    def n_mec(self) -> int:
        return self.cfg.mec_num

    @property
    def n_actions(self) -> int:
        return self.cfg.num_channels + 1      # local + one per channel

    @property
    def max_jobs(self) -> int:
        return int(self.cfg.latency_max_ms / self.t_length) + 1

    @property
    def obs_entity_feats(self) -> int:
        return 9  # ack_onehot(3) + agent_inf(5) + is_self(1)

    @property
    def state_entity_feats(self) -> int:
        if self.cfg.state_last_action:
            return 8 + self.n_actions
        return 8

    @property
    def obs_dim(self) -> int:
        if self.cfg.obs_entity_mode:
            return self.n_agents * self.obs_entity_feats
        return 6  # [last_ack, agent_inf(5)]

    @property
    def state_dim(self) -> int:
        return self.n_agents * self.state_entity_feats

    def get_env_info(self) -> Dict[str, int]:
        info = {
            "state_shape": self.state_dim,
            "obs_shape": self.obs_dim,
            "n_actions": self.n_actions,
            "n_agents": self.n_agents,
            "episode_limit": self.cfg.episode_limit,
            "n_entities": self.n_agents,
        }
        if self.cfg.obs_entity_mode:
            info["obs_entity_feats"] = self.obs_entity_feats
        if self.cfg.state_entity_mode:
            info["state_entity_feats"] = self.state_entity_feats
        return info

    # ---- params

    @property
    def dev(self) -> torch.device:
        return resolve_device(self.device)

    def default_params(self, b: int) -> EnvParams:
        """The fixed reference scenario for ``b`` lanes."""
        dev, a = self.dev, self.n_agents
        f = lambda v: torch.full((b,), float(v), device=dev)
        i = lambda v: torch.full((b,), int(v), dtype=torch.int32,
                                 device=dev)
        return EnvParams(
            n_active=i(a), gain_scale=f(1.0), interference_w=f(0.0),
            mec_scale=f(1.0), teleport_prob=f(1.0),
            job_prob=f(self.cfg.job_prob), surge_amp=f(0.0),
            surge_period=f(40.0), deadline_ms=f(self.cfg.latency_max_ms),
            mec_compute_scale=f(1.0),
            compute_scale=torch.ones(b, a, device=dev),
            tx_scale=torch.ones(b, a, device=dev), family=i(0))

    def mec_positions(self, params: EnvParams) -> torch.Tensor:
        """(B, M, 2): MECs on a line at spacing 2·radius, stretched by
        each lane's ``mec_scale``."""
        r = self.cfg.mec_radius_m
        xs = torch.arange(self.n_mec, dtype=torch.float64,
                          device=params.mec_scale.device) * (2 * r) + r
        base = torch.stack([xs, torch.full_like(xs, r)], dim=1).float()
        return base * params.mec_scale[:, None, None]

    # ---- helpers

    def _mec_centre(self, mec_index: torch.Tensor, params: EnvParams
                    ) -> torch.Tensor:
        """(B, A, 2) position of each agent's serving MEC. A padded
        agent's negative sentinel indexes as in ``jnp``: from the end,
        then clamped."""
        m = self.n_mec
        idx = mec_index.long()
        idx = torch.where(idx < 0, idx + m, idx).clamp(0, m - 1)
        return torch.gather(self.mec_positions(params), 1,
                            idx.unsqueeze(-1).expand(-1, -1, 2))

    def draw_step(self, key: torch.Tensor, scan: int = 0, rows=None
                  ) -> StepDraws:
        """The draws of ``reset``/``step`` from lane keys ``(..., B,
        width)``, in the JAX key order: ``k_mec, k_pos, k_gen = split(key,
        3)``; the new MEC from ``randint(k_mec)``; the position's radius
        and angle from ``split(k_pos)`` (M13); the teleport gate from the
        side key ``fold_in(key, 7)``; the job's Bernoulli coin and size
        from ``split(k_gen)``. ``reset`` reads all but the teleport gate.
        The lanes are JAX's ``vmap`` axis; ``scan`` leading dimensions
        before it are steps (a rollout's, drawn ahead), and ``rows`` keeps
        those lanes (a data-parallel rank's: ``prng``'s ``rows``)."""
        impl = self.prng_impl
        k_mec, k_pos, k_gen = prng.split(key, 3, impl, scan).unbind(-2)
        k_rad, k_theta = prng.split(k_pos, 2, impl, scan).unbind(-2)
        k_coin, k_data = prng.split(k_gen, 2, impl, scan).unbind(-2)
        a = self.n_agents
        u = lambda k, lo=0.0, hi=1.0: prng.uniform(k, (a,), lo, hi, rows,
                                                   scan)
        return StepDraws(
            new_mec=prng.randint(k_mec, (a,), 0, self.n_mec, impl, rows,
                                 scan),
            radius_u=u(k_rad),
            theta=u(k_theta, hi=2 * np.pi),
            teleport_u=u(prng.fold_in(key, 7, impl)),
            job_u=u(k_coin),
            job_data=u(k_data, self.cfg.data_size_min,
                       self.cfg.data_size_max))

    def _place(self, draws: StepDraws, mec_index: torch.Tensor,
               params: EnvParams) -> torch.Tensor:
        """M13: a uniform point in the serving MEC's circle, (B, A, 2)."""
        rad = self.cfg.communication_range_m * sqrt(draws.radius_u)
        centre = self._mec_centre(mec_index, params)
        theta = draws.theta
        return torch.stack([fma(rad, torch.cos(theta), centre[..., 0]),
                            fma(rad, torch.sin(theta), centre[..., 1])],
                           dim=-1)

    def _local_raw(self, data: torch.Tensor, params: EnvParams
                   ) -> torch.Tensor:
        """Unrounded local compute delay in ms: XLA folds ``cycles · data
        / cap · 1000`` into one factor; the per-AGV scale divides last."""
        k = fold(self.computation_cycles, self.cfg.user_compute_cap, 1000.0)
        return data * k / params.compute_scale

    def _local_delay(self, data: torch.Tensor, decimals: int,
                     params: EnvParams) -> torch.Tensor:
        return _round(self._local_raw(data, params), decimals)

    def _offload_delay(self, data: torch.Tensor, pos: torch.Tensor,
                       mec_index: torch.Tensor,
                       params: EnvParams) -> torch.Tensor:
        """Shannon-rate transmit delay + MEC compute delay in ms, rounded
        to 0.01; path loss uses base 3 (reference quirk)."""
        v = pos - self._mec_centre(mec_index, params)
        d = sqrt(fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0]))
        pl_db = fma(torch.log10(d + 0.1), 37.6, 128.1)
        pl_lin = torch.pow(self.path_loss_base, pl_db * -recip(10.0))
        gain_lin = 10.0 ** (self.channel_gain_db / 10.0)
        k = f32(np.float32(gain_lin * self.cfg.transmit_power_w)
                * np.float32(recip(self.noise_power)))
        lift = fma(params.interference_w, recip(self.noise_power), 1.0)
        snr = (pl_lin * k * params.gain_scale[:, None] * params.tx_scale
               / lift[:, None])
        rate = self.bandwidth * torch.log2(1.0 + snr)
        transmit = data / rate * 1000.0
        kc = fold(self.computation_cycles, self.cfg.mec_compute_cap, 1000.0)
        compute = data * kc / params.mec_compute_scale[:, None]
        return _round(transmit + compute, 2)

    def _agent_inf(self, state: EnvState, params: EnvParams
                   ) -> torch.Tensor:
        """(B, A, 5) rows ``[data_size, data_delay, offload_delay,
        remaining_delay, buffer_length]``, zero for empty buffers."""
        has_job = state.job_valid[..., 0]
        data = state.job_data[..., 0]
        inf = torch.stack([
            data,
            self._local_delay(data, 0, params),
            self._offload_delay(data, state.pos, state.mec_index, params),
            state.job_deadline[..., 0],
            state.job_valid.sum(dim=-1).float(),
        ], dim=-1)
        return torch.where(has_job[..., None], inf, 0.0)

    @staticmethod
    def _ack_onehot(last_ack: torch.Tensor) -> torch.Tensor:
        """ack {-1: [1,0,0], 0: [0,1,0], 1: [0,0,1]}."""
        return one_hot(last_ack + 1, 3)

    # ---- obs / state

    def _entity_parts(self, state: EnvState, params: EnvParams
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Feature rows ``(B, A, 8)`` and the same-MEC visibility mask
        ``(B, A, A)`` (padded agents see only themselves: their
        ``mec_index`` sentinels are unique)."""
        rows = torch.cat([self._ack_onehot(state.last_ack),
                          self._agent_inf(state, params)], dim=-1)
        mec = state.mec_index
        return rows, mec.unsqueeze(-1) == mec.unsqueeze(-2)

    def _raw_obs(self, state: EnvState, params: EnvParams) -> torch.Tensor:
        """(B, A, obs_dim) observations before normalization."""
        if self.cfg.obs_entity_mode:
            rows, same_mec = self._entity_parts(state, params)
            return self._entity_obs(rows, same_mec)
        inf = self._agent_inf(state, params)
        return torch.cat([state.last_ack.float().unsqueeze(-1), inf],
                         dim=-1)

    def _entity_obs(self, rows: torch.Tensor, same_mec: torch.Tensor
                    ) -> torch.Tensor:
        a = self.n_agents
        ent = torch.where(same_mec.unsqueeze(-1), rows.unsqueeze(-3), 0.0)
        eye = torch.eye(a, device=rows.device).expand(
            rows.shape[:-2] + (a, a)).unsqueeze(-1)
        return torch.cat([ent, eye], dim=-1).flatten(-2)

    def get_obs(self, state: EnvState, params: EnvParams,
                update_norm: bool = True, obs_form: str = "dense"
                ) -> Tuple[EnvState, object]:
        """Normalized per-agent observations ``(B, A, obs_dim)``. Default:
        the Welford state updates agent by agent, each agent normalized
        with the statistics after its own update (Q4/Q5); ``fast_norm``
        merges all agents at once (from the factored entity form in
        entity mode, as the JAX package does). ``obs_form`` (see the
        module docstring) picks dense, compact or both; the compact form
        reuses this call's feature rows and mask."""
        if obs_form not in OBS_FORMS:
            raise ValueError(f"obs_form must be one of {OBS_FORMS}, got "
                             f"{obs_form!r}")
        if self.cfg.fast_norm and self.cfg.obs_entity_mode:
            rows, same_mec = self._entity_parts(state, params)
            norm = select_update(
                state.norm,
                welford_update_batch_factored(state.norm, rows, same_mec),
                update_norm)
            state = dataclasses.replace(state, norm=norm)
            dense = (None if obs_form == "compact" else
                     apply_norm(norm, self._entity_obs(rows, same_mec)))
            if obs_form == "dense":
                return state, dense
            compact = (rows, same_mec) + self._compact_stats(state)
            return state, (compact if obs_form == "compact"
                           else (dense, compact))
        if obs_form != "dense":
            self._require_compact()
        raw = self._raw_obs(state, params)
        if self.cfg.fast_norm:
            norm, obs = normalize_batch(state.norm, raw, update=update_norm)
            return dataclasses.replace(state, norm=norm), obs
        norm, rows = state.norm, []
        for i in range(self.n_agents):
            norm, y = normalize(norm, raw[..., i, :], update=update_norm)
            rows.append(y)
        return dataclasses.replace(state, norm=norm), torch.stack(rows, -2)

    def _require_compact(self) -> None:
        if not (self.cfg.obs_entity_mode and self.cfg.fast_norm):
            raise ValueError(
                "the compact entity observation needs obs_entity_mode and "
                "fast_norm (the sequential normalizer gives each observer "
                "its own statistics)")

    def _compact_stats(self, state: EnvState
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The shared normalizer's mean and std per entity position,
        ``(B, A, F)`` each."""
        shape = state.norm.mean.shape[:-1] + (self.n_agents,
                                              self.obs_entity_feats)
        return (state.norm.mean.reshape(shape),
                state.norm.std.reshape(shape))

    def compact_obs(self, state: EnvState, params: EnvParams
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
        """Factored entity observation of a post-``get_obs`` state (its
        normalizer already updated): ``(rows (B, A, 8), same_mec (B, A, A)
        bool, mean (B, A, 9), std (B, A, 9))``. Every observer is
        normalized by the same per-position statistics, so these
        reconstruct the dense obs exactly; padded agents' unique negative
        ``mec_index`` makes each visible only to itself. Needs
        ``obs_entity_mode`` and ``fast_norm``."""
        self._require_compact()
        rows, same_mec = self._entity_parts(state, params)
        return (rows, same_mec) + self._compact_stats(state)

    def get_state(self, state: EnvState, params: EnvParams) -> torch.Tensor:
        """(B, state_dim): all ACK one-hots ++ all agent_inf rows
        (++ action one-hots first with ``state_last_action``)."""
        parts = [self._ack_onehot(state.last_ack).flatten(-2),
                 self._agent_inf(state, params).flatten(-2)]
        if self.cfg.state_last_action:
            parts.insert(0, one_hot(state.last_action,
                                    self.n_actions).flatten(-2))
        return torch.cat(parts, dim=-1)

    def get_avail_actions(self, state: EnvState, params: EnvParams
                          ) -> torch.Tensor:
        """(B, A, n_actions) int32: an empty buffer allows only action 0;
        ``edge_only`` forbids local compute when a job exists; padded
        agents are held to action 0."""
        dev, n = state.job_valid.device, self.n_actions
        idle_only = torch.arange(n, device=dev) == 0
        busy = (torch.arange(n, device=dev) > 0 if self.cfg.edge_only
                else torch.ones(n, dtype=torch.bool, device=dev))
        has_job = state.job_valid[..., 0:1]
        avail = torch.where(has_job, busy, idle_only)
        mask = params.agent_mask(self.n_agents).unsqueeze(-1)
        return torch.where(mask, avail, idle_only).to(torch.int32)

    def get_critic_score(self, state: EnvState, key: torch.Tensor,
                         params: EnvParams) -> torch.Tensor:
        """CRITIC scores ``(B, A)`` of [task_prior, queueing-delay ratio,
        buffer-fill ratio] plus 1e-6-scale noise."""
        has_job = state.job_valid[..., 0]
        lm = params.deadline_ms[:, None]
        prior = has_job.float()
        delay_q = torch.where(
            has_job, (lm - state.job_deadline[..., 0]) * (1.0 / lm), 0.0)
        fill = torch.where(
            has_job, state.job_valid.sum(dim=-1).float()
            * recip(self.cfg.latency_max_ms / self.t_length + 1), 0.0)
        mat = torch.stack([prior, delay_q, fill], dim=-1)
        noise = _round(prng.uniform(key, mat.shape[1:], 0.9, 1.1), 2) * 1e-6
        return critic(mat + noise)

    # ---- queues

    def _generate_jobs(self, state: EnvState, draws: StepDraws,
                       params: EnvParams) -> EnvState:
        """With prob ``job_prob`` (surge-modulated) append a job ``(data ~
        U[min, max] bits, deadline)`` to each active agent's queue (the
        JAX ``bernoulli`` is ``uniform < p``)."""
        a, j = self.n_agents, self.max_jobs
        phase = (f32(2.0 * np.pi) * state.time_slot.float()
                 / params.surge_period)
        p_eff = torch.clamp(
            params.job_prob * fma(params.surge_amp, torch.sin(phase), 1.0),
            0.0, 1.0)
        gen = (draws.job_u < p_eff[:, None]) & params.agent_mask(a)
        cnt = state.job_valid.sum(dim=-1, keepdim=True)
        slot = ((torch.arange(j, device=cnt.device) == cnt)
                & gen.unsqueeze(-1) & (cnt < j))
        return dataclasses.replace(
            state,
            job_data=torch.where(slot, draws.job_data.unsqueeze(-1),
                                 state.job_data),
            job_deadline=torch.where(slot, params.deadline_ms[:, None, None],
                                     state.job_deadline),
            job_valid=state.job_valid | slot,
            task_num=state.task_num + gen.to(torch.int32))

    def _pad_sentinel(self, mec_index: torch.Tensor,
                      params: EnvParams) -> torch.Tensor:
        """A unique negative serving-MEC index for every padded agent."""
        a = self.n_agents
        sentinel = -1 - torch.arange(a, dtype=mec_index.dtype,
                                     device=mec_index.device)
        return torch.where(params.agent_mask(a), mec_index, sentinel)

    def _update_users(self, state: EnvState, ack: torch.Tensor,
                      draws: StepDraws, params: EnvParams) -> EnvState:
        """Teleport (Q6, gated by ``teleport_prob``), pop the head job
        where ACK != -1, age every deadline by one slot, drop the
        expired, compact the survivors to the front in FIFO order, then
        maybe generate."""
        new_mec = draws.new_mec
        new_pos = self._place(draws, new_mec, params)
        tel = draws.teleport_u < params.teleport_prob[:, None]
        new_mec = torch.where(tel, new_mec, state.mec_index)
        new_pos = torch.where(tel.unsqueeze(-1), new_pos, state.pos)
        new_mec = self._pad_sentinel(new_mec, params)

        popped = ((ack != -1) & state.job_valid[..., 0]).unsqueeze(-1)

        def shift(x, fill):
            return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)],
                             dim=-1)

        data = torch.where(popped, shift(state.job_data, 0.0),
                           state.job_data)
        deadline = torch.where(popped, shift(state.job_deadline, 0.0),
                               state.job_deadline)
        valid = torch.where(popped, shift(state.job_valid, False),
                            state.job_valid)

        deadline = deadline - self.t_length
        keep = valid & (deadline > 0)
        # survivors move to the exclusive prefix count of kept jobs (a
        # stable compaction); dropped jobs go to a spare last column
        j = self.max_jobs
        dest = torch.where(keep, keep.long().cumsum(dim=-1) - 1, j)
        lead = keep.shape[:-1]
        packed_data = torch.zeros(lead + (j + 1,), device=data.device)
        packed_dl = torch.zeros_like(packed_data)
        packed_data.scatter_(-1, dest, data)
        packed_dl.scatter_(-1, dest, deadline)
        n_kept = keep.sum(dim=-1, keepdim=True)
        state = dataclasses.replace(
            state, mec_index=new_mec, pos=new_pos,
            job_data=packed_data[..., :j], job_deadline=packed_dl[..., :j],
            job_valid=torch.arange(j, device=keep.device) < n_kept)
        return self._generate_jobs(state, draws, params)

    # ---- reward

    def _reward(self, state: EnvState, ack: torch.Tensor, params: EnvParams
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           EnvState]:
        """Reference ``get_reward`` over its six branches, on pre-teleport
        positions and pre-update queues; also counts successes and
        completion delays. → (reward, delay_reward, overtime, state)."""
        has_job = state.job_valid[..., 0]
        data = state.job_data[..., 0]
        deadline = state.job_deadline[..., 0]
        lm = params.deadline_ms[:, None]

        local_hundredths = torch.round(self._local_raw(data, params) * 100.0)
        local_delay = local_hundredths * recip(100)           # _round(·, 2)
        offload_delay = self._offload_delay(data, state.pos,
                                            state.mec_index, params)
        is_local = has_job & (ack == 0)
        is_collision = has_job & (ack == -1)
        is_offload = has_job & (ack == 1)
        local_in = deadline - local_delay > 0
        offload_in = deadline - offload_delay > 0
        local_ok, local_miss = is_local & local_in, is_local & ~local_in
        collision_expiring = is_collision & (deadline - self.t_length <= 0)
        offload_ok = is_offload & offload_in
        offload_miss = is_offload & ~offload_in

        # XLA contracts local_delay - offload_delay into one FMA over the
        # rounded hundredths
        saving = fma(local_hundredths, recip(100), -offload_delay)
        delay_reward = torch.where(is_offload, saving, 0.0).sum(dim=-1)
        overtime = torch.where(local_miss | collision_expiring
                               | offload_miss, lm, 0.0).sum(dim=-1)
        success = local_ok | offload_ok
        finish_delay = torch.where(local_ok, local_delay, offload_delay)
        state = dataclasses.replace(
            state,
            task_success=state.task_success + success.to(torch.int32),
            remain_delay=state.remain_delay + torch.where(
                success, lm - deadline + finish_delay, 0.0))
        return delay_reward - overtime, delay_reward, overtime, state

    # ---- API

    def reset(self, key: torch.Tensor, norm: NormState = None,
              params: EnvParams = None, obs_form: str = "dense",
              rows=None
              ) -> Tuple[EnvState, object, torch.Tensor, torch.Tensor]:
        """Lane keys ``(B, width)`` → (state, obs, global_state, avail):
        fresh positions, empty queues, one ``generate_job`` call; ``norm``
        carries each lane's normalizer across episodes (None = fresh);
        ``obs`` in ``obs_form``; ``rows``: the lanes kept (``draw_step``)."""
        b, a, j = lane_count(key, rows), self.n_agents, self.max_jobs
        params = self.default_params(b) if params is None else params
        dev = key.device
        draws = self.draw_step(key, rows=rows)
        mec_index = self._pad_sentinel(draws.new_mec, params)
        zi = lambda: torch.zeros(b, a, dtype=torch.int32, device=dev)
        state = EnvState(
            time_slot=torch.zeros(b, dtype=torch.int32, device=dev),
            mec_index=mec_index,
            pos=self._place(draws, mec_index, params),
            job_data=torch.zeros(b, a, j, device=dev),
            job_deadline=torch.zeros(b, a, j, device=dev),
            job_valid=torch.zeros(b, a, j, dtype=torch.bool, device=dev),
            last_ack=zi(), last_action=zi(), task_num=zi(),
            task_success=zi(),
            remain_delay=torch.zeros(b, a, device=dev),
            norm=(NormState.create(self.obs_dim, (b,), dev) if norm is None
                  else norm))
        state = self._generate_jobs(state, draws, params)
        state, obs = self.get_obs(state, params, obs_form=obs_form)
        return (state, obs, self.get_state(state, params),
                self.get_avail_actions(state, params))

    def fresh_norm(self, state: EnvState) -> EnvState:
        return dataclasses.replace(state, norm=NormState.create(
            self.obs_dim, state.time_slot.shape, state.time_slot.device))

    def step(self, state: EnvState, actions: torch.Tensor,
             key: torch.Tensor, params: EnvParams, update_norm: bool = True,
             draws: StepDraws = None, obs_form: str = "dense"
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, StepInfo,
                        object, torch.Tensor, torch.Tensor]:
        """→ (state', reward, terminated, info, obs', global_state',
        avail'), each with the leading lane dimension; ``obs'`` in
        ``obs_form``. The step's random numbers come from the lane keys
        ``key (B, 2)``, or are handed in already drawn from them
        (``draws``, see ``draw_step``)."""
        if draws is None:
            draws = self.draw_step(key)
        a, m, c = self.n_agents, self.n_mec, self.n_actions
        mask = params.agent_mask(a)
        actions = actions.to(torch.int32)

        # per-MEC collision histogram (Q14) as an integer scatter-add;
        # padded agents (negative sentinel) count nowhere
        mec = state.mec_index.long()
        act = actions.long()
        real = (mec >= 0) & (mec < m)
        cell = torch.where(real, mec * c + act, m * c)
        counts = torch.zeros(cell.shape[:-1] + (m * c + 1,),
                             dtype=torch.int32, device=cell.device)
        counts.scatter_add_(-1, cell, torch.ones_like(cell,
                                                      dtype=torch.int32))
        counts = counts[..., :m * c]
        masked = torch.where(counts > 1, 0, counts)
        # utilization sums ALL slots incl. action 0 (reference quirk)
        utilization = masked.sum(dim=-1).float() \
            * recip(self.cfg.num_channels * m)
        chosen = torch.gather(masked, -1, torch.where(real, cell, 0))
        ack = torch.where(actions == 0, 0,
                          torch.where(chosen == 1, 1, -1)).to(torch.int32)
        ack = torch.where(mask, ack, 0)
        conflict_ratio = (ack == -1).float().sum(dim=-1) \
            * (1.0 / params.n_active.float())

        state = dataclasses.replace(state, time_slot=state.time_slot + 1,
                                    last_action=actions, last_ack=ack)
        reward, delay_reward, overtime, state = self._reward(state, ack,
                                                             params)
        state = self._update_users(state, ack, draws, params)

        terminated = state.time_slot >= self.cfg.episode_limit
        tn = state.task_num.sum(dim=-1)
        ts = state.task_success.sum(dim=-1)
        queued = state.job_valid.sum(dim=(-2, -1))
        tn1 = torch.clamp(tn, min=1).float()
        info = StepInfo(
            reward=reward, delay_reward=delay_reward,
            overtime_penalty=overtime,
            channel_utilization_rate=utilization,
            conflict_ratio=conflict_ratio,
            episode_limit=terminated,
            task_completion_rate=ts.float() / tn1,
            task_completion_delay=state.remain_delay.sum(dim=-1)
            / torch.clamp(ts, min=1).float(),
            deadline_miss_rate=(tn - ts - queued).float() / tn1)
        state, obs = self.get_obs(state, params, update_norm=update_norm,
                                  obs_form=obs_form)
        return (state, reward, terminated, info, obs,
                self.get_state(state, params),
                self.get_avail_actions(state, params))
