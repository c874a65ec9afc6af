"""Episode batch and replay buffers on the device (port of
``t2omca_tpu/components/episode_buffer.py``).

Scheme: ``state (T+1, S)``, per-agent ``obs (T+1, A, O)``,
``avail_actions (T+1, A, n_actions)`` bool, ``actions (T, A)`` int32,
``reward (T,)``, ``terminated (T,)`` bool, ``filled (T,)`` bool; step T
of obs/state/avail is the bootstrap observation. The ring lives on the
buffer's device, sampling and priority feedback never leave it.

Differences from the JAX package, by design:

* The ring is written IN PLACE: ``insert_episode_batch`` and
  ``insert_time_major`` write the episode storage (``index_copy_``,
  ``index_put_``) and every priority write (the insert's stamp, the
  feedback of ``update_priorities``) is an ``index_put_`` on the ring's
  own priority vector. The storage is the largest tensor on the card, and
  JAX only avoids its copy by donating it. The cursor ``insert_pos`` and
  the fill ``episodes_in_buffer`` are 0-d int32 tensors on the ring's
  device, as in JAX; an insert returns new ones, which the fused
  superstep (``train/superstep.py``) copies into its captured buffers.
* ``sample`` draws from a key of the JAX key chain
  (``t2omca_tpu_torch.prng``), as the JAX buffers do; ``u`` (PER: one
  uniform per stratum) or ``scores`` (uniform: one per slot) may be
  handed in instead, so a test can give both packages the same numbers.
  PER's β is a device scalar: the host computes it in XLA's float32 form
  (``per_beta``) and either fills one here or hands one in (``beta=``),
  so a captured sampler reads the current value.
* A population member's PER exponent (``alpha=``, a () f32 device tensor
  of its program) replaces the buffer's ``alpha`` at the insert stamp
  and the priority feedback, the two places that write ``p^alpha``; the
  sampler reads the stored values. A Python float would be a constant of
  a captured graph, and PBT changes a member's exponent.

Compact entity storage (``compact_obs=True``) keeps ``obs`` as a
``CompactEntityObs``: the entity feature rows, the serving MEC's index as
int8 and the normalizer's mean and std, always f32 whatever the
``store_dtype`` (raw features of O(1e4), which the learner normalizes
again). At config 3's widths that is 1.0 MB an episode against 11.1 MB
of dense bf16 obs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import prng
from ..device import DeviceLike, resolve_device
from ..xla_float import f32, fma, recip

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class CompactEntityObs:
    """The factored entity observation as episode storage (leaves share
    their leading dimensions with the episode's ``obs`` slot)."""

    rows: torch.Tensor        # (..., A, F-1) f32 raw entity feature rows
    mec_index: torch.Tensor   # (..., A) int8: visibility is same-MEC
    mean: torch.Tensor        # (..., A, F) f32 per-position Welford mean
    std: torch.Tensor         # (..., A, F) f32

    def map(self, fn, *others: "CompactEntityObs") -> "CompactEntityObs":
        """``fn`` over each leaf (and the same leaf of ``others``)."""
        return CompactEntityObs(**{
            f.name: fn(getattr(self, f.name),
                       *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)})


def obs_map(fn, obs, *others):
    """``fn`` over an ``obs`` slot: each leaf of a ``CompactEntityObs``,
    or the dense tensor itself."""
    if isinstance(obs, CompactEntityObs):
        return obs.map(fn, *others)
    return fn(obs, *others)


@dataclasses.dataclass
class EpisodeBatch:
    """One (batch of) episode(s): tensors shaped ``(B, T(+1), ...)``."""

    obs: object                  # (B, T+1, A, obs_dim) store dtype, or a
                                 # CompactEntityObs (compact storage)
    state: torch.Tensor          # (B, T+1, state_dim) store dtype
    avail_actions: torch.Tensor  # (B, T+1, A, n_actions) bool
    actions: torch.Tensor        # (B, T, A) int32
    reward: torch.Tensor         # (B, T) float32
    terminated: torch.Tensor     # (B, T) bool: env-terminal, time limit
                                 # excluded (Q7)
    filled: torch.Tensor         # (B, T) bool

    @property
    def batch_size(self) -> int:
        return self.actions.shape[0]

    @property
    def max_seq_length(self) -> int:
        return self.actions.shape[1]

    def map(self, fn) -> "EpisodeBatch":
        """``fn`` over every tensor, the compact obs leaves included."""
        return EpisodeBatch(**{f.name: obs_map(fn, getattr(self, f.name))
                               for f in dataclasses.fields(self)})


@dataclasses.dataclass
class TimeMajorEpisodes:
    """A rollout's per-step outputs before episode-batch assembly: ``(T,
    B, ...)`` stacks plus the ``(B, ...)`` bootstrap step."""

    obs: object                  # (T, B, A, obs) store dtype, or compact
    state: torch.Tensor          # (T, B, state_dim) store dtype
    avail_actions: torch.Tensor  # (T, B, A, n_actions) bool
    actions: torch.Tensor        # (T, B, A) int32
    reward: torch.Tensor         # (T, B) f32, the train-recorded reward
    terminated: torch.Tensor     # (T, B) bool, env-terminal (Q7)
    last_obs: object             # (B, A, obs), or compact
    last_state: torch.Tensor     # (B, state_dim)
    last_avail: torch.Tensor     # (B, A, n_actions) bool

    @property
    def batch_size(self) -> int:
        return self.actions.shape[1]

    def to_batch(self) -> EpisodeBatch:
        """The ``(B, T(+1), ...)`` episode batch."""
        t, b = self.actions.shape[:2]
        bt = lambda x: x.transpose(0, 1)
        cat = lambda seq, last: torch.cat([bt(seq), last.unsqueeze(1)], 1)
        return EpisodeBatch(
            obs=obs_map(cat, self.obs, self.last_obs),
            state=cat(self.state, self.last_state),
            avail_actions=cat(self.avail_actions, self.last_avail),
            actions=bt(self.actions), reward=bt(self.reward),
            terminated=bt(self.terminated),
            filled=torch.ones(b, t, dtype=torch.bool,
                              device=self.actions.device))


@dataclasses.dataclass
class BufferState:
    """The ring plus PER priorities."""

    storage: EpisodeBatch        # (capacity, T(+1), ...)
    insert_pos: torch.Tensor     # () int32: next ring slot
    episodes_in_buffer: torch.Tensor  # () int32
    # (capacity,) f32, stored PRE-EXPONENTIATED (p^alpha) by the
    # prioritized buffer, raw by the uniform one (which never samples by
    # priority)
    priorities: torch.Tensor
    max_priority: torch.Tensor   # () f32: running max of RAW priorities


@dataclasses.dataclass(frozen=True)
class ReplayBuffer:
    """Uniform episode replay. ``device``: ``cuda`` unless named."""

    capacity: int
    episode_limit: int
    n_agents: int
    n_actions: int
    obs_dim: int
    state_dim: int
    store_dtype: str = "float32"
    compact_obs: bool = False
    device: DeviceLike = None

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"buffer capacity must be >= 1, got "
                             f"{self.capacity}")
        if self.store_dtype not in _STORE_DTYPES:
            raise ValueError(f"store_dtype must be one of "
                             f"{sorted(_STORE_DTYPES)}, got "
                             f"{self.store_dtype!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    def init(self) -> BufferState:
        c, t, a = self.capacity, self.episode_limit, self.n_agents
        sd, dev = _STORE_DTYPES[self.store_dtype], self.device
        if self.compact_obs:
            f = self.obs_dim // a          # entity feats (entity-mode layout)
            z = lambda *shape, dtype=torch.float32: torch.zeros(
                (c, t + 1, a) + shape, dtype=dtype, device=dev)
            obs = CompactEntityObs(rows=z(f - 1),
                                   mec_index=z(dtype=torch.int8),
                                   mean=z(f), std=z(f))
        else:
            obs = torch.zeros(c, t + 1, a, self.obs_dim, dtype=sd,
                              device=dev)
        storage = EpisodeBatch(
            obs=obs,
            state=torch.zeros(c, t + 1, self.state_dim, dtype=sd,
                              device=dev),
            avail_actions=torch.zeros(c, t + 1, a, self.n_actions,
                                      dtype=torch.bool, device=dev),
            actions=torch.zeros(c, t, a, dtype=torch.int32, device=dev),
            reward=torch.zeros(c, t, device=dev),
            terminated=torch.zeros(c, t, dtype=torch.bool, device=dev),
            filled=torch.zeros(c, t, dtype=torch.bool, device=dev),
        )
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return BufferState(storage=storage, insert_pos=zero,
                           episodes_in_buffer=zero.clone(),
                           priorities=torch.zeros(c, device=dev),
                           max_priority=torch.ones((), device=dev))

    def _ring_slots(self, state: BufferState, b: int) -> torch.Tensor:
        """Target slots of ``b`` incoming episodes, from the device
        cursor (one source for both insert paths)."""
        if b > self.capacity:
            raise ValueError(
                f"insert batch of {b} episodes exceeds buffer capacity "
                f"{self.capacity}; raise replay.buffer_size above "
                f"batch_size_run")
        return (state.insert_pos + torch.arange(b, device=self.device)
                ) % self.capacity

    def _insert_priority(self, state: BufferState, alpha=None
                         ) -> torch.Tensor:
        """Stored priority of freshly inserted episodes: the raw running
        max here, pre-exponentiated by the prioritized subclass (with
        ``alpha``, a population member's exponent, where given)."""
        del alpha
        return state.max_priority

    def _ring_advance(self, state: BufferState, idx: torch.Tensor,
                      b: int, alpha=None) -> BufferState:
        """Bookkeeping shared by both insert paths: the cursor and fill
        advance on the device, the new slots are stamped at the running
        max priority (in place)."""
        state.priorities.index_put_(
            (idx,), self._insert_priority(state, alpha).expand(b))
        return dataclasses.replace(
            state,
            insert_pos=(state.insert_pos + b) % self.capacity,
            episodes_in_buffer=torch.clamp(state.episodes_in_buffer + b,
                                           max=self.capacity))

    def insert_episode_batch(self, state: BufferState, batch: EpisodeBatch,
                             alpha=None) -> BufferState:
        """Ring-insert ``B`` episodes, overwriting the oldest when full;
        the storage and priorities are written in place (see the module
        docstring). ``alpha``: a population member's PER exponent."""
        b = batch.batch_size
        idx = self._ring_slots(state, b)
        put = lambda dst, src: dst.index_copy_(
            0, idx, src.to(device=dst.device, dtype=dst.dtype))
        for f in dataclasses.fields(EpisodeBatch):
            obs_map(put, getattr(state.storage, f.name),
                    getattr(batch, f.name))
        return self._ring_advance(state, idx, b, alpha)

    def insert_time_major(self, state: BufferState, tm: TimeMajorEpisodes,
                          alpha=None) -> BufferState:
        """Ring-insert straight from the rollout's time-major ``(T, B,
        ...)`` stacks and bootstrap step: ONE scatter per leaf, row ``(t,
        b)`` to ring element ``(slots[b], t)``, with no ``(B, T+1, ...)``
        batch assembled first. Contents bit-identical to
        ``insert_episode_batch(state, tm.to_batch())``."""
        b = tm.batch_size
        idx = self._ring_slots(state, b)
        t1 = self.episode_limit + 1
        t_grid = torch.arange(t1, device=self.device)[:, None].expand(t1, b)
        s_grid = idx[None, :].expand(t1, b)

        def put_tp1(dst, seq, last):
            upd = torch.cat([seq, last[None]], 0)
            dst.index_put_((s_grid, t_grid), upd.to(dst.dtype))

        def put_t(dst, seq):
            dst.index_put_((s_grid[:-1], t_grid[:-1]), seq.to(dst.dtype))

        st = state.storage
        obs_map(put_tp1, st.obs, tm.obs, tm.last_obs)
        put_tp1(st.state, tm.state, tm.last_state)
        put_tp1(st.avail_actions, tm.avail_actions, tm.last_avail)
        put_t(st.actions, tm.actions)
        put_t(st.reward, tm.reward)
        put_t(st.terminated, tm.terminated)
        st.filled.index_fill_(0, idx, True)
        return self._ring_advance(state, idx, b, alpha)

    def can_sample(self, state: BufferState, batch_size: int
                   ) -> torch.Tensor:
        """() bool on the device (the driver gates on its host mirror)."""
        return state.episodes_in_buffer >= batch_size

    def _gather(self, state: BufferState, idx: torch.Tensor
                ) -> EpisodeBatch:
        return state.storage.map(lambda s: s.index_select(0, idx))

    def sample(self, state: BufferState, key: Optional[torch.Tensor],
               batch_size: int, t_env=0,
               scores: Optional[torch.Tensor] = None, beta=None
               ) -> Tuple[EpisodeBatch, torch.Tensor, torch.Tensor]:
        """→ (batch, idx, weights). Uniform without replacement (weights
        1): the top ``batch_size`` of one uniform score per valid slot,
        drawn from ``key``; ``scores`` (``(capacity,)``) replaces the
        draw."""
        del t_env, beta
        if scores is None:
            scores = prng.uniform(key, (self.capacity,))
        scores = scores.to(self.device)
        valid = torch.arange(self.capacity, device=self.device) \
            < state.episodes_in_buffer
        scores = torch.where(valid, scores, float("-inf"))
        idx = torch.topk(scores, batch_size).indices
        return (self._gather(state, idx), idx,
                torch.ones(batch_size, device=self.device))

    def update_priorities(self, state: BufferState, idx: torch.Tensor,
                          priorities: torch.Tensor,
                          valid: Optional[torch.Tensor] = None, alpha=None
                          ) -> BufferState:
        del idx, priorities, valid, alpha
        return state                      # uniform: nothing to update


@dataclasses.dataclass(frozen=True)
class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER over episodes: ``P(i) ∝ p_i^alpha``, importance
    weights ``(N·P(i))^-β`` normalized by their max, β annealed linearly
    from ``beta0`` to 1 over ``t_max`` env steps."""

    alpha: float = 0.6
    beta0: float = 0.4
    t_max: int = 1

    def _insert_priority(self, state: BufferState, alpha=None
                         ) -> torch.Tensor:
        return state.max_priority ** (self.alpha if alpha is None
                                      else alpha)

    def per_beta(self, t_env) -> float:
        """β at ``t_env`` on the host, in the float32 form XLA gives the
        JAX sampler's ``beta0 + (1 - beta0)·clip(t_env / t_max, 0, 1)``
        (the divisor as a reciprocal multiply, then one fused
        multiply-add)."""
        frac = min(max(f32(f32(t_env) * recip(self.t_max)), 0.0), 1.0)
        return f32(frac * f32(1.0 - self.beta0) + f32(self.beta0))   # fma

    def _probs(self, state: BufferState) -> torch.Tensor:
        valid = torch.arange(self.capacity, device=self.device) \
            < state.episodes_in_buffer
        p = torch.where(valid, state.priorities, 0.0)
        return p / torch.clamp(p.sum(), min=1e-12)

    def sample(self, state: BufferState, key: Optional[torch.Tensor],
               batch_size: int, t_env=0, u: Optional[torch.Tensor] = None,
               beta: Optional[torch.Tensor] = None
               ) -> Tuple[EpisodeBatch, torch.Tensor, torch.Tensor]:
        """Stratified inverse-CDF: one uniform per equal-mass stratum,
        drawn from ``key``; ``u`` (``(batch_size,)`` in [0, 1)) replaces
        the draw. The float32 arithmetic is XLA's form of the JAX
        sampler's (constant divisors as reciprocal multiplies). ``beta``
        (a () f32 device tensor) is β; else ``per_beta(t_env)`` fills
        one. ``n`` is the device fill count, so nothing here reads the
        host."""
        probs = self._probs(state)
        cdf = torch.cumsum(probs, dim=0)
        if u is None:
            u = prng.uniform(key, (batch_size,))
        u = (torch.arange(batch_size, device=self.device)
             + u.to(self.device)) * recip(batch_size)
        idx = torch.searchsorted(cdf, u * cdf[-1], side="left")
        idx = torch.clamp(idx, 0, self.capacity - 1)
        if beta is None:
            beta = torch.full((), self.per_beta(t_env), device=self.device)
        n = torch.clamp(state.episodes_in_buffer, min=1).float()
        w = (n * torch.clamp(probs[idx], min=1e-12)) ** (-beta)
        w = w / torch.clamp(w.max(), min=1e-12)
        return self._gather(state, idx), idx, w

    def update_priorities(self, state: BufferState, idx: torch.Tensor,
                          priorities: torch.Tensor,
                          valid: Optional[torch.Tensor] = None, alpha=None
                          ) -> BufferState:
        """Feed RAW ``|TD| + 1e-6`` back for the sampled episodes (Q9),
        stored as ``p^alpha`` (``alpha``: a population member's exponent,
        else the buffer's). ``valid`` (a () bool tensor) is the
        non-finite guard: when False the write puts back the episodes'
        existing values and the running max stays, with no host sync. The
        priorities are written in place; the running max is a new
        tensor."""
        pa = priorities ** (self.alpha if alpha is None else alpha)
        new_max = torch.maximum(state.max_priority, priorities.max())
        if valid is not None:
            pa = torch.where(valid, pa, state.priorities[idx])
            new_max = torch.where(valid, new_max, state.max_priority)
        state.priorities.index_put_((idx,), pa)
        return dataclasses.replace(state, max_priority=new_max)
