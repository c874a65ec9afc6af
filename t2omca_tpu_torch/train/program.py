"""The trainer step: sample → train → priority feedback (port of
``_train_iter`` in ``t2omca_tpu/run.py:290-312``).

The training counterpart of ``serve/program.py``; the loop around it
(rollout → insert → gated train) is ``t2omca_tpu_torch/run.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import prng
from ..components.episode_buffer import BufferState
from ..learners.qmix_learner import LearnerState
from ..obs import sight


@dataclasses.dataclass
class TrainState:
    learner: LearnerState
    buffer: BufferState
    episode: torch.Tensor         # () int32: episodes inserted so far
                                  # (target sync), on the device
    runner: Optional[object] = None   # the loop's RunnerState


def build_train_iter(buffer, learner, cfg):
    """→ ``train_iter(ts, key, t_env, beta=None) -> (ts', info)``. ``key``
    (a ``(2,)`` key of the driver's chain) splits into ``k_sample,
    k_learn`` as in the JAX program; the sampler draws from ``k_sample``,
    and ``k_learn`` seeds a noisy q-head's training noise (the learner
    ignores it otherwise). PER's β is ``beta`` (a () f32 device tensor)
    when given, else the sampler fills it from ``t_env`` on the host; the
    episode counter and the ring's fill are device tensors, so with
    ``beta`` given the step reads no host value and may be captured. A
    step whose loss or gradients are not finite writes back the sampled
    episodes' existing priorities (``valid=``), so NaN never enters the
    ring. With ``obs.sight`` and PER the info also carries the
    post-update priorities' entropy. ``spec`` (a population member's
    knobs: ``lr_scale`` and ``per_alpha``, () f32 device tensors) reaches
    the learner's update and the priority feedback's exponent."""

    def train_iter(ts: TrainState, key: torch.Tensor, t_env,
                   beta: Optional[torch.Tensor] = None, spec=None):
        k_sample, k_learn = prng.split(key, 2, cfg.prng_impl).unbind(-2)
        batch, idx, weights = buffer.sample(ts.buffer, k_sample,
                                            cfg.batch_size, t_env,
                                            beta=beta)
        learner_state, info = learner.train(ts.learner, batch, weights,
                                            t_env, ts.episode, k_learn,
                                            spec=spec)
        buf = buffer.update_priorities(
            ts.buffer, idx, info["td_errors_abs"] + 1e-6,          # Q9
            valid=info["all_finite"],
            alpha=None if spec is None else spec.per_alpha)
        # the PER-health read over the post-update priorities (no-op
        # unless obs.sight and prioritized replay)
        info = sight.maybe_buffer_info(cfg, info, buf)
        return dataclasses.replace(ts, learner=learner_state,
                                   buffer=buf), info

    return train_iter


def build_host_train_iter(buffer, learner, cfg):
    """→ ``train_iter(ts, key, t_env) -> (ts', info)`` over a host-RAM
    ring (``components/host_replay.HostReplayBuffer``), JAX's
    ``train_iter_host``: the buffer samples with its own host RNG, the
    learner takes ``key`` as it is, and the priority feedback is deferred
    to the buffer's next sample or insert. With ``obs.sight`` and PER the
    info carries the host mirror's PER-health read."""

    def train_iter(ts: TrainState, key: torch.Tensor, t_env, **_):
        batch, idx, weights = buffer.sample(cfg.batch_size, int(t_env))
        learner_state, info = learner.train(ts.learner, batch, weights,
                                            t_env, ts.episode, key)
        buffer.defer_priority_update(idx, info["td_errors_abs"],
                                     info["all_finite"])
        if cfg.obs.sight.enabled and buffer.prioritized:
            info = dict(info, **buffer.sight_priority_info())
        return dataclasses.replace(ts, learner=learner_state), info

    return train_iter
