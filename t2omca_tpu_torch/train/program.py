"""The trainer step: sample → train → priority feedback (port of
``_train_iter`` in ``t2omca_tpu/run.py:290-312``).

The training counterpart of ``serve/program.py``. The rollout that fills
the ring and the training loop around this step (``run.py``) are later
slices (``ROADMAP.md`` Queue A items 6 and 7): for now the ring is
filled by the caller, with ``ReplayBuffer.insert_episode_batch``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..components.episode_buffer import BufferState, PrioritizedReplayBuffer
from ..learners.qmix_learner import LearnerState


@dataclasses.dataclass
class TrainState:
    learner: LearnerState
    buffer: BufferState
    episode: int                  # episodes inserted so far (target sync)


def build_train_iter(buffer, learner, cfg):
    """→ ``train_iter(ts, t_env, generator=None, draws=None) -> (ts',
    info)``. ``draws`` replaces the sampler's random numbers (the PER
    buffer's ``u``, the uniform buffer's ``scores``); otherwise they come
    from ``generator``. A step whose loss or gradients are not finite
    writes back the sampled episodes' existing priorities (``valid=``),
    so NaN never enters the ring."""
    draw_kw = "u" if isinstance(buffer, PrioritizedReplayBuffer) else "scores"

    def train_iter(ts: TrainState, t_env,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[torch.Tensor] = None):
        batch, idx, weights = buffer.sample(
            ts.buffer, cfg.batch_size, t_env, generator=generator,
            **{draw_kw: draws})
        learner_state, info = learner.train(ts.learner, batch, weights,
                                            t_env, ts.episode)
        buf = buffer.update_priorities(
            ts.buffer, idx, info["td_errors_abs"] + 1e-6,          # Q9
            valid=info["all_finite"])
        return dataclasses.replace(ts, learner=learner_state,
                                   buffer=buf), info

    return train_iter
