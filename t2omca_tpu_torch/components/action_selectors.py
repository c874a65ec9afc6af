"""Action selectors (port of ``t2omca_tpu/components/action_selectors.py``).

* ``epsilon_greedy``: with probability ε a uniformly random available
  action (the Gumbel trick), else the argmax over available actions;
  test mode forces ε = 0.
* ``noisy-new``: greedy in train and test mode; exploration lives in
  the agent's noisy q-head.

Draws come from the JAX key chain (``t2omca_tpu_torch.prng``): ``select``
splits its key into ``k_coin, k_rand`` as the JAX selector does, so the
same key gives the same coins and the same random actions.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import prng
from .schedules import DecayThenFlatSchedule


def masked_argmax(q: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """Greedy action over available ones: unavailable Q-values become
    ``-inf`` before the argmax. Ties go to the first index, as in
    ``jnp.argmax``."""
    return torch.where(avail > 0, q, float("-inf")).argmax(dim=-1)


def random_avail(key: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """A uniform available action per row of ``avail (..., n)`` from one
    ``(2,)`` key: the argmax of Gumbel noise over the available
    actions."""
    return _gumbel_argmax(prng.gumbel(key, avail.shape), avail)


def _gumbel_argmax(g: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    return torch.where(avail > 0, g, float("-inf")).argmax(dim=-1)


def exploration_draws(key: torch.Tensor, shape, rows=None, impl=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The epsilon-greedy selector's draws from ``key (..., width)`` for q
    of ``shape`` ``(..., n_actions)``: ``k_coin, k_rand = split(key)``,
    the coins ``uniform(k_coin, shape[:-1])`` and the Gumbel noise
    ``gumbel(k_rand, shape)``. Leading key dimensions (steps: a scan in
    JAX, not a vmap) lead the results; ``rows`` keeps those rows of
    ``shape``'s first dimension (a data-parallel rank's env lanes);
    ``impl``: the run's ``prng_impl``."""
    scan = key.dim() - 1
    k_coin, k_rand = prng.split(key, 2, impl, scan).unbind(-2)
    return (prng.uniform(k_coin, tuple(shape[:-1]), rows=rows, scan=scan),
            prng.gumbel(k_rand, tuple(shape), rows=rows, scan=scan))


@dataclasses.dataclass(frozen=True)
class EpsilonGreedySelector:
    schedule: DecayThenFlatSchedule

    def epsilon(self, t_env, test_mode: bool, eps_scale=None) -> torch.Tensor:
        eps = self.schedule.eval(t_env)
        if eps_scale is not None:
            eps = eps * eps_scale
        return torch.zeros_like(eps) if test_mode else eps

    def select(self, key: torch.Tensor, q: torch.Tensor,
               avail: torch.Tensor, t_env, test_mode: bool = False,
               eps_scale=None, draws=None, eps=None, impl=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``key (width,)``; q, avail ``(..., n_actions)`` → (actions
        ``(...)``, epsilon). ``draws`` (``exploration_draws`` of ``key``)
        replaces drawing here. ``t_env`` is a host int, so epsilon stays
        on the host and the coin compares against it without a copy;
        ``eps`` (a () f32 device tensor the host filled from the same
        schedule) replaces it, so a captured rollout reads its current
        value. Both compare the same float32 number."""
        if eps is None or test_mode:
            eps = self.epsilon(t_env, test_mode, eps_scale)
            thresh = float(eps)
        else:
            thresh = eps
        greedy = masked_argmax(q, avail)
        if test_mode:
            return greedy, eps
        coin, g = (exploration_draws(key, q.shape, impl=impl)
                   if draws is None else draws)
        return torch.where(coin < thresh, _gumbel_argmax(g, avail),
                           greedy), eps


@dataclasses.dataclass(frozen=True)
class NoisySelector:
    """Greedy selection; exploration comes from the agent's noisy head."""

    schedule: DecayThenFlatSchedule

    def epsilon(self, t_env, test_mode: bool, eps_scale=None) -> torch.Tensor:
        return torch.zeros(())

    def select(self, key: torch.Tensor, q: torch.Tensor,
               avail: torch.Tensor, t_env, test_mode: bool = False,
               eps_scale=None, draws=None, eps=None, impl=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        del key, eps_scale, draws, eps, impl
        return masked_argmax(q, avail), torch.zeros(())


SELECTOR_REGISTRY = {
    "epsilon_greedy": EpsilonGreedySelector,
    "noisy-new": NoisySelector,
}
