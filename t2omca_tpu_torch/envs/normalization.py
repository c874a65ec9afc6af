"""Running normalization on carried state (port of
``t2omca_tpu/envs/normalization.py``).

The reference's two quirks stay: **Q5**, the first Welford sample sets
``std = x`` (so the first normalized output is exactly 0), and **Q4**,
the observation normalizer updates on every call, evaluation included
(callers pass ``update``).

``NormState`` leaves may carry leading lane dimensions: ``n (...)``
and ``mean``/``s``/``std (..., dim)``; every function maps over them.
The float32 arithmetic is written as XLA lowers the JAX package's
(``t2omca_tpu_torch.xla_float``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..xla_float import f32, fma, recip, sqrt


@dataclasses.dataclass
class NormState:
    """Welford running statistics (reference ``RunningMeanStd``)."""

    n: torch.Tensor       # (...) int32 sample count
    mean: torch.Tensor    # (..., dim) f32
    s: torch.Tensor       # (..., dim) sum of squared deviations
    std: torch.Tensor     # (..., dim)

    @classmethod
    def create(cls, dim: int, lead: Tuple[int, ...] = (),
               device=None) -> "NormState":
        z = lambda: torch.zeros(lead + (dim,), device=device)
        return cls(n=torch.zeros(lead, dtype=torch.int32, device=device),
                   mean=z(), s=z(), std=z())


def _col(n: torch.Tensor) -> torch.Tensor:
    """Count ``(...)`` as a column ``(..., 1)`` against ``(..., dim)``."""
    return n.unsqueeze(-1)


def welford_update(state: NormState, x: torch.Tensor) -> NormState:
    """One ``RunningMeanStd.update`` step with ``x (..., dim)``."""
    n1 = state.n + 1
    first = _col(n1 == 1)
    n1f = _col(n1).float()
    new_mean = torch.where(first, x, state.mean + (x - state.mean) / n1f)
    new_s = torch.where(first, state.s,
                        fma(x - state.mean, x - new_mean, state.s))
    new_std = torch.where(first, x, sqrt(new_s / n1f))  # Q5
    return NormState(n=n1, mean=new_mean, s=new_s, std=new_std)


def select_update(state: NormState, updated: NormState,
                  update: bool) -> NormState:
    """The updated statistics when ``update`` (a Python bool)."""
    return updated if update else state


def apply_norm(state: NormState, xs: torch.Tensor) -> torch.Tensor:
    """``(x - mean) / (std + 1e-8)``; ``xs (..., rows, dim)`` against
    statistics ``(..., dim)``."""
    mean, std = state.mean.unsqueeze(-2), state.std.unsqueeze(-2)
    return (xs - mean) / (std + 1e-8)


def normalize(state: NormState, x: torch.Tensor,
              update: bool = True) -> Tuple[NormState, torch.Tensor]:
    """``Normalization.__call__``: optionally update, then normalize
    ``x (..., dim)`` with the post-update statistics."""
    state = select_update(state, welford_update(state, x), update)
    return state, (x - state.mean) / (state.std + 1e-8)


def welford_update_batch(state: NormState, xs: torch.Tensor) -> NormState:
    """Order-free batched Welford: merge the ``A`` samples ``xs (..., A,
    dim)`` in one Chan merge (skips Q5 from ``n == 0``)."""
    a = xs.shape[-2]
    bmean = xs.sum(dim=-2) * recip(a)
    bs = ((xs - bmean.unsqueeze(-2)) ** 2).sum(dim=-2)
    return _welford_merge(state, a, bmean, bs)


def _welford_merge(state: NormState, a: int, bmean: torch.Tensor,
                   bs: torch.Tensor) -> NormState:
    """Chan-style merge of batch statistics (count ``a``, mean ``bmean``,
    squared-deviation sum ``bs``); the count products run in f32."""
    n1 = state.n + a
    nf = _col(state.n).float()
    bnf = float(a)
    n1f = nf + bnf
    delta = bmean - state.mean
    new_mean = state.mean + delta * bnf / n1f
    new_s = fma(delta ** 2, nf * bnf / n1f, state.s + bs)
    new_std = sqrt(new_s / n1f)
    return NormState(n=n1, mean=new_mean, s=new_s, std=new_std)


def welford_update_batch_factored(state: NormState, rows: torch.Tensor,
                                  same_mec: torch.Tensor) -> NormState:
    """``welford_update_batch`` over the entity observation without
    building it: ``rows (..., A, F-1)`` are the entity feature rows and
    ``same_mec (..., A, A)`` the visibility mask; the is-self feature's
    statistics are closed forms (see the JAX module)."""
    a = rows.shape[-2]
    cnt = same_mec.sum(dim=-2).float()                         # (..., A)
    frac = (cnt * recip(a)).unsqueeze(-1)
    bmean_f = rows * frac
    bs_f = fma((a - cnt).unsqueeze(-1), bmean_f ** 2,
                cnt.unsqueeze(-1) * (rows - bmean_f) ** 2)
    lead = rows.shape[:-1]
    bmean_s = torch.full(lead + (1,), f32(1.0 / a),
                         device=rows.device)
    bs_s = torch.full(lead + (1,), f32((a - 1.0) / a),
                      device=rows.device)
    bmean = torch.cat([bmean_f, bmean_s], dim=-1).flatten(-2)
    bs = torch.cat([bs_f, bs_s], dim=-1).flatten(-2)
    return _welford_merge(state, a, bmean, bs)


def normalize_batch(state: NormState, xs: torch.Tensor, update: bool = True
                    ) -> Tuple[NormState, torch.Tensor]:
    """One order-free merge of all rows ``xs (..., A, dim)``, every row
    normalized with the post-merge statistics."""
    state = select_update(state, welford_update_batch(state, xs), update)
    return state, apply_norm(state, xs)


@dataclasses.dataclass
class RewardScaleState:
    """``RewardScaling`` carried state: a discounted return whose running
    std divides rewards."""

    norm: NormState
    r: torch.Tensor       # (dim,) discounted return accumulator
    gamma: float = 0.99

    @classmethod
    def create(cls, gamma: float, dim: int = 1,
               device=None) -> "RewardScaleState":
        return cls(norm=NormState.create(dim, device=device),
                   r=torch.zeros(dim, device=device), gamma=gamma)


def scale_reward(state: RewardScaleState, x: torch.Tensor
                 ) -> Tuple[RewardScaleState, torch.Tensor]:
    r = fma(state.r, f32(state.gamma), x)
    norm = welford_update(state.norm, r)
    y = x / (norm.std + 1e-8)
    return RewardScaleState(norm=norm, r=r, gamma=state.gamma), y


def reset_reward_scale(state: RewardScaleState) -> RewardScaleState:
    return RewardScaleState(norm=state.norm, r=torch.zeros_like(state.r),
                            gamma=state.gamma)
