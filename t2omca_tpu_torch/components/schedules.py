"""Exploration schedules (port of ``t2omca_tpu/components/schedules.py``).

PyMARL's ``DecayThenFlatSchedule``: linear decay from ``start`` to
``finish`` over ``time_length`` env steps, flat afterwards. Written in
the form XLA lowers the JAX schedule to (``t`` times the float32
reciprocal of ``time_length``, then one fused multiply-add), so the
epsilon bits, which the exploration coins compare against, match.
"""

from __future__ import annotations

import dataclasses

import torch

from ..xla_float import f32, fma, recip


@dataclasses.dataclass(frozen=True)
class DecayThenFlatSchedule:
    start: float
    finish: float
    time_length: int

    def eval(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=torch.float32)
        frac = torch.clamp(t * recip(self.time_length), 0.0, 1.0)
        return fma(frac, f32(self.finish - self.start), f32(self.start))
