"""Scenario distributions (port of ``t2omca_tpu/envs/graftworld.py``,
the fixed kind).

A distribution samples one ``EnvParams`` instance per env lane from
lane keys ``(B, 2)``. The port has the fixed kind: one parameter point
(the family's canonical preset plus overrides), whose fleet size is
still drawn per lane when ``min_agents > 0`` (the padding axis). The
uniform and mixture kinds are ROADMAP Queue A item 11 and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .. import prng
from .mec_offload import EnvParams, MultiAgvOffloadingEnv

#: family order is the ``EnvParams.family`` id assignment
FAMILY_NAMES: Tuple[str, ...] = ("baseline", "hetfleet", "interference",
                                 "surge")
FAMILY_IDS: Dict[str, int] = {n: i for i, n in enumerate(FAMILY_NAMES)}

#: per-family canonical fixed parameter points
FAMILY_FIXED: Dict[str, Tuple[Tuple[str, object], ...]] = {
    "baseline": (),
    "hetfleet": (("compute_scale", ("linspace", 0.5, 2.0)),
                 ("tx_scale", ("linspace", 2.0, 0.5))),
    "interference": (("interference_w", 4e-11), ("gain_scale", 0.7)),
    "surge": (("surge_amp", 0.8), ("surge_period", 40.0)),
}


def _base_params(env: MultiAgvOffloadingEnv, b: int, family: str,
                 overrides: Tuple[Tuple[str, object], ...]) -> EnvParams:
    """Family-tagged default params for ``b`` lanes + the family's fixed
    preset + caller overrides (scalars, or ``("linspace", lo, hi)`` for
    the per-agent leaves)."""
    p = env.default_params(b)
    updates = {"family": torch.full_like(p.family, FAMILY_IDS[family])}
    for name, value in tuple(FAMILY_FIXED[family]) + tuple(overrides):
        leaf = getattr(p, name)
        if isinstance(value, tuple) and value and value[0] == "linspace":
            row = torch.linspace(float(value[1]), float(value[2]),
                                 leaf.shape[-1], dtype=leaf.dtype,
                                 device=leaf.device)
            updates[name] = row.expand_as(leaf).clone()
        else:
            updates[name] = torch.full_like(leaf, value)
    return dataclasses.replace(p, **updates)


@dataclasses.dataclass(frozen=True)
class FixedScenario:
    """One fixed parameter point; ``min_agents > 0`` draws each lane's
    fleet size in ``[min_agents, agv_num]`` from ``fold_in(key, 0)``."""

    family: str = "baseline"
    overrides: Tuple[Tuple[str, float], ...] = ()
    min_agents: int = 0

    def sample(self, keys: torch.Tensor, env: MultiAgvOffloadingEnv
               ) -> EnvParams:
        p = _base_params(env, keys.shape[0], self.family, self.overrides)
        if self.min_agents:
            n = prng.randint(prng.fold_in(keys, 0), (), self.min_agents,
                             env.n_agents + 1)
            p = dataclasses.replace(p, n_active=n)
        return p

    def families(self) -> Tuple[str, ...]:
        return (self.family,)


def _not_ported(kind: str):
    return NotImplementedError(
        f"scenario kind '{kind}' is not ported yet (ROADMAP.md Queue A "
        f"item 11: the scenario distributions); the port samples the "
        f"fixed kind")


@dataclasses.dataclass(frozen=True)
class UniformScenario:
    family: str = "baseline"
    ranges: Tuple[Tuple[str, float, float], ...] = ()
    overrides: Tuple[Tuple[str, float], ...] = ()
    min_agents: int = 0

    def __post_init__(self):
        raise _not_ported("uniform")


@dataclasses.dataclass(frozen=True)
class MixtureScenario:
    components: tuple = ()
    weights: Tuple[float, ...] = ()

    def __post_init__(self):
        raise _not_ported("mixture")


def make_distribution(scn) -> FixedScenario:
    """``config.ScenarioConfig`` → distribution (fixed kind only)."""
    kind = scn.kind or "fixed"
    if kind == "fixed":
        return FixedScenario(family=scn.family, overrides=scn.overrides,
                             min_agents=scn.min_agents)
    if kind == "uniform":
        return UniformScenario(family=scn.family, ranges=scn.ranges,
                               overrides=scn.overrides,
                               min_agents=scn.min_agents)
    if kind == "mixture":
        return MixtureScenario()
    raise ValueError(f"unknown scenario kind {kind!r}; "
                     f"valid: fixed/uniform/mixture")
