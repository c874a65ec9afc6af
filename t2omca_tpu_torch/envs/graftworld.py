"""Scenario distributions (port of ``t2omca_tpu/envs/graftworld.py``).

A distribution samples one ``EnvParams`` instance per env lane from lane
keys ``(B, width)``: lane ``b`` draws what the JAX distribution's
``sample`` draws under ``jax.vmap`` from key ``b`` (under an
RngBitGenerator impl, JAX's batching rule: rows of one draw from the
first lane's key, ``prng``); ``rows`` keeps some lanes (a data-parallel
rank's). Three kinds:

* :class:`FixedScenario`: one parameter point (the family's canonical
  preset plus overrides); ``min_agents > 0`` still draws each lane's
  fleet size (the padding axis);
* :class:`UniformScenario`: uniform draws over named knob ranges (the
  family's envelope :data:`FAMILY_RANGES` when none are given), one
  ``fold_in(key, i + 1)`` per range, i.i.d. per agent for the ``(B, A)``
  knobs;
* :class:`MixtureScenario`: a weighted mixture over component
  distributions: ``k_pick, k_sample = split(key)``, the component index
  from ``prng.choice(k_pick, n, w / w.sum())``, every component sampled
  from ``fold_in(k_sample, i)`` and the drawn one selected leaf-wise by a
  gather. No branch by family, no host sync and no allocation that
  depends on the data, so the draw runs inside a captured rollout graph.

Every sample carries its family id in ``EnvParams.family``; the runner
puts it into ``RolloutStats.scenario`` and the stats accumulator reports
the ``slice<fam>_*`` rows from it. ``distribution_can_pad`` is the static
gate of the learner's mixer padding mask. Under a population with
``population.scenario_salt``, each member folds its index into the
sampler key (``member_scenario_key``), so members draw different
instances of the same distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .. import prng
from .mec_offload import EnvParams, MultiAgvOffloadingEnv, lane_count

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

#: per-family default uniform ranges (``kind: uniform`` with no explicit
#: ``ranges``), in the units of the ``EnvParams`` leaf
FAMILY_RANGES: Dict[str, Tuple[Tuple[str, float, float], ...]] = {
    "baseline": (),
    "hetfleet": (("compute_scale", 0.5, 2.0), ("tx_scale", 0.5, 2.0)),
    "interference": (("interference_w", 1e-11, 8e-11),
                     ("gain_scale", 0.4, 1.0)),
    "surge": (("surge_amp", 0.4, 1.0), ("surge_period", 20.0, 80.0),
              ("job_prob", 0.3, 0.7)),
}

#: ``EnvParams`` leaves a distribution may randomize or override
#: (``family`` is assigned by the distribution); ``config.sanity_check``
#: keeps a copy of this tuple
RANDOMIZABLE_FIELDS: Tuple[str, ...] = (
    "n_active", "gain_scale", "interference_w", "mec_scale",
    "teleport_prob", "job_prob", "surge_amp", "surge_period",
    "deadline_ms", "mec_compute_scale", "compute_scale", "tx_scale",
)


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


def _sample_n_active(keys: torch.Tensor, env: MultiAgvOffloadingEnv,
                     min_agents: int, rows=None) -> torch.Tensor:
    """Each lane's fleet size, uniform in ``[min_agents, agv_num]``."""
    return prng.randint(keys, (), min_agents, env.n_agents + 1,
                        env.prng_impl, rows)


@dataclasses.dataclass(frozen=True)
class FixedScenario:
    """One fixed parameter point; ``min_agents > 0`` draws each lane's
    fleet size in ``[min_agents, agv_num]`` from ``fold_in(key, 0)``."""

    family: str = "baseline"
    overrides: Tuple[Tuple[str, float], ...] = ()
    min_agents: int = 0

    def sample(self, keys: torch.Tensor, env: MultiAgvOffloadingEnv,
               rows=None) -> EnvParams:
        p = _base_params(env, lane_count(keys, rows), self.family,
                         self.overrides)
        if self.min_agents:
            p = dataclasses.replace(p, n_active=_sample_n_active(
                prng.fold_in(keys, 0, env.prng_impl), env, self.min_agents,
                rows))
        return p

    def families(self) -> Tuple[str, ...]:
        return (self.family,)


@dataclasses.dataclass(frozen=True)
class UniformScenario:
    """Uniform draws over named knob ranges, on top of the family's
    defaults and ``overrides``; empty ``ranges`` means the family's
    envelope (:data:`FAMILY_RANGES`). ``n_active`` draws an integer fleet
    size."""

    family: str = "baseline"
    ranges: Tuple[Tuple[str, float, float], ...] = ()
    overrides: Tuple[Tuple[str, float], ...] = ()
    min_agents: int = 0

    def effective_ranges(self) -> Tuple[Tuple[str, float, float], ...]:
        return self.ranges or FAMILY_RANGES[self.family]

    def sample(self, keys: torch.Tensor, env: MultiAgvOffloadingEnv,
               rows=None) -> EnvParams:
        impl = env.prng_impl
        p = _base_params(env, lane_count(keys, rows), self.family,
                         self.overrides)
        updates = {}
        # fold_in per field index: adding a range never reshuffles the
        # draws of the ranges before it
        for i, (name, lo, hi) in enumerate(self.effective_ranges()):
            k = prng.fold_in(keys, i + 1, impl)
            if name == "n_active":
                updates[name] = prng.randint(k, (), int(lo), int(hi) + 1,
                                             impl, rows)
            else:
                shape = tuple(getattr(p, name).shape[1:])
                updates[name] = prng.uniform(k, shape, float(lo), float(hi),
                                             rows)
        if self.min_agents and "n_active" not in updates:
            updates["n_active"] = _sample_n_active(
                prng.fold_in(keys, 0, impl), env, self.min_agents, rows)
        return dataclasses.replace(p, **updates)

    def families(self) -> Tuple[str, ...]:
        return (self.family,)


def mixture_probs(weights: Tuple[float, ...], n: int) -> np.ndarray:
    """``w / w.sum()`` in float32 as the JAX mixture computes it (empty
    weights: ``1/n`` each), the sum left to right."""
    w = (np.asarray(weights, np.float32) if weights
         else np.full((n,), 1.0 / n, np.float32))
    return (w / np.float32(prng.cumsum_f32(w)[-1])).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MixtureScenario:
    """Weighted mixture over component distributions: draw a component
    index per lane, sample every component, select the drawn one
    leaf-wise."""

    components: tuple = ()
    weights: Tuple[float, ...] = ()

    def sample(self, keys: torch.Tensor, env: MultiAgvOffloadingEnv,
               rows=None) -> EnvParams:
        if not self.components:
            raise ValueError("MixtureScenario needs >= 1 component")
        n, impl = len(self.components), env.prng_impl
        k_pick, k_sample = prng.split(keys, 2, impl).unbind(-2)
        idx = prng.choice(k_pick, n, mixture_probs(self.weights, n),
                          rows).long()
        cand = [c.sample(prng.fold_in(k_sample, i, impl), env, rows)
                for i, c in enumerate(self.components)]

        def pick(*leaves):
            stacked = torch.stack(leaves)              # (n, B, ...)
            ix = idx.reshape((1, -1) + (1,) * (stacked.dim() - 2))
            return stacked.gather(0, ix.expand((1,) + stacked.shape[1:]))[0]

        return EnvParams(**{f.name: pick(*(getattr(c, f.name)
                                           for c in cand))
                            for f in dataclasses.fields(EnvParams)})

    def families(self) -> Tuple[str, ...]:
        seen = []
        for c in self.components:
            for f in c.families():
                if f not in seen:
                    seen.append(f)
        return tuple(seen)


def family_distribution(name: str, min_agents: int = 0):
    """The canonical per-family distribution: baseline is its fixed
    point, every other family its uniform envelope."""
    if name not in FAMILY_IDS:
        raise KeyError(f"unknown scenario family {name!r}; known: "
                       f"{list(FAMILY_NAMES)}")
    if name == "baseline":
        return FixedScenario(min_agents=min_agents)
    return UniformScenario(family=name, min_agents=min_agents)


def make_distribution(scn):
    """``config.ScenarioConfig`` → distribution (``env_args.scenario.kind``
    fixed | uniform | mixture)."""
    kind = scn.kind or "fixed"
    if kind == "fixed":
        return FixedScenario(family=scn.family, overrides=scn.overrides,
                             min_agents=scn.min_agents)
    if kind == "uniform":
        return UniformScenario(family=scn.family, ranges=scn.ranges,
                               overrides=scn.overrides,
                               min_agents=scn.min_agents)
    if kind == "mixture":
        fams = scn.families or FAMILY_NAMES
        return MixtureScenario(
            components=tuple(family_distribution(f, scn.min_agents)
                             for f in fams),
            weights=tuple(scn.weights))
    raise ValueError(f"unknown scenario kind {kind!r}; "
                     f"valid: fixed/uniform/mixture")


def member_scenario_key(key: torch.Tensor, member: int,
                        impl: str = None) -> torch.Tensor:
    """The population member's scenario sampler key
    (``population.scenario_salt``): ``fold_in(key, member)``, a fold and
    never a split, as the runner's own scenario salt. Off by default:
    ``fold_in(key, 0)`` is not the identity, so member 0 would stop
    matching the solo run's scenario draws."""
    return prng.fold_in(key, member, impl)


def distribution_can_pad(dist, n_agents: int) -> bool:
    """Static: can ``dist`` ever draw ``n_active < n_agents`` (padded
    agents)? The gate of the learner's mixer padding mask: a
    distribution that never pads runs none of its ops."""
    if isinstance(dist, MixtureScenario):
        return any(distribution_can_pad(c, n_agents)
                   for c in dist.components)
    min_agents = getattr(dist, "min_agents", 0)
    if min_agents and min_agents < n_agents:
        return True
    for name, value in getattr(dist, "overrides", ()):
        # n_active is a scalar leaf: a ("linspace", ...) form here is a
        # config error, never a padding opt-in
        if (name == "n_active" and not isinstance(value, tuple)
                and float(value) < n_agents):
            return True
    if isinstance(dist, UniformScenario):
        for name, lo, _hi in dist.effective_ranges():
            if name == "n_active" and float(lo) < n_agents:
                return True
    return False
