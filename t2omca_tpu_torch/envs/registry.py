"""Environment registry (port of ``t2omca_tpu/envs/registry.py``).

Every registered key of the JAX package resolves here, aliases
included. The scenario families share one physics and differ in the
default scenario distribution each key carries.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..config import EnvConfig, ScenarioConfig
from ..device import DeviceLike
from .mec_offload import MultiAgvOffloadingEnv

#: key → the scenario a bare config of that key trains over
REGISTRY: Dict[str, ScenarioConfig] = {
    "multi_agv_offloading": ScenarioConfig(kind="fixed", family="baseline"),
    "multi_agv_hetfleet": ScenarioConfig(kind="uniform", family="hetfleet"),
    "multi_agv_interference": ScenarioConfig(kind="uniform",
                                             family="interference"),
    "multi_agv_surge": ScenarioConfig(kind="uniform", family="surge"),
    "multi_agv_scenarios": ScenarioConfig(kind="mixture"),
}

ALIASES: Dict[str, str] = {
    "multi_mec": "multi_agv_offloading",
    "hetfleet": "multi_agv_hetfleet",
    "interference": "multi_agv_interference",
    "surge": "multi_agv_surge",
    "scenarios": "multi_agv_scenarios",
    "graftworld": "multi_agv_scenarios",
}


def resolve(key: str) -> Tuple[str, ScenarioConfig]:
    """→ (canonical key, its default scenario)."""
    canonical = ALIASES.get(key, key)
    if canonical not in REGISTRY:
        raise KeyError(f"unknown env '{key}'; canonical keys: "
                       f"{sorted(REGISTRY)}; aliases: {sorted(ALIASES)}")
    return canonical, REGISTRY[canonical]


def make_env(cfg: EnvConfig, device: DeviceLike = None,
             prng_impl: str = "threefry") -> MultiAgvOffloadingEnv:
    """The env of ``cfg.key``; ``device`` (``cuda`` unless named) is where
    its dynamics put tensors — the static sizes need none; ``prng_impl``:
    the run's (the lane keys' ``split`` and ``fold_in``)."""
    resolve(cfg.key)
    return MultiAgvOffloadingEnv(cfg, device=device, prng_impl=prng_impl)


def scenario_config(cfg: EnvConfig) -> ScenarioConfig:
    """An explicit ``env_args.scenario.kind`` wins; the empty kind falls
    back to the key's default."""
    if cfg.scenario.kind:
        return cfg.scenario
    return resolve(cfg.key)[1]


def make_scenario_distribution(cfg: EnvConfig):
    """→ the distribution the runner samples each lane's params from."""
    from .graftworld import make_distribution
    return make_distribution(scenario_config(cfg))
