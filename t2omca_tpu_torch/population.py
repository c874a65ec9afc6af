"""The population axis: P experiment variants trained side by side (port
of ``t2omca_tpu/population.py``; the contract is ``docs/POPULATION.md``).

A population of ``population.size = P`` members trains P copies of the
whole training state (params, Adam, replay ring and PER priorities, runner
state, keys): member ``i`` starts from ``seed + i·seed_stride`` and may
carry its own learning rate, epsilon scale and PER exponent
(:class:`PopulationSpec`). JAX vmaps the fused superstep over a leading
``(P,)`` axis of one stacked state; the port keeps a **list of P member
states** instead, each bound to its own captured program
(``train/superstep.py`` ``PopulationProgram``), so every leaf of a member
is the leaf a solo run of that member would hold.

Per-member knobs enter the math at the same seams as in JAX, each a
neutral operation at its default:

* ``lr_scale`` multiplies the update after Adam (``learners/
  qmix_learner.py``: ``u * lr_scale``; 1.0 is bitwise neutral);
* ``eps_scale`` multiplies the epsilon schedule (the rollout's ``(T,)``
  epsilons, filled on the host in float32: ``parallel_runner.epsilons``);
* ``per_alpha`` is the PER exponent of the insert stamp and the priority
  feedback (``components/episode_buffer.py``), a device scalar of the
  member's program, so PBT can change it under capture;
* ``member`` salts the scenario sampler key (``population.scenario_salt``,
  ``envs/graftworld.member_scenario_key``).

The spec lives on the host (CPU tensors): its values reach each member's
program as fills of device scalars before a dispatch, without a sync.

PBT (``population.pbt.*``, off by default) runs on the host at
checkpoint-save boundaries only: the bottom ``frac`` members copy the full
state of the top ``frac`` and perturb their spec, with JAX's decisions
(:func:`pbt_step`). The copy writes into the losers' bound tensors, never
rebinds them: their captured graphs read those addresses.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import prng


@dataclasses.dataclass
class PopulationSpec:
    """Per-member hyperparameters: ``(P,)`` host tensors."""

    lr_scale: torch.Tensor      # (P,) f32: update multiplier
    eps_scale: torch.Tensor     # (P,) f32: epsilon-schedule multiplier
    per_alpha: torch.Tensor     # (P,) f32: PER priority exponent
    member: torch.Tensor        # (P,) int32: member index (scenario salt)

    def scalars(self, m: int) -> Tuple[float, float, float, int]:
        """Member ``m``'s ``(lr_scale, eps_scale, per_alpha)`` as Python
        floats (each exactly its float32 value) and its scenario salt
        (``member``: the slot's own index, or after an elastic reshape the
        index of the member it was taken from, as in JAX)."""
        return (float(self.lr_scale[m]), float(self.eps_scale[m]),
                float(self.per_alpha[m]), int(self.member[m]))


@dataclasses.dataclass
class PopState:
    """What a population checkpoint holds: the P member states and the
    (PBT-mutable) spec. ``utils/checkpoint.py`` stores the members under
    ``ts.<i>.`` and lifts a single-member checkpoint into this layout.
    ``members`` (a data-parallel rank's, or an actor placement's) names
    the global ids of the states ``ts`` holds, None for all P; the spec
    always has P rows."""

    ts: List[object]            # run.TrainState of each held member
    spec: PopulationSpec
    members: Optional[List[int]] = None


def population_size(cfg) -> int:
    """P when the population axis is on, else 0 (``population.size``)."""
    return int(cfg.population.size)


def member_seeds(cfg) -> List[int]:
    """Member ``i`` inits and threads keys from ``seed + i·seed_stride``:
    stride 1 (default) is seed replication with member 0 the solo run,
    stride 0 gives every member the same seed."""
    pc = cfg.population
    return [cfg.seed + i * pc.seed_stride for i in range(pc.size)]


def build_spec(cfg) -> PopulationSpec:
    """The config's per-member grids as a spec. Empty grids replicate the
    base config's value: ``lr_scale`` and ``eps_scale`` exactly 1.0,
    ``per_alpha`` ``replay.per_alpha``. ``lr_scale`` is ``lr_i / cfg.lr``
    divided in Python (double) and rounded once to float32, as JAX
    divides."""
    pc = cfg.population
    p = pc.size
    lr = pc.lr or (cfg.lr,) * p
    eps = pc.eps_scale or (1.0,) * p
    alpha = pc.per_alpha or (cfg.replay.per_alpha,) * p
    return PopulationSpec(
        lr_scale=torch.tensor([v / cfg.lr for v in lr], dtype=torch.float32),
        eps_scale=torch.tensor(eps, dtype=torch.float32),
        per_alpha=torch.tensor(alpha, dtype=torch.float32),
        member=torch.arange(p, dtype=torch.int32))


def spec_is_neutral(cfg) -> bool:
    """A one-member population with no grid, no scenario salt and no PBT:
    it runs the solo program with no spec seam (``spec=None``), as JAX
    does, so it is the classic program exactly."""
    pc = cfg.population
    return (pc.size == 1 and not pc.lr and not pc.eps_scale
            and not pc.per_alpha and not pc.scenario_salt
            and not pc.pbt.enabled)


def init_population(exp, cfg, learner_params=None, members=None
                    ) -> Tuple[List[object], PopulationSpec]:
    """→ (member states, spec): P explicit solo ``exp.init_state(seed_i)``
    calls, so member ``i`` holds exactly the state a solo run at
    ``seed_i`` starts from. ``learner_params`` (a list of P ``{"agent",
    "mixer"}`` pairs, e.g. carried from flax) replaces the seeded
    params. ``members`` (global ids) inits only those members (a
    data-parallel rank's); the spec has every member's row."""
    seeds = member_seeds(cfg)
    params = learner_params or [None] * len(seeds)
    if len(params) != len(seeds):
        raise ValueError(f"{len(params)} learner params for a population "
                         f"of {len(seeds)}")
    ids = range(len(seeds)) if members is None else members
    return ([exp.init_state(seeds[m], learner_params=params[m])
             for m in ids], build_spec(cfg))


def member_keys(cfg, device=None) -> List[torch.Tensor]:
    """The P driver key streams, ``PRNGKey(seed_i + 1)`` each: the driver
    mirrors the train gate once (the counters evolve identically across
    members) and splits each member's stream as the classic loop splits
    its one, so member 0's stream is the solo run's."""
    return [prng.PRNGKey(s + 1, device, cfg.prng_impl)
            for s in member_seeds(cfg)]


def member_ranking(ema) -> Optional[List[int]]:
    """The members best first by their return EMA (the stats
    accumulator's ``member_return_ema``), what an elastic shrink keeps;
    None until every member has one (JAX's ``_save_topology``)."""
    if not ema or any(v is None for v in ema):
        return None
    return sorted(range(len(ema)), key=lambda m: ema[m], reverse=True)


# --------------------------------------------------------------------------
# PBT: host-side select-and-perturb at checkpoint-save boundaries
# --------------------------------------------------------------------------


def pbt_step(cfg, ts: List[object], spec: PopulationSpec,
             member_perf: Optional[List[Optional[float]]], t_env: int,
             members: Optional[List[int]] = None, placement=None
             ) -> Tuple[List[object], PopulationSpec, Optional[dict]]:
    """One exploit/explore pass (``population.pbt.*``) with JAX's
    decisions: rank members by ``member_perf`` (the stats accumulator's
    per-member return EMA) with a stable argsort, let the bottom ``n =
    round(P·frac)`` (at least 1, at most P // 2) copy the full state of the
    top ``n``, re-salt each loser's rollout key with ``fold_in(key, t_env
    + m + 1)``, perturb the losers' spec by ``perturb`` or
    ``1/perturb`` from ``default_rng((seed << 17) ^ (t_env + 1))`` (alpha
    clipped to [1e-3, 1]), and rescale the copied priorities to the new
    exponent, ``p ** (a_new / a_old)``. → ``(ts, spec, info)``; ``info``
    None is a no-op (a member without a return yet, or P too small).

    ``ts`` holds the members' bound states: the copies are written into
    the losers' own tensors (``_copy_into``), which their captured graphs
    read, and ``ts`` is returned as it came.

    Under population × dp ``ts`` holds this rank's members (global ids
    ``members``) and ``placement`` is the ``mesh.PopulationParallel`` of
    the rank: every rank makes the same decisions from the same
    ``member_perf``, a donor on another rank sends its whole state to the
    loser's rank (``placement.copy_member``), and the spec is updated on
    every rank, so the result is the one-process step's."""
    from .train.superstep import _copy_into
    pc = cfg.population.pbt
    p = cfg.population.size
    if (member_perf is None or len(member_perf) != p
            or any(v is None for v in member_perf)):
        return ts, spec, None
    n = max(1, int(round(p * pc.frac)))
    if 2 * n > p:
        n = p // 2
    if n < 1:
        return ts, spec, None
    order = np.argsort(np.asarray(member_perf, np.float64), kind="stable")
    losers, winners = order[:n], order[-n:]
    src = np.arange(p)
    src[losers] = winners
    held = dict(zip(range(p) if members is None else members, ts))
    # winners and losers are disjoint: copying one at a time is the JAX
    # gather's result
    for m in losers:
        m, s = int(m), int(src[m])
        if placement is not None:
            placement.copy_member(held.get(m), held.get(s), m, s)
        else:
            _copy_into(held[m], held[s])
            held[m].runner.t_env = held[s].runner.t_env
    for m in losers:
        if int(m) not in held:
            continue
        # the copy took the donor's rollout key verbatim: re-salt it, or
        # the loser replays its donor's trajectories
        rkey = held[int(m)].runner.key
        rkey.copy_(prng.fold_in(rkey, int(t_env) + int(m) + 1,
                                cfg.prng_impl))
    rng = np.random.default_rng((int(cfg.seed) << 17) ^ (int(t_env) + 1))
    lr = spec.lr_scale.numpy().astype(np.float32).copy()
    eps = spec.eps_scale.numpy().astype(np.float32).copy()
    alpha = spec.per_alpha.numpy().astype(np.float32).copy()
    alpha_pre = alpha.copy()          # the donors' exponents

    def _perturb(v):
        return v * (pc.perturb if rng.random() < 0.5 else 1.0 / pc.perturb)

    for m in losers:
        lr[m] = _perturb(lr[src[m]])
        eps[m] = _perturb(eps[src[m]])
        alpha[m] = float(np.clip(_perturb(alpha[src[m]]), 1e-3, 1.0))
    for m in losers:
        if int(m) not in held:
            continue
        # the copied ring stores the donor's p^alpha_donor; the loser
        # writes p^alpha_new from now on: one exponent per ring
        buf = getattr(held[int(m)], "buffer", None)
        a_old, a_new = float(alpha_pre[src[m]]), float(alpha[m])
        if (buf is not None and hasattr(buf, "priorities")
                and a_old != a_new and a_old > 0):
            buf.priorities.copy_(buf.priorities ** (a_new / a_old))
    spec = PopulationSpec(
        lr_scale=torch.from_numpy(lr), eps_scale=torch.from_numpy(eps),
        per_alpha=torch.from_numpy(alpha), member=spec.member)
    return ts, spec, {
        "copied": {int(m): int(src[m]) for m in losers},
        "perf": [float(v) for v in member_perf],
    }
