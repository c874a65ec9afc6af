"""Port parity of the batched rollout (``t2omca_tpu_torch.runners.
parallel_runner``) against the JAX package's jitted ``ParallelRunner.run``
at config-1 widths (4 AGVs, 2 MECs, emb 64, 3 heads, depth 2; sequential
normalizer, dense storage), 4 lanes, ``episode_limit`` 20.

The agent params are the JAX learner's, carried by ``convert.py``; the
runner state starts from the JAX ``init_train_state`` (and the port's own
``init_state`` is held against it). Epsilon anneals over 100 env steps,
so the exploration episodes see both random and greedy actions. Two
chained episodes each (the lanes' Welford state carries across, Q4).

Tolerances: actions, ``t_env`` and the key chain identical at every
step; obs, state and reward rtol 1e-5 / atol 1e-5 (the env's float32
differences, ``tests/test_torch_env.py``); stats rtol 1e-5 / atol
1e-4 (sums of rewards of order 1e2)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.convert import (agent_state_from_flax,
                                      learner_params_from_flax,
                                      state_from_jax)
from t2omca_tpu_torch.envs.mec_offload import EnvState
from t2omca_tpu_torch.run import Experiment
from t2omca_tpu_torch.runners.parallel_runner import (ParallelRunner,
                                                      RolloutStats,
                                                      RunnerState)

FLOAT = dict(rtol=1e-5, atol=1e-5)
STATS = dict(rtol=1e-5, atol=1e-4)


def config(**over):
    d = {"batch_size_run": 4, "batch_size": 4, "epsilon_anneal_time": 100,
         "env_args": {"agv_num": 4, "mec_num": 2, "num_channels": 2,
                      "episode_limit": 20, "fast_norm": False},
         "model": {"emb": 64, "heads": 3, "depth": 2, "mixer_emb": 64,
                   "mixer_heads": 3, "mixer_depth": 2},
         "replay": {"buffer_size": 8}}
    for key, val in over.items():
        sect, _, name = key.rpartition(".")
        (d.setdefault(sect, {}) if sect else d)[name] = val
    return d


class Pair:
    def __init__(self, d):
        self.jexp = JaxExperiment.build(jax_from_dict(d))
        self.jts = self.jexp.init_train_state(0)
        self.texp = Experiment.build(from_dict(d), device="cpu")
        np_params = jax.tree.map(np.asarray, self.jts.learner.params)
        self.learner_params = learner_params_from_flax(np_params, "cpu")
        self.agent = agent_state_from_flax(np_params["agent"], "cpu")
        self.jrun = jax.jit(self.jexp.runner.run,
                            static_argnames=("test_mode",))

    def runner_state(self):
        return state_from_jax(RunnerState,
                              jax.tree.map(np.asarray, self.jts.runner),
                              "cpu")


@pytest.fixture(scope="module")
def pair():
    return Pair(config())


def assert_close(t, j, what, tol=FLOAT):
    j = np.asarray(j)
    t = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j, err_msg=what)
    else:
        np.testing.assert_allclose(t, j.astype(np.float32), err_msg=what,
                                   **tol)


def assert_runner_state(trs, jrs, what):
    assert trs.t_env == int(jrs.t_env), what
    np.testing.assert_array_equal(trs.key.numpy(), np.asarray(jrs.key))
    for f in dataclasses.fields(EnvState):
        if f.name != "norm":
            assert_close(getattr(trs.env_states, f.name),
                         getattr(jrs.env_states, f.name), f"{what} {f.name}")
    for g in ("n", "mean", "s", "std"):
        assert_close(getattr(trs.env_states.norm, g),
                     getattr(jrs.env_states.norm, g), f"{what} norm.{g}")
    assert_close(trs.env_params.n_active, jrs.env_params.n_active, what)
    for g in ("n", "mean", "std"):
        assert_close(getattr(trs.rscale.norm, g),
                     getattr(jrs.rscale.norm, g), f"{what} rscale.{g}")


def run_both(p, test_mode, episodes=2):
    jrs, trs = p.jts.runner, p.runner_state()
    for ep in range(episodes):
        jrs, jb, js = p.jrun(p.jts.learner.params["agent"], jrs,
                             test_mode=test_mode)
        trs, tb, ts = p.texp.runner.run(p.agent, trs, test_mode=test_mode)
        what = f"episode {ep}"
        np.testing.assert_array_equal(tb.actions.numpy(),
                                      np.asarray(jb.actions), err_msg=what)
        for name in ("avail_actions", "terminated", "filled"):
            assert_close(getattr(tb, name), getattr(jb, name),
                         f"{what} {name}")
        for name in ("obs", "state", "reward"):
            assert_close(getattr(tb, name), getattr(jb, name),
                         f"{what} {name}")
        for f in dataclasses.fields(RolloutStats):
            assert_close(getattr(ts, f.name), getattr(js, f.name),
                         f"{what} stats.{f.name}", STATS)
        assert_runner_state(trs, jrs, what)
    return trs, tb, ts


def test_init_state_matches_jax(pair):
    """``Experiment.init_state``: the runner from ``split(PRNGKey(seed))``
    (the ``env_args.seed`` fold-in, scenario draw, reset of every lane)
    equals the JAX runner state; the learner holds the carried params."""
    ts = pair.texp.init_state(0, learner_params=pair.learner_params)
    assert_runner_state(ts.runner, pair.jts.runner, "init")
    assert ts.episode == 0 and ts.buffer.episodes_in_buffer == 0
    assert torch.equal(ts.learner.params["agent"]["feat_embedding.weight"],
                       pair.learner_params["agent"]["feat_embedding.weight"])


@pytest.mark.parametrize("test_mode", [False, True])
def test_rollout_matches_jax_for_two_episodes(pair, test_mode):
    trs, tb, ts = run_both(pair, test_mode)
    b, t = 4, 20
    assert tb.obs.shape == (b, t + 1, 4, 36) and tb.actions.dtype == \
        torch.int32
    assert trs.t_env == (0 if test_mode else 2 * b * t)
    assert float(ts.epsilon) == (0.0 if test_mode else
                                 pytest.approx(0.1))
    # every stored action was available
    taken = torch.gather(tb.avail_actions[:, :-1], -1,
                         tb.actions.long().unsqueeze(-1))
    assert bool(taken.all())


def test_reward_scaling_rollout_matches_jax():
    """``env_args.reward_scaling``: the stored reward is scaled by the
    lanes' running std, the stats keep the raw reward, and the scale
    state carries; a test rollout leaves the scale state alone."""
    p = Pair(config(**{"env_args.reward_scaling": True}))
    trs, tb, ts = run_both(p, test_mode=False)
    assert int(trs.rscale.norm.n) == 40
    raw = ts.episode_return
    assert not torch.allclose(tb.reward.sum(1), raw)
    jrs, _, _ = p.jrun(p.jts.learner.params["agent"], p.jts.runner,
                       test_mode=True)
    trs2, _, _ = p.texp.runner.run(p.agent, p.runner_state(),
                                   test_mode=True)
    assert int(trs2.rscale.norm.n) == int(jrs.rscale.norm.n) == 0


def test_unported_paths_raise(pair):
    """Capture (ported with the driver's episode runner) emits the JAX
    runner's trajectory of the same episode: pre-step positions and MECs,
    post-step ACKs and actions identical, rewards and step info at the
    env's tolerance. A config that acts through the entity tables but
    stores dense obs (``compact_entity_store: false``) builds, asks the
    env for both obs forms, and rolls out as JAX does: actions identical,
    the stored dense obs at the env's tolerance."""
    jrun = jax.jit(pair.jexp.runner.run,
                   static_argnames=("test_mode", "capture"))
    *_, jviz = jrun(pair.jts.learner.params["agent"], pair.jts.runner,
                    test_mode=False, capture=True)
    *_, tviz = pair.texp.runner.run(pair.agent, pair.runner_state(),
                                    capture=True)
    for name in ("pos", "mec_index", "acks", "actions", "reward"):
        assert_close(tviz[name], jviz[name], f"viz {name}")
    for f in dataclasses.fields(tviz["info"]):
        assert_close(getattr(tviz["info"], f.name),
                     getattr(jviz["info"], f.name), f"viz info.{f.name}")
    p = Pair(config(**{"env_args.fast_norm": True,
                       "model.use_entity_tables": True,
                       "replay.compact_entity_store": False}))
    runner = ParallelRunner(p.texp.env, p.texp.mac, p.texp.cfg)
    assert runner.obs_form == "both" and p.texp.mac.use_entity_tables
    assert not p.texp.buffer.compact_obs
    run_both(p, test_mode=False, episodes=1)


@pytest.mark.parametrize("t_env", [0, 60, 10 ** 6])
def test_epsilon_greedy_select_matches_jax(t_env):
    """The selector alone, from the same key, q and avail: the same
    actions and epsilon (its coins, Gumbel argmax and schedule)."""
    from t2omca_tpu.components.action_selectors import (
        EpsilonGreedySelector as JaxSel, random_avail as jax_random_avail)
    from t2omca_tpu.components.schedules import \
        DecayThenFlatSchedule as JaxSched
    from t2omca_tpu_torch.components.action_selectors import (
        EpsilonGreedySelector, random_avail)
    from t2omca_tpu_torch.components.schedules import DecayThenFlatSchedule
    from t2omca_tpu_torch.convert import tensor_from_jax
    rng = np.random.default_rng(t_env)
    q = rng.standard_normal((6, 5, 9)).astype(np.float32)
    avail = rng.random((6, 5, 9)) < 0.5
    avail[..., 0] = True
    args = (1.0, 0.05, 120)
    jsel, tsel = JaxSel(JaxSched(*args)), EpsilonGreedySelector(
        DecayThenFlatSchedule(*args))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ja, je = jax.jit(jsel.select, static_argnames="test_mode")(
            key, q, avail, t_env)
        ta, te = tsel.select(tensor_from_jax(key, "cpu"),
                             torch.from_numpy(q), torch.from_numpy(avail),
                             t_env)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert float(te) == float(je)
        np.testing.assert_array_equal(
            random_avail(tensor_from_jax(key, "cpu"),
                         torch.from_numpy(avail)).numpy(),
            np.asarray(jax_random_avail(key, avail)))
