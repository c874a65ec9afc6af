"""Port parity of config 6's scenario mixture against the live JAX
functions (never ``tests/test_graftworld.py``'s stored digests):

* ``UniformScenario`` and ``MixtureScenario`` draws bit for bit against
  ``jax.jit(jax.vmap(dist.sample))`` on the same lane keys, for every
  ``EnvParams`` leaf (family envelopes, explicit ranges with
  ``n_active``, ``min_agents``, weights that do not sum to 1, zero
  weights); ``distribution_can_pad``, ``families()`` and the registry's
  family keys as JAX's; ``sanity_check`` rejects JAX's bad scenarios;
* the mixer padding mask: ``QMixLearner.train`` against JAX's on padded
  batches for two steps (``tests/test_torch_learner.py``'s tolerances),
  and bit-identical to the unmasked learner on a full fleet;
* the ``slice<fam>_*`` rows of ``StatsAccumulator`` against JAX's on the
  same ``RolloutStats``;
* one fused K = 2 dispatch of a cut config 6 (mixture, ``min_agents``,
  the default stack) against JAX's ``superstep_program(2)`` from the same
  seed, to its first train step, as ``tests/test_torch_superstep.py``
  does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu import config as jax_config
from t2omca_tpu.envs import graftworld as jg
from t2omca_tpu.envs import registry as jreg
from t2omca_tpu.envs.mec_offload import MultiAgvOffloadingEnv as JaxEnv
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu.run import TrainState as JaxTrainState
from t2omca_tpu.runners.parallel_runner import RolloutStats as JaxStats
from t2omca_tpu.utils.stats import StatsAccumulator as JaxAccumulator
from t2omca_tpu_torch import config as port_config
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.convert import learner_params_from_flax, tensor_from_jax
from t2omca_tpu_torch.envs import graftworld as tg
from t2omca_tpu_torch.envs import registry as treg
from t2omca_tpu_torch.envs.mec_offload import MultiAgvOffloadingEnv
from t2omca_tpu_torch.run import Experiment
from t2omca_tpu_torch.runners.parallel_runner import RolloutStats
from t2omca_tpu_torch.utils.stats import SLICE_KEYS, StatsAccumulator

import test_torch_learner as tl_test
from test_torch_superstep import INFO, _fused

ENV = dict(agv_num=8, mec_num=2, num_channels=2)
#: scenario blocks of both kinds and their edges; the last is config 6's
SCENARIOS = {
    "uniform_surge": dict(kind="uniform", family="surge"),
    "uniform_hetfleet_min3": dict(kind="uniform", family="hetfleet",
                                  min_agents=3),
    "uniform_ranges_n_active": dict(
        kind="uniform", family="interference",
        ranges=(("n_active", 2, 6), ("deadline_ms", 5.0, 9.0),
                ("mec_scale", 0.5, 1.5))),
    "uniform_overrides": dict(kind="uniform", family="baseline",
                              overrides=(("teleport_prob", 0.3),),
                              ranges=(("job_prob", 0.2, 0.9),)),
    "mixture_default": dict(kind="mixture"),
    "mixture_odd_weights": dict(kind="mixture",
                                families=("surge", "baseline", "hetfleet"),
                                weights=(0.3, 1.7, 0.05)),
    "mixture_zero_weights": dict(kind="mixture",
                                 weights=(0.0, 1.0, 2.0, 0.0)),
    "config6": dict(kind="mixture",
                    families=("baseline", "hetfleet", "interference",
                              "surge"),
                    weights=(0.25, 0.25, 0.25, 0.25), min_agents=4),
}


def _dists(scn):
    return (jg.make_distribution(jax_config.ScenarioConfig(**scn)),
            tg.make_distribution(port_config.ScenarioConfig(**scn)))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_draws_are_bit_exact(name):
    scn = SCENARIOS[name]
    jenv = JaxEnv(jax_config.EnvConfig(**ENV))
    tenv = MultiAgvOffloadingEnv(port_config.EnvConfig(**ENV), device="cpu")
    jd, td = _dists(scn)
    assert type(td).__name__ == type(jd).__name__
    assert td.families() == jd.families()
    keys = jax.random.split(jax.random.PRNGKey(3), 512)
    jp = jax.jit(jax.vmap(lambda k: jd.sample(k, jenv)))(keys)
    tp = td.sample(tensor_from_jax(keys, "cpu"), tenv)
    for f in dataclasses.fields(tp):
        got, want = getattr(tp, f.name), np.asarray(getattr(jp, f.name))
        assert got.numpy().dtype == want.dtype, f.name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
    fam = tp.family.numpy()
    if scn.get("weights"):
        zero = [i for i, w in enumerate(scn["weights"]) if w == 0.0]
        ids = [jg.FAMILY_IDS[f] for f in jd.families()]
        assert not np.isin(fam, [ids[i] for i in zero]).any()
    if scn["kind"] == "mixture" and not scn.get("weights"):
        assert len(np.unique(fam)) == len(jd.families())
    if scn.get("min_agents"):
        n = tp.n_active.numpy()
        assert n.min() >= scn["min_agents"] and n.max() <= ENV["agv_num"]
        assert n.min() < ENV["agv_num"]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_distribution_can_pad_matches_jax(name):
    jd, td = _dists(SCENARIOS[name])
    for n_agents in (3, 4, 8):
        assert tg.distribution_can_pad(td, n_agents) == \
            jg.distribution_can_pad(jd, n_agents), n_agents


def test_registry_family_keys_and_sanity_check_match_jax():
    assert set(treg.REGISTRY) == set(jreg.REGISTRY)
    assert treg.ALIASES == jreg.ALIASES
    assert tg.FAMILY_RANGES == jg.FAMILY_RANGES
    assert tg.RANDOMIZABLE_FIELDS == jg.RANDOMIZABLE_FIELDS
    for key in sorted(set(treg.REGISTRY) | set(treg.ALIASES)):
        jcfg = jax_config.EnvConfig(key=key, **ENV)
        tcfg = port_config.EnvConfig(key=key, **ENV)
        jd = jreg.make_scenario_distribution(jcfg)
        td = treg.make_scenario_distribution(tcfg)
        assert type(td).__name__ == type(jd).__name__, key
        assert td.families() == jd.families(), key
        assert dataclasses.asdict(treg.scenario_config(tcfg)) == \
            dataclasses.asdict(jreg.scenario_config(jcfg)), key
    with pytest.raises(KeyError, match="unknown scenario family"):
        tg.family_distribution("desert")
    # config.sanity_check's scenario checks, as JAX's
    bad = [dict(kind="gaussian"), dict(family="desert"),
           dict(kind="mixture", families=("desert",)),
           dict(kind="mixture", weights=(1.0, 2.0)),
           dict(kind="mixture", weights=(1.0, -1.0, 1.0, 1.0)),
           dict(overrides=(("family", 1.0),)),
           dict(ranges=(("n_active", 0, 4),)),
           dict(ranges=(("gain_scale", 2.0, 1.0),)),
           dict(min_agents=9)]
    for scn in bad:
        d = {"env_args": dict(ENV, scenario=scn)}
        with pytest.raises(ValueError) as te:
            port_config.sanity_check(port_config.from_dict(d))
        with pytest.raises(ValueError) as je:
            jax_config.sanity_check(jax_config.from_dict(d))
        assert str(te.value) == str(je.value), scn


# ------------------------------------------------------ the padding mask

def _pad_config(min_agents, **over):
    d = tl_test.config(**over)
    d["env_args"]["scenario"] = {"kind": "fixed", "min_agents": min_agents}
    return d


def _padded_episodes(rng, info):
    """``make_episodes`` with the fleet cut per episode: episode 0 keeps
    2 of 3 agents, episode 1 one, episode 2 all three but its middle
    agent idle-only (an active agent before an active one: not masked).
    Padded agents have only action 0 available and take it."""
    ep = tl_test.make_episodes(rng, info, tl_test.BATCH, tl_test.T)
    for b, n_active in ((0, 2), (1, 1)):
        ep["avail_actions"][b, :, n_active:, 1:] = False
        ep["actions"][b, :, n_active:] = 0
    ep["avail_actions"][2, :, 1, 1:] = False
    ep["actions"][2, :, 1] = 0
    ep["avail_actions"][2, 0, 2, 1] = True      # the last agent saw a job
    return ep


@pytest.mark.parametrize("case", ["qslice", "remat"])
def test_padding_mask_train_matches_jax(case):
    over = {"model.remat": True} if case == "remat" else {}
    jl, jls, tl, tls, info = tl_test.build_pair(_pad_config(2, **over),
                                                jit_init=True)
    assert tl._mask_padded and jl._mask_padded
    jtrain = jax.jit(jl.train)
    rng = np.random.default_rng(5)
    for step in range(2):
        ep = _padded_episodes(rng, info)
        w = rng.uniform(0.5, 1.0, tl_test.BATCH).astype(np.float32)
        jls, jinfo = jtrain(jls, tl_test.to_jax(ep), jnp.asarray(w), 0,
                            step + 1)
        tls, tinfo = tl.train(tls, tl_test.to_port(ep), torch.from_numpy(w),
                              0, step + 1)
        for key in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
                    "td_errors_abs"):
            np.testing.assert_allclose(tinfo[key].numpy(),
                                       np.asarray(jinfo[key]),
                                       err_msg=f"step {step} {key}",
                                       **tl_test.INFO)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-4)
        tl_test._params_close(tls.params, jls.params, f"step {step}")


def test_padding_mask_changes_padded_batches_only():
    """The same params and batches through a learner that can pad and one
    that cannot: a padded batch's loss differs (the mask is on), a full
    fleet's update is bit-identical (multiplying by 1.0)."""
    _, _, tl_pad, ls_pad, info = tl_test.build_pair(_pad_config(2),
                                                    jit_init=True)
    _, _, tl_full, ls_full, _ = tl_test.build_pair(_pad_config(0),
                                                   jit_init=True)
    assert tl_pad._mask_padded and not tl_full._mask_padded
    rng = np.random.default_rng(9)
    w = torch.ones(tl_test.BATCH)
    padded = tl_test.to_port(_padded_episodes(rng, info))
    _, i_pad = tl_pad.train(ls_pad, padded, w, 0, 1)
    _, i_full = tl_full.train(ls_full, padded, w, 0, 1)
    assert float(i_pad["loss"]) != float(i_full["loss"])
    full = tl_test.make_episodes(rng, info, tl_test.BATCH, tl_test.T)
    full["avail_actions"][:, 0, -1, 1] = True
    new_pad, i_pad = tl_pad.train(ls_pad, tl_test.to_port(full), w, 0, 1)
    new_full, i_full = tl_full.train(ls_full, tl_test.to_port(full), w, 0,
                                     1)
    for k in i_full:
        assert torch.equal(i_pad[k], i_full[k]), k
    for m in new_full.params:
        for k in new_full.params[m]:
            assert torch.equal(new_pad.params[m][k], new_full.params[m][k])


# ---------------------------------------------------------- slice rows

class _Sink:
    def __init__(self):
        self.rows = []

    def log_stat(self, key, value, t):
        self.rows.append((key, value, t))


def _stats(rng, shape, n_families):
    names = [f.name for f in dataclasses.fields(RolloutStats)]
    vals = {k: (rng.standard_normal(shape)
                * 10.0 ** rng.integers(-2, 4, shape)).astype(np.float32)
            for k in names if k not in ("epsilon", "scenario")}
    scenario = rng.integers(0, n_families, shape).astype(np.int32)
    eps = np.asarray(0.5, np.float32)
    port = RolloutStats(**{k: torch.from_numpy(v) for k, v in vals.items()},
                        epsilon=torch.from_numpy(eps),
                        scenario=torch.from_numpy(scenario))
    jax_ = JaxStats(**{k: jnp.asarray(v) for k, v in vals.items()},
                    epsilon=jnp.asarray(eps), scenario=jnp.asarray(scenario))
    return port, jax_


def test_slice_rows_match_jax_accumulator():
    """Pushes of (B,) and a stacked (K, B) over four families, a fold
    forced by FOLD_EVERY, a train flush and a test-prefixed flush: the
    same rows and values as JAX's accumulator, the slice rows included;
    one family alone logs no slice row."""
    rng = np.random.default_rng(0)
    ours, theirs = StatsAccumulator(), JaxAccumulator()
    sink_o, sink_t = _Sink(), _Sink()
    pushes = [(1024,), (4, 32), (37,)] + [(3,)] * 66
    for i, shape in enumerate(pushes):
        p, j = _stats(rng, shape, 4)
        ours.push(p)
        theirs.push(j)
    ours.flush(sink_o, 1)
    theirs.flush(sink_t, 1)
    p, j = _stats(rng, (32,), 4)
    ours.push(p)
    theirs.push(j)
    ours.flush(sink_o, 2, prefix="test_")
    theirs.flush(sink_t, 2, prefix="test_")
    p, j = _stats(rng, (16,), 1)
    ours.push(p)
    theirs.push(j)
    ours.flush(sink_o, 3)
    theirs.flush(sink_t, 3)
    assert sink_o.rows == sink_t.rows
    keys = {k for k, _, _ in sink_o.rows}
    for prefix in ("", "test_"):
        for fam in range(4):
            tag = f"{prefix}slice{fam}_"
            assert {tag + "n", tag + "return_mean"} <= keys
            assert {tag + k + "_mean" for k in SLICE_KEYS} <= keys
    assert not any(k.startswith("slice") for k, _, t in sink_o.rows
                   if t == 3)
    assert ours.fetches == theirs.fetches


# ------------------------------------------- config 6, fused, against JAX

#: config 6 (configs/config6_scenarios.yaml: the four-family mixture,
#: min_agents 4, superstep 4) cut to the CPU: 8 AGVs as shipped, 4 lanes
#: of 20 steps, batch 4, a ring of 8, emb 8, depth 1, K = 2
CONFIG6 = {"batch_size_run": 4, "batch_size": 4, "superstep": 2,
           "epsilon_anneal_time": 100, "target_update_interval": 8,
           "env_args": {"agv_num": 8, "mec_num": 2, "num_channels": 2,
                        "episode_limit": 20,
                        "scenario": SCENARIOS["config6"]},
           "model": {"emb": 8, "heads": 2, "depth": 1, "mixer_emb": 8,
                     "mixer_heads": 2, "mixer_depth": 1},
           "replay": {"buffer_size": 8}}


def test_config6_fused_dispatch_matches_jax_superstep():
    """One K = 2 dispatch of the cut config 6 from the same seed, the
    learner's params carried from flax, on the default stack (entity
    tables, compact storage, PER): the first rollout's stats at the env's
    tolerance with the family ids exact and at least two families drawn;
    the first train step's info at ``tests/test_torch_loop.py``'s
    tolerances (``grad_norm`` at the default stack's 2e-3, as
    ``tests/test_torch_entity.py``), the padding mask on both sides;
    counters, ring cursor and the key rows equal."""
    jexp = JaxExperiment.build(jax_config.from_dict(CONFIG6))
    # init_train_state's pieces, jitted (the same structure, faster; the
    # learner's params are carried to the port from whatever they are)
    k_learner, k_runner = jax.random.split(jax.random.PRNGKey(0))
    jts = JaxTrainState(learner=jax.jit(jexp.learner.init_state)(k_learner),
                        runner=jax.jit(jexp.runner.init_state)(k_runner),
                        buffer=jax.jit(jexp.buffer.init)(),
                        episode=jnp.zeros((), jnp.int32))
    texp = Experiment.build(from_dict(CONFIG6), device="cpu")
    assert texp.learner._mask_padded and jexp.learner._mask_padded
    assert texp.runner.compact_store
    tts = texp.init_state(0, learner_params=learner_params_from_flax(
        jax.tree.map(np.asarray, jts.learner.params), "cpu"))
    jkey, rows = jax.random.PRNGKey(texp.cfg.seed + 1), []
    for _ in range(2):
        jkey, k_sample = jax.random.split(jkey)
        rows.append(k_sample)
    jts2, jstats, jinfos = jexp.superstep_program(2)(
        jts, jnp.stack(rows), jnp.asarray(0, jnp.int32))
    ts, (stats,), _, all_rows, gates, key = _fused(texp, tts, 2, 1)
    assert gates == [True, True]
    assert torch.equal(key, tensor_from_jax(jkey, "cpu"))
    fam = stats.scenario.numpy()
    np.testing.assert_array_equal(fam, np.asarray(jstats.scenario))
    assert len(np.unique(fam[0])) >= 2
    for f in dataclasses.fields(stats):
        got = getattr(stats, f.name)[:1].numpy()
        want = np.asarray(getattr(jstats, f.name))[:1]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=f.name)
    n_active = ts.runner.env_params.n_active.numpy()
    assert n_active.min() >= 4 and n_active.max() <= 8
    np.testing.assert_array_equal(
        n_active, np.asarray(jts2.runner.env_params.n_active))
    assert int(ts.buffer.insert_pos) == int(jts2.buffer.insert_pos)
    assert int(ts.episode) == int(jts2.episode) == 8
    assert int(ts.learner.train_steps) == int(jts2.learner.train_steps) == 2
    for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
              "grad_norm"):
        tol = dict(rtol=2e-3, atol=1e-6) if k == "grad_norm" else INFO
        np.testing.assert_allclose(all_rows[0][k].numpy(),
                                   np.asarray(jinfos[k])[0], err_msg=k,
                                   **tol)
        assert np.isfinite(float(all_rows[1][k]))
    assert all(bool(r["all_finite"]) for r in all_rows)
    # the second rollout's episodes fill ring slots 4..7: its padded
    # agents took action 0 at every step
    acts = ts.buffer.storage.actions[4:8].numpy()
    padded = np.arange(8)[None, :] >= n_active[:, None]
    assert padded.any() and (acts.transpose(0, 2, 1)[padded] == 0).all()
