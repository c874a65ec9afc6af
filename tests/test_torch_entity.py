"""Port parity of the default fast stack: the entity tables, compact
entity storage and the learner's compact unroll (``t2omca_tpu_torch``'s
``envs.mec_offload.compact_obs``, ``ops.query_slice.
agent_forward_qslice_entity``, ``CompactEntityObs`` storage, the
runner's compact ``obs_store`` and the learner's entity-table unroll)
against the JAX package's jitted functions on the CPU.

Widths: 5 AGVs, 2 MECs, emb 32, 2 heads, depth 2 (the rollouts 4 AGVs,
the loop ``tests/test_torch_loop.py``'s 4 AGVs at emb 64); ``fast_norm`` and the entity modes are the
config's defaults, so ``use_entity_tables`` and ``compact_entity_store``
are on without an override. Inputs come from numpy at a seed and from
JAX env states rolled from a seed; params are carried from flax by
``convert.py``.

Tolerances, each stated where it is used:

* ``compact_obs``: rows, ``same_mec`` and the statistics exactly; the
  dense obs rebuilt from them within rtol 1e-5 / atol 1e-6 of JAX's;
* the entity forward at f32: q and h rtol 1e-5 / atol 1e-6, gradients
  with respect to the params rtol 1e-4 / atol 1e-5; at bf16 within 32
  bf16 ULPs per element (``tests/test_entity_tables.py``'s bound);
* the rollout: actions, ``mec_index`` and the key chain identical, the
  float compact leaves at the env's rtol/atol 1e-5;
* the buffers: inserted leaves, sampled indices and gathered episodes
  exact, importance weights within rtol 1e-6 (``tests/test_torch_replay.
  py``'s bound: the float32 ``pow`` may differ in the last bit);
* ``QMixLearner.train`` and the loop at ``tests/test_torch_learner.py``'s
  and ``tests/test_torch_loop.py``'s tolerances, except the loop's
  ``grad_norm``: rtol 2e-3. The mixer reads the raw global state (data
  sizes of O(1e4)), its attention saturates, and the gradient through
  its logits is the small difference ``P·(dP − Δ)`` of large terms: two
  float32 lowerings of the same loss put the mixer's first-block
  gradients ~5e-4 apart in relative norm (ROADMAP Queue C, "the learner
  drifts"). Measured on the loop's third iteration from JAX's own batch
  and learner state: every agent gradient tensor (the entity unroll)
  within 1e-6 of JAX's in relative norm, the mixer's first block 5e-4;
  ``grad_norm`` 9.4e-5 to 1.2e-3 apart across two initializations of
  the same seed (eager and jitted flax init)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.components.episode_buffer import (
    CompactEntityObs as JaxCompact, EpisodeBatch as JaxBatch,
    PrioritizedReplayBuffer as JaxPER)
from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.ops.query_slice import \
    agent_forward_qslice_entity as jax_entity_forward
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu_torch.components.episode_buffer import (
    CompactEntityObs, EpisodeBatch, PrioritizedReplayBuffer)
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.convert import (agent_state_from_flax,
                                      learner_params_from_flax,
                                      learner_state_from_jax, state_from_jax,
                                      tensor_from_jax)
from t2omca_tpu_torch.envs.mec_offload import EnvParams, EnvState
from t2omca_tpu_torch.ops.query_slice import agent_forward_qslice_entity
from t2omca_tpu_torch.run import Experiment, run_classic

import test_torch_learner as tl_test
import test_torch_loop as loop_test

FLOAT = dict(rtol=1e-5, atol=1e-5)
B = 4


def config(**over):
    d = {"batch_size_run": B, "batch_size": 4,
         "env_args": {"agv_num": 5, "mec_num": 2, "num_channels": 2,
                      "episode_limit": 8},
         "model": {"emb": 32, "heads": 2, "depth": 2, "mixer_emb": 32,
                   "mixer_heads": 2, "mixer_depth": 2},
         "replay": {"buffer_size": 8}}
    for key, val in over.items():
        sect, _, name = key.rpartition(".")
        (d.setdefault(sect, {}) if sect else d)[name] = val
    return d


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@functools.lru_cache(maxsize=None)
def _jax_exp(**over):
    return JaxExperiment.build(jax_from_dict(config(**over)))


_PROGRAMS = {}


def _env_programs(jexp):
    """Jitted, vmapped reset and step of an experiment's env, compiled
    once per experiment (``_jax_exp`` caches the experiments)."""
    if id(jexp) not in _PROGRAMS:
        _PROGRAMS[id(jexp)] = (jexp, jax.jit(jax.vmap(jexp.env.reset)),
                               jax.jit(jax.vmap(jexp.env.step)))
    return _PROGRAMS[id(jexp)][1:]


def rolled(jexp, steps, seed, min_agents=0):
    """JAX env states after ``steps`` random legal steps (real queues and
    normalizer statistics) → (states, obs, params); ``min_agents`` draws
    padded lanes."""
    from t2omca_tpu.envs.graftworld import FixedScenario
    env = jexp.env
    key = jax.random.PRNGKey(seed)
    keys = jax.random.split(key, B)
    if min_agents:
        params = jax.vmap(lambda k: FixedScenario(
            min_agents=min_agents).sample(k, env))(keys)
    else:
        params = jax.vmap(lambda _: env.default_params())(jnp.arange(B))
    reset, step = _env_programs(jexp)
    states, obs, _, avail = reset(keys, None, params)
    rng = np.random.default_rng(seed)
    for t in range(steps):
        av = np.asarray(avail)
        acts = np.argmax(np.where(av > 0, rng.random(av.shape), -1), -1)
        out = step(states, jnp.asarray(acts.astype(np.int32)),
                   jax.random.split(jax.random.fold_in(key, t), B), params)
        states, obs, avail = out[0], out[4], out[6]
    return states, obs, params


def port_env():
    return Experiment.build(from_dict(config()), device="cpu").env


# ------------------------------------------------------------ compact_obs

@pytest.mark.parametrize("steps,min_agents", [(0, 0), (5, 0), (5, 2)])
def test_compact_obs_matches_jax(steps, min_agents):
    """``compact_obs`` of the same env states: rows, ``same_mec`` and the
    statistics exactly (padded lanes included: their unique sentinels
    see only themselves); the dense obs rebuilt from them within rtol
    1e-5 / atol 1e-6 of the obs JAX's env returned; ``get_obs`` in the
    compact and both forms gives the same tuple and the dense obs."""
    jexp = _jax_exp()
    env = jexp.env
    states, obs, params = rolled(jexp, steps, 11 + steps, min_agents)
    if min_agents:
        assert int(np.asarray(params.n_active).min()) < env.n_agents
    jc = jax.jit(jax.vmap(env.compact_obs))(states, params)
    tenv = port_env()
    ts = state_from_jax(EnvState, np_tree(states), "cpu")
    tp = state_from_jax(EnvParams, np_tree(params), "cpu")
    tc = tenv.compact_obs(ts, tp)
    for name, j, t in zip(("rows", "same_mec", "mean", "std"), jc, tc):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    rows, same_mec, mean, std = tc
    b, a, f = rows.shape[0], env.n_agents, env.obs_entity_feats
    rows9 = torch.cat([rows, torch.zeros(b, a, 1)], dim=-1)
    raw = torch.where(same_mec[..., None], rows9[:, None], 0.0)
    raw[:, torch.arange(a), torch.arange(a), f - 1] = 1.0
    norm = (raw - mean[:, None]) / (std + 1e-8)[:, None]
    np.testing.assert_allclose(norm.reshape(b, a, a * f).numpy(),
                               np.asarray(obs), rtol=1e-5, atol=1e-6)
    # the obs forms of get_obs (without a further update)
    _, dense = tenv.get_obs(ts, tp, update_norm=False)
    _, comp = tenv.get_obs(ts, tp, update_norm=False, obs_form="compact")
    _, (dense2, comp2) = tenv.get_obs(ts, tp, update_norm=False,
                                      obs_form="both")
    assert torch.equal(dense, dense2)
    for x, y, z in zip(tc, comp, comp2):
        assert torch.equal(x, y) and torch.equal(x, z)


# ------------------------------------------------------- the entity forward

def _forward_inputs(jexp, seed=3, steps=3):
    states, _, params = rolled(jexp, steps, seed)
    compact = jax.jit(jax.vmap(jexp.env.compact_obs))(states, params)
    variables = jexp.mac.init_params(jax.random.PRNGKey(seed),
                                     jexp.env.obs_dim)
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal(
        (B, jexp.env.n_agents, jexp.cfg.model.emb)).astype(np.float32)
    return compact, variables, hidden


def _kw(cfg, dtype):
    m = cfg.model
    return dict(emb=m.emb, heads=m.heads, depth=m.depth,
                n_actions=cfg.env_args.num_channels + 1,
                standard_heads=m.standard_heads, dtype=dtype)


def _port_compact(compact):
    return tuple(torch.from_numpy(np.array(x)) for x in compact)


@pytest.mark.parametrize("standard_heads", [False, True])
def test_entity_forward_matches_jax_f32(standard_heads):
    """q and h at f32 within rtol 1e-5 / atol 1e-6 of the jitted JAX
    function on real env states."""
    jexp = _jax_exp(**{"model.standard_heads": standard_heads})
    compact, variables, hidden = _forward_inputs(jexp)
    jq, jh = jax.jit(functools.partial(
        jax_entity_forward, **_kw(jexp.cfg, jnp.float32)))(
        variables, *compact, jnp.asarray(hidden))
    tq, th = agent_forward_qslice_entity(
        agent_state_from_flax(np_tree(variables), "cpu"),
        *_port_compact(compact), torch.from_numpy(hidden),
        **_kw(jexp.cfg, torch.float32))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)


def test_entity_forward_gradients_match_jax():
    """Gradients of ``sum(q·cq) + sum(h·ch)`` with respect to every
    agent param within rtol 1e-4 / atol 1e-5 of ``jax.grad``."""
    jexp = _jax_exp(**{"model.standard_heads": True})
    compact, variables, hidden = _forward_inputs(jexp, seed=5)
    rng = np.random.default_rng(9)
    a, e = jexp.env.n_agents, jexp.cfg.model.emb
    cq = rng.standard_normal((B, a, 3)).astype(np.float32)
    ch = rng.standard_normal((B, a, e)).astype(np.float32)
    kw = _kw(jexp.cfg, jnp.float32)

    def jloss(v):
        q, h = jax_entity_forward(v, *compact, jnp.asarray(hidden), **kw)
        return (q * cq).sum() + (h * ch).sum()

    jgrad = agent_state_from_flax(np_tree(jax.jit(jax.grad(jloss))(
        variables)), "cpu")
    params = {k: v.requires_grad_() for k, v in agent_state_from_flax(
        np_tree(variables), "cpu").items()}
    q, h = agent_forward_qslice_entity(
        params, *_port_compact(compact), torch.from_numpy(hidden),
        **_kw(jexp.cfg, torch.float32))
    loss = (q * torch.from_numpy(cq)).sum() + (h * torch.from_numpy(ch)).sum()
    grads = torch.autograd.grad(loss, list(params.values()))
    assert set(jgrad) == set(params)
    for (k, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), jgrad[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def assert_close_bf16_ulp(actual, desired, max_ulp=32):
    """Per-element bound in bf16 ULPs, the ULP floored at the tensor's
    RMS (``tests/test_entity_tables.py``'s rule: both sides round
    intermediates at different points, so the error scales with the
    summands)."""
    to_bf16 = lambda x: np.asarray(torch.as_tensor(np.asarray(
        x, np.float32)).to(torch.bfloat16).float())
    a, d = to_bf16(actual), to_bf16(desired)
    scale = np.maximum(np.maximum(np.abs(a), np.abs(d)),
                       np.sqrt(np.mean(d ** 2)))
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7.0)
    err = np.abs(a - d) / ulp
    assert err.max() <= max_ulp, (
        f"{int((err > max_ulp).sum())}/{err.size} elements beyond "
        f"{max_ulp} bf16 ULPs (worst {err.max():.1f})")


def test_entity_forward_bf16_within_ulp_bound():
    """The bf16 mode (config 3's dtype, standard heads) against JAX's
    bf16 entity forward: q and h within 32 bf16 ULPs per element."""
    jexp = _jax_exp(**{"model.standard_heads": True,
                       "model.dtype": "bfloat16"})
    compact, variables, hidden = _forward_inputs(jexp, seed=4)
    jq, jh = jax.jit(functools.partial(
        jax_entity_forward, **_kw(jexp.cfg, jnp.bfloat16)))(
        variables, *compact, jnp.asarray(hidden))
    tq, th = agent_forward_qslice_entity(
        agent_state_from_flax(np_tree(variables), "cpu"),
        *_port_compact(compact), torch.from_numpy(hidden),
        **_kw(jexp.cfg, torch.bfloat16))
    assert tq.dtype == th.dtype == torch.float32
    assert_close_bf16_ulp(tq.numpy(), jq)
    assert_close_bf16_ulp(th.numpy(), jh)


# ---------------------------------------------------------------- rollout

ROLL = {"env_args.agv_num": 4, "env_args.episode_limit": 12,
        "epsilon_anneal_time": 60}


def rollout_start(jexp, seed=0):
    """Agent variables and a runner state of the JAX package at a seed
    (jitted; ``init_train_state`` would build the learner and the ring
    too)."""
    k_agent, k_runner = jax.random.split(jax.random.PRNGKey(seed))
    variables = jax.jit(lambda k: jexp.mac.init_params(
        k, jexp.env.obs_dim))(k_agent)
    return variables, jax.jit(jexp.runner.init_state)(k_runner)


@pytest.fixture(scope="module")
def roll_pair():
    jexp = JaxExperiment.build(jax_from_dict(config(**ROLL)))
    texp = Experiment.build(from_dict(config(**ROLL)), device="cpu")
    assert texp.runner.compact_store and texp.mac.use_entity_tables
    assert texp.runner.obs_form == "compact"
    return jexp, rollout_start(jexp), texp


def assert_compact(t, j, what):
    np.testing.assert_array_equal(t.mec_index.numpy(),
                                  np.asarray(j.mec_index), err_msg=what)
    assert t.mec_index.dtype == torch.int8 and t.rows.dtype == torch.float32
    for name in ("rows", "mean", "std"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   err_msg=f"{what} {name}", **FLOAT)


@pytest.mark.parametrize("test_mode", [False, True])
def test_rollout_on_the_default_stack_matches_jax(roll_pair, test_mode):
    """Two chained episodes on the default stack (entity-table acting,
    compact storage, bf16-free f32): actions and the runner key chain
    identical every episode, the stored compact leaves at the env's
    tolerance (``mec_index`` exact), avail and terminal flags exact."""
    from t2omca_tpu_torch.runners.parallel_runner import RunnerState
    jexp, (variables, jrs), texp = roll_pair
    jrun = jax.jit(jexp.runner.run, static_argnames=("test_mode",))
    agent = agent_state_from_flax(np_tree(variables), "cpu")
    trs = state_from_jax(RunnerState, np_tree(jrs), "cpu")
    for ep in range(2):
        jrs, jb, _ = jrun(variables, jrs, test_mode=test_mode)
        trs, tb, _ = texp.runner.run(agent, trs, test_mode=test_mode)
        what = f"episode {ep}"
        assert isinstance(tb.obs, CompactEntityObs)
        np.testing.assert_array_equal(tb.actions.numpy(),
                                      np.asarray(jb.actions), err_msg=what)
        assert_compact(tb.obs, jb.obs, what)
        for name in ("avail_actions", "terminated", "filled"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)))
        np.testing.assert_allclose(tb.state.numpy(), np.asarray(jb.state),
                                   **FLOAT)
        np.testing.assert_array_equal(trs.key.numpy(), np.asarray(jrs.key))
        assert trs.t_env == int(jrs.t_env)
    taken = torch.gather(tb.avail_actions[:, :-1], -1,
                         tb.actions.long().unsqueeze(-1))
    assert bool(taken.all())


# ---------------------------------------------------------------- buffers

def compact_episodes(rng, b, t, a, f, m):
    """Numpy compact episodes shaped like the env's: MEC ids in [0, m)
    with the last agent padded (its unique negative sentinel), per
    position a mean and a std over a scale of 1 to 1e3 (the env's data
    sizes reach 1e4), and rows drawn around them, so the normalized
    tokens are O(1) as the env's are."""
    mec = rng.integers(0, m, (b, t + 1, a)).astype(np.int8)
    mec[..., -1] = -a
    scale = 10.0 ** rng.uniform(0, 3, (b, t + 1, a, f))
    scale[..., -1] = 0.5                        # the is-self feature
    mean = (rng.standard_normal((b, t + 1, a, f)) * scale)
    std = rng.uniform(0.2, 1.0, (b, t + 1, a, f)) * scale
    rows = mean[..., :-1] + std[..., :-1] * rng.standard_normal(
        (b, t + 1, a, f - 1))
    return dict(rows=rows.astype(np.float32), mec_index=mec,
                mean=mean.astype(np.float32), std=std.astype(np.float32))


def episodes(rng, info, b, t):
    """A full numpy episode batch with compact obs."""
    ep = tl_test.make_episodes(rng, info, b, t)
    a = info["n_agents"]
    ep["obs"] = compact_episodes(rng, b, t, a, info["obs_shape"] // a,
                                 info["n_agents"] // 2 + 1)
    return ep


def to_jax(ep):
    return JaxBatch(**{k: (JaxCompact(**{n: jnp.asarray(x) for n, x in
                                         v.items()}) if k == "obs"
                           else jnp.asarray(v)) for k, v in ep.items()})


def to_port(ep):
    conv = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return EpisodeBatch(**{k: (CompactEntityObs(**{n: conv(x) for n, x in
                                                    v.items()})
                               if k == "obs" else conv(v))
                           for k, v in ep.items()})


def test_compact_insert_and_per_sample_match_jax():
    """Three inserts of 3 episodes into a ring of 6 (it wraps), then PER
    samples from two keys: the stored compact leaves (f32 under bf16
    storage, the MEC index int8), the ring cursor, sampled indices and
    the gathered episodes equal JAX's exactly, the weights within rtol
    1e-6."""
    info = {"n_agents": 4, "n_actions": 3, "obs_shape": 4 * 9,
            "state_shape": 20}
    t, cap = 5, 6
    kw = dict(capacity=cap, episode_limit=t, n_agents=4, n_actions=3,
              obs_dim=36, state_dim=20, store_dtype="bfloat16",
              compact_obs=True, alpha=0.6, beta0=0.4, t_max=100)
    jbuf, tbuf = JaxPER(**kw), PrioritizedReplayBuffer(device="cpu", **kw)
    js, ts = jbuf.init(), tbuf.init()
    assert ts.storage.obs.rows.dtype == torch.float32
    assert ts.storage.obs.mec_index.dtype == torch.int8
    assert ts.storage.state.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    jinsert = jax.jit(jbuf.insert_episode_batch)
    for _ in range(3):
        ep = episodes(rng, info, 3, t)
        js, ts = jinsert(js, to_jax(ep)), tbuf.insert_episode_batch(
            ts, to_port(ep))
    assert ts.insert_pos == int(js.insert_pos) == 3
    assert ts.episodes_in_buffer == int(js.episodes_in_buffer) == cap
    for f in dataclasses.fields(JaxCompact):
        np.testing.assert_array_equal(
            getattr(ts.storage.obs, f.name).numpy(),
            np.asarray(getattr(js.storage.obs, f.name)), err_msg=f.name)
    js = js.replace(priorities=js.priorities.at[:].set(
        jnp.asarray(rng.uniform(0.1, 1.0, cap).astype(np.float32))))
    ts.priorities = torch.from_numpy(np.asarray(js.priorities))
    jsample = jax.jit(jbuf.sample, static_argnums=2)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        jb, ji, jw = jsample(js, key, 4, 50)
        tb, ti, tw = tbuf.sample(ts, tensor_from_jax(key, "cpu"), 4, 50)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        for f in dataclasses.fields(JaxCompact):
            np.testing.assert_array_equal(
                getattr(tb.obs, f.name).numpy(),
                np.asarray(getattr(jb.obs, f.name)), err_msg=f.name)
        np.testing.assert_array_equal(tb.actions.numpy(),
                                      np.asarray(jb.actions))
    # the port's converter carries a JAX ring with compact obs across
    from t2omca_tpu_torch.components.episode_buffer import BufferState
    conv = state_from_jax(BufferState, np_tree(js), "cpu")
    assert isinstance(conv.storage.obs, CompactEntityObs)
    assert torch.equal(conv.storage.obs.mec_index, ts.storage.obs.mec_index)


# ---------------------------------------------------------------- learner

def test_train_on_compact_batches_matches_jax():
    """Three ``QMixLearner.train`` steps on compact batches (the agent
    unrolls through the entity tables, the mixer through its query
    slice; the flash kernels' plain versions on this path are held
    against JAX's Pallas kernels in ``tests/test_torch_learner.py``, and
    their launch counts under compact storage there too):
    info rtol 1e-5 / atol 1e-6, ``grad_norm`` rtol 1e-4, params and
    target params atol 1e-5 (``tests/test_torch_learner.py``)."""
    d = tl_test.config(**{"replay.compact_entity_store": True,
                          "model.depth": 2, "model.mixer_depth": 2})
    jl, jls, tl, tls, info = tl_test.build_pair(d, jit_init=True)
    assert tl._agent_qslice and tl.mac.use_entity_tables
    jtrain = jax.jit(jl.train)
    rng = np.random.default_rng(1)
    bsz, t = tl_test.BATCH, tl_test.T
    for step in range(3):
        ep = episodes(rng, info, bsz, t)
        w = rng.uniform(0.5, 1.0, bsz).astype(np.float32)
        jls, jinfo = jtrain(jls, to_jax(ep), jnp.asarray(w), 0, step + 1)
        tls, tinfo = tl.train(tls, to_port(ep), torch.from_numpy(w), 0,
                              step + 1)
        for key in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
                    "td_errors_abs"):
            np.testing.assert_allclose(tinfo[key].numpy(),
                                       np.asarray(jinfo[key]),
                                       err_msg=f"step {step} {key}",
                                       **tl_test.INFO)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-4)
        tl_test._params_close(tls.params, jls.params, f"step {step}")
        tl_test._params_close(tls.target_params, jls.target_params,
                              f"step {step} target")


# ------------------------------------------------------------------- loop

LOOP = dict(loop_test.D, env_args=dict(loop_test.D["env_args"],
                                       fast_norm=True))


def test_loop_on_the_default_stack_matches_jax(monkeypatch):
    """Three ``run_classic`` iterations on the default config (no
    override of ``use_entity_tables`` or ``compact_entity_store``)
    against JAX's classic iteration, as ``tests/test_torch_loop.py``
    does it (the learner state set from JAX before each iteration):
    actions, sampled indices, counters and the ring cursor exact, info
    and priorities at that file's tolerances, the stored compact leaves
    at the env's."""
    from t2omca_tpu.run import TrainState as JaxTrainState
    jexp = JaxExperiment.build(jax_from_dict(LOOP))
    # init_train_state's pieces, jitted (the same values, faster)
    k_learner, k_runner = jax.random.split(jax.random.PRNGKey(0))
    jts = JaxTrainState(learner=jax.jit(jexp.learner.init_state)(k_learner),
                        runner=jax.jit(jexp.runner.init_state)(k_runner),
                        buffer=jax.jit(jexp.buffer.init)(),
                        episode=jnp.zeros((), jnp.int32))
    texp = Experiment.build(from_dict(LOOP), device="cpu")
    assert texp.buffer.compact_obs and texp.runner.obs_form == "compact"
    ts = texp.init_state(0, learner_params=learner_params_from_flax(
        np_tree(jts.learner.params), "cpu"))
    jrecs = loop_test.jax_loop(jexp, jts, loop_test.ITERATIONS)
    sampled = []
    sample = PrioritizedReplayBuffer.sample

    def recording(self, *a, **kw):
        out = sample(self, *a, **kw)
        sampled.append(out[1])
        return out

    monkeypatch.setattr(PrioritizedReplayBuffer, "sample", recording)
    cursor, jls = None, jts.learner
    for it, rec in enumerate(jrecs):
        ts.learner = learner_state_from_jax(np_tree(jls), "cpu")
        ts, cursor, (trec,) = run_classic(texp, ts, 1, cursor)
        jls = rec["ts"].learner
        what = f"iteration {it}"
        assert (trec.t_env, trec.episode) == (rec["t_env"], rec["episode"])
        np.testing.assert_array_equal(sampled[-1].numpy(),
                                      np.asarray(rec["idx"]), err_msg=what)
        for k, v in rec["info"].items():
            tol = (dict(rtol=2e-3, atol=1e-6) if k == "grad_norm"
                   else tl_test.INFO)
            np.testing.assert_allclose(trec.info[k].numpy(), np.asarray(v),
                                       err_msg=f"{what} {k}", **tol)
        jbuf = rec["ts"].buffer
        assert ts.buffer.insert_pos == int(jbuf.insert_pos)
        np.testing.assert_allclose(ts.buffer.priorities.numpy(),
                                   np.asarray(jbuf.priorities), rtol=1e-5,
                                   atol=1e-6, err_msg=what)
        np.testing.assert_array_equal(ts.buffer.storage.actions.numpy(),
                                      np.asarray(jbuf.storage.actions))
        assert_compact(ts.buffer.storage.obs, jbuf.storage.obs, what)
        loop_test.params_close(ts.learner.params, rec["ts"].learner.params,
                               2 * texp.cfg.lr, what)
    assert cursor.t_env == ts.runner.t_env == loop_test.ITERATIONS * 4 * 20
