"""Port parity of the env (``t2omca_tpu_torch.envs``: ``mec_offload``,
``normalization``, ``critic``, ``graftworld``) against the JAX package's
jitted, vmapped functions on the CPU.

What the comparison found about the arithmetic, and what the port does
about it:

* XLA lowers a division by a compile-time constant to a multiply by the
  float32 reciprocal, and folds chains of constant factors: the JAX
  ``_local_delay`` runs as ``data · 0.00625`` and ``jnp.round(x, 2)`` as
  ``round(x · 100) · 0.01``. Written as true divisions, ``round(x, 2)``
  differs from JAX in about a quarter of the values; in XLA's form the
  local delay matches bit for bit (``test_delays_match_xla_form``).
* XLA's CPU backend contracts ``a · b + c`` into one FMA (the uniform
  draw's affine, ``jnp.linalg.norm``, the position offset): the port
  computes those in float64 and rounds once.
* ``log10``, ``pow``, ``log2``, ``sin`` and ``cos`` of torch and of XLA
  differ in the last bit. Positions differ by up to 8 ulp; the offload
  delay, rounded to 0.01 ms, absorbed every such difference on 64 000
  samples at the north-star widths.

Tolerances: discrete fields (ACK, ``mec_index``, ``job_valid``,
``last_action``, task counters, avail, ``terminated``, ``time_slot``,
the Welford count) exact; float fields rtol 1e-5 / atol 1e-5."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.config import EnvConfig as JaxEnvConfig
from t2omca_tpu.envs.critic import critic as jax_critic
from t2omca_tpu.envs import normalization as jnorm
from t2omca_tpu.envs.graftworld import FixedScenario as JaxFixed
from t2omca_tpu.envs.mec_offload import MultiAgvOffloadingEnv as JaxEnv
from t2omca_tpu_torch import prng
from t2omca_tpu_torch.config import EnvConfig
from t2omca_tpu_torch.convert import state_from_jax, tensor_from_jax
from t2omca_tpu_torch.envs import normalization as tnorm
from t2omca_tpu_torch.envs.critic import critic
from t2omca_tpu_torch.envs.graftworld import (FAMILY_IDS, FixedScenario,
                                              make_distribution)
from t2omca_tpu_torch.envs.mec_offload import (EnvParams, EnvState,
                                               MultiAgvOffloadingEnv,
                                               StepDraws, StepInfo)
from t2omca_tpu_torch.envs.registry import make_env, scenario_config

FLOAT = dict(rtol=1e-5, atol=1e-5)
B = 4

#: normalizer settings: sequential Welford (the reference order), the
#: batched merge from the factored entity form, the batched merge on
#: flat observations
NORMS = {"sequential": dict(fast_norm=False),
         "factored": dict(fast_norm=True),
         "flat_batch": dict(fast_norm=True, obs_entity_mode=False)}


def envs(**kw):
    d = dict(agv_num=4, mec_num=2, num_channels=2, episode_limit=20)
    d.update(kw)
    return (JaxEnv(JaxEnvConfig(**d)),
            MultiAgvOffloadingEnv(EnvConfig(**d), device="cpu"))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def port(cls, x):
    return state_from_jax(cls, np_tree(x), "cpu")


def pkey(k):
    return tensor_from_jax(k, "cpu")


def assert_same(j, t, what):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape, (what, j.shape, t.shape)
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j, err_msg=what)
    else:
        np.testing.assert_allclose(t, j, err_msg=what, **FLOAT)


def assert_state(js, ts, what):
    for f in dataclasses.fields(EnvState):
        if f.name == "norm":
            for g in ("n", "mean", "s", "std"):
                assert_same(getattr(js.norm, g), getattr(ts.norm, g),
                            f"{what} norm.{g}")
        else:
            assert_same(getattr(js, f.name), getattr(ts, f.name),
                        f"{what} {f.name}")


def default_params(jenv, b=B):
    jp = jax.vmap(lambda _: jenv.default_params())(jnp.arange(b))
    return jp, port(EnvParams, jp)


def padded_params(jenv, tenv, seed=3, min_agents=2):
    """Per-lane params of a fixed scenario that pads (``n_active`` drawn
    in [min_agents, A])."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jp = jax.vmap(lambda k: JaxFixed(min_agents=min_agents).sample(
        k, jenv))(keys)
    tp = FixedScenario(min_agents=min_agents).sample(pkey(keys), tenv)
    for f in dataclasses.fields(EnvParams):
        assert_same(getattr(jp, f.name), getattr(tp, f.name), f.name)
    return jp, tp


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("norm", sorted(NORMS))
def test_reset_and_step_match_jax(norm, padded):
    """From the same state, actions and keys: one reset, then eight steps
    each started from the JAX state (so each step is compared alone)."""
    jenv, tenv = envs(**NORMS[norm])
    jp, tp = (padded_params(jenv, tenv) if padded
              else default_params(jenv))
    if padded:
        assert int(tp.n_active.min()) < jenv.n_agents
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    jout = jax.jit(jax.vmap(jenv.reset))(keys, None, jp)
    tout = tenv.reset(pkey(keys), None, tp)
    assert_state(jout[0], tout[0], "reset")
    for name, j, t in zip(("obs", "state", "avail"), jout[1:], tout[1:]):
        assert_same(j, t, f"reset {name}")
    jstep = jax.jit(jax.vmap(jenv.step))
    js, javail = jout[0], jout[3]
    rng = np.random.default_rng(7)
    for i in range(8):
        av = np.asarray(javail)
        acts = np.argmax(np.where(av > 0, rng.random(av.shape), -1), -1)
        acts = acts.astype(np.int32)
        skeys = jax.random.split(jax.random.PRNGKey(100 + i), B)
        jo = jstep(js, jnp.asarray(acts), skeys, jp)
        to = tenv.step(port(EnvState, js), torch.from_numpy(acts),
                       pkey(skeys), tp)
        assert_state(jo[0], to[0], f"step {i}")
        for name, j, t in zip(("reward", "terminated"), jo[1:3], to[1:3]):
            assert_same(j, t, f"step {i} {name}")
        for f in dataclasses.fields(StepInfo):
            assert_same(getattr(jo[3], f.name), getattr(to[3], f.name),
                        f"step {i} info.{f.name}")
        for name, j, t in zip(("obs", "state", "avail"), jo[4:], to[4:]):
            assert_same(j, t, f"step {i} {name}")
        js, javail = jo[0], jo[6]


def _discrete_digest(leaves) -> str:
    h = hashlib.sha256()
    for x in leaves:
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        h.update(np.ascontiguousarray(x).astype(np.int64).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("norm", ["sequential", "factored"])
def test_teacher_forced_rollout_digest(norm):
    """20 steps of 4 lanes, shaped like ``tests/test_graftworld.py``'s
    digest: JAX draws each step's actions (categorical over the available
    ones) and both envs run them, each from its own state. The digest of
    every discrete output (avail, terminated, ACKs, serving MECs, queues,
    counters) is identical; float outputs within the stated tolerance."""
    jenv, tenv = envs(**NORMS[norm])
    jp, tp = default_params(jenv)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jst, jobs, jgs, javail = jax.jit(jax.vmap(jenv.reset))(keys, None, jp)
    tst, tobs, tgs, tavail = tenv.reset(pkey(keys), None, tp)
    jstep = jax.jit(jax.vmap(jenv.step))
    jd, td = [javail], [tavail]
    k = jax.random.PRNGKey(1)
    for _ in range(20):
        k, k_act, k_step = jax.random.split(k, 3)
        logits = jnp.where(javail > 0, 0.0, -1e9)
        acts = jax.vmap(lambda kk, lg: jax.random.categorical(kk, lg))(
            jax.random.split(k_act, B), logits).astype(jnp.int32)
        step_keys = jax.random.split(k_step, B)
        jst, jr, jterm, jinfo, jobs, jgs, javail = jstep(jst, acts,
                                                         step_keys, jp)
        tst, tr, tterm, tinfo, tobs, tgs, tavail = tenv.step(
            tst, torch.from_numpy(np.array(acts)), pkey(step_keys), tp)
        jd += [javail, jterm, jst.last_ack, jst.mec_index, jst.job_valid,
               jst.task_num, jst.task_success]
        td += [tavail, tterm, tst.last_ack, tst.mec_index, tst.job_valid,
               tst.task_num, tst.task_success]
        for name, j, t in (("reward", jr, tr), ("obs", jobs, tobs),
                           ("state", jgs, tgs),
                           ("completion", jinfo.task_completion_rate,
                            tinfo.task_completion_rate),
                           ("delay", jinfo.task_completion_delay,
                            tinfo.task_completion_delay)):
            assert_same(j, t, name)
    assert _discrete_digest(td) == _discrete_digest(jd)
    assert_state(jst, tst, "final")
    assert bool(np.asarray(jterm).all()) and bool(tterm.all())


def test_delays_match_xla_form():
    """The local delay (XLA's folded factor) and ``_round`` equal the
    jitted JAX helpers bit for bit, the offload delay on given positions
    too; the naive true-division ``round(x, 2)`` would not."""
    jenv, tenv = envs(agv_num=64, mec_num=8, num_channels=8)
    jp, tp = default_params(jenv, 256)
    rng = np.random.default_rng(0)
    data = rng.uniform(4000, 12000, (256, 64)).astype(np.float32)
    mec = rng.integers(0, 8, (256, 64)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 256)
    pos = np.asarray(jax.vmap(jenv._random_positions)(keys, mec, jp))
    for dec in (0, 2):
        want = jax.jit(jax.vmap(lambda d, p: jenv._local_delay(d, dec, p)))(
            data, jp)
        got = tenv._local_delay(torch.from_numpy(data), dec, tp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.jit(jax.vmap(jenv._offload_delay))(data, pos, mec, jp)
    got = tenv._offload_delay(torch.from_numpy(data),
                              torch.from_numpy(pos.copy()),
                              torch.from_numpy(mec), tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = torch.from_numpy(data * np.float32(0.00625))
    naive = torch.round(x * 100.0) / 100.0
    want = np.asarray(jax.jit(lambda v: jnp.round(v, 2))(x.numpy()))
    assert (naive.numpy() != want).mean() > 0.1
    k_rad, k_theta = prng.split(pkey(keys)).unbind(-2)
    draws = StepDraws(new_mec=None, radius_u=prng.uniform(k_rad, (64,)),
                      theta=prng.uniform(k_theta, (64,), 0.0, 2 * np.pi),
                      teleport_u=None, job_u=None, job_data=None)
    pos_t = tenv._place(draws, torch.from_numpy(mec), tp)
    np.testing.assert_allclose(pos_t.numpy(), pos, rtol=1e-6, atol=1e-4)


def test_get_critic_score_and_critic_match_jax():
    jenv, tenv = envs()
    jp, tp = default_params(jenv)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    jst = jax.jit(jax.vmap(jenv.reset))(keys, None, jp)[0]
    skeys = jax.random.split(jax.random.PRNGKey(6), B)
    want = jax.jit(jax.vmap(jenv.get_critic_score))(jst, skeys, jp)
    got = tenv.get_critic_score(port(EnvState, jst), pkey(skeys), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    rng = np.random.default_rng(1)
    for m in (rng.random((6, 3)), rng.random((64, 3)) * 100,
              np.ones((5, 3)), np.eye(4)[:, :3]):
        m = m.astype(np.float32)
        np.testing.assert_allclose(critic(torch.from_numpy(m)).numpy(),
                                   np.asarray(jax_critic(m)),
                                   rtol=1e-5, atol=1e-6)


def test_normalization_matches_jax():
    """Welford (Q5 first sample), normalize, the batched and factored
    merges, and reward scaling, from the same inputs."""
    rng = np.random.default_rng(2)
    dim = 6
    js, ts = jnorm.NormState.create(dim), tnorm.NormState.create(dim)
    for i in range(5):
        x = (rng.standard_normal(dim) * 10 + i).astype(np.float32)
        js, jy = jnorm.normalize(js, jnp.asarray(x))
        ts, ty = tnorm.normalize(ts, torch.from_numpy(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FLOAT)
        if i == 0:
            assert float(ty.abs().max()) == 0.0           # Q5
    for g in ("n", "mean", "s", "std"):
        assert_same(getattr(js, g), getattr(ts, g), g)
    js2, jy = jnorm.normalize(js, jnp.asarray(x), update=False)
    ts2, ty = tnorm.normalize(ts, torch.from_numpy(x), update=False)
    assert int(ts2.n) == int(js2.n) == 5
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FLOAT)
    xs = (rng.standard_normal((4, dim)) * 3).astype(np.float32)
    jb, jyb = jnorm.normalize_batch(js, jnp.asarray(xs))
    tb, tyb = tnorm.normalize_batch(ts, torch.from_numpy(xs))
    np.testing.assert_allclose(tyb.numpy(), np.asarray(jyb), **FLOAT)
    for g in ("mean", "s", "std"):
        assert_same(getattr(jb, g), getattr(tb, g), g)
    a, f = 5, 9
    rows = rng.standard_normal((a, f - 1)).astype(np.float32)
    mec = rng.integers(0, 2, a)
    same = mec[:, None] == mec[None, :]
    jf = jnorm.welford_update_batch_factored(
        jnorm.NormState.create(a * f), jnp.asarray(rows), jnp.asarray(same))
    tf = tnorm.welford_update_batch_factored(
        tnorm.NormState.create(a * f), torch.from_numpy(rows),
        torch.from_numpy(same))
    for g in ("n", "mean", "s", "std"):
        assert_same(getattr(jf, g), getattr(tf, g), f"factored {g}")
    jr = jnorm.RewardScaleState.create(0.9, dim=3)
    tr = tnorm.RewardScaleState.create(0.9, dim=3)
    for i in range(4):
        x = rng.standard_normal(3).astype(np.float32)
        jr, jy = jnorm.scale_reward(jr, jnp.asarray(x))
        tr, ty = tnorm.scale_reward(tr, torch.from_numpy(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FLOAT)
    jr, tr = jnorm.reset_reward_scale(jr), tnorm.reset_reward_scale(tr)
    assert float(tr.r.abs().max()) == 0.0 and int(tr.norm.n) == 4


def test_scenarios_and_registry():
    """Every kind builds and samples: the fixed kind, and the registry's
    uniform (surge) and mixture keys, each lane's family among the
    distribution's own; ``compact_obs`` of a reset state equals the
    jitted JAX one exactly, and the sequential normalizer has no compact
    form."""
    cfg = EnvConfig(agv_num=4, mec_num=2, num_channels=2)
    assert scenario_config(cfg).kind == "fixed"
    assert isinstance(make_distribution(scenario_config(cfg)),
                      FixedScenario)
    tenv = make_env(cfg, device="cpu")
    lane_keys = pkey(jax.random.split(jax.random.PRNGKey(1), 8))
    for key, kind in (("multi_agv_surge", "uniform"),
                      ("scenarios", "mixture")):
        dist = make_distribution(scenario_config(
            dataclasses.replace(cfg, key=key)))
        assert type(dist).__name__ == kind.capitalize() + "Scenario"
        sp = dist.sample(lane_keys, tenv)
        assert sp.n_active.shape == (8,) and sp.compute_scale.shape == (8, 4)
        ids = {FAMILY_IDS[f] for f in dist.families()}
        assert set(sp.family.tolist()) <= ids
    tp = FixedScenario(family="interference").sample(
        pkey(jax.random.split(jax.random.PRNGKey(0), 2)), tenv)
    assert float(tp.gain_scale[0]) == pytest.approx(0.7)
    assert int(tp.family[0]) == 2
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    state = tenv.reset(pkey(keys))[0]
    jenv = JaxEnv(JaxEnvConfig(agv_num=4, mec_num=2, num_channels=2))
    jp = jax.vmap(lambda _: jenv.default_params())(jnp.arange(2))
    jstate = jax.jit(jax.vmap(jenv.reset))(keys, None, jp)[0]
    want = jax.jit(jax.vmap(jenv.compact_obs))(jstate, jp)
    for j, t in zip(want, tenv.compact_obs(state, tenv.default_params(2))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    seq = make_env(dataclasses.replace(cfg, fast_norm=False), device="cpu")
    with pytest.raises(ValueError, match="fast_norm"):
        seq.compact_obs(state, seq.default_params(2))
    with pytest.raises(KeyError):
        make_env(dataclasses.replace(cfg, key="nope"), device="cpu")
