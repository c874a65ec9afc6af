"""Port parity of the agent and mixer families (``agent: rnn``, ``mixer:
qmix_ff | vdn``) against the JAX package on the CPU: the registries, the
GRU agent, the feed-forward QMIX and VDN mixers on parameters carried
from flax by ``convert.py``, train steps of the family combinations, and
the sight module groups.

Tolerances: forwards at float32 rtol 1e-5 / atol 1e-6; at bfloat16
rtol 2**-5 / atol 2e-2 (``tests/test_torch_dropout.py``'s); train steps
at ``tests/test_torch_learner.py``'s (info rtol 1e-5 / atol 1e-6,
``grad_norm`` rtol 1e-4, params atol 1e-5); the sight group norms rtol
1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from t2omca_tpu.controllers.basic_mac import AGENT_REGISTRY as JAX_AGENTS
from t2omca_tpu.learners.qmix_learner import MIXER_REGISTRY as JAX_MIXERS
from t2omca_tpu.models.ff_mixer import QMixFFMixer as JaxQMixFF
from t2omca_tpu.models.ff_mixer import VDNMixer as JaxVDN
from t2omca_tpu.models.rnn_agent import RNNAgent as JaxRNN
from t2omca_tpu.obs import sight as jax_sight
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.controllers.basic_mac import AGENT_REGISTRY, BasicMAC
from t2omca_tpu_torch.convert import (agent_state_from_flax,
                                      learner_params_from_flax,
                                      mixer_state_from_flax,
                                      tensor_from_jax)
from t2omca_tpu_torch.envs.registry import make_env
from t2omca_tpu_torch.learners.qmix_learner import (MIXER_REGISTRY,
                                                    QMixLearner)
from t2omca_tpu_torch.models.ff_mixer import QMixFFMixer, VDNMixer
from t2omca_tpu_torch.models.rnn_agent import RNNAgent
from t2omca_tpu_torch.obs import sight

import test_torch_dropout as drop_test
import test_torch_learner as tl_test

FWD = drop_test.FWD
DTYPES = drop_test.DTYPES


def _np(x):
    return jax.tree.map(np.asarray, x)


def _close(t, j, dt):
    np.testing.assert_allclose(t.float().detach().numpy(),
                               np.asarray(j, np.float32), **FWD[dt])


def test_registries_match_jax():
    assert set(AGENT_REGISTRY) == set(JAX_AGENTS) == {"transformer", "rnn"}
    assert set(MIXER_REGISTRY) == set(JAX_MIXERS) == {
        "transformer", "qmix_ff", "vdn"}
    for name in ("rnn", "transformer"):
        cfg = from_dict(tl_test.config(agent=name))
        info = make_env(cfg.env_args).get_env_info()
        mac = BasicMAC.build(cfg, info, device="cpu")
        assert type(mac.agent) is AGENT_REGISTRY[name]
        # the GRU agent takes the flat obs as one token
        assert (mac.agent.feat_dim == info["obs_shape"]) == (name == "rnn")


@pytest.mark.parametrize("dt,noisy", [("float32", False),
                                      ("float32", True),
                                      ("bfloat16", True)])
def test_rnn_agent_matches_flax(dt, noisy):
    """``fc1`` + relu, flax's GRU cell gate for gate, the q-head (noisy:
    drawn from ``rngs["noise"]`` under ``q_basic``), two chained steps."""
    jdt, tdt = DTYPES[dt]
    kw = dict(n_agents=3, n_entities=1, feat_dim=20, emb=16, n_actions=4,
              noisy=noisy)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((2, 2, 3, 20)).astype(np.float32)
    h = np.zeros((2, 3, 16), np.float32)
    ja = JaxRNN(dtype=jdt, **kw)
    params = ja.init(jax.random.PRNGKey(1), obs[0], h)
    assert set(params["params"]["rnn"]) == {"ir", "iz", "in", "hr", "hz",
                                            "hn"}
    ta = RNNAgent(dtype=tdt, device="meta", **kw)
    sd = agent_state_from_flax(_np(params), "cpu")
    assert set(sd) == {k for k, _ in ta.named_parameters()}
    key = jax.random.PRNGKey(9)
    japply = jax.jit(lambda p, o, h, k: ja.apply(
        p, o, h, deterministic=not noisy, rngs={"noise": k}))
    jh, th = h, torch.from_numpy(h)
    rngs = {"noise": tensor_from_jax(key, "cpu")} if noisy else None
    for t in range(2):
        jq, jh = japply(params, obs[t], jh, key)
        tq, th = functional_call(ta, sd, (torch.from_numpy(obs[t]), th),
                                 {"rngs": rngs})
        _close(tq, jq, dt)
        _close(th, jh, dt)
        assert th.dtype == torch.float32


def _mixer_inputs(a, emb, sdim, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 1, a)).astype(np.float32),
            rng.standard_normal((4, a, emb)).astype(np.float32),
            rng.standard_normal((4, 3, emb)).astype(np.float32),
            # the env's raw state is O(1e4): state_norm's fast variance
            (rng.standard_normal((4, sdim)) * 3e3 + 1e4).astype(np.float32),
            np.zeros((4, a, 1), np.float32))


@pytest.mark.parametrize("dt,gate", [("float32", False),
                                     ("float32", True),
                                     ("bfloat16", True)])
def test_qmix_ff_mixer_matches_flax(dt, gate):
    jdt, tdt = DTYPES[dt]
    a, emb, sdim = 3, 8, 23
    kw = dict(n_agents=a, emb=emb, qmix_pos_func="abs",
              zero_init_gate=gate)
    xs = _mixer_inputs(a, emb, sdim, 2)
    jm = JaxQMixFF(dtype=jdt, **kw)
    params = _np(jm.init(jax.random.PRNGKey(3), *xs))
    if gate:                                     # open the zero-init gate
        params["params"]["out_gate"] = np.full((1,), 0.75, np.float32)
    jy, jhy = jax.jit(jm.apply)(params, *xs)
    tm = QMixFFMixer(dtype=tdt, state_dim=sdim, device="meta", **kw)
    sd = mixer_state_from_flax(params, "cpu")
    assert set(sd) == {k for k, _ in tm.named_parameters()}
    ty, thy = functional_call(tm, sd, tuple(map(torch.from_numpy, xs)))
    _close(ty, jy, dt)
    np.testing.assert_array_equal(thy.numpy(), np.asarray(jhy))


def test_vdn_mixer_matches_flax():
    xs = _mixer_inputs(3, 8, 5, 4)
    jm = JaxVDN(n_agents=3, emb=8)
    params = jm.init(jax.random.PRNGKey(0), *xs)
    assert not jax.tree.leaves(params)
    jy, jhy = jm.apply(params, *xs)
    tm = VDNMixer(n_agents=3, emb=8)
    assert not list(tm.parameters())
    ty, thy = tm(*map(torch.from_numpy, xs))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6)
    np.testing.assert_array_equal(thy.numpy(), np.asarray(jhy))
    assert tuple(tm.initial_hyper(4).shape) == (4, 3, 8)


# -------------------------------------------------------------- learner

FAMILIES = {
    "rnn_vdn": {"agent": "rnn", "mixer": "vdn"},
    "transformer_qmix_ff": {"mixer": "qmix_ff",
                            "kernels.attention": "pallas"},
    "rnn_transformer_noisy": {"agent": "rnn",
                              "action_selector": "noisy-new"},
}


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_train_step_matches_jax(case):
    """Two train steps of each combination from the same params, batches
    and keys, at the learner tests' tolerances (the key handed in
    whether the combination draws or not)."""
    over = FAMILIES[case]
    jl, jls, tl, tls, info = tl_test.build_pair(tl_test.config(**over))
    jtrain = jax.jit(jl.train)
    rng = np.random.default_rng(1)
    for step in range(2):
        ep = tl_test.make_episodes(rng, info, tl_test.BATCH, tl_test.T)
        w = rng.uniform(0.5, 1.0, tl_test.BATCH).astype(np.float32)
        key = jax.random.PRNGKey(60 + step)
        jls, ji = jtrain(jls, tl_test.to_jax(ep), jnp.asarray(w), 0,
                         step + 1, key)
        tls, ti = tl.train(tls, tl_test.to_port(ep), torch.from_numpy(w),
                           0, step + 1, tensor_from_jax(key, "cpu"))
        for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
                  "td_errors_abs"):
            np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]),
                                       err_msg=f"{case} {step} {k}",
                                       **tl_test.INFO)
        np.testing.assert_allclose(float(ti["grad_norm"]),
                                   float(ji["grad_norm"]), rtol=1e-4)
        tl_test._params_close(tls.params, jls.params, f"{case} {step}")
    if over.get("mixer") == "vdn":
        assert tls.params["mixer"] == {}


@pytest.mark.parametrize("agent,mixer", [("rnn", "vdn"),
                                         ("transformer", "qmix_ff")])
def test_sight_groups_match_jax(agent, mixer):
    """The per-module groups of the sight norms: the same names as JAX's
    (VDN has no mixer group, the GRU agent no ``agent_tf``) and the same
    norm of each group over the carried params."""
    d = tl_test.config(agent=agent, mixer=mixer)
    jl, jls, tl, tls, _ = tl_test.build_pair(d)
    cfg = tl.cfg
    names = sight.module_group_names(cfg)
    assert names == jax_sight.module_group_names(jl.cfg)
    assert ("agent_tf" in names) == (agent == "transformer")
    assert ("mixer" in names) == (mixer != "vdn")
    tg = sight.module_groups(cfg, tls.params)
    jg = jax_sight.module_groups(jl.cfg, _np(jls.params))
    for name in names:
        t = float(torch.sqrt(sum((x.double() ** 2).sum() for x in tg[name])))
        j = float(np.sqrt(sum((np.asarray(x, np.float64) ** 2).sum()
                              for x in jg[name])))
        np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=name)
    assert set(learner_params_from_flax(_np(jls.params), "cpu")["mixer"]) \
        == set(tls.params["mixer"])


@pytest.mark.parametrize("over", [
    {"agent": "rnn", "mixer": "vdn"},
    {"agent": "rnn", "mixer": "qmix_ff"},
    {"mixer": "qmix_ff"},
    {"agent": "rnn", "action_selector": "noisy-new"},
], ids=["rnn_vdn", "rnn_qmix_ff", "transformer_qmix_ff", "rnn_noisy"])
def test_experiment_builds_and_trains(tmp_path, over):
    """Each family through ``Experiment.build`` and three classic
    iterations on the CPU (``tests/test_torch_driver.py``'s tiny
    config): the train gate opens, losses are finite, the params move."""
    from t2omca_tpu_torch.run import Experiment, run_classic
    from test_torch_driver import tiny
    exp = Experiment.build(from_dict(tiny(tmp_path, **over)), device="cpu")
    ts0 = exp.init_state(0)
    ts, _, recs = run_classic(exp, ts0, 3)
    infos = [r.info for r in recs if r.info is not None]
    assert infos and all(bool(i["all_finite"]) for i in infos)
    moved = [k for k, v in ts.learner.params["agent"].items()
             if not torch.equal(v, ts0.learner.params["agent"][k])]
    assert moved


@pytest.mark.parametrize("over", [
    {"agent": "rnn", "mixer": "vdn"},
    {"model": {"dropout": 0.2, "remat": True}, "replay": {"buffer_size": 8},
     "obs": {}},
], ids=["rnn_vdn", "dropout"])
def test_population_members_track_their_solo_runs(tmp_path, over):
    """A P = 2 population of a family (and one with dropout) for two
    dispatches of K = 2 against each member's solo fused loop at its seed
    (``tests/test_torch_population_dispatch.py``'s comparison and
    tolerances: learner leaves rtol 1e-4 / atol 1e-6, Adam moments atol
    1e-3 of the leaf's max, priorities rtol 1e-6, everything else
    exact)."""
    from t2omca_tpu_torch import population as pop
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    from test_torch_population_dispatch import pop_drive
    from test_torch_superstep import DENSE, _fused
    from test_torch_driver import tiny
    if "model" in over:
        over = dict(DENSE, replay=over["replay"], obs=over["obs"],
                    model=dict(DENSE["model"], **over["model"]))
    d = tiny(tmp_path, population={"size": 2}, **over)
    exp = Experiment.build(from_dict(d), device="cpu")
    pts, spec = pop.init_population(exp, exp.cfg)
    pts, pstats, _, keys = pop_drive(exp, pts, spec, 2, 2)
    for m, seed in enumerate(pop.member_seeds(exp.cfg)):
        sd = dict(d, seed=seed)
        sd.pop("population")
        sexp = Experiment.build(from_dict(sd), device="cpu")
        ts, stats, kept, _, _, key = _fused(sexp, sexp.init_state(seed), 2,
                                            2)
        assert kept and torch.equal(keys[m], key)
        fa, ha = flatten_state(pts[m])
        fb, hb = flatten_state(ts)
        assert ha == hb and set(fa) == set(fb)
        for k in fa:
            got, want = fa[k].double().numpy(), fb[k].double().numpy()
            if k.startswith("learner.opt_state") and got.size:
                scale = max(float(np.abs(want).max()), 1e-30)
                np.testing.assert_allclose(got, want, rtol=0.0,
                                           atol=1e-3 * scale,
                                           err_msg=f"member {m} {k}")
            elif k.startswith("learner."):
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                           err_msg=f"member {m} {k}")
            elif k == "buffer.priorities":
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           err_msg=f"member {m} {k}")
            else:
                assert torch.equal(fa[k], fb[k]), (m, k)
        for st, ps in zip(stats, pstats):
            assert torch.equal(ps.episode_return[m], st.episode_return)


def test_serve_frontend_of_a_gru_agent_matches_jax():
    """A ``ServeFrontend`` over the GRU agent against JAX's serve step on
    the same flax params: 7 requests over buckets (1, 2, 4), the hidden
    carried across 3 calls; actions equal, hidden within 1e-5 (as
    ``tests/test_torch_serve.py``)."""
    from t2omca_tpu.serve.program import build_serve_step as jax_serve_step
    from t2omca_tpu_torch.serve.frontend import ServeFrontend
    import test_torch_serve as serve_test
    d = serve_test._cfg_dict(use_qslice=False)
    d = dict(d, agent="rnn")
    jmac, jparams, tmac, sd, obs_dim = serve_test._pair(d, seed=2)
    assert type(tmac.agent) is RNNAgent
    jstep = jax_serve_step(jmac)
    fe = ServeFrontend(from_dict(d), sd, (1, 2, 4), device="cpu")
    rng = np.random.default_rng(5)
    hj = np.zeros((7, serve_test.A, fe.emb), np.float32)
    ht = None
    for step in range(3):
        obs, avail = serve_test._requests(rng, 7, obs_dim)
        aj, hj = jstep(jparams, obs, avail, hj)
        at, ht = fe.select(obs, avail, ht)
        np.testing.assert_array_equal(at, np.asarray(aj),
                                      err_msg=f"step {step}")
        np.testing.assert_allclose(ht, np.asarray(hj), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {step}")
        hj = np.asarray(hj)
