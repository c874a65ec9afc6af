"""Port parity of NoisyNet's q-head noise on the query-slice and
entity-table paths (``t2omca_tpu_torch.models.noisy.noisy_weights``,
``ops.query_slice._q_head``, the MAC's ``k_noise, k_sel`` split and the
learner's ``k_ag, k_tag, k_mx, k_tmx`` keys) against the JAX package on
the CPU, with the same threefry keys.

Both packages draw the q-head's noise from a raw split key on these
paths, so the comparison is path for path; the dense module draws
through flax's path-folded ``make_rng`` (``flax_rng.py``), held in
``test_dense_noisy_training_still_raises`` and
``tests/test_torch_dropout.py``.

Tolerances: ``noisy_weights`` rtol 1e-5 / atol 1e-6 (``prng.normal``'s
erfinv tails, ``tests/test_torch_prng.py``); a noisy train step's loss
rtol 1e-5, ``grad_norm`` rtol 1e-4 and every sigma gradient rtol 1e-4 /
atol 1e-5 (the gradient tolerance of ``tests/test_torch_entity.py``: at
these widths a sigma gradient reaches ~31, where one float32 ulp is
1.9e-6 and the sum over the unroll's steps moves ~10 of them); the other
info values and params at ``tests/test_torch_learner.py``'s tolerances;
a noisy rollout's actions identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.models.noisy import noisy_weights as jax_noisy_weights
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.convert import (agent_state_from_flax,
                                      learner_params_from_flax,
                                      state_from_jax, tensor_from_jax)
from t2omca_tpu_torch.models.noisy import noisy_weights
from t2omca_tpu_torch.run import Experiment

import test_torch_entity as ent
import test_torch_learner as tl_test

NOISY = {"action_selector": "noisy-new"}


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.mark.parametrize("n_in,n_out,batched", [(32, 3, False),
                                                 (256, 9, False),
                                                 (64, 5, True)])
def test_noisy_weights_match_jax(n_in, n_out, batched):
    """One draw (or one per key of a batch of keys, as ``jax.vmap``) from
    the same key: w and b within rtol 1e-5 / atol 1e-6. JAX stores the
    kernel ``(in, out)``, the port ``(out, in)``."""
    rng = np.random.default_rng(n_in)
    w_mu = rng.uniform(-0.2, 0.2, (n_in, n_out)).astype(np.float32)
    w_sigma = np.full((n_in, n_out), 0.5 / np.sqrt(n_in), np.float32)
    b_mu = rng.uniform(-0.2, 0.2, n_out).astype(np.float32)
    b_sigma = np.full(n_out, 0.5 / np.sqrt(n_in), np.float32)
    key = jax.random.PRNGKey(n_in + n_out)
    draw = jax.jit(jax_noisy_weights)
    if batched:
        key = jax.random.split(key, 7)
        draw = jax.jit(jax.vmap(jax_noisy_weights,
                                in_axes=(None, None, None, None, 0)))
    jw, jb = draw(w_mu, w_sigma, b_mu, b_sigma, key)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    tw, tb = noisy_weights(t(w_mu.T), t(w_sigma.T), t(b_mu), t(b_sigma),
                           tensor_from_jax(key, "cpu"))
    np.testing.assert_allclose(tw.transpose(-1, -2).numpy(), np.asarray(jw),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(np.asarray(jw), w_mu)


CASES = {"qslice": {"replay.compact_entity_store": False},
         "entity": {"replay.compact_entity_store": True}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_noisy_train_step_matches_jax(case):
    """Two noisy train steps from the same params, batch, weights and
    ``k_learn``: the query-slice path (dense obs) and the entity-table
    path (compact obs). Loss rtol 1e-5, ``grad_norm`` rtol 1e-4, the
    sigma gradients of ``_loss`` rtol 1e-4 / atol 1e-5, info and params at the
    learner tests' tolerances; the noise reaches the loss (another key
    gives another loss)."""
    d = tl_test.config(**NOISY, **CASES[case])
    jl, jls, tl, tls, info = tl_test.build_pair(d, jit_init=True)
    assert tl.needs_rngs and jl.needs_rngs
    jtrain = jax.jit(jl.train)
    jgrad = jax.jit(jax.grad(lambda p, tp, b, w, k: jl._loss(
        p, tp, b, w, k)[0]))
    rng = np.random.default_rng(5)
    bsz, t = tl_test.BATCH, tl_test.T
    make = ent.episodes if case == "entity" else tl_test.make_episodes
    to_jax = ent.to_jax if case == "entity" else tl_test.to_jax
    to_port = ent.to_port if case == "entity" else tl_test.to_port
    for step in range(2):
        ep = make(rng, info, bsz, t)
        w = rng.uniform(0.5, 1.0, bsz).astype(np.float32)
        key = jax.random.PRNGKey(40 + step)
        tkey = tensor_from_jax(key, "cpu")
        jb, tb = to_jax(ep), to_port(ep)
        # the sigma gradients of the loss
        jg = jgrad(jls.params, jls.target_params, jb, jnp.asarray(w), key)
        jg = learner_params_from_flax(np_tree(jg), "cpu")["agent"]
        params = {m: {k: v.detach().requires_grad_() for k, v in sub.items()}
                  for m, sub in tls.params.items()}
        loss, _ = tl._loss(params, tls.target_params, tb,
                           torch.from_numpy(w), tkey)
        names = sorted(k for k in params["agent"] if "sigma" in k)
        assert names == ["q_basic.bias_sigma", "q_basic.weight_sigma"]
        grads = torch.autograd.grad(loss, [params["agent"][k]
                                           for k in names])
        for k, g in zip(names, grads):
            assert float(g.abs().max()) > 0.0, k
            np.testing.assert_allclose(g.numpy(), jg[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{step} {k}")
        other, _ = tl._loss(params, tls.target_params, tb,
                            torch.from_numpy(w),
                            tensor_from_jax(jax.random.PRNGKey(99), "cpu"))
        assert float(other) != float(loss)
        # the train step itself
        jls, jinfo = jtrain(jls, jb, jnp.asarray(w), 0, step + 1, key)
        tls, tinfo = tl.train(tls, tb, torch.from_numpy(w), 0, step + 1,
                              tkey)
        for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
                  "td_errors_abs"):
            np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                       err_msg=f"step {step} {k}",
                                       **tl_test.INFO)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-4)
        tl_test._params_close(tls.params, jls.params, f"step {step}")
    with pytest.raises(ValueError, match="PRNG key"):
        tl.train(tls, tb, torch.from_numpy(w), 0, 3)


def test_dense_noisy_training_still_raises():
    """The dense agent's noise (flax's ``make_rng("noise")`` stream under
    ``q_basic``, once refused) now matches JAX: the learner builds with
    keys, and training-mode ``select_actions`` on the dense path draws
    the same noisy q-head as JAX's MAC from the same key (actions
    identical, hidden state at rtol 1e-5 / atol 1e-6); test mode runs
    the mu head in both packages."""
    from t2omca_tpu.controllers.basic_mac import BasicMAC as JaxMAC
    from t2omca_tpu.envs.registry import make_env as jax_make_env
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.envs.registry import make_env
    from t2omca_tpu_torch.learners import QMixLearner
    d = tl_test.config(**NOISY, **{"model.use_qslice": False})
    cfg = from_dict(d)
    info = make_env(cfg.env_args).get_env_info()
    mac = BasicMAC.build(cfg, info, device="cpu")
    assert QMixLearner.build(cfg, mac, info, device="cpu").needs_rngs
    assert mac.stochastic and not mac.use_qslice
    jcfg = jax_from_dict(d)
    jmac = JaxMAC.build(jcfg, jax_make_env(jcfg.env_args).get_env_info())
    jparams = jmac.init_params(jax.random.PRNGKey(0), info["obs_shape"])
    params = agent_state_from_flax(np_tree(jparams), "cpu")
    rng = np.random.default_rng(8)
    b, a = 5, info["n_agents"]
    obs = rng.standard_normal((b, a, info["obs_shape"])).astype(np.float32)
    avail = rng.random((b, a, info["n_actions"])) < 0.7
    avail[..., 0] = True
    h = np.zeros((b, a, cfg.model.emb), np.float32)
    sel = jax.jit(jmac.select_actions, static_argnames="test_mode")
    for test_mode in (False, True):
        key = jax.random.PRNGKey(17)
        ja, jh, _ = sel(jparams, jnp.asarray(obs), jnp.asarray(avail),
                        jnp.asarray(h), key, jnp.asarray(0),
                        test_mode=test_mode)
        ta, th, _ = mac.select_actions(
            params, torch.from_numpy(obs), torch.from_numpy(avail),
            torch.from_numpy(h), tensor_from_jax(key, "cpu"),
            test_mode=test_mode)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-6)
    k_noise, _ = jax.random.split(jax.random.PRNGKey(17))
    q_noisy, _ = mac.forward(params, torch.from_numpy(obs),
                             torch.from_numpy(h),
                             key=tensor_from_jax(k_noise, "cpu"),
                             deterministic=False)
    q_mu, _ = mac.forward(params, torch.from_numpy(obs),
                          torch.from_numpy(h))
    assert not torch.allclose(q_noisy, q_mu)


@pytest.mark.parametrize("entity", [False, True])
def test_noisy_rollout_matches_jax(entity):
    """A training rollout of a noisy agent, query-slice acting on dense
    obs or entity-table acting on compact obs: each step's q-head noise
    from ``k_noise`` of ``split(k_act)``; actions identical, and the
    noise changes them against a test-mode (mu head) rollout."""
    from t2omca_tpu_torch.runners.parallel_runner import RunnerState
    over = dict(ent.ROLL, **NOISY)
    if not entity:
        over["model.use_entity_tables"] = False
    d = ent.config(**over)
    jexp = JaxExperiment.build(jax_from_dict(d))
    variables, jrs = ent.rollout_start(jexp)
    texp = Experiment.build(from_dict(d), device="cpu")
    assert texp.mac.use_entity_tables == entity
    jrun = jax.jit(jexp.runner.run, static_argnames=("test_mode",))
    agent = agent_state_from_flax(np_tree(variables), "cpu")
    trs = state_from_jax(RunnerState, np_tree(jrs), "cpu")
    _, jb, _ = jrun(variables, jrs, test_mode=False)
    _, tb, _ = texp.runner.run(agent, trs, test_mode=False)
    np.testing.assert_array_equal(tb.actions.numpy(), np.asarray(jb.actions))
    _, tb_mu, _ = texp.runner.run(agent, trs, test_mode=True)
    assert not torch.equal(tb_mu.actions, tb.actions)
