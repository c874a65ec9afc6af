"""Port parity of dropout and the dense agent's NoisyNet noise (flax's
``make_rng`` streams, ``t2omca_tpu_torch/flax_rng.py``) against the JAX
package and flax itself on the CPU, from the same keys.

Exact: the keys flax's ``make_rng`` gives a scope (held against keys
flax makes inside tiny modules), the dropout masks (the zero pattern of
a block's output), a training rollout's actions, and remat on against
remat off and the fused superstep against ``run_classic`` under
dropout. Within tolerance:

* forwards at float32: rtol 1e-5 / atol 1e-6 (``FWD``); at bfloat16,
  rtol 2**-5 (4 bf16 ulps) / atol 2e-2 (``chip_smoke.py``'s bf16
  ``TOL``): the blocks round every product to bf16, and XLA and torch
  order the LayerNorm sums differently, which moves an output by up to
  4 ulps;
* train steps at ``tests/test_torch_learner.py``'s tolerances (info
  rtol 1e-5 / atol 1e-6, ``grad_norm`` rtol 1e-4, params atol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch.func import functional_call

from t2omca_tpu.models.agent import TransformerAgent as JaxAgent
from t2omca_tpu.models.mixer import TransformerMixer as JaxMixer
from t2omca_tpu.models.transformer import TransformerBlock as JaxBlock
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.convert import (agent_state_from_flax,
                                      mixer_state_from_flax,
                                      tensor_from_jax)
from t2omca_tpu_torch.flax_rng import Scope
from t2omca_tpu_torch.models.agent import TransformerAgent
from t2omca_tpu_torch.models.mixer import TransformerMixer
from t2omca_tpu_torch.models.transformer import TransformerBlock
from t2omca_tpu_torch.run import Experiment, run_classic
from t2omca_tpu_torch.train.superstep import clone_state

import test_torch_learner as tl_test
import test_torch_runner as runner_test
import test_torch_superstep as sup_test

FWD = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2 ** -5, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RATE = 0.3


# --------------------------------------------------------------- flax keys

class Probe(fnn.Module):
    """Calls ``make_rng(stream)`` ``calls`` times at the end of a path of
    named child scopes."""

    names: tuple
    stream: str
    calls: int = 1

    @fnn.compact
    def __call__(self):
        if self.names:
            return Probe(self.names[1:], self.stream, self.calls,
                         name=self.names[0])()
        return [self.make_rng(self.stream) for _ in range(self.calls)]


@pytest.mark.parametrize("path,stream", [
    ((), "noise"),
    (("q_basic",), "noise"),
    (("transformer", "block_0", "Dropout_0"), "dropout"),
    (("transformer", "block_1", "Dropout_1"), "dropout"),
    (("rnn", "block_10", "Dropout_7"), "dropout"),
])
def test_make_rng_keys_match_flax(path, stream):
    """Keys of the first three ``make_rng`` calls of a scope, bit for
    bit against flax's own, under two root keys."""
    for seed in (0, 123456):
        key = jax.random.PRNGKey(seed)
        want = Probe(path, stream, calls=3).apply({}, rngs={stream: key})
        scope = Scope(tensor_from_jax(key, "cpu"), path)
        for count, w in enumerate(want, start=1):
            np.testing.assert_array_equal(scope.make_rng(count).numpy(),
                                          np.asarray(w))


# ------------------------------------------------------------- forwards

def _np(x):
    return jax.tree.map(np.asarray, x)


def _close(t, j, dt):
    np.testing.assert_allclose(t.float().detach().numpy(),
                               np.asarray(j, np.float32), **FWD[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_block_dropout_matches_flax(dt):
    """A ``TransformerBlock`` with dropout against flax's ``apply`` with
    ``rngs``: the same zero pattern (the second mask) and the values."""
    jdt, tdt = DTYPES[dt]
    emb, heads = 16, 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, emb)).astype(np.float32)
    jb = JaxBlock(emb=emb, heads=heads, dropout=RATE, standard_heads=True,
                  dtype=jdt)
    params = jb.init(jax.random.PRNGKey(1), x, x)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, x, k: jb.apply(
        p, x, x, deterministic=False, rngs={"dropout": k}))(params, x, key)
    tb = TransformerBlock(emb, heads, dropout=RATE, standard_heads=True,
                          dtype=tdt, device="meta")
    sd = agent_state_from_flax(_np(params), "cpu")
    xt = torch.from_numpy(x)
    got = functional_call(tb, sd, (xt, xt),
                          {"rng": Scope(tensor_from_jax(key, "cpu"))})
    want32 = np.asarray(want, np.float32)
    np.testing.assert_array_equal(got.float().numpy() == 0, want32 == 0)
    assert 0.1 < float((want32 == 0).mean()) < 0.5
    _close(got, want, dt)
    # another key, another mask; no scope, no dropout
    other = functional_call(tb, sd, (xt, xt),
                            {"rng": Scope(tensor_from_jax(
                                jax.random.PRNGKey(8), "cpu"))})
    assert not torch.equal(other == 0, got == 0)
    plain = functional_call(tb, sd, (xt, xt))
    assert not bool((plain == 0).any())


@pytest.mark.parametrize("dt,noisy", [("float32", False),
                                      ("float32", True),
                                      ("bfloat16", True)])
def test_agent_with_dropout_and_noise_matches_flax(dt, noisy):
    """The transformer agent with dropout (and a noisy q-head) against
    flax's ``apply(deterministic=False, rngs={"noise", "dropout"})``;
    with ``noisy`` and rate 0 the dense noisy agent alone."""
    jdt, tdt = DTYPES[dt]
    kw = dict(n_agents=3, n_entities=4, feat_dim=5, emb=16, heads=2,
              depth=2, n_actions=4, noisy=noisy, standard_heads=True)
    for rate in ((0.0, RATE) if noisy else (RATE,)):
        rng = np.random.default_rng(2)
        obs = rng.standard_normal((2, 3, 20)).astype(np.float32)
        h = rng.standard_normal((2, 3, 16)).astype(np.float32)
        ja = JaxAgent(dropout=rate, dtype=jdt, **kw)
        params = ja.init(jax.random.PRNGKey(3), obs, h)
        kn, kd = jax.random.split(jax.random.PRNGKey(11))
        jq, jh = jax.jit(lambda p, o, h, kn, kd: ja.apply(
            p, o, h, deterministic=False,
            rngs={"noise": kn, "dropout": kd}))(params, obs, h, kn, kd)
        ta = TransformerAgent(dropout=rate, dtype=tdt, device="meta", **kw)
        sd = agent_state_from_flax(_np(params), "cpu")
        rngs = {"noise": tensor_from_jax(kn, "cpu"),
                "dropout": tensor_from_jax(kd, "cpu")}
        tq, th = functional_call(ta, sd, (torch.from_numpy(obs),
                                          torch.from_numpy(h)),
                                 {"rngs": rngs})
        _close(tq, jq, dt)
        _close(th, jh, dt)
        mu_q, _ = functional_call(ta, sd, (torch.from_numpy(obs),
                                           torch.from_numpy(h)))
        assert not torch.allclose(mu_q, tq)


def test_mixer_with_dropout_matches_flax(dt="float32"):
    jdt, tdt = DTYPES[dt]
    a, ne, feat, emb = 3, 4, 5, 16
    kw = dict(n_agents=a, n_entities=ne, feat_dim=feat, emb=emb, heads=2,
              depth=2, dropout=RATE, standard_heads=True,
              zero_init_gate=False)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, a)).astype(np.float32)
    hs = rng.standard_normal((2, a, emb)).astype(np.float32)
    hy = rng.standard_normal((2, 3, emb)).astype(np.float32)
    st = rng.standard_normal((2, ne * feat)).astype(np.float32)
    obs = np.zeros((2, a, 1), np.float32)
    jm = JaxMixer(dtype=jdt, **kw)
    params = jm.init(jax.random.PRNGKey(5), q, hs, hy, st, obs)
    key = jax.random.PRNGKey(13)
    jy, jhy = jax.jit(lambda p, k: jm.apply(
        p, q, hs, hy, st, obs, deterministic=False,
        rngs={"dropout": k}))(params, key)
    tm = TransformerMixer(dtype=tdt, device="meta", **kw)
    sd = mixer_state_from_flax(_np(params), "cpu")
    t = torch.from_numpy
    ty, thy = functional_call(tm, sd, (t(q), t(hs), t(hy), t(st), t(obs)),
                              {"rngs": {"dropout": tensor_from_jax(key,
                                                                   "cpu")}})
    _close(thy, jhy, dt)
    _close(ty, jy, dt)


# -------------------------------------------------------------- rollouts

def test_training_rollout_matches_jax():
    """A training-mode rollout of the dense agent drawing dropout masks
    from its acting keys, as the JAX MAC does: actions identical, obs,
    state, rewards and stats at ``tests/test_torch_runner.py``'s
    tolerances; test mode is deterministic. (The dense noise's acting
    draw is ``tests/test_torch_noisy.py``'s
    ``test_dense_noisy_training_still_raises``.)"""
    p = runner_test.Pair(runner_test.config(**{
        "env_args.episode_limit": 8, "model.emb": 16, "model.heads": 2,
        "model.mixer_emb": 16, "model.mixer_heads": 2,
        "model.dropout": RATE}))
    assert p.texp.mac.stochastic and not p.texp.mac.use_qslice
    runner_test.run_both(p, test_mode=False, episodes=1)
    a, _, _ = p.texp.runner.run(p.agent, p.runner_state(), test_mode=True)
    b, _, _ = p.texp.runner.run(p.agent, p.runner_state(), test_mode=True)
    assert torch.equal(a.env_states.pos, b.env_states.pos)


# -------------------------------------------------------------- learner

#: dropout alone and the dense noise alone are
#: ``tests/test_torch_learner.py``'s ``test_unported_paths_raise`` cases
TRAIN_CASES = {
    "dropout_dense_noise": {"model.dropout": 0.1,
                            "action_selector": "noisy-new"},
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_matches_jax(case):
    """Two keyed train steps of both learners from the same params,
    batches, weights and keys (a hard target sync between them), at
    ``test_torch_learner.py``'s tolerances."""
    jl, jls, tl, tls, info = tl_test.build_pair(
        tl_test.config(**TRAIN_CASES[case]))
    assert tl.needs_rngs and jl.needs_rngs
    jtrain = jax.jit(jl.train)
    rng = np.random.default_rng(1)
    for step in range(2):
        ep = tl_test.make_episodes(rng, info, tl_test.BATCH, tl_test.T)
        w = rng.uniform(0.5, 1.0, tl_test.BATCH).astype(np.float32)
        key = jax.random.PRNGKey(40 + step)
        jls, ji = jtrain(jls, tl_test.to_jax(ep), jnp.asarray(w), 0,
                         step + 1, key)
        tls, ti = tl.train(tls, tl_test.to_port(ep), torch.from_numpy(w),
                           0, step + 1, tensor_from_jax(key, "cpu"))
        for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
                  "td_errors_abs"):
            np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]),
                                       err_msg=f"step {step} {k}",
                                       **tl_test.INFO)
        np.testing.assert_allclose(float(ti["grad_norm"]),
                                   float(ji["grad_norm"]), rtol=1e-4)
        tl_test._params_close(tls.params, jls.params, f"step {step}")
        tl_test._params_close(tls.target_params, jls.target_params,
                              f"step {step} target")


def test_remat_on_equals_remat_off_under_dropout():
    """``model.remat`` recomputes each step from its own key: the same
    masks, so the same loss, gradients and update, bit for bit."""
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.envs.registry import make_env
    from t2omca_tpu_torch.learners import QMixLearner
    from t2omca_tpu_torch import prng
    states, infos = [], []
    for remat in (False, True):
        cfg = from_dict(tl_test.config(**{"model.dropout": 0.2,
                                          "model.remat": remat}))
        info = make_env(cfg.env_args).get_env_info()
        tl = QMixLearner.build(cfg, BasicMAC.build(cfg, info, device="cpu"),
                               info, device="cpu")
        tls = tl.init_state(torch.Generator().manual_seed(0))
        ep = tl_test.make_episodes(np.random.default_rng(6), info,
                                   tl_test.BATCH, tl_test.T)
        tls, ti = tl.train(tls, tl_test.to_port(ep),
                           torch.ones(tl_test.BATCH), 0, 1,
                           prng.PRNGKey(3, "cpu"))
        states.append(tls)
        infos.append(ti)
    for k in ("loss", "grad_norm", "td_errors_abs"):
        assert torch.equal(infos[0][k], infos[1][k]), k
    for m in states[0].params:
        for k in states[0].params[m]:
            assert torch.equal(states[0].params[m][k],
                               states[1].params[m][k]), (m, k)


def test_superstep_is_bit_identical_to_run_classic_under_dropout(tmp_path):
    """The fused program (its stage functions eagerly on the CPU) and
    ``run_classic`` under dropout, remat on: one dispatch of K = 3
    against 3 iterations from one state, bit for bit (every rollout and
    train step draws its masks from the same keys)."""
    d = sup_test.tiny(tmp_path, accumulated_episodes=4,
                      **dict(sup_test.DENSE, obs={}))
    d["model"] = dict(d["model"], dropout=0.2, remat=True)
    exp = Experiment.build(from_dict(d), device="cpu")
    assert exp.mac.stochastic and exp.learner.needs_rngs
    ts0 = exp.init_state(0)
    ts_c, cursor, recs = run_classic(exp, clone_state(ts0), 3)
    ts_f, _, kept, _, gates, key = sup_test._fused(exp, clone_state(ts0),
                                                   3, 1)
    assert gates == [r.info is not None for r in recs]
    sup_test._states_equal(ts_c, ts_f)
    assert torch.equal(cursor.key, key)
    infos = [r.info for r in recs if r.info is not None]
    for a, b in zip(infos, kept):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert dataclasses.is_dataclass(ts_f)


def test_keep_mask_on_the_cpu_is_the_plain_draw():
    """On a CPU key the dropout-mask wrapper runs its plain version: the
    scope's fold, then ``prng.bernoulli`` (equal to JAX's ``fold_in`` and
    ``bernoulli``); it counts no launch."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.kernels import dropout as dk
    key = prng.split(prng.PRNGKey(3, "cpu"))[1]
    scope = Scope(key, ("transformer", "block_1", "Dropout_0"))
    dk.reset_launches()
    got = dk.keep_mask(key, scope.fold_data(), 0.9, (5, 7, 3))
    assert got.dtype == torch.bool
    assert torch.equal(got, prng.bernoulli(scope.make_rng(), 0.9, (5, 7, 3)))
    jkey = jax.random.fold_in(jnp.asarray(key.numpy().astype(np.uint32)),
                              scope.fold_data())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.bernoulli(jkey, 0.9, (5, 7, 3))))
    assert dk.LAUNCHES["dropout_mask"] == 0
