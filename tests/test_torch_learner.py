"""Port parity of the QMIX learner: the port's ``QMixLearner.train``
against the JAX package's (jitted, Pallas in interpret mode) for three
consecutive steps from the same params, numpy batch and importance
weights, with a hard target sync inside the three steps. The batch has
partial ``filled`` masks and a mid-episode ``terminated``.

Cases: qslice × {pallas, xla}; dense (``use_qslice: false``) × pallas;
``td_loss`` ∈ {mse, huber}; ``double_q`` ∈ {T, F}; ``rmsprop`` once.
Tolerances (f32): every info value rtol 1e-5 / atol 1e-6, ``grad_norm``
rtol 1e-4, params and target params atol 1e-5 after each step,
``train_steps`` and ``last_target_update`` equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.components.episode_buffer import EpisodeBatch as JaxBatch
from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.controllers.basic_mac import BasicMAC as JaxMAC
from t2omca_tpu.envs.registry import make_env as jax_make_env
from t2omca_tpu.learners.qmix_learner import QMixLearner as JaxLearner
from t2omca_tpu_torch.components.episode_buffer import EpisodeBatch
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
from t2omca_tpu_torch.convert import learner_params_from_flax
from t2omca_tpu_torch.envs.registry import make_env
from t2omca_tpu_torch.learners import QMixLearner

INFO = dict(rtol=1e-5, atol=1e-6)
PARAMS = dict(rtol=0.0, atol=1e-5)
BATCH, T = 3, 6


def config(**over):
    d = {"batch_size": BATCH, "target_update_interval": 2, "lr": 0.001,
         "env_args": {"agv_num": 3, "mec_num": 2, "num_channels": 2,
                      "episode_limit": T},
         "model": {"emb": 8, "heads": 2, "depth": 1, "mixer_emb": 8,
                   "mixer_heads": 2, "mixer_depth": 1},
         "replay": {"compact_entity_store": False, "buffer_size": 8},
         "kernels": {"attention": "xla"}}
    for key, val in over.items():
        sect, _, name = key.rpartition(".")
        (d.setdefault(sect, {}) if sect else d)[name] = val
    return d


def make_episodes(rng, info, b, t, partial=True):
    """A numpy episode batch: action 0 always available, actions legal,
    rewards ~N(0, 1); with ``partial``, episode 0 terminates mid-way
    (filled stops after it) and episode 1 is cut by the time limit."""
    a, n, od, sd = (info["n_agents"], info["n_actions"], info["obs_shape"],
                    info["state_shape"])
    avail = rng.random((b, t + 1, a, n)) < 0.6
    avail[..., 0] = True
    logits = np.where(avail[:, :-1], rng.random((b, t, a, n)), -1.0)
    filled = np.ones((b, t), bool)
    terminated = np.zeros((b, t), bool)
    if partial:
        terminated[0, t // 2] = True
        filled[0, t // 2 + 1:] = False
        filled[1, t - 2:] = False
    return dict(
        obs=rng.standard_normal((b, t + 1, a, od)).astype(np.float32),
        state=rng.standard_normal((b, t + 1, sd)).astype(np.float32),
        avail_actions=avail,
        actions=logits.argmax(-1).astype(np.int32),
        reward=rng.standard_normal((b, t)).astype(np.float32),
        terminated=terminated, filled=filled)


def to_jax(ep):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in ep.items()})


def to_port(ep):
    return EpisodeBatch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in ep.items()})


def build_pair(d, jit_init=False):
    """JAX and port learners of config ``d`` from the same params; with
    ``jit_init`` the JAX state is initialized under ``jax.jit`` (faster,
    other float32 values than the eager init)."""
    jcfg = jax_from_dict(d)
    info = jax_make_env(jcfg.env_args).get_env_info()
    jl = JaxLearner.build(jcfg, JaxMAC.build(jcfg, info), info)
    init = jax.jit(jl.init_state) if jit_init else jl.init_state
    jls = init(jax.random.PRNGKey(0))
    tcfg = from_dict(d)
    tinfo = make_env(tcfg.env_args).get_env_info()
    assert tinfo == info
    tl = QMixLearner.build(tcfg, BasicMAC.build(tcfg, tinfo, device="cpu"),
                           tinfo, device="cpu")
    tls = tl.init_state(params=learner_params_from_flax(
        jax.tree.map(np.asarray, jls.params), device="cpu"))
    return jl, jls, tl, tls, info


def _params_close(port_tree, jax_tree, what):
    want = learner_params_from_flax(jax.tree.map(np.asarray, jax_tree),
                                    device="cpu")
    for m in ("agent", "mixer"):
        assert set(port_tree[m]) == set(want[m])
        for k, v in port_tree[m].items():
            np.testing.assert_allclose(v.numpy(), want[m][k].numpy(),
                                       err_msg=f"{what} {m}.{k}", **PARAMS)


CASES = {
    "qslice_pallas": {"kernels.attention": "pallas"},
    "qslice_xla": {},
    "dense_pallas": {"kernels.attention": "pallas",
                     "model.use_qslice": False},
    "huber_no_double_q": {"td_loss": "huber", "huber_delta": 0.5,
                          "double_q": False},
    "rmsprop": {"optimizer": "rmsprop"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_matches_jax_for_three_steps(case):
    jl, jls, tl, tls, info = build_pair(config(**CASES[case]))
    jtrain = jax.jit(jl.train)
    rng = np.random.default_rng(1)
    for step in range(3):
        ep = make_episodes(rng, info, BATCH, T)
        w = rng.uniform(0.5, 1.0, BATCH).astype(np.float32)
        episode = step + 1
        jls, jinfo = jtrain(jls, to_jax(ep), jnp.asarray(w), 0, episode)
        tls, tinfo = tl.train(tls, to_port(ep), torch.from_numpy(w), 0,
                              episode)
        for key in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
                    "td_errors_abs"):
            np.testing.assert_allclose(tinfo[key].numpy(),
                                       np.asarray(jinfo[key]),
                                       err_msg=f"step {step} {key}", **INFO)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-4)
        assert bool(tinfo["all_finite"]) and bool(jinfo["all_finite"])
        _params_close(tls.params, jls.params, f"step {step} params")
        _params_close(tls.target_params, jls.target_params,
                      f"step {step} target")
        assert int(tls.train_steps) == int(jls.train_steps) == step + 1
        assert int(tls.last_target_update) == int(jls.last_target_update)
    # the hard sync happened (episode 2) and params moved on after it
    assert int(tls.last_target_update) == 2


def test_injected_nan_trips_guard_and_changes_nothing():
    d = config(**{"resilience.inject_nan_at_step": 1})
    tcfg = from_dict(d)
    info = make_env(tcfg.env_args).get_env_info()
    tl = QMixLearner.build(tcfg, BasicMAC.build(tcfg, info, device="cpu"),
                           info, device="cpu")
    tls = tl.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    w = torch.ones(BATCH)
    tls, i0 = tl.train(tls, to_port(make_episodes(rng, info, BATCH, T)), w,
                       0, 0)
    assert bool(i0["all_finite"])
    before = tls
    tls, i1 = tl.train(tls, to_port(make_episodes(rng, info, BATCH, T)), w,
                       0, 0)
    assert not bool(i1["all_finite"]) and torch.isnan(i1["loss"])
    assert int(tls.train_steps) == 2
    for tree_new, tree_old in ((tls.params, before.params),
                               (tls.opt_state["mu"], before.opt_state["mu"]),
                               (tls.opt_state["nu"], before.opt_state["nu"])):
        for m in tree_new:
            for k in tree_new[m]:
                assert torch.equal(tree_new[m][k], tree_old[m][k]), (m, k)
    assert torch.equal(tls.opt_state["count"], before.opt_state["count"])


def test_train_info_zeros_matches_train_info():
    d = config()
    tcfg = from_dict(d)
    info = make_env(tcfg.env_args).get_env_info()
    tl = QMixLearner.build(tcfg, BasicMAC.build(tcfg, info, device="cpu"),
                           info, device="cpu")
    tls = tl.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    _, got = tl.train(tls, to_port(make_episodes(rng, info, BATCH, T)),
                      torch.ones(BATCH), 0, 0)
    zeros = tl.train_info_zeros(BATCH)
    assert set(zeros) == set(got)
    for k in got:
        assert zeros[k].shape == got[k].shape and \
            zeros[k].dtype == got[k].dtype, k
    assert bool(zeros["all_finite"])


@pytest.mark.parametrize("over,match", [
    ({"mixer": "vdn"}, "mixer 'vdn'"),
    ({"model.dropout": 0.1}, "dropout"),
    ({"mixer": "qmix_ff"}, "mixer 'qmix_ff'"),
    ({"action_selector": "noisy-new", "model.use_qslice": False},
     "dense agent's NoisyNet"),
])
def test_unported_paths_raise(over, match):
    """The four paths the port once refused (``match`` names each) now
    build and match JAX: one keyed train step from the same params,
    batch, weights and key, at this file's tolerances (info ``INFO``,
    ``grad_norm`` rtol 1e-4, params ``PARAMS``)."""
    jl, jls, tl, tls, info = build_pair(config(**over))
    assert (tl.needs_rngs == jl.needs_rngs
            == (match in ("dropout", "dense agent's NoisyNet")))
    rng = np.random.default_rng(7)
    ep = make_episodes(rng, info, BATCH, T)
    w = rng.uniform(0.5, 1.0, BATCH).astype(np.float32)
    key = jax.random.PRNGKey(21)
    jls, jinfo = jax.jit(jl.train)(jls, to_jax(ep), jnp.asarray(w), 0, 1,
                                   key)
    from t2omca_tpu_torch.convert import tensor_from_jax
    tls, tinfo = tl.train(tls, to_port(ep), torch.from_numpy(w), 0, 1,
                          tensor_from_jax(key, "cpu"))
    for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
              "td_errors_abs"):
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                   err_msg=f"{match} {k}", **INFO)
    np.testing.assert_allclose(float(tinfo["grad_norm"]),
                               float(jinfo["grad_norm"]), rtol=1e-4)
    _params_close(tls.params, jls.params, match)


@pytest.mark.parametrize("compact", [False, True])
def test_attention_routing_matches_the_card_launch_counts(monkeypatch,
                                                          compact):
    """On CPU tensors the kernels' plain versions run where the card
    launches K1, K1 + residuals, K2 and K3. Counting those calls over one
    qslice/pallas train step gives the launch counts ``chip_smoke.py``
    asserts on the card. Dense storage: K1 (2(T+1)+1)·depth (target
    unrolls and the online agent's bootstrap step), K1 + residuals, K2
    and K3 2T·depth. Compact storage (the default stack): the agent
    unrolls through the entity tables and launch nothing, so K1 is the
    target mixer's (T+1)·depth and the rest the online mixer's T·depth."""
    from t2omca_tpu_torch.kernels import attention as att
    calls = {"k1": 0, "k1_res": 0, "bwd": 0}
    ref, fwd_ref, bwd_ref = (att.flash_attention_reference,
                             att.flash_attention_fwd_reference,
                             att.flash_attention_bwd_reference)

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(att, "flash_attention_reference",
                        counted("k1", ref))
    monkeypatch.setattr(att, "flash_attention_fwd_reference",
                        counted("k1_res", fwd_ref))
    monkeypatch.setattr(att, "flash_attention_bwd_reference",
                        counted("bwd", bwd_ref))
    d = config(**{"kernels.attention": "pallas", "model.depth": 2,
                  "model.mixer_depth": 2,
                  "replay.compact_entity_store": compact})
    tcfg = from_dict(d)
    info = make_env(tcfg.env_args).get_env_info()
    tl = QMixLearner.build(tcfg, BasicMAC.build(tcfg, info, device="cpu"),
                           info, device="cpu")
    tls = tl.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    if compact:
        import test_torch_entity
        batch = test_torch_entity.to_port(test_torch_entity.episodes(
            rng, info, BATCH, T))
    else:
        batch = to_port(make_episodes(rng, info, BATCH, T))
    tl.train(tls, batch, torch.ones(BATCH), 0, 0)
    depth = 2
    if compact:
        want = {"k1": (T + 1) * depth, "k1_res": T * depth,
                "bwd": T * depth}
    else:
        want = {"k1": (2 * (T + 1) + 1) * depth, "k1_res": 2 * T * depth,
                "bwd": 2 * T * depth}
    assert calls == want
