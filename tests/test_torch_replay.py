"""Port parity of the replay buffers and the trainer step
(``t2omca_tpu_torch.components.episode_buffer``, ``train.program``)
against the JAX package. Mirrors ``tests/test_selectors_buffer.py:83-290``.

The samplers draw from keys of the port's threefry chain, bit for bit
the JAX draws: from the same key the indices are identical and the
weights within 1e-6. The injected draws (``u`` for PER, ``scores`` for
the uniform buffer) stay as a second way in. The trainer step is held
against the JAX composition ``split(key) → buffer.sample → learner.train
→ update_priorities`` for two iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.components.episode_buffer import \
    PrioritizedReplayBuffer as JaxPER
from t2omca_tpu.components.episode_buffer import ReplayBuffer as JaxRB
from t2omca_tpu_torch.components.episode_buffer import (
    PrioritizedReplayBuffer, ReplayBuffer)
from t2omca_tpu_torch.convert import tensor_from_jax
from t2omca_tpu_torch.train.program import TrainState, build_train_iter

from test_torch_learner import (BATCH, T, _params_close, build_pair,
                                config, make_episodes, to_jax, to_port)

KW = dict(episode_limit=3, n_agents=2, n_actions=3, obs_dim=4, state_dim=5)


def _episodes(b, seed):
    info = {"n_agents": 2, "n_actions": 3, "obs_shape": 4, "state_shape": 5}
    return make_episodes(np.random.default_rng(seed), info, b, 3,
                         partial=False)


def _pair(cls_t, cls_j, cap=5, **kw):
    return cls_t(capacity=cap, device="cpu", **KW, **kw), \
        cls_j(capacity=cap, **KW, **kw)


def _same_state(st, sj):
    assert st.insert_pos == int(sj.insert_pos)
    assert st.episodes_in_buffer == int(sj.episodes_in_buffer)
    # p^alpha: torch's and XLA's pow may differ in the last ulp
    np.testing.assert_allclose(st.priorities.numpy(),
                               np.asarray(sj.priorities), rtol=1e-6)
    assert float(st.max_priority) == float(sj.max_priority)
    for name in ("obs", "state", "avail_actions", "actions", "reward",
                 "terminated", "filled"):
        np.testing.assert_array_equal(
            getattr(st.storage, name).numpy(),
            np.asarray(getattr(sj.storage, name)), err_msg=name)


@pytest.mark.parametrize("prioritized", [False, True])
def test_ring_insert_wraparound_and_can_sample(prioritized):
    kw = dict(alpha=0.6, beta0=0.4, t_max=100) if prioritized else {}
    bt, bj = _pair(PrioritizedReplayBuffer if prioritized else ReplayBuffer,
                   JaxPER if prioritized else JaxRB, **kw)
    st, sj = bt.init(), bj.init()
    assert not bt.can_sample(st, 2)
    for seed, b in ((1, 3), (2, 3)):
        ep = _episodes(b, seed)
        st = bt.insert_episode_batch(st, to_port(ep))
        sj = bj.insert_episode_batch(sj, to_jax(ep))
        _same_state(st, sj)
    assert st.episodes_in_buffer == 5 and st.insert_pos == 1
    assert bt.can_sample(st, 5) and not bt.can_sample(st, 6)
    np.testing.assert_array_equal(st.storage.reward[0].numpy(),
                                  _episodes(3, 2)["reward"][2])
    assert st.storage.avail_actions.dtype == torch.bool


def test_fresh_episodes_get_the_max_priority_pre_exponentiated():
    bt, bj = _pair(PrioritizedReplayBuffer, JaxPER, cap=6, alpha=0.6,
                   beta0=0.4, t_max=100)
    st = bt.insert_episode_batch(bt.init(), to_port(_episodes(3, 1)))
    sj = bj.insert_episode_batch(bj.init(), to_jax(_episodes(3, 1)))
    pr = np.array([2.0, 5.0, 0.5], np.float32)
    st = bt.update_priorities(st, torch.arange(3), torch.from_numpy(pr))
    sj = bj.update_priorities(sj, jnp.arange(3), jnp.asarray(pr))
    st = bt.insert_episode_batch(st, to_port(_episodes(2, 2)))
    sj = bj.insert_episode_batch(sj, to_jax(_episodes(2, 2)))
    _same_state(st, sj)
    assert float(st.max_priority) == 5.0
    np.testing.assert_allclose(st.priorities[3:5].numpy(), 5.0 ** 0.6,
                               rtol=1e-6)
    np.testing.assert_allclose(st.priorities[:3].numpy(), pr ** 0.6,
                               rtol=1e-6)


def test_update_priorities_invalid_is_a_noop_in_value():
    bt, _ = _pair(PrioritizedReplayBuffer, JaxPER, alpha=0.6, beta0=0.4,
                  t_max=100)
    st = bt.insert_episode_batch(bt.init(), to_port(_episodes(4, 1)))
    st = bt.update_priorities(st, torch.arange(4),
                              torch.tensor([1.0, 2.0, 3.0, 4.0]))
    nan = torch.tensor([float("nan"), 9.0])
    # the priorities are written in place: hold the values from before
    before, max_before = st.priorities.clone(), st.max_priority.clone()
    after = bt.update_priorities(st, torch.tensor([1, 2]), nan,
                                 valid=torch.tensor(False))
    assert torch.equal(after.priorities, before)
    assert torch.equal(after.max_priority, max_before)
    uniform = ReplayBuffer(capacity=5, device="cpu", **KW)
    su = uniform.insert_episode_batch(uniform.init(),
                                      to_port(_episodes(2, 1)))
    assert uniform.update_priorities(su, torch.arange(2), nan) is su


@pytest.mark.parametrize("t_env", [0, 37, 500])
def test_per_sample_matches_jax_with_injected_uniforms(t_env):
    bt, bj = _pair(PrioritizedReplayBuffer, JaxPER, cap=8, alpha=0.6,
                   beta0=0.4, t_max=100)
    st = bt.insert_episode_batch(bt.init(), to_port(_episodes(6, 1)))
    sj = bj.insert_episode_batch(bj.init(), to_jax(_episodes(6, 1)))
    pr = np.random.default_rng(4).uniform(0.01, 3.0, 6).astype(np.float32)
    st = bt.update_priorities(st, torch.arange(6), torch.from_numpy(pr))
    sj = bj.update_priorities(sj, jnp.arange(6), jnp.asarray(pr))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        bjx, ij, wj = bj.sample(sj, key, 4, t_env)
        u = torch.tensor(np.asarray(jax.random.uniform(key, (4,))))
        btx, it, wt = bt.sample(st, None, 4, t_env, u=u)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(btx.obs.numpy(), np.asarray(bjx.obs))
        _, ik, wk = bt.sample(st, tensor_from_jax(key, "cpu"), 4, t_env)
        assert torch.equal(ik, it) and torch.equal(wk, wt)


def test_uniform_sample_matches_jax_with_injected_scores():
    bt, bj = _pair(ReplayBuffer, JaxRB, cap=8)
    st = bt.insert_episode_batch(bt.init(), to_port(_episodes(5, 1)))
    sj = bj.insert_episode_batch(bj.init(), to_jax(_episodes(5, 1)))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        _, ij, wj = bj.sample(sj, key, 3)
        scores = torch.tensor(np.asarray(jax.random.uniform(key, (8,))))
        _, it, wt = bt.sample(st, None, 3, scores=scores)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert len(set(it.tolist())) == 3 and int(it.max()) < 5
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        ik = bt.sample(st, tensor_from_jax(key, "cpu"), 3)[1]
        assert torch.equal(ik, it)


def test_train_iter_matches_jax_composition():
    """Two trainer steps (split → sample → train → priority feedback) from
    the same ring, params and key: priorities, max_priority and params
    match the JAX composition."""
    d = config(**{"kernels.attention": "pallas", "replay.buffer_size": 6})
    jl, jls, tl, tls, info = build_pair(d)
    kw = dict(capacity=6, episode_limit=T, n_agents=info["n_agents"],
              n_actions=info["n_actions"], obs_dim=info["obs_shape"],
              state_dim=info["state_shape"], alpha=0.6, beta0=0.4,
              t_max=1000)
    bj, bt = JaxPER(**kw), PrioritizedReplayBuffer(device="cpu", **kw)
    ep = make_episodes(np.random.default_rng(5), info, 5, T)
    sj = bj.insert_episode_batch(bj.init(), to_jax(ep))
    ts = TrainState(learner=tls,
                    buffer=bt.insert_episode_batch(bt.init(), to_port(ep)),
                    episode=5)
    train_iter = build_train_iter(bt, tl, tl.cfg)
    jtrain = jax.jit(jl.train)
    for it in range(2):
        key = jax.random.PRNGKey(10 + it)
        t_env = 100 * (it + 1)
        k_sample, _ = jax.random.split(key)
        batch, idx, w = bj.sample(sj, k_sample, BATCH, t_env)
        jls, jinfo = jtrain(jls, batch, w, t_env, 5)
        sj = bj.update_priorities(sj, idx, jinfo["td_errors_abs"] + 1e-6,
                                  valid=jinfo["all_finite"])
        ts, tinfo = train_iter(ts, tensor_from_jax(key, "cpu"), t_env)
        np.testing.assert_allclose(ts.buffer.priorities.numpy(),
                                   np.asarray(sj.priorities), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(ts.buffer.max_priority),
                                   float(sj.max_priority), rtol=1e-5)
        np.testing.assert_allclose(float(tinfo["loss"]),
                                   float(jinfo["loss"]), rtol=1e-5)
    _params_close(ts.learner.params, jls.params, "train_iter params")
    assert int(ts.learner.train_steps) == 2


@pytest.mark.parametrize("t_env", [0, 37, 500])
@pytest.mark.parametrize("prioritized", [False, True])
def test_keyed_sample_is_the_jax_sample(prioritized, t_env):
    """Without injected draws: the same key gives the JAX buffer's
    indices (both samplers, a ring that wrapped) and weights."""
    kw = dict(alpha=0.6, beta0=0.4, t_max=300) if prioritized else {}
    bt, bj = _pair(PrioritizedReplayBuffer if prioritized else ReplayBuffer,
                   JaxPER if prioritized else JaxRB, cap=7, **kw)
    st, sj = bt.init(), bj.init()
    for seed, b in ((1, 4), (2, 5)):
        st = bt.insert_episode_batch(st, to_port(_episodes(b, seed)))
        sj = bj.insert_episode_batch(sj, to_jax(_episodes(b, seed)))
    pr = np.random.default_rng(6).uniform(0.01, 3.0, 7).astype(np.float32)
    st = bt.update_priorities(st, torch.arange(7), torch.from_numpy(pr))
    sj = bj.update_priorities(sj, jnp.arange(7), jnp.asarray(pr))
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        bjx, ij, wj = bj.sample(sj, key, 5, t_env)
        btx, it, wt = bt.sample(st, tensor_from_jax(key, "cpu"), 5, t_env)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(btx.reward.numpy(),
                                      np.asarray(bjx.reward))


def test_buffer_state_converts_from_jax():
    """``convert.state_from_jax`` carries a JAX ring (storage, cursor,
    fill, priorities) across: the same state as the port's own inserts."""
    from t2omca_tpu_torch.components.episode_buffer import BufferState
    from t2omca_tpu_torch.convert import state_from_jax
    bt, bj = _pair(PrioritizedReplayBuffer, JaxPER, alpha=0.6, beta0=0.4,
                   t_max=100)
    st, sj = bt.init(), bj.init()
    for seed, b in ((1, 3), (2, 4)):
        st = bt.insert_episode_batch(st, to_port(_episodes(b, seed)))
        sj = bj.insert_episode_batch(sj, to_jax(_episodes(b, seed)))
    carried = state_from_jax(BufferState, jax.tree.map(np.asarray, sj),
                             "cpu")
    assert (carried.insert_pos, carried.episodes_in_buffer) == (2, 5)
    _same_state(carried, sj)
    _same_state(st, sj)
