"""Port parity of the host-RAM replay (``replay.buffer_cpu_only``,
``t2omca_tpu_torch/components/host_replay.py`` and the native sum-tree)
against the JAX package's ``HostReplayBuffer`` and ``tests/
test_host_replay.py``'s cases, on the CPU.

Exact: sum-tree indices (native against Python and against the JAX
package's tree), the device sample's indices against JAX's
``_stratified_sample`` and the sum-tree formulation, the port's weights
against its own formulation at the tree's indices, the priority
mirrors, and every stored and sampled leaf. The importance weights
against JAX's: rtol 1e-6 (``WEIGHTS``, a few float32 ulps), because the
weights normalize by ``p.sum()`` and XLA's CPU reduction sums a float32
vector in another order than torch's (361.11337 against 361.1134 on
one 250-slot fill, which moves a weight by one ulp). The driver's
metric rows at ``buffer_cpu_only`` against JAX's ``run`` at
``tests/test_torch_driver.py``'s tolerances."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.components.episode_buffer import EpisodeBatch as JaxBatch
from t2omca_tpu.components.host_replay import (
    HostReplayBuffer as JaxHostBuffer, _importance_weights,
    _stratified_sample)
from t2omca_tpu_torch.components.episode_buffer import EpisodeBatch
from t2omca_tpu_torch.components.host_replay import (
    HostReplayBuffer, PySumTree, importance_weights, stratified_sample)

WEIGHTS = dict(rtol=1e-6, atol=0.0)


def _native_or_skip(cap):
    from t2omca_tpu_torch.components.host_replay import NativeSumTree
    from t2omca_tpu_torch.native import NativeBuildError
    try:
        return NativeSumTree(cap)
    except NativeBuildError as e:        # no g++ on this machine
        pytest.skip(f"native sum-tree unavailable: {e}")


# ------------------------------------------------------------------ trees

def test_native_sumtree_set_get_total():
    t = _native_or_skip(10)          # rounds up to 16 leaves
    t.set_batch(np.array([0, 3, 7]), np.array([1.0, 2.0, 5.0]))
    assert t.total() == pytest.approx(8.0)
    assert t.get(np.array([3]))[0] == pytest.approx(2.0)
    t.set_batch(np.array([3]), np.array([0.5]))
    assert t.total() == pytest.approx(6.5)


def test_native_sumtree_matches_python_and_jax_package():
    """The port's native tree (its own copy of ``sumtree.cpp``, built
    under ``native/_build``) against ``PySumTree`` and against the JAX
    package's native tree: indices and priorities equal."""
    from t2omca_tpu.components.host_replay import NativeSumTree as JaxNat
    nat = _native_or_skip(8)
    py = PySumTree(8)
    jnat = JaxNat(8)
    pri = np.array([0.5, 2.0, 0.0, 1.5, 3.0, 0.25, 7.0, 1.0])
    for tree in (nat, py, jnat):
        tree.set_batch(np.arange(8), pri)
    us = np.random.default_rng(1).random(64)
    i_n, p_n = nat.sample(us)
    for other in (py, jnat):
        i_o, p_o = other.sample(us)
        np.testing.assert_array_equal(i_n, i_o)
        np.testing.assert_array_equal(p_n, p_o)
    for idx in (3, np.arange(8), np.array([7, 0, 3, 3, 6, 0])):
        np.testing.assert_array_equal(nat.get(idx),
                                      np.atleast_1d(py.get(
                                          np.atleast_1d(idx))))


# ---------------------------------------------------------- device sample

def _trees(cap, pri32):
    py = PySumTree(cap)
    py.set_batch(np.arange(len(pri32)), pri32.astype(np.float64))
    return [("py", py)]


def test_device_sample_matches_jax_and_sumtree():
    """25 random fills: indices equal to JAX's device program and to the
    sum-tree at the same f32 uniforms, weights equal to JAX's and to the
    shared formulation at the tree's indices, a poisoned tail changes
    nothing."""
    rng = np.random.default_rng(123)
    for trial in range(25):
        cap = int(rng.integers(4, 400))
        n = cap if trial % 3 == 0 else int(rng.integers(1, cap + 1))
        bs = int(rng.integers(1, min(n, 48) + 1))
        pri = np.zeros(cap, np.float32)
        pri[:n] = (rng.random(n) * 3 + 1e-6).astype(np.float32)
        us = rng.random(bs).astype(np.float32)
        beta = np.float32(rng.random())
        j_idx, j_w = _stratified_sample(
            jnp.asarray(pri), jnp.asarray(us), jnp.asarray(n, jnp.int32),
            jnp.asarray(beta))
        poisoned = pri.copy()
        poisoned[n:] = np.resize([np.nan, 1e30, -7.0], cap - n)
        for vec in (pri, poisoned):
            idx, w = stratified_sample(torch.from_numpy(vec),
                                       torch.from_numpy(us), n, float(beta))
            np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx),
                                          err_msg=f"trial {trial}")
            np.testing.assert_allclose(w.numpy(), np.asarray(j_w),
                                       err_msg=f"trial {trial}", **WEIGHTS)
        for label, tree in _trees(cap, pri):
            ti, _ = tree.sample(us.astype(np.float64))
            ti = np.minimum(ti, n - 1)
            np.testing.assert_array_equal(idx.numpy(), ti, err_msg=label)
            w_ref = importance_weights(torch.from_numpy(pri),
                                       torch.from_numpy(ti), n, float(beta))
            np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
            np.testing.assert_allclose(w_ref.numpy(), np.asarray(
                _importance_weights(jnp.asarray(pri), jnp.asarray(ti),
                                    jnp.asarray(n, jnp.int32),
                                    jnp.asarray(beta))), **WEIGHTS)


# ----------------------------------------------------------------- buffer

def _mk(b, t=3, a=2, n_act=3, obs=4, state=5, seed=0):
    rng = np.random.default_rng(seed)
    avail = rng.random((b, t + 1, a, n_act)) < 0.7
    avail[..., 0] = True
    return dict(
        obs=rng.normal(size=(b, t + 1, a, obs)).astype(np.float32),
        state=rng.normal(size=(b, t + 1, state)).astype(np.float32),
        avail_actions=avail,
        actions=rng.integers(0, n_act, (b, t, a)).astype(np.int32),
        reward=rng.normal(size=(b, t)).astype(np.float32),
        terminated=rng.random((b, t)) < 0.2,
        filled=np.ones((b, t), bool))


def _pair(**kw):
    kw = dict(dict(capacity=8, episode_limit=3, n_agents=2, n_actions=3,
                   obs_dim=4, state_dim=5, t_max=100), **kw)
    return JaxHostBuffer(**kw), HostReplayBuffer(device="cpu", **kw)


def _insert(jbuf, tbuf, ep):
    jbuf.insert_episode_batch(JaxBatch(**{k: jnp.asarray(v)
                                          for k, v in ep.items()}))
    tbuf.insert_episode_batch(EpisodeBatch(**{
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in ep.items()}))


def _same_batch(tb, jb):
    for f in dataclasses.fields(EpisodeBatch):
        t = getattr(tb, f.name)
        j = np.asarray(getattr(jb, f.name))
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32), err_msg=f.name)


def _same_mirrors(jbuf, tbuf):
    np.testing.assert_array_equal(tbuf._pri, jbuf._pri)
    np.testing.assert_array_equal(tbuf._pri_dev.numpy(), tbuf._pri)
    assert tbuf._max_priority == jbuf._max_priority
    assert (tbuf._pos, tbuf._count) == (jbuf._pos, jbuf._count)


@pytest.mark.parametrize("prioritized", [True, False])
def test_samples_match_jax_through_feedback_and_wrap(prioritized):
    """The same inserts, samples and deferred feedback on both buffers
    (capacity 5, so the third insert wraps): indices, weights, every
    sampled leaf and both priority mirrors equal at each step."""
    jbuf, tbuf = _pair(capacity=5, prioritized=prioritized)
    rng = np.random.default_rng(11)
    for it in range(4):
        _insert(jbuf, tbuf, _mk(2, seed=it))
        _same_mirrors(jbuf, tbuf)
        if not tbuf.can_sample(2):
            assert not jbuf.can_sample(2)
            continue
        jb, jidx, jw = jbuf.sample(2, t_env=10 * it)
        tb, tidx, tw = tbuf.sample(2, t_env=10 * it)
        np.testing.assert_array_equal(tidx, np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **WEIGHTS)
        _same_batch(tb, jb)
        td = rng.random(2).astype(np.float32) * 3
        jbuf.defer_priority_update(jidx, jnp.asarray(td),
                                   jnp.asarray(True))
        tbuf.defer_priority_update(tidx, torch.from_numpy(td),
                                   torch.tensor(True))
    # the feedback lands one step late: at the next insert or sample
    assert tbuf._pending_update is not None or not prioritized
    _insert(jbuf, tbuf, _mk(2, seed=9))
    assert tbuf._pending_update is None
    _same_mirrors(jbuf, tbuf)
    np.testing.assert_array_equal(tbuf._storage.reward.numpy(),
                                  jbuf._storage.reward)


def test_deferred_update_skips_a_tripped_step_and_drop_discards():
    """A non-finite step's feedback leaves the mirrors as they were;
    ``drop_pending_update`` discards a pending update unread."""
    jbuf, tbuf = _pair()
    _insert(jbuf, tbuf, _mk(4, seed=5))
    _, idx, _ = tbuf.sample(3, t_env=0)
    before = tbuf._pri.copy()
    tbuf.defer_priority_update(idx, torch.full((3,), 1e6),
                               torch.tensor(False))
    tbuf.flush_priority_updates()
    np.testing.assert_array_equal(tbuf._pri, before)
    tbuf.defer_priority_update(idx, torch.full((3,), 1e6),
                               torch.tensor(True))
    tbuf.drop_pending_update()
    assert tbuf._pending_update is None
    tbuf.flush_priority_updates()
    np.testing.assert_array_equal(tbuf._pri, before)
    np.testing.assert_array_equal(tbuf._pri_dev.numpy(), before)


def test_ring_wraparound_and_bf16_storage():
    jbuf, tbuf = _pair(capacity=4, store_dtype="bfloat16")
    _insert(jbuf, tbuf, _mk(3, seed=2))
    _insert(jbuf, tbuf, _mk(3, seed=3))
    assert (tbuf._count, tbuf._pos) == (4, 2)
    np.testing.assert_array_equal(tbuf._storage.reward[0].numpy(),
                                  _mk(3, seed=3)["reward"][1])
    assert tbuf._storage.obs.dtype == torch.bfloat16
    jb, jidx, _ = jbuf.sample(2, t_env=0)
    tb, tidx, _ = tbuf.sample(2, t_env=0)
    np.testing.assert_array_equal(tidx, np.asarray(jidx))
    assert tb.obs.dtype == torch.bfloat16
    _same_batch(tb, jb)


def test_steady_state_runs_no_sumtree_and_copies_once(monkeypatch):
    """Nothing on the live path builds or calls a sum-tree, and a
    prioritized sample makes one device-to-host and one host-to-device
    copy."""
    import t2omca_tpu_torch.components.host_replay as hr
    import t2omca_tpu_torch.native as native

    def boom(*a, **kw):
        raise AssertionError("sum-tree touched on the live path")

    monkeypatch.setattr(native, "load_sumtree", boom)
    monkeypatch.setattr(hr.PySumTree, "__init__", boom)
    monkeypatch.setattr(hr.NativeSumTree, "__init__", boom)
    _, tbuf = _pair()
    tbuf.insert_episode_batch(EpisodeBatch(**{
        k: torch.from_numpy(v) for k, v in _mk(4, seed=9).items()}))
    batch, idx, _ = tbuf.sample(3, t_env=10)
    assert tbuf.copies == {"d2h": 1, "h2d": 1}
    tbuf.defer_priority_update(idx, torch.tensor([0.5, 2.0, 0.1]),
                               torch.tensor(True))
    _, idx2, w2 = tbuf.sample(3, t_env=20)
    assert tbuf.copies == {"d2h": 2, "h2d": 2}
    assert batch.obs.shape == (3, 4, 2, 4) and (idx2 < 4).all()
    assert float(w2.max()) == pytest.approx(1.0)


# ----------------------------------------------------------------- driver

def test_driver_rows_match_jax_at_buffer_cpu_only(tmp_path):
    """JAX's ``run`` and the port's at ``replay.buffer_cpu_only`` on
    ``tests/test_torch_driver.py``'s operating point, from the same
    params: the same ``(key, t)`` rows, every rollout-side row up to the
    first train step exact, the first train step's values at that test's
    tolerances (the same sampled episodes: one host RNG stream in each
    package), later rows finite; the checkpoint holds no ring."""
    import test_torch_driver as drv
    from t2omca_tpu.config import from_dict as jax_from_dict
    from t2omca_tpu.run import Experiment as JaxExperiment
    from t2omca_tpu.run import run as jax_run
    from t2omca_tpu.utils.logging import Logger as JaxLogger
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.convert import learner_params_from_flax
    from t2omca_tpu_torch.run import run
    from t2omca_tpu_torch.utils.checkpoint import find_checkpoint
    from t2omca_tpu_torch.utils.logging import Logger
    # through the first train step (t_env 24) and its log cadence
    kw = dict(replay=dict(buffer_size=8, buffer_cpu_only=True), t_max=24)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcfg = jax_from_dict(drv.tiny(jdir, **kw))
    flax = jax.tree.map(np.asarray, JaxExperiment.build(jcfg)
                        .init_train_state(jcfg.seed).learner.params)
    jax_run(jcfg, JaxLogger())
    ts = run(from_dict(drv.tiny(tdir, **kw)), Logger(), device="cpu",
             learner_params=learner_params_from_flax(flax, "cpu"))
    assert ts.buffer is None
    rj, rt = drv.rows_of(jdir), drv.rows_of(tdir)
    assert set(rt) == set(rj)
    first = min(t for (k, t) in rj if k == "loss")
    early = [k for k in rj if not drv.wall_clock(k[0]) and (
        k[1] < first or k[1] == first and not k[0].startswith("test_")
        and k[0] not in drv.LEARNER_KEYS)]
    assert len(early) > 10
    for k in early:
        assert rt[k] == rj[k], (k, rt[k], rj[k])
    for k in drv.LEARNER_KEYS:
        tol = drv.GRAD_NORM if k == "grad_norm" else drv.INFO
        np.testing.assert_allclose(rt[(k, first)], rj[(k, first)],
                                   err_msg=k, **tol)
    for k, v in rt.items():
        assert np.isfinite(v), (k, v)
    (models,) = (tdir / "models").iterdir()
    found = find_checkpoint(str(models))
    assert found is not None
    state = torch.load(os.path.join(found[0], "state.pt"),
                       weights_only=True)
    assert state and not any(k.startswith("buffer.") for k in state)
