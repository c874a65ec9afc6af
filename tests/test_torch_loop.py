"""Port parity of the classic training loop's core (``t2omca_tpu_torch.
run``: ``Experiment`` and ``run_classic``) against the JAX package's
``Experiment.init_train_state`` + ``jitted_programs`` driven as
``run.run_sequential`` drives them at ``superstep: 1``: rollout → ring
insert → episode / ``t_env`` accounting → the train gate → ``key2,
k_sample = split(key)`` → ``train_iter`` → ``key = key2``.

Config-1 semantics at small widths (4 AGVs, 2 MECs, emb 64, depth 2,
sequential normalizer, dense storage, PER), 4 lanes of 20 steps, batch
4, a ring of 8 episodes (it wraps in the third iteration); the learner's
params are carried from flax. Three iterations, each of which trains.
The runner state, the ring, the driver key and the counters chain
through the port's own loop; the learner state is set from the JAX one
before each iteration (``convert.learner_state_from_jax``), because two
float32 lowerings of one train step drift apart at these widths (see
the params tolerance), and a drifted policy would act differently.

Tolerances: the rollout batches, sampled indices, ``t_env``,
``episode``, the ring cursor and ``train_steps`` identical; loss and the
other info values rtol 1e-5 / atol 1e-6, ``grad_norm`` rtol 1e-4 (as
``tests/test_torch_learner.py``); priorities rtol 1e-5 / atol 1e-6.
Params: at least 99% of the agent's and of the mixer's within atol 1e-5
(the learner test's bound), every element within Adam's largest move,
``2·lr`` a step. At
these widths the loss is O(1e4) and the pre-clip gradients O(1e3); two
float32 lowerings of the same loss (the port's plain flash-attention
path against its einsum path, like the port against JAX) put gradient
elements ~5e-4 apart relative, which flips the sign of Adam's first
step, ``-lr·g/(|g| + eps)``, for the few elements whose gradient is
that close to 0. Where the step itself is that unstable,
``jax_loop(witness=True)`` takes JAX's step again from params scaled by
1 ± 1e-7, and the norm and the params share are held at the larger of
these bounds and twice the spread JAX's own step shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu_torch import prng
from t2omca_tpu_torch.components.episode_buffer import \
    PrioritizedReplayBuffer
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.convert import (learner_params_from_flax,
                                      learner_state_from_jax)
from t2omca_tpu_torch.run import Experiment, run_classic

from test_torch_learner import INFO
from test_torch_threads import one_intra_op_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(
    one_intra_op_thread)

ITERATIONS = 3
D = {"batch_size_run": 4, "batch_size": 4, "epsilon_anneal_time": 100,
     "target_update_interval": 8, "t_max": 1000,
     "env_args": {"agv_num": 4, "mec_num": 2, "num_channels": 2,
                  "episode_limit": 20, "fast_norm": False},
     "model": {"emb": 64, "heads": 3, "depth": 2, "mixer_emb": 64,
               "mixer_heads": 3, "mixer_depth": 2},
     "replay": {"buffer_size": 8}}


#: the params scalings JAX's own train step is taken again from, with
#: ``jax_loop(witness=True)``: a perturbation the size of one float32
#: rounding, to see how far the step itself moves under one
WITNESS_SCALES = (1 + 1e-7, 1 - 1e-7)
#: how far past that spread the port's step may be
WITNESS_MARGIN = 2


def step_spread(train_iter, ts, key, t_env, info, after):
    """JAX's own train step from ``ts`` with its params scaled by each of
    ``WITNESS_SCALES``, against the unscaled step (its ``info`` and its
    learner params ``after``) → the largest relative change of the
    pre-clip gradient norm and the largest share of agent or mixer
    params that end more than 1e-5 from the unscaled step's."""
    norm = float(info["grad_norm"])
    want = learner_params_from_flax(jax.tree.map(np.asarray, after), "cpu")
    out = {"grad_norm": 0.0, "params": 0.0}
    for s in WITNESS_SCALES:
        scaled = jax.tree.map(lambda x: x * np.float32(s), ts.learner.params)
        new, winfo = train_iter(ts.replace(learner=ts.learner.replace(
            params=scaled)), key, jnp.asarray(t_env))
        out["grad_norm"] = max(out["grad_norm"],
                               abs(float(winfo["grad_norm"]) - norm) / norm)
        got = learner_params_from_flax(
            jax.tree.map(np.asarray, new.learner.params), "cpu")
        for m in ("agent", "mixer"):
            diff = torch.cat([(v - want[m][k]).abs().flatten()
                              for k, v in got[m].items()])
            out["params"] = max(out["params"],
                                float((diff > 1e-5).float().mean()))
    return out


def jax_loop(exp, ts, n, witness: bool = False):
    """``run_sequential``'s classic iteration, without its cadences; with
    ``witness``, each trained iteration's record also holds
    ``step_spread`` of its step (``"spread"``)."""
    cfg = exp.cfg
    rollout, insert, train_iter = exp.jitted_programs()
    key = jax.random.PRNGKey(cfg.seed + 1)
    t_env = episode = filled = 0
    out = []
    for _ in range(n):
        rs, batch, stats = rollout(ts.learner.params["agent"], ts.runner,
                                   test_mode=False)
        ts = ts.replace(runner=rs, buffer=insert(ts.buffer, batch),
                        episode=ts.episode + cfg.batch_size_run)
        t_env += cfg.batch_size_run * cfg.env_args.episode_limit
        episode += cfg.batch_size_run
        filled = min(filled + cfg.batch_size_run, cfg.replay.buffer_size)
        rec = {"t_env": t_env, "episode": episode, "actions": batch.actions}
        if filled >= cfg.batch_size and episode >= cfg.accumulated_episodes:
            key2, k_sample = jax.random.split(key)
            rec["idx"] = exp.buffer.sample(
                ts.buffer, jax.random.split(k_sample)[0], cfg.batch_size,
                t_env)[1]
            before = ts
            ts, info = train_iter(ts, k_sample, jnp.asarray(t_env))
            rec["info"] = info
            if witness:
                rec["spread"] = step_spread(train_iter, before, k_sample,
                                            t_env, info, ts.learner.params)
            key = key2
        rec["ts"] = ts
        out.append(rec)
    return out


def params_close(port_tree, jax_tree, adam_bound, what, frac=0.01):
    want = learner_params_from_flax(jax.tree.map(np.asarray, jax_tree),
                                    device="cpu")
    for m in ("agent", "mixer"):
        assert set(port_tree[m]) == set(want[m])
        diff = torch.cat([(v - want[m][k]).abs().flatten()
                          for k, v in port_tree[m].items()])
        off = float((diff > 1e-5).float().mean())
        assert off <= frac, (what, m, off)
        assert float(diff.max()) <= adam_bound, (what, m)


@pytest.fixture(scope="module")
def runs():
    jexp = JaxExperiment.build(jax_from_dict(D))
    jts = jexp.init_train_state(0)
    texp = Experiment.build(from_dict(D), device="cpu")
    params = learner_params_from_flax(
        jax.tree.map(np.asarray, jts.learner.params), "cpu")
    tts = texp.init_state(0, learner_params=params)
    jrecs = jax_loop(jexp, jts, ITERATIONS)
    return texp, tts, jts, jrecs


def test_loop_matches_jax_for_three_iterations(runs, monkeypatch):
    check_loop_against_jax(*runs, monkeypatch)


def check_loop_against_jax(texp, ts, jts, jrecs, monkeypatch):
    """``run_classic`` one iteration at a time from ``ts`` against JAX's
    records ``jrecs`` of ``jax_loop`` from ``jts`` (the module
    docstring's checks). Where a record holds JAX's own ``"spread"``
    (``jax_loop(witness=True)``), the gradient norm's rtol and the share
    of params past 1e-5 are the larger of the module docstring's and
    ``WITNESS_MARGIN`` times that spread."""
    sampled = []
    sample = PrioritizedReplayBuffer.sample

    def recording(self, *a, **kw):
        out = sample(self, *a, **kw)
        sampled.append(out[1])
        return out

    monkeypatch.setattr(PrioritizedReplayBuffer, "sample", recording)
    cursor, jls = None, jts.learner
    for it, rec in enumerate(jrecs):
        ts.learner = learner_state_from_jax(jax.tree.map(np.asarray, jls),
                                            "cpu")
        ts, cursor, (trec,) = run_classic(texp, ts, 1, cursor)
        jls = rec["ts"].learner
        what = f"iteration {it}"
        assert (trec.t_env, trec.episode) == (rec["t_env"], rec["episode"])
        assert ts.episode == int(rec["ts"].episode)
        assert trec.info is not None, what
        np.testing.assert_array_equal(sampled[-1].numpy(),
                                      np.asarray(rec["idx"]), err_msg=what)
        spread = rec.get("spread", {"grad_norm": 0.0, "params": 0.0})
        norm_rtol = max(1e-4, WITNESS_MARGIN * spread["grad_norm"])
        frac = max(0.01, WITNESS_MARGIN * spread["params"])
        for k, v in rec["info"].items():
            tol = (dict(rtol=norm_rtol, atol=1e-6) if k == "grad_norm"
                   else INFO)
            np.testing.assert_allclose(trec.info[k].numpy(), np.asarray(v),
                                       err_msg=f"{what} {k}", **tol)
        jbuf = rec["ts"].buffer
        assert ts.buffer.insert_pos == int(jbuf.insert_pos)
        assert ts.buffer.episodes_in_buffer == int(jbuf.episodes_in_buffer)
        np.testing.assert_allclose(ts.buffer.priorities.numpy(),
                                   np.asarray(jbuf.priorities), rtol=1e-5,
                                   atol=1e-6, err_msg=what)
        np.testing.assert_array_equal(
            ts.buffer.storage.actions.numpy(),
            np.asarray(jbuf.storage.actions), err_msg=what)
        params_close(ts.learner.params, rec["ts"].learner.params,
                     2 * texp.cfg.lr, what, frac)
        assert int(ts.learner.train_steps) == \
            int(rec["ts"].learner.train_steps) == it + 1
        np.testing.assert_array_equal(
            np.asarray(rec["actions"]),
            ts.buffer.storage.actions[(it * 4 + np.arange(4)) % 8].numpy())
    assert cursor.t_env == ts.runner.t_env == ITERATIONS * 4 * 20
    # the driver key advanced once per trained iteration
    impl = texp.cfg.prng_impl
    key = prng.PRNGKey(texp.cfg.seed + 1, "cpu", impl)
    for _ in range(ITERATIONS):
        key = prng.split(key, 2, impl)[0]
    assert torch.equal(cursor.key, key)


def test_gate_holds_until_the_ring_can_fill_a_batch():
    """With batch 6 > 4 lanes the first iteration does not train and the
    driver key does not move; the second does."""
    d = dict(D, batch_size=6)
    texp = Experiment.build(from_dict(d), device="cpu")
    ts = texp.init_state(0)
    ts, cursor, recs = run_classic(texp, ts, 2)
    assert recs[0].info is None and recs[1].info is not None
    assert (recs[0].t_env, recs[1].t_env) == (80, 160)
    assert int(ts.learner.train_steps) == 1
    key = prng.split(prng.PRNGKey(1, "cpu"))[0]
    assert torch.equal(cursor.key, key)
