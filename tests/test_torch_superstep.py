"""The port's fused training superstep (``t2omca_tpu_torch.run.
Experiment.superstep_program``, ``train/superstep.py``) and its ring
insert (``ReplayBuffer.insert_time_major``): the counterpart of
``tests/test_superstep.py``, on the CPU, where the program runs its stage
functions eagerly (on the card it replays captured CUDA graphs:
``tests/test_torch_cuda.py``).

The config is ``tests/test_driver.py``'s ``tiny_cfg`` (3 AGVs, 2 MECs,
emb 8, depth 1, a ring of 8, 2 lanes of 6 steps; the default stack:
entity tables, compact storage, PER), plus a dense variant (the kill
switch ``use_entity_tables: false``, ``fast_norm: false``) with
``obs.sight`` on. What is held, and how tightly:

* ``insert_time_major`` against ``insert_episode_batch(tm.to_batch())``
  bit for bit, and against JAX's ``insert_time_major`` exactly (storage,
  cursor, fill, priorities), dense (f32 and bf16 storage) and compact,
  across a ring wrap;
* ``superstep_program(3)`` against ``run.run_classic`` from one state,
  bit for bit: learner, ring, priorities, runner state, counters, the
  driver key consumed, the stacked stats and the kept info rows; a gate
  that skips sub-iterations gives zero info rows with ``all_finite``
  True;
* against JAX's ``superstep_program(3)`` from the same seed, the
  learner's params carried from flax (``convert.py``): every value of
  the rollouts before the first train step exactly, the first train
  step's info at ``tests/test_torch_loop.py``'s tolerances (rtol 1e-5,
  atol 1e-6; ``grad_norm`` rtol 1e-4), the counters exactly;
* the driver (``run.run``): one ``dispatch.superstep`` span per K
  iterations, the zero rows of skipped sub-iterations dropped; the non-finite
  guard inside the fused dispatch; a fused dispatch that keeps failing
  takes the ladder's K→1 rung (JAX's ``test_chaos``
  ``persistent_fused_degrades``) and one that fails after it began
  writing its state takes the restore rung; a checkpoint of the earlier
  layout (ring counters as host values) loads.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.components.episode_buffer import \
    CompactEntityObs as JaxCompact
from t2omca_tpu.components.episode_buffer import \
    PrioritizedReplayBuffer as JaxPER
from t2omca_tpu.components.episode_buffer import \
    TimeMajorEpisodes as JaxTM
from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu_torch import prng
from t2omca_tpu_torch.components.episode_buffer import (
    CompactEntityObs, PrioritizedReplayBuffer, TimeMajorEpisodes)
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.convert import learner_params_from_flax, tensor_from_jax
from t2omca_tpu_torch.run import Experiment, run, run_classic
from t2omca_tpu_torch.train import superstep as superstep_mod
from t2omca_tpu_torch.train.superstep import clone_state
from t2omca_tpu_torch.utils import resilience
from t2omca_tpu_torch.utils.checkpoint import (find_checkpoint,
                                               flatten_state,
                                               load_checkpoint, read_meta,
                                               save_checkpoint)
from t2omca_tpu_torch.utils.logging import Logger

from test_torch_driver import rows_of, tiny
from test_torch_threads import one_intra_op_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(
    one_intra_op_thread)

INFO = dict(rtol=1e-5, atol=1e-6)          # tests/test_torch_loop.py
GRAD_NORM = dict(rtol=1e-4, atol=1e-6)
#: tests/test_torch_loop.py's config
LOOP = {"batch_size_run": 4, "batch_size": 4, "epsilon_anneal_time": 100,
        "target_update_interval": 8, "t_max": 1000,
        "env_args": {"agv_num": 4, "mec_num": 2, "num_channels": 2,
                     "episode_limit": 20, "fast_norm": False},
        "model": {"emb": 64, "heads": 3, "depth": 2, "mixer_emb": 64,
                  "mixer_heads": 3, "mixer_depth": 2},
        "replay": {"buffer_size": 8}}
DENSE = {"env_args": dict(agv_num=3, mec_num=2, num_channels=2,
                          episode_limit=6, fast_norm=False),
         "model": dict(emb=8, heads=2, depth=1, mixer_emb=8, mixer_heads=2,
                       mixer_depth=1, use_entity_tables=False),
         "obs": {"sight": {"enabled": True}}}


@pytest.fixture(autouse=True)
def _no_fault_leaks():
    resilience.clear_faults()
    yield
    resilience.clear_faults()


# ------------------------------------------------------ insert_time_major

def _tm_numpy(rng, b, t, a, n_actions, obs_dim, state_dim, compact):
    """One rollout's time-major emission as numpy arrays."""
    def obs(*lead):
        if not compact:
            return rng.standard_normal(lead + (a, obs_dim)).astype(
                np.float32)
        f = obs_dim // a
        return {"rows": rng.standard_normal(lead + (a, f - 1)).astype(
                    np.float32),
                "mec_index": rng.integers(0, 2, lead + (a,)).astype(
                    np.int8),
                "mean": rng.standard_normal(lead + (a, f)).astype(
                    np.float32),
                "std": rng.uniform(0.5, 2.0, lead + (a, f)).astype(
                    np.float32)}
    return {"obs": obs(t, b),
            "state": rng.standard_normal((t, b, state_dim)).astype(
                np.float32),
            "avail_actions": rng.random((t, b, a, n_actions)) > 0.3,
            "actions": rng.integers(0, n_actions, (t, b, a)).astype(
                np.int32),
            "reward": rng.standard_normal((t, b)).astype(np.float32),
            "terminated": rng.random((t, b)) > 0.8,
            "last_obs": obs(b),
            "last_state": rng.standard_normal((b, state_dim)).astype(
                np.float32),
            "last_avail": rng.random((b, a, n_actions)) > 0.3}


def _as(tree, conv, compact_cls, cls):
    kw = {k: (compact_cls(**{n: conv(x) for n, x in v.items()})
              if isinstance(v, dict) else conv(v)) for k, v in tree.items()}
    return cls(**kw)


@pytest.mark.parametrize("store_dtype,compact", [
    ("float32", False), ("bfloat16", False), ("bfloat16", True)],
    ids=["dense-f32", "dense-bf16", "compact"])
def test_insert_time_major_matches_batch_insert_and_jax(store_dtype,
                                                        compact):
    """Three inserts of 3 episodes into a ring of 8 (the third wraps):
    the time-major insert equals the batch insert of ``to_batch()`` bit
    for bit, and JAX's ``insert_time_major`` exactly, counters included."""
    a, t, cap = 4, 5, 8
    kw = dict(capacity=cap, episode_limit=t, n_agents=a, n_actions=3,
              obs_dim=4 * 9, state_dim=7, store_dtype=store_dtype,
              compact_obs=compact, alpha=0.6, beta0=0.4, t_max=100)
    jbuf, tbuf = JaxPER(**kw), PrioritizedReplayBuffer(device="cpu", **kw)
    js, tm_state, tb_state = jbuf.init(), tbuf.init(), tbuf.init()
    jinsert = jax.jit(jbuf.insert_time_major)
    rng = np.random.default_rng(3)
    for _ in range(3):
        ep = _tm_numpy(rng, 3, t, a, 3, 4 * 9, 7, compact)
        ttm = _as(ep, lambda x: torch.from_numpy(np.array(x)),
                  CompactEntityObs, TimeMajorEpisodes)
        js = jinsert(js, _as(ep, jnp.asarray, JaxCompact, JaxTM))
        tm_state = tbuf.insert_time_major(tm_state, ttm)
        tb_state = tbuf.insert_episode_batch(tb_state, ttm.to_batch())
        fa, _ = flatten_state(tm_state)
        fb, _ = flatten_state(tb_state)
        assert set(fa) == set(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
    assert isinstance(tm_state.insert_pos, torch.Tensor)
    assert tm_state.insert_pos.dtype == torch.int32
    assert int(tm_state.insert_pos) == int(js.insert_pos) == 1
    assert int(tm_state.episodes_in_buffer) == \
        int(js.episodes_in_buffer) == cap
    np.testing.assert_array_equal(tm_state.priorities.numpy(),
                                  np.asarray(js.priorities))
    jflat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
             jax.tree_util.tree_leaves_with_path(js.storage)}
    for k, v in flatten_state(tm_state.storage)[0].items():
        want = jflat["." + k]
        got = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=k)


# ----------------------------------------------- superstep vs run_classic

def _fused(exp, ts, k, n_dispatches, key=None):
    """The driver's K > 1 path: the host mirror of the gate drives the
    key splits, zeros for skipped rows → (ts', [stats], kept infos, all
    info rows, gates, key)."""
    cfg = exp.cfg
    sup = exp.superstep_program(k)
    key = (prng.PRNGKey(cfg.seed + 1, exp.device, cfg.prng_impl)
           if key is None else key)
    spr = cfg.batch_size_run * cfg.env_args.episode_limit
    t_env, episode, filled = 0, 0, 0
    stats, kept, rows_all, gates = [], [], [], []
    for _ in range(n_dispatches):
        rows, gated = [], []
        for _ in range(k):
            episode += cfg.batch_size_run
            filled = min(filled + cfg.batch_size_run, cfg.replay.buffer_size)
            g = (filled >= cfg.batch_size
                 and episode >= cfg.accumulated_episodes)
            gated.append(g)
            if g:
                key, k_sample = prng.split(key, 2,
                                           cfg.prng_impl).unbind(0)
                rows.append(k_sample)
            else:
                rows.append(torch.zeros_like(key))
        ts, st, infos = sup(ts, torch.stack(rows), t_env, gated)
        t_env += k * spr
        stats.append(st)
        for i, g in enumerate(gated):
            row = {name: v[i] for name, v in infos.items()}
            rows_all.append(row)
            if g:
                kept.append(row)
        gates.extend(gated)
    return ts, stats, kept, rows_all, gates, key


def _states_equal(a, b):
    fa, ha = flatten_state(a)
    fb, hb = flatten_state(b)
    assert ha == hb
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("stack", ["default", "dense-sight"])
def test_superstep_is_bit_identical_to_run_classic(tmp_path, stack):
    """Two dispatches of K = 3 against 6 ``run_classic`` iterations from
    one state; the gate opens inside the first dispatch
    (``accumulated_episodes`` 4: iterations 2..6 train)."""
    d = tiny(tmp_path, accumulated_episodes=4, **(DENSE if stack != "default"
                                                  else {}))
    exp = Experiment.build(from_dict(d), device="cpu")
    ts0 = exp.init_state(0)
    ts_c, cursor, recs = run_classic(exp, clone_state(ts0), 6)
    ts_f, stats, kept, _, gates, key = _fused(exp, clone_state(ts0), 3, 2)
    assert gates == [r.info is not None for r in recs] == [False] + [True] * 5
    _states_equal(ts_c, ts_f)
    assert int(ts_f.episode) == 12 and int(ts_f.learner.train_steps) == 5
    assert torch.equal(cursor.key, key)
    for i, rec in enumerate(recs):
        st = stats[i // 3]
        for f in dataclasses.fields(st):
            assert torch.equal(getattr(rec.stats, f.name).reshape(-1),
                               getattr(st, f.name)[i % 3].reshape(-1)), \
                (i, f.name)
    infos = [r.info for r in recs if r.info is not None]
    assert len(infos) == len(kept) == 5
    for a, b in zip(infos, kept):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_skipped_sub_iterations_give_zero_info_rows(tmp_path):
    """batch_size 6 > batch_size_run 2 and ``accumulated_episodes`` 10:
    the first dispatch of K = 3 trains nowhere and the second from its
    second sub-iteration. Skipped rows are zeros with ``all_finite``
    True, and the kept rows are exactly the trained steps."""
    d = tiny(tmp_path, batch_size=6, accumulated_episodes=10)
    exp = Experiment.build(from_dict(d), device="cpu")
    ts, _, kept, rows, gates, _ = _fused(exp, exp.init_state(0), 3, 2)
    assert gates == [False] * 4 + [True] * 2
    assert int(ts.learner.train_steps) == 2 and len(kept) == 2
    zeros = exp.learner.train_info_zeros(6)
    for row, g in zip(rows, gates):
        assert bool(row["all_finite"])
        if not g:
            assert set(row) == set(zeros)
            assert all(torch.equal(row[k], zeros[k]) for k in zeros)
    assert all(float(r["loss"]) != 0.0 for r in kept)


# ------------------------------------------------------- against JAX

def test_superstep_matches_jax_superstep_program():
    """One dispatch of K = 2 from the same seed at
    ``tests/test_torch_loop.py``'s config and operating point (4 lanes of
    20 steps, batch 4, a ring of 8, emb 64, depth 2; the first
    sub-iteration trains on the first 4 episodes), with its tolerances:
    the first rollout and the ring slots it fills (0..3) equal JAX's
    exactly, the first train step's info is within rtol 1e-5
    (``grad_norm`` 1e-4); the counters and key rows are equal; the second
    sub-iteration, whose policies drift apart as in the loop test, is
    finite. (The learner's float32 lowering is the loop test's: on the
    tiny config the first step's ``grad_norm`` is 7e-4 from JAX's, and
    here on a full ring of 8 it is 1.1e-4, for ``run_classic`` alike.)"""
    jexp = JaxExperiment.build(jax_from_dict(LOOP))
    jts = jexp.init_train_state(0)
    texp = Experiment.build(from_dict(LOOP), device="cpu")
    tts = texp.init_state(0, learner_params=learner_params_from_flax(
        jax.tree.map(np.asarray, jts.learner.params), "cpu"))
    cfg = texp.cfg
    jkey, rows = jax.random.PRNGKey(cfg.seed + 1), []
    for _ in range(2):
        jkey, k_sample = jax.random.split(jkey)
        rows.append(k_sample)
    jts2, jstats, jinfos = jexp.superstep_program(2)(
        jts, jnp.stack(rows), jnp.asarray(0, jnp.int32))
    ts, (stats,), _, all_rows, gates, key = _fused(texp, tts, 2, 1)
    assert gates == [True, True]
    assert torch.equal(key, tensor_from_jax(jkey, "cpu"))
    for f in dataclasses.fields(stats):
        got, want = getattr(stats, f.name), np.asarray(
            getattr(jstats, f.name))
        np.testing.assert_array_equal(got[:1].numpy(), want[:1],
                                      err_msg=f.name)
        assert np.isfinite(got.numpy().astype(np.float64)).all()
    jbuf = jts2.buffer
    assert int(ts.buffer.insert_pos) == int(jbuf.insert_pos) == 0
    assert int(ts.buffer.episodes_in_buffer) == \
        int(jbuf.episodes_in_buffer) == 8
    assert int(ts.episode) == int(jts2.episode) == 8
    assert int(ts.learner.train_steps) == int(jts2.learner.train_steps) == 2
    jflat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
             jax.tree_util.tree_leaves_with_path(jbuf.storage)}
    for k, v in flatten_state(ts.buffer.storage)[0].items():
        got = (v[:4].float() if v.dtype == torch.bfloat16 else v[:4]).numpy()
        np.testing.assert_array_equal(
            got, jflat["." + k][:4].astype(got.dtype), err_msg=k)
    for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
              "grad_norm"):
        tol = GRAD_NORM if k == "grad_norm" else INFO
        np.testing.assert_allclose(all_rows[0][k].numpy(),
                                   np.asarray(jinfos[k])[0], err_msg=k,
                                   **tol)
        assert np.isfinite(float(all_rows[1][k]))
    assert all(bool(r["all_finite"]) for r in all_rows)


# ----------------------------------------------------------- the driver

def _metric_keys(root):
    out = []
    for p in glob.glob(os.path.join(str(root), "*", "metrics.jsonl")):
        with open(p) as f:
            out.extend(json.loads(line) for line in f)
    return out


def test_run_sequential_issues_one_dispatch_per_k(tmp_path, monkeypatch):
    """The driver at superstep 3: one ``dispatch.superstep`` span and one
    program call per 3 iterations (spr 12, t_max 70: dispatches at t_env
    0 and 36), none of the classic loop's. With batch 8 the gate opens at
    the fourth iteration, so the first dispatch trains nowhere: its zero
    info rows are dropped and the log cadence at t_env 36 writes no
    learner row."""
    calls = []
    orig = superstep_mod.SuperstepProgram.__call__

    def counting(self, *a, **kw):
        calls.append(self.k)
        return orig(self, *a, **kw)

    monkeypatch.setattr(superstep_mod.SuperstepProgram, "__call__", counting)
    ts = run(from_dict(tiny(tmp_path, superstep=3, batch_size=8, t_max=70,
                            log_interval=36, runner_log_interval=36,
                            save_model=False, obs={"enabled": True})),
             Logger(), device="cpu")
    assert calls == [3, 3]
    assert ts.runner.t_env == 72 and int(ts.learner.train_steps) == 3
    with open(glob.glob(str(tmp_path / "*" / "spans.jsonl"))[0]) as f:
        spans = [e for e in map(json.loads, f) if e["event"] == "span"]
    fused = [e for e in spans if e["phase"] == "dispatch.superstep"]
    assert [e["k"] for e in fused] == [3, 3]
    assert not any(e["phase"] in ("dispatch.rollout", "dispatch.train")
                   for e in spans)
    rows = rows_of(tmp_path)
    learner = {t for (k, t) in rows if k in ("loss", "grad_norm")}
    assert learner == {72}
    assert ("return_mean", 36) in rows


def test_nonfinite_guard_holds_inside_the_superstep(tmp_path):
    """``resilience.inject_nan_at_step`` inside a fused dispatch: the
    tripped step changes no param, and the driver sees its flag through
    the stacked infos at the log cadence."""
    d = tiny(tmp_path, t_max=60, superstep=2, save_model=False,
             log_interval=12, resilience={"inject_nan_at_step": 1})
    ts = run(from_dict(d), Logger(), device="cpu")
    assert all(torch.isfinite(v).all() for sub in ts.learner.params.values()
               for v in sub.values())
    keys = {r["key"] for r in _metric_keys(tmp_path)}
    assert "nonfinite_steps" in keys


def test_persistent_fused_failure_takes_the_k_to_1_rung(tmp_path):
    """Every fused dispatch fails at its hook (a transient error): the
    ladder degrades K→1 (``superstep_k`` 1 logged), drops the program,
    and the classic loop trains on to ``t_max``."""
    def _always(t_env, **kw):
        raise RuntimeError("chaos: fused dispatch socket closed")

    resilience.register_fault("dispatch.superstep", _always)
    d = tiny(tmp_path, t_max=60, superstep=2, save_model=True,
             save_model_interval=12, test_interval=1_000_000,
             resilience={"dispatch_retries": 1, "retry_backoff_s": 0.01})
    ts = run(from_dict(d), Logger(), device="cpu")
    assert ts.runner.t_env > 60 and int(ts.learner.train_steps) > 0
    rows = _metric_keys(tmp_path)
    assert [r["value"] for r in rows if r["key"] == "superstep_k"] == [1]
    assert any(r["key"] == "dispatch_failures" for r in rows)
    meta = read_meta(find_checkpoint(
        glob.glob(str(tmp_path / "models" / "*"))[0])[0])
    assert meta["topology"]["fused"] is False


def test_failure_after_the_state_was_written_restores(tmp_path, monkeypatch):
    """A transient failure inside a fused dispatch, after it began to
    write its state in place: no retry and no K→1 rung (the state is
    partly written); the ladder restores the last checkpoint into the
    program's buffers and training goes on fused."""
    orig = superstep_mod.SuperstepProgram._run
    fired = []

    def failing(self, name, fn):
        if name == "train" and self.state.runner.t_env >= 36 and not fired:
            fired.append(self.state.runner.t_env)
            raise RuntimeError("chaos: connection reset by peer")
        return orig(self, name, fn)

    monkeypatch.setattr(superstep_mod.SuperstepProgram, "_run", failing)
    d = tiny(tmp_path, t_max=72, superstep=2, save_model=True,
             save_model_interval=12, test_interval=1_000_000,
             resilience={"dispatch_retries": 2, "retry_backoff_s": 0.01})
    ts = run(from_dict(d), Logger(), device="cpu")
    assert fired and ts.runner.t_env > 72
    rows = _metric_keys(tmp_path)
    assert not any(r["key"] == "superstep_k" for r in rows)
    assert any(r["key"] == "dispatch_failures" for r in rows)
    meta = read_meta(find_checkpoint(
        glob.glob(str(tmp_path / "models" / "*"))[0])[0])
    assert meta["topology"]["fused"] is True


def test_checkpoint_of_the_earlier_layout_loads(tmp_path):
    """A checkpoint whose ring cursor, fill and episode counter are host
    values (the layout before they moved to the device) loads into the
    tensors; every other leaf as saved."""
    exp = Experiment.build(from_dict(tiny(tmp_path)), device="cpu")
    ts, _, _ = run_classic(exp, exp.init_state(0), 5)
    old = dataclasses.replace(
        ts, episode=int(ts.episode), buffer=dataclasses.replace(
            ts.buffer, insert_pos=int(ts.buffer.insert_pos),
            episodes_in_buffer=int(ts.buffer.episodes_in_buffer)))
    d = save_checkpoint(str(tmp_path / "c"), 60, old)
    host = read_meta(d)["host"]
    assert (host["buffer.insert_pos"], host["buffer.episodes_in_buffer"],
            host["episode"]) == (2, 8, 10)
    flat = torch.load(os.path.join(d, "state.pt"), weights_only=True)
    assert "buffer.insert_pos" not in flat and "episode" not in flat
    restored = load_checkpoint(d, exp.init_state(1))
    for t in (restored.episode, restored.buffer.insert_pos,
              restored.buffer.episodes_in_buffer):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
    _states_equal(restored, ts)
