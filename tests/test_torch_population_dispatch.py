"""The port's population dispatch (``Experiment.population_superstep_
program``, ``train/superstep.py`` ``PopulationProgram``): one fused
program a member, run eagerly here on the CPU (on the card each member
replays its own captured graphs on its own stream:
``tests/test_torch_cuda.py``).

* Against JAX's ``population_superstep_program(2)`` at P = 2 on a cut
  config 7 (4 lanes of 20 steps, 4 AGVs, the four-family mixture with
  ``min_agents`` 4, a ring of 8, emb 8, depth 1, K = 2, ``kernels.
  attention: xla``) with every seam on: an lr grid, an epsilon grid, a
  PER-exponent grid and the scenario salt. The members start from JAX's
  stacked state (``convert.member_states_from_jax``). Every rollout value
  before the first train step is exact, so are the ring slots it fills,
  the counters and the keys; the first train step's info is within
  ``tests/test_torch_loop.py``'s tolerances for each member (``grad_norm``
  at the default stack's 2e-3, as ``tests/test_torch_scenarios.py``).
* A neutral one-member population (no grid, salt or PBT) is the classic
  superstep loop bit for bit: params, Adam, ring, priorities, runner,
  stats, infos (JAX's ``test_p1_population_bit_identical_to_classic_
  superstep_loop``).
* ``seed_stride: 0`` with no grid or salt: the two members are
  bit-identical to each other.
* The driver (``run.run``): a population run stopped by its shutdown
  guard and resumed from its emergency checkpoint ends bit-identical to a
  run that never stopped (every member's tensors, the spec, the logged
  rows; PBT off: its ranking is host state that a resume re-warms, as in
  JAX).
* Seed replication (stride 1): member m against the port's solo run at
  ``seed_m``, three dispatches of K = 2. This is not bit for bit: a
  member's PER exponent is a device scalar (``x ** alpha`` with a tensor
  exponent), the solo program's a Python float (torch's scalar ``pow`` on
  the CPU), and the two differ in the last bit of a few priorities
  (measured: 2.5e-7 relative), which moves the importance weights and so
  the updates. The ring, the runner, the counters, the keys and every
  rollout stat are exact; priorities within rtol 1e-6, params and target
  params within rtol 1e-4 (measured 5.8e-5), Adam's moments within 1e-3
  of each leaf's largest magnitude (measured 1.1e-4, the mixer's). JAX holds its members against
  their solo runs no closer (its batched reduces reassociate).
"""

import dataclasses
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu import population as jpop
from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu.run import TrainState as JaxTrainState
from t2omca_tpu_torch import population as pop
from t2omca_tpu_torch import prng
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.convert import member_states_from_jax, tensor_from_jax
from t2omca_tpu_torch.run import Experiment, run
from t2omca_tpu_torch.train.program import TrainState
from t2omca_tpu_torch.utils import resilience
from t2omca_tpu_torch.utils.checkpoint import (find_checkpoint,
                                               flatten_state, read_meta)
from t2omca_tpu_torch.utils.logging import Logger

from test_torch_driver import rows_of, tiny, wall_clock
from test_torch_superstep import INFO, _fused

#: config 7 (configs/config7_population.yaml) cut to the CPU: P = 2 with
#: a grid of every knob and the salt, 4 lanes of 20 steps, 4 AGVs, a
#: ring of 8, emb 8, depth 1, K = 2
CONFIG7 = {
    "batch_size_run": 4, "batch_size": 4, "superstep": 2,
    "epsilon_anneal_time": 100, "target_update_interval": 8,
    "env_args": {"agv_num": 4, "mec_num": 2, "num_channels": 2,
                 "episode_limit": 20,
                 "scenario": {"kind": "mixture",
                              "families": ["baseline", "hetfleet",
                                           "interference", "surge"],
                              "weights": [0.25, 0.25, 0.25, 0.25],
                              "min_agents": 4}},
    "model": {"emb": 8, "heads": 2, "depth": 1, "mixer_emb": 8,
              "mixer_heads": 2, "mixer_depth": 1},
    "replay": {"buffer_size": 8},
    "kernels": {"attention": "xla"},
    "population": {"size": 2, "lr": [2.5e-4, 1e-3], "eps_scale": [1.0, 0.5],
                   "per_alpha": [0.6, 0.8], "scenario_salt": True},
}


def cfg7(path, **kw):
    """``CONFIG7`` for the driver: batch 8, every cadence each dispatch of
    160 env steps, two dispatches, ``obs.sight`` and PBT on."""
    d = dict(CONFIG7, batch_size=8, t_max=160, test_interval=160,
             test_nepisode=4, log_interval=160, runner_log_interval=160,
             save_model=True, save_model_interval=160,
             local_results_path=str(path), use_tensorboard=False,
             obs={"sight": {"enabled": True}},
             population=dict(CONFIG7["population"],
                             pbt={"enabled": True, "frac": 0.5}))
    d.update(kw)
    return d


def pop_drive(exp, pts, spec, k, n, keys=None):
    """The population driver's fused path: one gate mirror, each member's
    key stream split as the solo one, ``(P, K, 2)`` stacks → (pts', [stats
    a dispatch], [info rows a dispatch], keys)."""
    cfg = exp.cfg
    p = cfg.population.size
    prog = exp.population_superstep_program(k)
    keys = pop.member_keys(cfg, exp.device) if keys is None else keys
    spr = cfg.batch_size_run * cfg.env_args.episode_limit
    t_env, episode, filled = 0, 0, 0
    stats, infos = [], []
    for _ in range(n):
        rows, gated = [], []
        for _ in range(k):
            episode += cfg.batch_size_run
            filled = min(filled + cfg.batch_size_run, cfg.replay.buffer_size)
            g = filled >= cfg.batch_size and \
                episode >= cfg.accumulated_episodes
            gated.append(g)
            row = []
            for m in range(p):
                if g:
                    keys[m], k_s = prng.split(keys[m]).unbind(0)
                    row.append(k_s)
                else:
                    row.append(torch.zeros_like(keys[m]))
            rows.append(torch.stack(row))
        pts, st, inf = prog(pts, torch.stack(rows, 1), t_env, gated, spec)
        t_env += k * spr
        stats.append(st)
        infos.append(inf)
    return pts, stats, infos, keys


def _equal(a, b, what=""):
    fa, ha = flatten_state(a)
    fb, hb = flatten_state(b)
    assert ha == hb and set(fa) == set(fb), what
    differ = [k for k in fa if not (fa[k].dtype == fb[k].dtype
                                    and torch.equal(fa[k], fb[k]))]
    assert differ == [], (what, differ[:5])


# ------------------------------------------------------- against JAX

@pytest.fixture(scope="module")
def jax_dispatch():
    """JAX's population init and one K = 2 dispatch, made once."""
    jcfg = jax_from_dict(CONFIG7)
    jexp = JaxExperiment.build(jcfg)
    # init_population's P solo inits, each jitted (the same structure,
    # faster; the members start the port from whatever values they hold)
    inits = (jax.jit(jexp.learner.init_state), jax.jit(jexp.runner.init_state),
             jax.jit(jexp.buffer.init))
    members = []
    for seed in jpop.member_seeds(jcfg):
        k_learner, k_runner = jax.random.split(jax.random.PRNGKey(seed))
        members.append(JaxTrainState(
            learner=inits[0](k_learner), runner=inits[1](k_runner),
            buffer=inits[2](), episode=jnp.zeros((), jnp.int32)))
    jts = jax.tree.map(lambda *xs: jnp.stack(xs), *members)
    jspec = jpop.build_spec(jcfg)
    keys, rows = jpop.member_keys(jcfg), []
    for _ in range(2):
        row = []
        for m in range(2):
            keys[m], k_s = jax.random.split(keys[m])
            row.append(k_s)
        rows.append(jnp.stack(row))
    key_stack = jnp.stack(rows, axis=1)
    out = jexp.population_superstep_program(2)(
        jts, key_stack, jnp.asarray(0, jnp.int32), jspec)
    return jts, key_stack, keys, out


def test_population_dispatch_matches_jax(jax_dispatch):
    jts, key_stack, jkeys, (jts2, jstats, jinfos) = jax_dispatch
    texp = Experiment.build(from_dict(CONFIG7), device="cpu")
    cfg = texp.cfg
    pairs = member_states_from_jax(jts.learner, jts.runner, "cpu")
    pts = []
    for m, (ls, rs) in enumerate(pairs):
        own = texp.init_state(pop.member_seeds(cfg)[m])
        _equal(rs, own.runner, f"member {m} runner from JAX")
        pts.append(TrainState(learner=ls, buffer=texp.buffer.init(),
                              episode=torch.zeros((), dtype=torch.int32),
                              runner=rs))
    spec = pop.build_spec(cfg)
    keys = [tensor_from_jax(k, "cpu") for k in jpop.member_keys(
        jax_from_dict(CONFIG7))]
    pts, (stats,), (infos,), keys = pop_drive(texp, pts, spec, 2, 1, keys)
    assert torch.equal(torch.stack(keys), tensor_from_jax(jnp.stack(jkeys),
                                                          "cpu"))
    # every rollout value before the first train step, each member
    for f in dataclasses.fields(stats):
        got = getattr(stats, f.name)[:, :1].numpy()
        want = np.asarray(getattr(jstats, f.name))[:, :1]
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    eps = stats.epsilon.numpy()
    assert eps[1, 0] == np.float32(eps[0, 0] * np.float32(0.5))
    fam = stats.scenario.numpy()
    assert not np.array_equal(fam[0], fam[1])          # the salt
    jflat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
             jax.tree_util.tree_leaves_with_path(jts2.buffer.storage)}
    for m, ts in enumerate(pts):
        for k, v in flatten_state(ts.buffer.storage)[0].items():
            got = (v[:4].float() if v.dtype == torch.bfloat16
                   else v[:4]).numpy()
            np.testing.assert_array_equal(
                got, jflat["." + k][m, :4].astype(got.dtype),
                err_msg=f"member {m} {k}")
        assert int(ts.buffer.insert_pos) == \
            int(np.asarray(jts2.buffer.insert_pos)[m])
        assert int(ts.buffer.episodes_in_buffer) == 8
        assert int(ts.episode) == int(np.asarray(jts2.episode)[m]) == 8
        assert int(ts.learner.train_steps) == 2
        assert ts.runner.t_env == int(np.asarray(jts2.runner.t_env)[m])
    for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
              "grad_norm"):
        tol = dict(rtol=2e-3, atol=1e-6) if k == "grad_norm" else INFO
        np.testing.assert_allclose(infos[k][:, 0].numpy(),
                                   np.asarray(jinfos[k])[:, 0], err_msg=k,
                                   **tol)
        assert np.isfinite(infos[k].numpy()).all()
    assert bool(infos["all_finite"].all())


# ------------------------------------------------- the port against itself

def test_p1_population_bit_identical_to_classic_superstep_loop(tmp_path):
    """A neutral one-member population (it builds its member without the
    spec seams) against the solo fused loop: two dispatches of K = 3 from
    one seed, the gate opening inside the first."""
    d = tiny(tmp_path, accumulated_episodes=4)
    solo = Experiment.build(from_dict(d), device="cpu")
    ts, stats, kept, _, gates, key = _fused(solo, solo.init_state(0), 3, 2)
    pexp = Experiment.build(from_dict(dict(d, population=1)), device="cpu")
    assert pop.spec_is_neutral(pexp.cfg)
    pts, spec = pop.init_population(pexp, pexp.cfg)
    pts, pstats, pinfos, keys = pop_drive(pexp, pts, spec, 3, 2)
    assert pexp.population_superstep_program(3).members[0].member is None
    _equal(pts[0], ts, "member 0 against the solo loop")
    assert torch.equal(keys[0], key)
    for st, ps in zip(stats, pstats):
        for f in dataclasses.fields(st):
            assert torch.equal(getattr(ps, f.name)[0], getattr(st, f.name))
    rows = [{n: v[0, i] for n, v in inf.items()}
            for inf in pinfos for i in range(3)]
    rows = [r for r, g in zip(rows, gates) if g]
    assert len(rows) == len(kept) == 5
    for a, b in zip(rows, kept):
        assert set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in a)


def test_p2_stride0_members_bit_identical(tmp_path):
    d = tiny(tmp_path, population={"size": 2, "seed_stride": 0})
    exp = Experiment.build(from_dict(d), device="cpu")
    pts, spec = pop.init_population(exp, exp.cfg)
    pts, stats, infos, _ = pop_drive(exp, pts, spec, 2, 3)
    _equal(pts[0], pts[1], "members")
    for st, inf in zip(stats, infos):
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            assert torch.equal(v[0], v[1]), f.name
        assert all(torch.equal(v[0], v[1]) for v in inf.values())
    assert int(pts[0].learner.train_steps) == 5


def test_p2_members_track_their_solo_runs(tmp_path):
    """Seed replication at P = 2: each member against the solo fused loop
    at its seed, three dispatches of K = 2 (the module docstring says how
    close and why)."""
    d = tiny(tmp_path, population={"size": 2})
    exp = Experiment.build(from_dict(d), device="cpu")
    pts, spec = pop.init_population(exp, exp.cfg)
    pts, pstats, _, keys = pop_drive(exp, pts, spec, 2, 3)
    discrete = ("actions", "avail_actions", "filled", "terminated",
                "mec_index")
    for m, seed in enumerate(pop.member_seeds(exp.cfg)):
        sd = dict(d, seed=seed)
        sd.pop("population")
        sexp = Experiment.build(from_dict(sd), device="cpu")
        ts, stats, _, _, _, key = _fused(sexp, sexp.init_state(seed), 2, 3)
        assert torch.equal(keys[m], key)
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
        assert any(k.endswith(discrete) for k in fa)
        for st, ps in zip(stats, pstats):
            for f in dataclasses.fields(st):
                assert torch.equal(getattr(ps, f.name)[m],
                                   getattr(st, f.name)), (m, f.name)


def test_population_resume_is_bit_exact(tmp_path):
    """Three dispatches straight against two, the guard's emergency
    checkpoint at t_env 320 (its topology stamps the population and its
    driver keys both members') and a fresh ``run`` from it for the third:
    the final members, spec and rows are bit-identical."""
    kw = dict(population=dict(CONFIG7["population"]),
              save_model_interval=10_000, t_max=320)
    straight = run(from_dict(cfg7(tmp_path / "straight", **kw)), Logger(),
                   device="cpu")

    def stop(t_env, guard, **_):
        if t_env >= 320:
            guard.request("test")

    resilience.register_fault("driver.iteration", stop)
    try:
        run(from_dict(cfg7(tmp_path / "first", **kw)), Logger(),
            device="cpu")
    finally:
        resilience.clear_faults()
    model_dir = glob.glob(str(tmp_path / "first" / "models" / "*"))[0]
    dirname, step = find_checkpoint(model_dir)
    assert step == 320
    meta = read_meta(dirname)
    assert meta["topology"]["population"] == 2
    assert len(meta["driver"]["keys"]) == 2
    resumed = run(from_dict(cfg7(tmp_path / "second", checkpoint_path=
                                 model_dir, **kw)), Logger(), device="cpu")
    a, ha = flatten_state(straight)
    b, hb = flatten_state(resumed)
    assert ha == hb and set(a) == set(b)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert all(t.runner.t_env == 480 for t in resumed.ts)
    keep = lambda rows: {k: v for k, v in rows.items()  # noqa: E731
                         if not wall_clock(k[0])}
    rs = rows_of(tmp_path / "straight")
    rr = {**rows_of(tmp_path / "first"), **rows_of(tmp_path / "second")}
    assert keep(rr) == keep(rs)
