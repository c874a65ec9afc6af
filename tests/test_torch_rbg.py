"""Port parity of the training path under ``prng_impl: rbg`` and
``unsafe_rbg`` (4-word keys, XLA's CPU Philox stream: ``prng``) against
the JAX package on the CPU with the same keys.

Every draw site follows JAX's batching rule for ``rng_bit_generator``:
under ``jax.vmap`` the whole batch is drawn from the first key (the env
lanes, the scenario sampler), while the rollout's steps are a
``lax.scan`` (their keys draw on their own: the port's ``scan``
dimensions). What is held, and how tightly:

* 3 ``run_classic`` iterations against JAX's ``jitted_programs`` driven
  as ``run_sequential`` drives them, with ``tests/test_torch_loop.py``'s
  checks and tolerances (rollouts, sampled indices and counters exact),
  the pre-clip gradient norm and the share of params past 1e-5 held at
  the larger of the loop test's bound and twice JAX's own spread: JAX's
  step taken again from its params scaled by 1 ± 1e-7
  (``jax_loop(witness=True)``). Under ``rbg`` the first step's gradient
  is not a stable function of the params on the trajectories these keys
  draw: JAX's own norm (503 763) moves up to 31% and 41% of its params
  end more than 1e-5 apart; the later steps and every ``unsafe_rbg``
  step move less than 1.2e-3 and 0.6%;
* one fused K = 4 dispatch against 4 ``run_classic`` iterations bit for
  bit, and under ``rbg`` against JAX's ``superstep_program(4)``: the
  counters, the runner and driver keys equal, the first rollout's discrete
  stats exact and its float stats within a hundredth (JAX's fused
  rollout program and its own jitted env step disagree by that much on
  one reward of these trajectories), the first train step's loss and TD
  values within the loop test's tolerances;
* dropout: flax's ``make_rng`` keys through ``flax_rng.Scope``, the mask's
  plain draw against JAX's ``bernoulli`` of the same ``fold_in`` bit for
  bit (with a rank's rows: those rows of the whole mask), two keyed train
  steps of the dropout learner against JAX's at
  ``tests/test_torch_learner.py``'s tolerances, and the learner at 2 gloo
  ranks against the step the 2 ranks should take computed in one process
  (``tests/test_torch_dp_options.py``'s blocked step), bit for bit;
* a data-parallel run at 2 ranks against world 1: a rank draws its lanes'
  rows of each draw from the first global lane's key, so the ring and
  the runner equal world 1's bit for bit;
* a threefry checkpoint restored under ``rbg`` raises and names the
  key widths.

JAX's ``Experiment.build`` pins ``jax_default_prng_impl`` for the
process; each JAX build here restores ``threefry2x32`` and clears JAX's
caches afterwards (jit's cache does not key on the impl)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_learner as tl_test
import torch_dp_ranks as ranks
from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu_torch import prng
from t2omca_tpu_torch.components.episode_buffer import EpisodeBatch
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
from t2omca_tpu_torch.convert import learner_params_from_flax, tensor_from_jax
from t2omca_tpu_torch.envs.registry import make_env
from t2omca_tpu_torch.flax_rng import Scope
from t2omca_tpu_torch.kernels import dropout as dk
from t2omca_tpu_torch.learners import qmix_learner as ql
from t2omca_tpu_torch.run import Experiment, run_classic
from t2omca_tpu_torch.train.superstep import clone_state
from t2omca_tpu_torch.utils import checkpoint as ckpt
from t2omca_tpu_torch.utils.checkpoint import flatten_state

from test_torch_dp import D as DP, plain
from test_torch_dp_options import WORLD, _blocked_step
from test_torch_dropout import Probe
from test_torch_driver import tiny
from test_torch_loop import D as LOOP, ITERATIONS, check_loop_against_jax
from test_torch_loop import jax_loop
from test_torch_superstep import _fused, _states_equal
from test_torch_threads import one_intra_op_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(
    one_intra_op_thread)

IMPLS = ("rbg", "unsafe_rbg")
INFO = dict(rtol=1e-5, atol=1e-6)          # tests/test_torch_loop.py


@contextlib.contextmanager
def jax_impl(impl):
    """JAX under ``impl`` inside, ``threefry2x32`` again after; the jit
    caches cleared at both ends."""
    jax.clear_caches()
    jax.config.update("jax_default_prng_impl", impl)
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", "threefry2x32")
        jax.clear_caches()


def test_threefry_is_restored_after_the_rbg_tests():
    assert jax.config.jax_default_prng_impl == "threefry2x32"


# ---------------------------------------------------------------- the loop

@pytest.mark.parametrize("impl", IMPLS)
def test_three_iterations_match_jax(impl, monkeypatch):
    d = dict(LOOP, prng_impl=impl)
    with jax_impl(impl):
        jexp = JaxExperiment.build(jax_from_dict(d))
        jts = jexp.init_train_state(0)
        jrecs = jax_loop(jexp, jts, ITERATIONS, witness=True)
        jrecs = jax.tree.map(np.asarray, jrecs)
        jts = jax.tree.map(np.asarray, jts)
    texp = Experiment.build(from_dict(d), device="cpu")
    assert texp.runner.env.prng_impl == impl
    params = learner_params_from_flax(jts.learner.params, "cpu")
    ts = texp.init_state(0, learner_params=params)
    assert ts.runner.key.shape == (4,)
    np.testing.assert_array_equal(ts.runner.key.numpy(), jts.runner.key)
    check_loop_against_jax(texp, ts, jts, jrecs, monkeypatch)


@pytest.mark.parametrize("impl", IMPLS)
def test_fused_dispatch_is_bit_identical_to_run_classic(tmp_path, impl):
    """One K = 4 dispatch against 4 ``run_classic`` iterations from one
    state (the gate opens in the second: iterations 2..4 train)."""
    exp = Experiment.build(from_dict(tiny(tmp_path, prng_impl=impl)),
                           device="cpu")
    ts0 = exp.init_state(0)
    ts_c, cursor, recs = run_classic(exp, clone_state(ts0), 4)
    ts_f, _, kept, _, gates, key = _fused(exp, clone_state(ts0), 4, 1)
    assert gates == [r.info is not None for r in recs] == [False] + [True] * 3
    _states_equal(ts_c, ts_f)
    assert torch.equal(cursor.key, key) and key.shape == (4,)
    for a, b in zip([r.info for r in recs if r.info is not None], kept):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_fused_dispatch_matches_jax_superstep_program():
    """A K = 4 dispatch under ``rbg`` from the same seed at the loop
    test's config against JAX's ``superstep_program(4)`` (the module
    docstring); the later train steps finite (the policies drift apart
    as in the loop test)."""
    d = dict(LOOP, prng_impl="rbg")
    with jax_impl("rbg"):
        jexp = JaxExperiment.build(jax_from_dict(d))
        jts = jexp.init_train_state(0)
        jkey, rows = jax.random.PRNGKey(1), []
        for _ in range(4):
            jkey, k_sample = jax.random.split(jkey)
            rows.append(k_sample)
        jts2, jstats, jinfos = jexp.superstep_program(4)(
            jts, jnp.stack(rows), jnp.asarray(0, jnp.int32))
        jts, jts2, jstats, jinfos, jkey = jax.tree.map(
            np.asarray, (jts, jts2, jstats, jinfos, jkey))
    texp = Experiment.build(from_dict(d), device="cpu")
    tts = texp.init_state(0, learner_params=learner_params_from_flax(
        jts.learner.params, "cpu"))
    ts, (stats,), _, all_rows, gates, key = _fused(texp, tts, 4, 1)
    assert gates == [True] * 4
    assert torch.equal(key, tensor_from_jax(jkey, "cpu"))
    for f in dataclasses.fields(stats):
        got, want = getattr(stats, f.name)[:1].numpy(), \
            getattr(jstats, f.name)[:1]
        if got.dtype.kind == "f":
            # a hundredth, the env's reward resolution: XLA compiles the
            # reward inside JAX's fused rollout otherwise than its own
            # jitted step does (on the port's state before step 8 of lane
            # 2, JAX's jitted ``_reward`` gives the port's 93.2, its fused
            # rollout 93.189995)
            np.testing.assert_allclose(got, want, rtol=0, atol=0.011,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
    jbuf = jts2.buffer
    assert int(ts.buffer.episodes_in_buffer) == \
        int(jbuf.episodes_in_buffer) == 8
    assert int(ts.episode) == int(jts2.episode) == 16
    assert int(ts.learner.train_steps) == int(jts2.learner.train_steps) == 4
    np.testing.assert_array_equal(ts.runner.key.numpy(), jts2.runner.key)
    # not grad_norm: the loop test's finding (the module docstring)
    for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean"):
        np.testing.assert_allclose(all_rows[0][k].numpy(), jinfos[k][0],
                                   err_msg=k, **INFO)
    for k in ("loss", "grad_norm"):
        assert all(np.isfinite(float(r[k])) for r in all_rows)


# ------------------------------------------------------------- dropout

@pytest.mark.parametrize("impl", IMPLS)
def test_make_rng_keys_and_masks_match_jax(impl):
    path = ("transformer", "block_1", "Dropout_0")
    with jax_impl(impl):
        key = jax.random.PRNGKey(5)
        want = Probe(path, "dropout", calls=2).apply(
            {}, rngs={"dropout": key})
        fold = Scope(tensor_from_jax(key, "cpu"), path).fold_data()
        mask = jax.jit(lambda k: jax.random.bernoulli(
            jax.random.fold_in(k, jnp.uint32(fold)), 0.9, (6, 5, 7)))(key)
        want, mask = jax.tree.map(np.asarray, (want, mask))
    scope = Scope(tensor_from_jax(key, "cpu"), path, impl=impl)
    for count, w in enumerate(want, start=1):
        np.testing.assert_array_equal(scope.make_rng(count).numpy(), w)
    got = dk.keep_mask(scope.key, fold, 0.9, (6, 5, 7), impl=impl)
    np.testing.assert_array_equal(got.numpy(), mask)
    rows = torch.tensor([4, 0, 3])
    np.testing.assert_array_equal(
        dk.keep_mask(scope.key, fold, 0.9, (6, 5, 7), rows, impl).numpy(),
        mask[rows.numpy()])


@pytest.mark.parametrize("impl", IMPLS)
def test_dropout_train_steps_match_jax(impl):
    """Two keyed train steps of the dropout learner from the same params,
    batches, weights and keys (``tests/test_torch_dropout.py``'s
    ``test_train_matches_jax`` under the impl)."""
    with jax_impl(impl):
        jl, jls, tl, tls, info = tl_test.build_pair(tl_test.config(**{
            "model.dropout": 0.1, "prng_impl": impl}))
        jtrain = jax.jit(jl.train)
        rng = np.random.default_rng(1)
        outs = []
        for step in range(2):
            ep = tl_test.make_episodes(rng, info, tl_test.BATCH, tl_test.T)
            w = rng.uniform(0.5, 1.0, tl_test.BATCH).astype(np.float32)
            key = jax.random.PRNGKey(40 + step)
            jls, ji = jtrain(jls, tl_test.to_jax(ep), jnp.asarray(w), 0,
                             step + 1, key)
            outs.append((ep, w, np.asarray(key),
                         jax.tree.map(np.asarray, (jls, ji))))
    assert tl.mac.prng_impl == impl
    for step, (ep, w, key, (jls, ji)) in enumerate(outs):
        assert key.shape == (4,)
        tls, ti = tl.train(tls, tl_test.to_port(ep), torch.from_numpy(w),
                           0, step + 1, tensor_from_jax(key, "cpu"))
        for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
                  "td_errors_abs"):
            np.testing.assert_allclose(ti[k].numpy(), ji[k],
                                       err_msg=f"step {step} {k}",
                                       **tl_test.INFO)
        np.testing.assert_allclose(float(ti["grad_norm"]),
                                   float(ji["grad_norm"]), rtol=1e-4)
        tl_test._params_close(tls.params, jls.params, f"step {step}")


@pytest.mark.parametrize("impl", IMPLS)
def test_dropout_learner_at_two_ranks_matches_the_blocked_step(tmp_path,
                                                                impl):
    d = tl_test.config(**{"model.dropout": 0.1, "batch_size": 4,
                          "prng_impl": impl})
    cfg = from_dict(d)
    info = make_env(cfg.env_args, device="cpu").get_env_info()
    tl = ql.QMixLearner.build(cfg, BasicMAC.build(cfg, info, device="cpu"),
                              info, device="cpu")
    tls = tl.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    batch = tl_test.to_port(tl_test.make_episodes(rng, info, 4, tl_test.T))
    w = torch.from_numpy(rng.uniform(0.5, 1.0, 4).astype(np.float32))
    key = prng.split(prng.PRNGKey(11, "cpu", impl), 2, impl)[0]
    inp, out = tmp_path / "in.pt", tmp_path / "out.pt"
    torch.save({"config": d, "params": tls.params, "weights": w,
                "key": key, "batch": {f.name: getattr(batch, f.name)
                                      for f in dataclasses.fields(
                                          EpisodeBatch)}}, inp)
    ctx = ranks.start(ranks.learner_step, WORLD, (str(inp), str(out)))
    want = _blocked_step(tl, tls, batch, w, key)
    assert ranks.wait(ctx, 120) == [0] * WORLD
    got = torch.load(out, weights_only=False)
    assert torch.equal(got["info"]["loss"], want["loss"])
    assert torch.equal(got["info"]["grad_norm"], want["grad_norm"])
    assert torch.equal(got["info"]["td_errors_abs"], want["td"])
    for m in want["params"]:
        for k in want["params"][m]:
            assert torch.equal(got["ls"].params[m][k],
                               want["params"][m][k]), k


# ------------------------------------------------ data parallel rollouts

@pytest.mark.parametrize("impl", IMPLS)
def test_two_ranks_match_world_1(tmp_path, impl):
    d = dict(DP, prng_impl=impl)
    exp = Experiment.build(from_dict(d), "cpu")
    params = exp.init_state(0).learner.params
    ctx = ranks.start(ranks.classic, WORLD,
                      (str(tmp_path / "w2.pt"), [(impl, d, params, 2)]))
    one = plain(d, params, 2)
    assert ranks.wait(ctx, 120) == [0] * WORLD
    got = torch.load(tmp_path / "w2.pt", weights_only=False)[impl]
    a, _ = flatten_state(got["ts"])
    b, _ = flatten_state(one["ts"])
    exact = [k for k in a if not k.startswith("learner.")
             and k not in ("buffer.priorities", "buffer.max_priority")]
    assert a["runner.key"].shape == (4,)
    assert [k for k in exact if not torch.equal(a[k], b[k])] == []


# ------------------------------------------------------------ checkpoints

def test_restoring_a_threefry_checkpoint_under_rbg_names_the_widths(
        tmp_path):
    d = tiny(tmp_path)
    three = Experiment.build(from_dict(d), device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "m"), 0, three.init_state(0))
    rbg = Experiment.build(from_dict(dict(d, prng_impl="rbg")),
                           device="cpu")
    with pytest.raises(ValueError, match=r"runner\.key stored \(2,\).*"
                       r"vs configured \(4,\).*prng_impl"):
        ckpt.load_checkpoint(str(tmp_path / "m" / "0"), rbg.init_state(0))


# ------------------------------------------------- Sebulba, a population

def test_sebulba_lockstep_shards_match_the_classic_loop(tmp_path):
    """Under ``rbg`` a Sebulba actor shard draws its lanes' rows of the
    global draw from the first global lane's key (JAX shards one program
    over the actor mesh): lockstep at 2 actor shards equals the classic
    run bit for bit (``tests/test_torch_sebulba.py``'s check)."""
    from t2omca_tpu_torch.run import run
    from t2omca_tpu_torch.utils.logging import Logger
    from test_torch_sebulba import _equal, lockstep
    kw = dict(t_max=36, prng_impl="rbg")
    classic = run(from_dict(tiny(tmp_path / "classic", **kw)), Logger(),
                  device="cpu")
    seb = run(from_dict(tiny(tmp_path / "seb", sebulba=lockstep(2), **kw)),
              Logger(), device="cpu")
    assert seb.runner.key.shape == (4,)
    assert _equal(seb, classic) == []


def test_a_population_over_ranks_under_rbg_is_refused(tmp_path):
    """A population's members over data-parallel ranks or Sebulba
    placements: a rank without member 0 has no member 0 to draw from, so
    under an RngBitGenerator impl the port raises (one process seats its
    members: the tests below)."""
    from t2omca_tpu_torch.run import run
    from t2omca_tpu_torch.utils.logging import Logger
    from test_torch_sebulba import lockstep
    cfg = from_dict(tiny(tmp_path, prng_impl="rbg", population={"size": 2},
                         sebulba=lockstep(), superstep=1))
    with pytest.raises(NotImplementedError, match="item 16.*members"):
        run(cfg, Logger(), device="cpu")


def _pop_states(texp, jts):
    """The port's member states from JAX's stacked ones."""
    from t2omca_tpu_torch.convert import member_states_from_jax
    from t2omca_tpu_torch.train.program import TrainState
    return [TrainState(learner=ls, buffer=texp.buffer.init(),
                       episode=torch.zeros((), dtype=torch.int32),
                       runner=rs)
            for ls, rs in member_states_from_jax(jts.learner, jts.runner,
                                                  "cpu")]


def _jax_population(d):
    """JAX's population init as ``tests/test_torch_population_dispatch.py``
    makes it (each member's init jitted, the states stacked)."""
    from t2omca_tpu import population as jpop
    from t2omca_tpu.run import TrainState as JaxTrainState
    jcfg = jax_from_dict(d)
    jexp = JaxExperiment.build(jcfg)
    inits = (jax.jit(jexp.learner.init_state),
             jax.jit(jexp.runner.init_state), jax.jit(jexp.buffer.init))
    members = []
    for seed in jpop.member_seeds(jcfg):
        k_learner, k_runner = jax.random.split(jax.random.PRNGKey(seed))
        members.append(JaxTrainState(
            learner=inits[0](k_learner), runner=inits[1](k_runner),
            buffer=inits[2](), episode=jnp.zeros((), jnp.int32)))
    return jexp, jcfg, jax.tree.map(lambda *xs: jnp.stack(xs), *members)


def test_population_dispatch_matches_jax_under_unsafe_rbg():
    """A P = 2 dispatch of K = 2 (``tests/test_torch_population_
    dispatch.py``'s cut config 7: every knob's grid and the scenario
    salt) under ``unsafe_rbg`` against JAX's ``population_superstep_
    program``: JAX vmaps the members, so member 1 draws its rows of member
    0's draws, with member 0's salt (the vmapped ``fold_in`` data's first
    row), its own carried key its rows of member 0's split draws. The
    rollout stats before the first train step, the ring slots they fill,
    the runner keys and the counters exact; the first train step within
    the loop test's tolerances (``grad_norm`` at that test's 2e-3)."""
    from t2omca_tpu import population as jpop
    from t2omca_tpu_torch import population as pop
    from test_torch_population_dispatch import CONFIG7
    d = dict(CONFIG7, prng_impl="unsafe_rbg")
    with jax_impl("unsafe_rbg"):
        jexp, jcfg, jts = _jax_population(d)
        keys, rows = jpop.member_keys(jcfg), []
        for _ in range(2):
            row = []
            for m in range(2):
                keys[m], k_s = jax.random.split(keys[m])
                row.append(k_s)
            rows.append(jnp.stack(row))
        out = jexp.population_superstep_program(2)(
            jts, jnp.stack(rows, axis=1), jnp.asarray(0, jnp.int32),
            jpop.build_spec(jcfg))
        jts, jkeys, (jts2, jstats, jinfos) = jax.tree.map(
            np.asarray, (jts, jnp.stack(keys), out))
    texp = Experiment.build(from_dict(d), device="cpu")
    cfg = texp.cfg
    pts = _pop_states(texp, jts)
    prog = texp.population_superstep_program(2)
    assert prog.seated
    tkeys = pop.member_keys(cfg, "cpu")
    rows = []
    for _ in range(2):
        row = []
        for m in range(2):
            tkeys[m], k_s = prng.split(tkeys[m], 2, cfg.prng_impl).unbind(0)
            row.append(k_s)
        rows.append(torch.stack(row))
    np.testing.assert_array_equal(torch.stack(tkeys).numpy(), jkeys)
    pts, stats, infos = prog(pts, torch.stack(rows, 1), 0, [True, True],
                             pop.build_spec(cfg))
    for f in dataclasses.fields(stats):
        np.testing.assert_array_equal(getattr(stats, f.name)[:, :1].numpy(),
                                      getattr(jstats, f.name)[:, :1],
                                      err_msg=f.name)
    jflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_leaves_with_path(jts2.buffer.storage)}
    for m, ts in enumerate(pts):
        np.testing.assert_array_equal(ts.runner.key.numpy(),
                                      jts2.runner.key[m], err_msg=str(m))
        for k, v in flatten_state(ts.buffer.storage)[0].items():
            np.testing.assert_array_equal(
                v[:4].numpy(), jflat["." + k][m, :4].astype(
                    v.numpy().dtype), err_msg=f"member {m} {k}")
        assert int(ts.episode) == int(jts2.episode[m]) == 8
        assert int(ts.learner.train_steps) == 2
    for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
              "grad_norm"):
        tol = dict(rtol=2e-3, atol=1e-6) if k == "grad_norm" else INFO
        np.testing.assert_allclose(infos[k][:, 0].numpy(), jinfos[k][:, 0],
                                   err_msg=k, **tol)


def test_population_test_rollout_matches_jax_under_rbg():
    """The greedy test rollout of a P = 2 population under ``rbg`` against
    JAX's ``population_rollout_program`` (the members vmapped): each
    member's stats and runner key exact (member 1's env draws are its
    rows of member 0's), the positions at ``tests/test_torch_runner.py``'s
    float tolerance."""
    from test_torch_population_dispatch import CONFIG7
    d = dict(CONFIG7, prng_impl="rbg")
    with jax_impl("rbg"):
        jexp, jcfg, jts = _jax_population(d)
        jrs, jstats = jexp.population_rollout_program()(
            jts.learner.params["agent"], jts.runner)
        jts, jrs, jstats = jax.tree.map(np.asarray, (jts, jrs, jstats))
    texp = Experiment.build(from_dict(d), device="cpu")
    pts = _pop_states(texp, jts)
    rs, stats = texp.population_rollout_program()(pts)
    for f in dataclasses.fields(stats):
        np.testing.assert_array_equal(getattr(stats, f.name).numpy(),
                                      np.asarray(getattr(jstats, f.name)),
                                      err_msg=f.name)
    for m in range(2):
        np.testing.assert_array_equal(rs[m].key.numpy(), jrs.key[m])
        # tests/test_torch_runner.py's float tolerance: XLA fuses the
        # members' vmapped placement otherwise (1 ulp at 150 m)
        np.testing.assert_allclose(rs[m].env_states.pos.numpy(),
                                   jrs.env_states.pos[m], rtol=1e-5,
                                   atol=1e-5)
