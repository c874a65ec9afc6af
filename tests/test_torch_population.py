"""Port parity of the population's pieces (``t2omca_tpu_torch/
population.py`` and its seams) against the live JAX functions, at unit
size (no superstep compile; the dispatch and the driver are
``tests/test_torch_population_{dispatch,run}.py``):

* ``build_spec`` (``lr_i / cfg.lr`` rounded once to float32, bit-equal),
  ``member_seeds``, ``member_keys`` and the neutral-spec predicate, for
  config 7 as shipped, a bare-int ``population: 4``, a stride of 0 and
  every grid;
* ``member_scenario_key`` and the salted scenario draws of P members, bit
  for bit against ``ParallelRunner._sample_scenarios(key, member=)``
  (never ``tests/test_graftworld.py``'s stored digests);
* the epsilon seam (the runner's host ``(T,)`` epsilons times the member's
  float32 scale, equal to JAX's ``selector.epsilon(t, eps_scale=)``, and
  ``run_raw(eps_scale=)`` equal to the rollout that reads them) and
  the PER-exponent seam at insert, feedback and sample (priorities at
  rtol 1e-6, as ``tests/test_torch_replay.py``: torch's and XLA's pow may
  differ in the last bit; indices and the running max exact);
* the lr seam: ``QMixLearner.train(spec=)`` against JAX's for two steps at
  ``tests/test_torch_learner.py``'s operating point and tolerances, and a
  scale of 1.0 bit-identical to no spec;
* ``pbt_step``: the same copies, bit-equal spec values and re-salted keys,
  the rescaled priorities at rtol 1e-6;
* ``StatsAccumulator(population=P)`` rows and ``member_return_ema``, and
  ``PopulationSightMonitor``'s rows, trips, report and check names;
* checkpoints: a population round-trips, a single-member checkpoint lifts
  (member keys equal to JAX's ``fold_in``), a checkpoint of the earlier
  format loads, and a population of another size is refused.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from t2omca_tpu import population as jpop
from t2omca_tpu.components.episode_buffer import \
    PrioritizedReplayBuffer as JaxPER
from t2omca_tpu.config import SightConfig as JaxSightConfig
from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.config import load_config as jax_load_config
from t2omca_tpu.envs import graftworld as jg
from t2omca_tpu.obs.sight import PopulationSightMonitor as JaxPopMonitor
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu.runners.parallel_runner import RolloutStats as JaxStats
from t2omca_tpu.utils import checkpoint as jckpt
from t2omca_tpu.utils.stats import StatsAccumulator as JaxAccumulator
from t2omca_tpu_torch import population as pop
from t2omca_tpu_torch import prng
from t2omca_tpu_torch.components.episode_buffer import \
    PrioritizedReplayBuffer
from t2omca_tpu_torch.config import SightConfig, from_dict, load_config
from t2omca_tpu_torch.convert import tensor_from_jax
from t2omca_tpu_torch.envs import graftworld as tg
from t2omca_tpu_torch.obs import sight
from t2omca_tpu_torch.run import Experiment
from t2omca_tpu_torch.runners.parallel_runner import RolloutStats
from t2omca_tpu_torch.utils import checkpoint as ckpt
from t2omca_tpu_torch.utils.stats import StatsAccumulator

import test_torch_learner as tl_test
from test_torch_replay import _episodes, to_jax, to_port

CONFIG7 = "configs/config7_population.yaml"
#: population blocks beside config 7's own: the bare int, stride 0 with
#: every grid, a neutral one-member population, a salted one
POPULATIONS = {
    "bare_int": 4,
    "stride0_grids": {"size": 3, "seed_stride": 0,
                      "lr": (1e-4, 3e-4, 7e-4),
                      "eps_scale": (0.5, 1.0, 1.7),
                      "per_alpha": (0.4, 0.6, 0.9)},
    "neutral": {"size": 1},
    "salted": {"size": 1, "scenario_salt": True},
    "pbt": {"size": 2, "pbt": {"enabled": True}},
}


def _pair_cfg(population, **kw):
    d = dict(lr=3e-4, seed=7, save_model=True, population=population,
             **kw)
    return jax_from_dict(d), from_dict(d)


def _spec_equal(spec, jspec):
    for f in ("lr_scale", "eps_scale", "per_alpha", "member"):
        got, want = getattr(spec, f).numpy(), np.asarray(getattr(jspec, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("name", ["config7"] + sorted(POPULATIONS))
def test_spec_seeds_and_keys_match_jax(name):
    if name == "config7":
        jcfg, tcfg = jax_load_config(CONFIG7), load_config(CONFIG7)
    else:
        jcfg, tcfg = _pair_cfg(POPULATIONS[name])
    assert pop.population_size(tcfg) == jpop.population_size(jcfg)
    assert pop.member_seeds(tcfg) == jpop.member_seeds(jcfg)
    _spec_equal(pop.build_spec(tcfg), jpop.build_spec(jcfg))
    for k, jk in zip(pop.member_keys(tcfg, "cpu"), jpop.member_keys(jcfg)):
        assert torch.equal(k, tensor_from_jax(jk, "cpu"))
    pc = jcfg.population
    assert pop.spec_is_neutral(tcfg) == (
        pc.size == 1 and not pc.lr and not pc.eps_scale and not pc.per_alpha
        and not pc.scenario_salt and not pc.pbt.enabled)
    if name == "config7":
        # lr_i / cfg.lr: 2.5e-4 / 5e-4 and its neighbours, as float32
        np.testing.assert_array_equal(pop.build_spec(tcfg).lr_scale.numpy(),
                                      np.float32([0.5, 1.0, 2.0, 4.0]))


# ------------------------------------------------------- scenario salt

def test_member_scenario_key_and_salted_draws_match_jax():
    """Config 7's mixture (8 AGVs, min_agents 4), 16 lanes: each member's
    salted draw from one runner key equals JAX's, the members' draws
    differ, and the key fold is ``fold_in``."""
    d = {"batch_size_run": 16, "env_args": {
        "agv_num": 8, "mec_num": 2, "num_channels": 2, "episode_limit": 6,
        "scenario": {"kind": "mixture", "min_agents": 4}}}
    jexp = JaxExperiment.build(jax_from_dict(d))
    texp = Experiment.build(from_dict(d), device="cpu")
    key = jax.random.PRNGKey(11)
    tkey = tensor_from_jax(key, "cpu")
    draws = []
    for m in range(4):
        assert torch.equal(tg.member_scenario_key(tkey, m), tensor_from_jax(
            jg.member_scenario_key(key, jnp.int32(m)), "cpu"))
        jp = jax.jit(lambda k, m=m: jexp.runner._sample_scenarios(
            k, member=jnp.int32(m)))(key)
        tp = texp.runner._sample_scenarios(tkey, m)
        for f in dataclasses.fields(tp):
            np.testing.assert_array_equal(
                getattr(tp, f.name).numpy(), np.asarray(getattr(jp, f.name)),
                err_msg=f"member {m} {f.name}")
        draws.append(tp)
    assert not torch.equal(draws[0].family, draws[1].family) or \
        not torch.equal(draws[0].n_active, draws[1].n_active)
    unsalted = texp.runner._sample_scenarios(tkey)
    assert not all(torch.equal(getattr(unsalted, f.name),
                               getattr(draws[0], f.name))
                   for f in dataclasses.fields(unsalted))


# ------------------------------------------------------------ the seams

def test_eps_seam_matches_jax():
    """The rollout's ``(T,)`` epsilons times a member's float32 scale, on
    the host in numpy float32, against JAX's jitted ``selector.epsilon(t,
    eps_scale=)`` at the same steps; a scale of 1.0 gives the unscaled
    vector bit for bit; the selector's own ``epsilon`` agrees; a host
    rollout with ``run_raw(eps_scale=)`` is the one that reads the scaled
    vector."""
    d = {"batch_size_run": 4, "epsilon_anneal_time": 500,
         "env_args": {"agv_num": 3, "mec_num": 2, "num_channels": 2,
                      "episode_limit": 20}}
    jexp = JaxExperiment.build(jax_from_dict(d))
    texp = Experiment.build(from_dict(d), device="cpu")
    sel = jexp.mac.selector
    for scale in (0.37, 1.0, 1.7, 2.5e-3):
        s32 = np.float32(scale)
        for t0 in (0, 80, 440, 2000):
            got = texp.runner.epsilons(t0, float(s32)).numpy()
            t = t0 + 4 * np.arange(20, dtype=np.int32)
            want = np.asarray(jax.jit(lambda t, s: sel.epsilon(
                t, False, s))(jnp.asarray(t), jnp.float32(s32)))
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=(scale, t0))
            one = texp.runner.epsilons(t0, 1.0)
            assert torch.equal(one, texp.runner.epsilons(t0))
            mine = texp.mac.selector.epsilon(torch.as_tensor(t), False,
                                             torch.tensor(s32))
            np.testing.assert_array_equal(np.asarray(mine), want)
    # run_raw's seam: a host rollout with eps_scale is the rollout that
    # reads the scaled vector from the device, bit for bit
    rs = texp.init_state(0).runner
    rs.t_env = 80
    params = texp.init_state(0).learner.params["agent"]
    a = texp.runner.run_raw(params, rs, eps_scale=0.37)
    b = texp.runner.run_raw(params, rs,
                            eps=texp.runner.epsilons(80, 0.37))
    for x, y in ((a[1].actions, b[1].actions), (a[2].epsilon, b[2].epsilon),
                 (a[1].reward, b[1].reward)):
        assert torch.equal(x, y)
    assert float(a[2].epsilon) == float(np.float32(
        texp.runner.epsilons(80)[-1]) * np.float32(0.37))


def test_alpha_seam_matches_jax_at_insert_feedback_and_sample():
    """A PER ring written with a member's exponent (a () f32 tensor)
    against JAX's with a traced one: two inserts (one wraps), two
    priority feedbacks and a sample between them; an exponent equal to
    the buffer's reproduces the static path's values."""
    kw = dict(episode_limit=3, n_agents=2, n_actions=3, obs_dim=4,
              state_dim=5, capacity=5)
    bt = PrioritizedReplayBuffer(alpha=0.6, beta0=0.4, t_max=100,
                                 device="cpu", **kw)
    bj = JaxPER(alpha=0.6, beta0=0.4, t_max=100, **kw)
    for a in (0.8, 0.35):
        at, aj = torch.tensor(a, dtype=torch.float32), jnp.float32(a)
        st, sj = bt.init(), bj.init()
        rng = np.random.default_rng(3)
        for i, b in enumerate((3, 4)):
            ep = _episodes(b, i)
            st = bt.insert_episode_batch(st, to_port(ep), alpha=at)
            sj = bj.insert_episode_batch(sj, to_jax(ep), alpha=aj)
            np.testing.assert_allclose(st.priorities.numpy(),
                                       np.asarray(sj.priorities), rtol=1e-6)
            key = jax.random.PRNGKey(20 + i)
            _, idx, w = bt.sample(st, tensor_from_jax(key, "cpu"), 4, 30)
            _, jidx, jw = bj.sample(sj, key, 4, 30)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
            pr = rng.uniform(0.1, 9.0, 4).astype(np.float32)
            st = bt.update_priorities(st, idx, torch.from_numpy(pr),
                                      alpha=at)
            sj = bj.update_priorities(sj, jidx, jnp.asarray(pr), alpha=aj)
            np.testing.assert_allclose(st.priorities.numpy(),
                                       np.asarray(sj.priorities), rtol=1e-6)
            assert float(st.max_priority) == float(sj.max_priority)
    # the buffer's own exponent through the seam: the static path's values
    s1, s2 = bt.init(), bt.init()
    ep = to_port(_episodes(3, 0))
    s1 = bt.update_priorities(bt.insert_episode_batch(s1, ep),
                              torch.arange(3), torch.tensor([2., 5., 7.]))
    s2 = bt.update_priorities(
        bt.insert_episode_batch(s2, ep, alpha=torch.tensor(0.6)),
        torch.arange(3), torch.tensor([2., 5., 7.]),
        alpha=torch.tensor(0.6))
    np.testing.assert_allclose(s1.priorities.numpy(), s2.priorities.numpy(),
                               rtol=1e-6)


def test_lr_seam_matches_jax():
    """``train(spec=)`` with ``lr_scale`` 2.5 (``u * lr_scale`` after Adam)
    against JAX's for two steps; ``lr_scale`` 1.0 is bit-identical to no
    spec."""
    jl, jls, tl, tls, info = tl_test.build_pair(tl_test.config())
    jtrain = jax.jit(jl.train)
    jspec = jpop.PopulationSpec(lr_scale=jnp.float32(2.5),
                                eps_scale=jnp.float32(1.0),
                                per_alpha=jnp.float32(0.6),
                                member=jnp.int32(0))
    spec = SimpleNamespace(lr_scale=torch.tensor(2.5))
    rng = np.random.default_rng(4)
    plain = tls
    for step in range(2):
        ep = tl_test.make_episodes(rng, info, tl_test.BATCH, tl_test.T)
        w = rng.uniform(0.5, 1.0, tl_test.BATCH).astype(np.float32)
        jls, jinfo = jtrain(jls, tl_test.to_jax(ep), jnp.asarray(w), 0,
                            step + 1, spec=jspec)
        batch, tw = tl_test.to_port(ep), torch.from_numpy(w)
        new, tinfo = tl.train(tls, batch, tw, 0, step + 1, spec=spec)
        for key in ("loss", "td_error_abs", "q_taken_mean", "target_mean"):
            np.testing.assert_allclose(tinfo[key].numpy(),
                                       np.asarray(jinfo[key]),
                                       err_msg=f"step {step} {key}",
                                       **tl_test.INFO)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-4)
        tl_test._params_close(new.params, jls.params, f"step {step}")
        one, _ = tl.train(tls, batch, tw, 0, step + 1,
                          spec=SimpleNamespace(lr_scale=torch.tensor(1.0)))
        none, _ = tl.train(tls, batch, tw, 0, step + 1)
        for m in none.params:
            for k in none.params[m]:
                assert torch.equal(one.params[m][k], none.params[m][k])
        moved = sum(float((new.params[m][k] - tls.params[m][k]).abs().sum())
                    for m in new.params for k in new.params[m])
        base = sum(float((none.params[m][k] - tls.params[m][k]).abs().sum())
                   for m in none.params for k in none.params[m])
        assert moved > 2.0 * base
        tls, plain = new, none
    del plain


# ------------------------------------------------------------------ PBT

@struct.dataclass
class _JRunner:
    key: jnp.ndarray


@struct.dataclass
class _JBuf:
    priorities: jnp.ndarray


@struct.dataclass
class _JState:
    w: jnp.ndarray
    runner: _JRunner
    buffer: _JBuf


@dataclasses.dataclass
class _Runner:
    key: torch.Tensor
    t_env: int


@dataclasses.dataclass
class _Buf:
    priorities: torch.Tensor


@dataclasses.dataclass
class _State:
    w: torch.Tensor
    runner: _Runner
    buffer: _Buf


@pytest.mark.parametrize("p,frac,grid", [
    (4, 0.25, None), (4, 0.5, (0.3, 0.6, 0.8, 1.0)), (2, 0.5, (0.6, 0.8)),
    (5, 0.4, None)])
def test_pbt_step_matches_jax(p, frac, grid):
    """The same stacked state, spec and ranking through JAX's ``pbt_step``
    and the port's (P member states): the copies and the perf in ``info``,
    the spec bit for bit, each member's ``w`` and rollout key exactly, the
    rescaled priorities at rtol 1e-6; at several ``t_env`` (the RNG
    stream's coin flips), and a no-op without a full ranking."""
    popd = {"size": p, "pbt": {"enabled": True, "frac": frac}}
    if grid:
        popd["per_alpha"] = grid
        popd["lr"] = tuple(3e-4 * (1 + i) for i in range(p))
    jcfg, tcfg = _pair_cfg(popd)
    rng = np.random.default_rng(p)
    w = rng.standard_normal((p, 3)).astype(np.float32)
    pri = rng.uniform(0.5, 4.0, (p, 6)).astype(np.float32)
    pri[:, -1] = 0.0                      # an unfilled tail slot
    keys = np.stack([np.asarray(jax.random.PRNGKey(100 + m))
                     for m in range(p)])
    for t_env in (100, 2400, 7):
        perf = list(rng.permutation(p).astype(float))
        jts = _JState(w=jnp.asarray(w), runner=_JRunner(jnp.asarray(keys)),
                      buffer=_JBuf(jnp.asarray(pri)))
        tts = [_State(w=torch.from_numpy(w[m].copy()),
                      runner=_Runner(torch.from_numpy(
                          keys[m].astype(np.int64)), 0),
                      buffer=_Buf(torch.from_numpy(pri[m].copy())))
               for m in range(p)]
        jts2, jspec2, jinfo = jpop.pbt_step(jcfg, jts, jpop.build_spec(jcfg),
                                            perf, t_env)
        tts2, spec2, info = pop.pbt_step(tcfg, tts, pop.build_spec(tcfg),
                                         perf, t_env)
        assert info == jinfo and info["copied"]
        assert tts2 is tts
        _spec_equal(spec2, jspec2)
        for m in range(p):
            np.testing.assert_array_equal(tts[m].w.numpy(),
                                          np.asarray(jts2.w)[m])
            assert torch.equal(tts[m].runner.key, tensor_from_jax(
                np.asarray(jts2.runner.key)[m], "cpu")), (t_env, m)
            np.testing.assert_allclose(tts[m].buffer.priorities.numpy(),
                                       np.asarray(jts2.buffer.priorities)[m],
                                       rtol=1e-6)
    spec = pop.build_spec(tcfg)
    for perf in (None, [1.0] * (p - 1), [1.0] * (p - 1) + [None]):
        same, spec_same, info = pop.pbt_step(tcfg, tts, spec, perf, 5)
        assert info is None and same is tts and spec_same is spec


# ------------------------------------------------------ stats and sight

class _Sink:
    def __init__(self):
        self.rows = []

    def log_stat(self, key, value, t):
        self.rows.append((key, value, t))


def _pop_stats(rng, shape):
    names = [f.name for f in dataclasses.fields(RolloutStats)]
    vals = {k: (rng.standard_normal(shape)
                * 10.0 ** rng.integers(-2, 4, shape)).astype(np.float32)
            for k in names if k not in ("epsilon", "scenario")}
    scenario = rng.integers(0, 4, shape).astype(np.int32)
    eps = rng.uniform(0, 1, shape[:-1]).astype(np.float32)
    port = RolloutStats(**{k: torch.from_numpy(v) for k, v in vals.items()},
                        epsilon=torch.from_numpy(eps),
                        scenario=torch.from_numpy(scenario))
    jax_ = JaxStats(**{k: jnp.asarray(v) for k, v in vals.items()},
                    epsilon=jnp.asarray(eps), scenario=jnp.asarray(scenario))
    return port, jax_


@pytest.mark.parametrize("p", [1, 2, 4])
def test_stats_accumulator_population_rows_match_jax(p):
    """Pushes of ``(P, K, B)`` stacks (and a fold forced by FOLD_EVERY),
    a train flush, a test-prefixed flush and a third flush: the same rows
    and values as JAX's accumulator (``pop<i>_*`` at P > 1 only, the slice
    rows, member 0's epsilon), the same ``member_return_ema`` and
    fetches."""
    rng = np.random.default_rng(p)
    ours, theirs = StatsAccumulator(population=p), \
        JaxAccumulator(population=p)
    sink_o, sink_t = _Sink(), _Sink()
    shapes = [(p, 4, 32), (p, 1, 7)] + [(p, 2, 3)] * 66
    for t, (prefix, pushes) in enumerate(
            [("", shapes), ("test_", [(p, 1, 16)]), ("", [(p, 4, 5)])]):
        for shape in pushes:
            a, b = _pop_stats(rng, shape)
            ours.push(a)
            theirs.push(b)
        assert ours.epsilon == theirs.epsilon
        ours.flush(sink_o, t, prefix=prefix)
        theirs.flush(sink_t, t, prefix=prefix)
        assert ours.member_return_ema == theirs.member_return_ema
    assert sink_o.rows == sink_t.rows
    keys = {k for k, _, _ in sink_o.rows}
    assert any(k.startswith("pop") for k in keys) == (p > 1)
    if p > 1:
        assert {f"test_pop{m}_return_mean" for m in range(p)} <= keys
    assert ours.fetches == theirs.fetches
    assert all(v is not None for v in ours.member_return_ema)


def _sight_stream(p):
    """A (P,)-leading info stream: member 1 diverges and collapses."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        info = {"loss": rng.uniform(1, 2, p).astype(np.float32),
                "q_taken_mean": np.float32([0.5, 99.0 * i, 0.1, 3.0][:p]),
                "target_mean": np.float32([0.5, 99.0 * i, 0.2, 1.0][:p]),
                "sight_priority_entropy_norm":
                    np.float32([0.9, 0.01, 0.8, 0.7][:p]),
                "sight_attn_entropy_mixer": rng.uniform(
                    0, 1, (p, 2)).astype(np.float32),
                "sight_per_ess": rng.uniform(0, 1, p).astype(np.float32)}
        out.append((info, 100 * (i + 1)))
    return out


class _Hub:
    def __init__(self):
        self.names = []

    def health(self, name, fn):
        self.names.append(name)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_population_sight_monitor_matches_jax(p):
    """The same stream through JAX's ``PopulationSightMonitor`` and the
    port's: the logged rows (``pop<i>_sight_*`` at P > 1, the solo names at
    P = 1), the trips (``pop<i>:<detector>``), the report and the
    ``/healthz`` check names (``sight-pop<i>-<detector>``)."""
    out = []
    for mod_cls, cfg in ((sight.PopulationSightMonitor,
                          SightConfig(enabled=True, q_div=10.0)),
                         (JaxPopMonitor,
                          JaxSightConfig(enabled=True, q_div=10.0))):
        log, hub = _Sink(), _Hub()
        mon = mod_cls(cfg, p, logger=log)
        trips = [mon.observe(info, t) for info, t in _sight_stream(p)]
        mon.wire_pulse(hub)
        out.append(([(k, np.asarray(v).tolist(), t) for k, v, t in log.rows],
                    trips, mon.report(), hub.names))
    assert out[0] == out[1]
    rows, trips, report, names = out[0]
    assert report["population"] == p and len(names) == 5 * p
    if p > 1:
        assert "pop1:q_divergence" in sum(trips, [])
        assert all(n.startswith("sight-pop") for n in names)
    else:
        assert all(not k.startswith("pop") for k, _, _ in rows)


# ---------------------------------------------------------- checkpoints

def _tiny(**kw):
    d = dict(batch_size_run=2, batch_size=4, epsilon_anneal_time=50,
             env_args=dict(agv_num=3, mec_num=2, num_channels=2,
                           episode_limit=6),
             model=dict(emb=8, heads=2, depth=1, mixer_emb=8, mixer_heads=2,
                        mixer_depth=1),
             replay=dict(buffer_size=8))
    d.update(kw)
    return from_dict(d)


def _flat(state):
    return ckpt.flatten_state(state)


def test_population_checkpoint_round_trips(tmp_path):
    """A P = 3 population after a dispatch saves as format 2 with the
    population stamp and loads into fresh members bit for bit (every
    member's tensors, host values and the spec); each loaded member owns
    its tensors."""
    cfg = _tiny(population={"size": 3, "lr": (1e-4, 2e-4, 3e-4)})
    exp = Experiment.build(cfg, device="cpu")
    pts, spec = pop.init_population(exp, cfg)
    keys = torch.stack([torch.stack([k, k]) for k in
                        pop.member_keys(cfg, "cpu")])
    pts, _, _ = exp.population_superstep_program(2)(pts, keys, 0,
                                                    [False, True], spec)
    spec.per_alpha[1] = 0.75              # as PBT would leave it
    d = ckpt.save_checkpoint(str(tmp_path), 24, pop.PopState(pts, spec))
    meta = ckpt.read_meta(d)
    assert meta["format"] == ckpt.FORMAT_VERSION == 2
    assert meta["topology"]["population"] == 3
    fresh, fresh_spec = pop.init_population(exp, cfg)
    back = ckpt.load_checkpoint(d, pop.PopState(fresh, fresh_spec))
    a, ha = _flat(pop.PopState(pts, spec))
    b, hb = _flat(back)
    assert ha == hb and set(a) == set(b)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert float(back.spec.per_alpha[1]) == 0.75
    ptrs = [t.untyped_storage().data_ptr() for m in back.ts
            for t in _flat(m)[0].values()]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("fmt", [1, 2])
def test_single_member_checkpoint_lifts_into_a_population(tmp_path,
                                                          monkeypatch, fmt):
    """A solo checkpoint (format 1, the layout before populations, and
    format 2) restored into a P = 3 template: member 0 is the restored
    run, members 1 and 2 equal it but for their rollout keys, re-salted
    with ``fold_in(key, m)`` as JAX's ``_lift_population`` re-salts them;
    the spec is the template's; the same checkpoint still loads into a
    solo template."""
    cfg = _tiny()
    exp = Experiment.build(cfg, device="cpu")
    from t2omca_tpu_torch.run import run_classic
    ts, _, _ = run_classic(exp, exp.init_state(0), 3)
    monkeypatch.setattr(ckpt, "FORMAT_VERSION", fmt)
    d = ckpt.save_checkpoint(str(tmp_path), 36, ts)
    monkeypatch.undo()
    meta = ckpt.read_meta(d)
    assert meta["format"] == fmt and meta["topology"]["population"] is None
    pcfg = _tiny(population={"size": 3, "per_alpha": (0.5, 0.6, 0.7)})
    pexp = Experiment.build(pcfg, device="cpu")
    members, spec = pop.init_population(pexp, pcfg)
    lifted = ckpt.load_checkpoint(d, pop.PopState(members, spec))
    assert lifted.spec is spec
    solo, hs = _flat(ts)
    key = ts.runner.key
    jraw = {"runner": {"key": np.asarray(key.numpy(), np.uint32)}}
    jlift = jckpt._lift_population(jraw, SimpleNamespace(
        spec=jpop.build_spec(jax_from_dict({"population": 3}))))
    for m, member in enumerate(lifted.ts):
        got, hm = _flat(member)
        assert hm == hs and set(got) == set(solo)
        differ = [k for k in got if not torch.equal(got[k], solo[k])]
        assert differ == ([] if m == 0 else ["runner.key"])
        assert torch.equal(member.runner.key, tensor_from_jax(
            jlift["ts"]["runner"]["key"][m], "cpu"))
        assert torch.equal(member.runner.key,
                           key if m == 0 else prng.fold_in(key, m))
    ptrs = [t.untyped_storage().data_ptr() for m in lifted.ts
            for t in _flat(m)[0].values()]
    assert len(set(ptrs)) == len(ptrs)
    back = ckpt.load_checkpoint(d, exp.init_state(1))
    b, _ = _flat(back)
    assert all(torch.equal(b[k], solo[k]) for k in solo)


def test_population_checkpoint_refuses_another_size(tmp_path):
    """A P = 2 checkpoint restored into a solo template or a P = 3 one
    raises, naming ``population.size`` (another size is item 12)."""
    cfg = _tiny(population={"size": 2})
    exp = Experiment.build(cfg, device="cpu")
    pts, spec = pop.init_population(exp, cfg)
    d = ckpt.save_checkpoint(str(tmp_path), 12, pop.PopState(pts, spec))
    with pytest.raises(ValueError, match="population.size=2"):
        ckpt.load_checkpoint(d, exp.init_state(0))
    cfg3 = _tiny(population={"size": 3})
    exp3 = Experiment.build(cfg3, device="cpu")
    with pytest.raises(ValueError, match="item 12"):
        ckpt.load_checkpoint(d, pop.PopState(*pop.init_population(exp3,
                                                                  cfg3)))
