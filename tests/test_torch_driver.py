"""Port parity of the training driver (``t2omca_tpu_torch.run.run``, the
classic ``run_sequential``, ``evaluate_sequential`` and the CLI) against
the JAX package's ``run`` on the same config, plus the port's own exact
resume.

The config is ``tests/test_driver.py``'s ``tiny_cfg`` (3 AGVs, 2 MECs,
emb 8, depth 1, a ring of 8, 2 lanes of 6 steps; the default stack:
entity tables, compact storage). The port's initial learner params are
carried across from JAX's ``init_train_state(seed)`` with
``convert.learner_params_from_flax`` through ``run``'s
``learner_params`` argument; everything else (runner state, key chain,
replay) the port draws itself from the same seed.

What is held, and how tightly:

* the set of ``(key, t)`` rows of ``metrics.jsonl`` equals JAX's, at
  ``superstep`` 1 and 2;
* every rollout-side value from before the first train step is equal
  exactly (the env, the runner, the stats fold and the epsilon schedule
  are bit-exact): the rows logged before it, and the training rollouts'
  rows logged with it;
* the first train step's ``loss`` / ``td_error_abs`` / ``q_taken_mean``
  / ``target_mean`` at ``tests/test_torch_loop.py``'s ``INFO``
  tolerance (rtol 1e-5, atol 1e-6) and ``grad_norm`` at its rtol 1e-4;
* later rows are only required to be finite: the two learners drift
  apart free-running (float32 lowerings of one train step differ by
  ~5e-4 relative in the mixer's gradients, ROADMAP.md Queue C), and so
  do the rollouts acting on their params. The largest later difference
  seen (this seed): grad_norm 7.7e-4 relative, at superstep 1.

Wall-clock rows (``time_*_ms``, ``env_steps_per_sec``) are compared by
key and ``t`` only.
"""

import glob
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu.run import run as jax_run
from t2omca_tpu.utils.logging import Logger as JaxLogger
from t2omca_tpu_torch import __main__ as cli
from t2omca_tpu_torch.config import from_dict, load_config
from t2omca_tpu_torch.convert import learner_params_from_flax
from t2omca_tpu_torch.run import run
from t2omca_tpu_torch.utils.checkpoint import (find_checkpoint,
                                               flatten_state)
from t2omca_tpu_torch.utils import resilience
from t2omca_tpu_torch.utils.logging import Logger
from test_torch_threads import one_intra_op_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(
    one_intra_op_thread)

LEARNER_KEYS = ("loss", "grad_norm", "td_error_abs", "q_taken_mean",
                "target_mean")
INFO = dict(rtol=1e-5, atol=1e-6)          # tests/test_torch_loop.py
GRAD_NORM = dict(rtol=1e-4, atol=1e-6)


def tiny(path, **kw):
    """``tests/test_driver.py``'s ``tiny_cfg`` as a dict."""
    d = dict(t_max=60, batch_size_run=2, batch_size=4, test_interval=24,
             test_nepisode=2, log_interval=12, runner_log_interval=12,
             save_model=True, save_model_interval=24,
             local_results_path=str(path), use_tensorboard=False,
             epsilon_anneal_time=50,
             env_args=dict(agv_num=3, mec_num=2, num_channels=2,
                           episode_limit=6),
             model=dict(emb=8, heads=2, depth=1, mixer_emb=8,
                        mixer_heads=2, mixer_depth=1),
             replay=dict(buffer_size=8))
    d.update(kw)
    return d


def rows_of(root):
    """``{(key, t): value}`` of every metrics.jsonl under ``root``."""
    out = {}
    for p in glob.glob(os.path.join(str(root), "*", "metrics.jsonl")):
        with open(p) as f:
            for line in f:
                r = json.loads(line)
                assert (r["key"], r["t"]) not in out, r
                out[(r["key"], r["t"])] = r["value"]
    return out


def wall_clock(key):
    return key.startswith("time_") or key == "env_steps_per_sec"


@pytest.fixture(scope="module")
def flax_params(tmp_path_factory):
    cfg = jax_from_dict(tiny(tmp_path_factory.mktemp("init")))
    ts = JaxExperiment.build(cfg).init_train_state(cfg.seed)
    return jax.tree.map(np.asarray, ts.learner.params)


SIGHT = {"obs": {"sight": {"enabled": True}}}


@pytest.fixture(scope="module")
def both(tmp_path_factory, flax_params):
    """(superstep, sight) → (JAX rows, port rows, the port's final state,
    JAX's final ``t_env``), each pair of runs made once."""
    cache = {}

    def get(superstep, sight=False):
        if (superstep, sight) not in cache:
            root = tmp_path_factory.mktemp(f"k{superstep}")
            jdir, tdir = root / "jax", root / "port"
            kw = dict(superstep=superstep, **(SIGHT if sight else {}))
            jts = jax_run(jax_from_dict(tiny(jdir, **kw)), JaxLogger())
            ts = run(from_dict(tiny(tdir, **kw)), Logger(),
                     device="cpu", learner_params=learner_params_from_flax(
                         flax_params, "cpu"))
            cache[superstep, sight] = (rows_of(jdir), rows_of(tdir), ts,
                                       int(jts.runner.t_env))
        return cache[superstep, sight]

    return get


@pytest.mark.parametrize("superstep", [1, 2])
def test_metrics_rows_match_jax_driver(both, superstep):
    """The same ``(key, t)`` rows; exact values for what the rollouts
    made before the first train step (every row logged before it, and
    the training rollouts' rows logged with it: the train gate opens in
    the second iteration, after its rollout); finite values after it."""
    rj, rt, ts, jax_t_env = both(superstep)
    assert set(rt) == set(rj)
    first_train = min(t for (k, t) in rj if k == "loss")
    assert first_train == 24             # the ring holds 4 episodes at 24
    early = [k for k in rj if not wall_clock(k[0]) and (
        k[1] < first_train or k[1] == first_train
        and not k[0].startswith("test_") and k[0] not in LEARNER_KEYS)]
    assert len(early) > 10 and ("return_mean", 24) in early
    for k in early:
        assert rt[k] == rj[k], (k, rt[k], rj[k])
    for k, v in rt.items():
        assert np.isfinite(v), (k, v)
    # test rollouts leave the runner's t_env where training put it, in
    # both packages
    assert ts.runner.t_env == jax_t_env == 72
    assert int(ts.learner.train_steps) > 0


def test_first_train_step_matches_jax(both):
    """At superstep 1 the first logged train step is the first train
    step: its learner values at ``test_torch_loop.py``'s tolerances."""
    rj, rt, _, _ = both(1)
    for k in LEARNER_KEYS:
        tol = GRAD_NORM if k == "grad_norm" else INFO
        np.testing.assert_allclose(rt[(k, 24)], rj[(k, 24)], err_msg=k,
                                   **tol)


SIGHT_KEYS = {f"sight_{k}" for k in (
    "grad_norm_agent_tf", "grad_norm_embed", "grad_norm_mixer",
    "update_norm_agent_tf", "update_norm_embed", "update_norm_mixer",
    "per_ess", "target_drift", "td_hist", "q_taken_hist", "target_hist",
    "attn_entropy_agent", "attn_entropy_mixer", "priority_entropy",
    "priority_entropy_norm")}


@pytest.mark.parametrize("superstep", [1, 2])
def test_sight_rows_match_jax_driver(both, superstep):
    """With ``obs.sight`` on: the same ``(key, t)`` rows as JAX's driver
    (the sight_* stats at every log cadence that follows a train step,
    the detectors' ``sight_alert_*`` transitions), every value finite,
    histograms summing to 1 and entropies in [0, 1]. At superstep 1 the
    first train step's sight values agree with JAX's as in
    ``tests/test_torch_sight.py``'s train-step case: the norms at
    ``grad_norm``'s rtol 1e-4, the others at the info tolerance, the
    histograms within one masked element (of 4·6 steps, times 3 agents
    for the chosen Qs) moved."""
    rj, rt, _, _ = both(superstep, sight=True)
    assert set(rt) == set(rj)
    keys = {k for k, _ in rt if k.startswith("sight_")}
    assert keys - {k for k in keys if k.startswith("sight_alert_")} \
        == SIGHT_KEYS
    for (k, t), v in rt.items():
        assert np.all(np.isfinite(v)), (k, t)
        if k.endswith("_hist"):
            assert len(v) == 16 and abs(sum(v) - 1.0) < 1e-5, (k, t)
        elif k.startswith("sight_attn_entropy"):
            assert len(v) == 1 and 0.0 <= v[0] <= 1.0 + 1e-6, (k, t)
    if superstep != 1:
        return
    for k in sorted(SIGHT_KEYS):
        got, want = np.asarray(rt[(k, 24)]), np.asarray(rj[(k, 24)])
        if k.endswith("_hist"):
            total = 4 * 6 * (3 if "q_taken" in k else 1)
            assert np.abs(got - want).sum() * total <= 2.0 + 1e-3, k
        elif "_norm_" in k:
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **INFO)


def _run_port(path, **kw):
    return run(from_dict(tiny(path, **kw)), Logger(), device="cpu")


def test_sight_adds_no_stat_fetch(tmp_path):
    """Spans on (so ``stat_fetches`` is logged): the blocking stat
    round trips are the same with ``obs.sight`` on and off, and so is
    every row the run writes but the sight_* ones."""
    rows = {}
    for on in (False, True):
        _run_port(tmp_path / str(on), obs=dict(
            enabled=True, sight=dict(enabled=on)))
        rows[on] = {k: v for k, v in rows_of(tmp_path / str(on)).items()
                    if not wall_clock(k[0])}
    fetches = lambda r: {k: v for k, v in r.items()
                         if k[0] == "stat_fetches"}
    assert fetches(rows[True]) == fetches(rows[False])
    assert len(fetches(rows[False])) > 3
    assert {k: v for k, v in rows[True].items()
            if not k[0].startswith("sight_")} == rows[False]


def test_resume_is_bit_exact(tmp_path):
    """2N dispatches straight against N, a checkpoint, a fresh ``run``
    from it and N more: the final state (params, Adam, the ring and its
    priorities and cursor, the runner's envs and key) and every logged
    value are bit-identical. The first run is stopped by its shutdown
    guard at t_env 36 (the same ``t_max``: PER's beta anneals over it)
    and leaves its emergency checkpoint there. Every cadence fires every
    dispatch, so the resumed run's first cadences (which JAX starts one
    interval back) line up with the straight run's."""
    every = dict(test_interval=12, log_interval=12, runner_log_interval=12,
                 save_model_interval=1000)
    straight = _run_port(tmp_path / "straight", t_max=60, **every)

    def stop(t_env, guard, **_):
        if t_env >= 36:
            guard.request("test")

    resilience.register_fault("driver.iteration", stop)
    try:
        _run_port(tmp_path / "first", t_max=60, **every)
    finally:
        resilience.clear_faults()
    model_dir = glob.glob(str(tmp_path / "first" / "models" / "*"))[0]
    assert find_checkpoint(model_dir)[1] == 36
    resumed = _run_port(tmp_path / "second", t_max=60,
                        checkpoint_path=model_dir, **every)
    a, ha = flatten_state(straight)
    b, hb = flatten_state(resumed)
    assert ha == hb and set(a) == set(b)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert differ == []
    # the ring cursor, its fill and the episode counter are device tensors
    assert int(a["buffer.insert_pos"]) == 12 % 8
    assert int(b["episode"]) == 12 and int(b["buffer.episodes_in_buffer"]) == 8
    rs = rows_of(tmp_path / "straight")
    rr = {**rows_of(tmp_path / "first"), **rows_of(tmp_path / "second")}
    keep = lambda rows: {k: v for k, v in rows.items()
                         if not wall_clock(k[0])}
    assert keep(rr) == keep(rs)


def _saved(model_dir):
    """The newest checkpoint's tensors."""
    dirname, _ = find_checkpoint(model_dir)
    return torch.load(os.path.join(dirname, "state.pt"), weights_only=True)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger():
    h = _Lines()
    log = logging.getLogger(f"t2omca-test-{id(h)}")
    log.addHandler(h)
    log.setLevel(logging.INFO)
    log.propagate = False
    return Logger(console_logger=log), h.lines


def test_evaluate_restores_full_state_and_exports(tmp_path):
    """evaluate + benchmark from a training checkpoint: the full-state
    restore at the training config, replays (every
    ``animation_interval_evaluation``-th episode) and benchmark.csv."""
    _run_port(tmp_path / "train")
    model_dir = glob.glob(str(tmp_path / "train" / "models" / "*"))[0]
    saved = _saved(model_dir)
    logger, lines = _logger()
    ts = run(from_dict(tiny(tmp_path / "eval", evaluate=True,
                            save_replay=True, benchmark_mode=True,
                            test_nepisode=2,
                            animation_interval_evaluation=2,
                            checkpoint_path=model_dir)),
             logger, device="cpu")
    assert any("loaded full state" in x for x in lines)
    restored, _ = flatten_state(ts)
    assert set(restored) == set(saved)
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    replays = glob.glob(str(tmp_path / "eval" / "*" /
                            "replay_episode_*.npz"))
    assert [os.path.basename(p) for p in replays] == ["replay_episode_0.npz"]
    data = np.load(replays[0])
    assert data["pos"].shape == (6, 3, 2)
    assert set(data) >= {"mec_index", "acks", "reward", "actions",
                         "deadline_miss_rate", "mec_positions"}
    with open(glob.glob(str(tmp_path / "eval" / "*" /
                            "benchmark.csv"))[0]) as f:
        table = f.read().strip().splitlines()
    assert table[0].split(",")[:3] == ["episode", "return", "delay_reward"]
    assert len(table) == 3
    rows = rows_of(tmp_path / "eval")
    assert list(rows) == [("test_return_mean", 0)]
    assert np.isfinite(rows[("test_return_mean", 0)])


def test_evaluate_falls_back_to_the_model_under_other_lanes(tmp_path):
    """A checkpoint from 2 lanes evaluated at 4: the full-state restore is
    rejected and the learner alone is restored (reference semantics)."""
    _run_port(tmp_path / "train")
    model_dir = glob.glob(str(tmp_path / "train" / "models" / "*"))[0]
    saved = _saved(model_dir)
    logger, lines = _logger()
    ts = run(from_dict(tiny(tmp_path / "eval", evaluate=True,
                            batch_size_run=4, test_nepisode=4,
                            checkpoint_path=model_dir)),
             logger, device="cpu")
    assert any("full-state restore rejected" in x for x in lines)
    assert any("model-only" in x for x in lines)
    learner, _ = flatten_state(ts.learner)
    assert all(torch.equal(v, saved["learner." + k])
               for k, v in learner.items())
    assert ts.runner.env_states.pos.shape[0] == 4


def test_benchmark_command_sets_evaluate_and_csv(monkeypatch, tmp_path):
    """The CLI parses ``--config`` and overrides into the same config
    ``load_config`` builds; ``evaluate`` and ``benchmark`` set their
    flags."""
    seen = []
    monkeypatch.setattr(cli, "run",
                        lambda cfg, logger, device=None: seen.append(cfg))
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "config3_tpu_northstar.yaml")
    over = ["kernels.attention=pallas", "obs.sight.enabled=false",
            "obs.pulse_port=0", "t_max=1000", f"local_results_path={tmp_path}"]
    assert cli.main(["train", "--config", path, *over]) == 0
    assert cli.main(["benchmark", "--config", path, *over]) == 0
    assert cli.main(["evaluate", *over]) == 0
    train, bench, ev = seen
    assert train == load_config(path, tuple(over))
    assert train.batch_size_run == 1024 and train.superstep == 4
    assert train.kernels.attention == "pallas" and train.t_max == 1000
    assert not train.obs.sight.enabled and train.obs.pulse_port == 0
    assert not train.evaluate and bench.evaluate and bench.benchmark_mode
    assert ev.evaluate and not ev.benchmark_mode
    with pytest.raises(SystemExit):
        cli.main(["serve"])


def test_profile_dir_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    _run_port(tmp_path / "run", t_max=24, profile_dir=str(trace_dir),
              profile_start=0, profile_iterations=2)
    files = glob.glob(str(trace_dir / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]


def _overrides(d, prefix=""):
    """A config dict as the CLIs' ``key=value`` overrides."""
    out = []
    for k, v in d.items():
        if isinstance(v, dict):
            out += _overrides(v, f"{prefix}{k}.")
        else:
            out.append(f"{prefix}{k}={v}")
    return out


def _checkpoints(root, load):
    """``{t_env: {leaf: numpy}}`` of the run's checkpoints under ``root``,
    without what the params decide: the learner's leaves, PER's
    priorities, and what the greedy test rollouts touch (the env states
    and the normalizer they carry, and the obs statistics stored with
    it)."""
    out = {}
    for d in glob.glob(os.path.join(str(root), "models", "*", "*")):
        out[int(os.path.basename(d))] = {
            k: v for k, v in load(d).items()
            if not k.startswith(("learner.", "runner.env_states."))
            and "priorit" not in k
            and not k.startswith(("buffer.storage.obs.mean",
                                  "buffer.storage.obs.std"))}
    return out


def _jax_checkpoint(d):
    from flax import serialization
    with open(os.path.join(d, "state.msgpack"), "rb") as f:
        tree = serialization.msgpack_restore(f.read())

    def walk(x, pre):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from walk(v, f"{pre}{k}.")
        else:
            yield pre[:-1], np.asarray(x)
    return dict(walk(tree, ""))


def _port_checkpoint(d):
    sd = torch.load(os.path.join(d, "state.pt"), weights_only=False)
    return {k: v.numpy() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def test_driver_raises_for_what_is_not_ported(tmp_path):
    # the rbg PRNG is ported (ROADMAP item 14): a tiny run under
    # prng_impl=rbg through both CLIs. Epsilon held at 1 makes every
    # training action a random one, so the rollouts, their returns and
    # what the checkpoints hold of them do not depend on the two
    # packages' different initial params: they are equal bit for bit
    from t2omca_tpu.__main__ import main as jax_main
    kw = dict(prng_impl="rbg", epsilon_finish=1.0, t_max=48,
              save_model_interval=12)
    try:
        assert jax_main(["train", *_overrides(
            tiny(tmp_path / "jax", **kw))]) == 0
    finally:
        jax.config.update("jax_default_prng_impl", "threefry2x32")
        jax.clear_caches()
    assert cli.main(["train", "--device", "cpu", *_overrides(
        tiny(tmp_path / "port", **kw))]) == 0
    rj, rt = rows_of(tmp_path / "jax"), rows_of(tmp_path / "port")
    assert set(rt) == set(rj)
    returns = [k for k in rj if k[0] == "return_mean"]
    assert len(returns) >= 3
    for k in returns:
        assert rt[k] == rj[k], (k, rt[k], rj[k])
    cj = _checkpoints(tmp_path / "jax", _jax_checkpoint)
    ct = _checkpoints(tmp_path / "port", _port_checkpoint)
    assert set(ct) == set(cj) and len(cj) >= 3
    for t in cj:
        # the port keeps t_env on the host (meta.json), not a tensor
        assert set(cj[t]) - set(ct[t]) == {"runner.t_env"}, t
        assert ct[t]["runner.key"].shape == (4,)
        for k, v in ct[t].items():
            np.testing.assert_array_equal(v, cj[t][k], err_msg=f"{t} {k}")
    # obs.program_trace is ported: the classic loop's window of two
    # iterations attributes its programs' host ranges (the CPU) into
    # device_times.json and device_ms_<program> rows
    _run_port(tmp_path / "y", t_max=24, profile_dir=str(tmp_path / "tr"),
              profile_start=0, profile_iterations=2,
              obs=dict(enabled=True, program_trace=True))
    (path,) = glob.glob(str(tmp_path / "y" / "*" / "device_times.json"))
    with open(path) as f:
        progs = json.load(f)["programs"]
    assert {"rollout", "insert"} <= set(progs)
    assert all(p["events"] >= 1 and p["device_ms"] > 0
               for p in progs.values())
    rows = rows_of(tmp_path / "y")
    assert {f"device_ms_{p}" for p in progs} <= {k for k, _ in rows}
