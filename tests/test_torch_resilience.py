"""The port's fault-tolerance layer on the CPU (``t2omca_tpu_torch.utils.
{checkpoint, resilience, watchdog, stats}``, ``obs/{spans, memwatch}.py``
and the driver's use of them), mirroring the host cases of
``tests/test_resilience.py`` and ``tests/test_watchdog.py``:

* crash-safe checkpoints: ``find_checkpoint`` edge cases, skip-back over
  a truncated or bit-flipped top step, a crash mid-save, a torn write
  that still got published, a re-save of one step, retention, the
  obs-layout mismatch naming the flag, the model-only restore's check;
* the non-finite guard's escalation end to end (restore, and abort
  with a diagnosis when no checkpoint exists);
* preemption: ``ShutdownGuard`` on a real signal, SIGTERM in-process
  (emergency checkpoint, orderly return) and in a subprocess (exit 0);
* the watchdog: an injected stall fires it, writes
  ``stall_diagnosis.json`` with the flight tail, trips the guard and
  saves the stamped state; its unit behaviour on millisecond timeouts;
* ``StatsAccumulator`` folds and flushes the numbers the JAX
  accumulator does on the same ``RolloutStats``, fetch counts included.

The driver runs at ``tests/test_driver.py``'s tiny config (3 AGVs, 2
lanes of 6 steps, ring 8) on ``device="cpu"``.
"""

import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.runners.parallel_runner import RolloutStats as JaxStats
from t2omca_tpu.utils.stats import StatsAccumulator as JaxAccumulator
from t2omca_tpu_torch.config import from_dict, load_config
from t2omca_tpu_torch.obs import memwatch, spans
from t2omca_tpu_torch.run import Experiment, _NonFiniteEscalation, run
from t2omca_tpu_torch.runners.parallel_runner import RolloutStats
from t2omca_tpu_torch.utils import resilience, watchdog
from t2omca_tpu_torch.utils.checkpoint import (CheckpointIntegrityError,
                                               find_checkpoint,
                                               flatten_state,
                                               load_checkpoint,
                                               load_learner_state,
                                               prune_checkpoints, read_meta,
                                               save_checkpoint,
                                               verify_checkpoint)
from t2omca_tpu_torch.utils.logging import Logger
from t2omca_tpu_torch.utils.stats import np_sum_f32

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _no_fault_leaks():
    """Every test starts and ends with an empty injector registry."""
    resilience.clear_faults()
    yield
    resilience.clear_faults()


def tiny(path, **kw):
    d = dict(t_max=60, batch_size_run=2, batch_size=4, test_interval=24,
             test_nepisode=2, log_interval=12, runner_log_interval=12,
             save_model=True, save_model_interval=12,
             local_results_path=str(path), use_tensorboard=False,
             epsilon_anneal_time=50,
             env_args=dict(agv_num=3, mec_num=2, num_channels=2,
                           episode_limit=6),
             model=dict(emb=8, heads=2, depth=1, mixer_emb=8,
                        mixer_heads=2, mixer_depth=1),
             replay=dict(buffer_size=8))
    for key, val in kw.items():
        if isinstance(val, dict):
            d.setdefault(key, {}).update(val)
        else:
            d[key] = val
    return from_dict(d)


def _run(path, **kw):
    return run(tiny(path, **kw), Logger(), device="cpu")


@pytest.fixture(scope="module")
def tiny_state(tmp_path_factory):
    exp = Experiment.build(tiny(tmp_path_factory.mktemp("st")), "cpu")
    return exp, exp.init_state(0)


def _save_steps(tmp_path, tiny_state, steps):
    _, ts = tiny_state
    root = str(tmp_path / "ckpt")
    for s in steps:
        save_checkpoint(root, s, ts)
    return root


# ---------------------------------------------------------------------------
# find_checkpoint and the on-disk format
# ---------------------------------------------------------------------------

def test_find_checkpoint_empty_and_missing_dir(tmp_path):
    assert find_checkpoint(str(tmp_path / "nope")) is None
    (tmp_path / "empty").mkdir()
    assert find_checkpoint(str(tmp_path / "empty")) is None


def test_find_checkpoint_ignores_non_numeric_entries(tmp_path, tiny_state):
    root = _save_steps(tmp_path, tiny_state, [10, 20])
    os.makedirs(os.path.join(root, "tmp.30"))
    os.makedirs(os.path.join(root, "notes"))
    open(os.path.join(root, "40"), "w").close()        # a file, not a dir
    assert find_checkpoint(root) == (os.path.join(root, "20"), 20)


def test_load_step_nearest_tie_prefers_smaller_step(tmp_path, tiny_state):
    root = _save_steps(tmp_path, tiny_state, [10, 20, 30])
    assert find_checkpoint(root, load_step=15)[1] == 10
    assert find_checkpoint(root, load_step=26)[1] == 30
    assert find_checkpoint(root, load_step=1000)[1] == 30


def test_checkpoint_layout_and_host_values(tmp_path, tiny_state):
    """``state.pt`` + ``meta.json``: CPU tensors under dotted paths, the
    host values the tensors do not carry, the digest and layout."""
    exp, ts = tiny_state
    ts = dataclasses.replace(ts, episode=6, buffer=dataclasses.replace(
        ts.buffer, insert_pos=5, episodes_in_buffer=7))
    d = save_checkpoint(str(tmp_path / "c"), 12, ts,
                        driver={"key": [1, 2]})
    assert sorted(os.listdir(d)) == ["meta.json", "state.pt"]
    meta = read_meta(d)
    assert meta["obs_layout"] == "compact" and meta["bytes"] > 0
    assert meta["host"]["buffer.insert_pos"] == 5
    assert meta["host"]["buffer.episodes_in_buffer"] == 7
    assert meta["host"]["episode"] == 6 and meta["driver"] == {"key": [1, 2]}
    flat = torch.load(os.path.join(d, "state.pt"), weights_only=True)
    assert "buffer.storage.obs.rows" in flat and "runner.key" in flat
    assert all(v.device.type == "cpu" for v in flat.values())
    restored = load_checkpoint(d, exp.init_state(1))
    assert (restored.episode, restored.buffer.insert_pos,
            restored.buffer.episodes_in_buffer) == (6, 5, 7)
    a, _ = flatten_state(ts)
    b, _ = flatten_state(restored)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_truncated_top_checkpoint_skips_back(tmp_path, tiny_state):
    root = _save_steps(tmp_path, tiny_state, [10, 20])
    path = os.path.join(root, "20", "state.pt")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert not verify_checkpoint(os.path.join(root, "20"))
    assert find_checkpoint(root) == (os.path.join(root, "10"), 10)


def test_bitflip_detected_by_checksum_and_skipped(tmp_path, tiny_state):
    root = _save_steps(tmp_path, tiny_state, [10, 20])
    path = os.path.join(root, "20", "state.pt")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x10]))
    assert find_checkpoint(root)[1] == 10


def test_corrupt_checkpoint_direct_load_raises_integrity(tmp_path,
                                                         tiny_state):
    exp, _ = tiny_state
    root = _save_steps(tmp_path, tiny_state, [10])
    path = os.path.join(root, "10", "state.pt")
    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    with pytest.raises(CheckpointIntegrityError, match="integrity"):
        load_checkpoint(os.path.join(root, "10"), exp.init_state(0))


def test_crash_mid_save_leaves_previous_checkpoint_usable(tmp_path,
                                                          tiny_state):
    exp, ts = tiny_state
    root = _save_steps(tmp_path, tiny_state, [10])

    def crash(dirname, t_env):
        raise RuntimeError("injected crash mid-save")

    resilience.register_fault("checkpoint.staged", crash)
    with pytest.raises(RuntimeError, match="mid-save"):
        save_checkpoint(root, 20, ts)
    resilience.clear_faults()
    assert os.path.isdir(os.path.join(root, "tmp.20"))
    assert find_checkpoint(root) == (os.path.join(root, "10"), 10)
    load_checkpoint(os.path.join(root, "10"), exp.init_state(0))
    prune_checkpoints(root, keep_last=5)
    assert not os.path.exists(os.path.join(root, "tmp.20"))


def test_torn_but_published_write_caught_by_checksum(tmp_path, tiny_state):
    _, ts = tiny_state
    root = _save_steps(tmp_path, tiny_state, [10])

    def tear(dirname, t_env):
        path = os.path.join(dirname, "state.pt")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 7)

    resilience.register_fault("checkpoint.staged", tear)
    save_checkpoint(root, 20, ts)            # published despite the tear
    assert os.path.isdir(os.path.join(root, "20"))
    assert find_checkpoint(root)[1] == 10


def test_resave_same_step_replaces_published_dir(tmp_path, tiny_state):
    exp, ts = tiny_state
    root = _save_steps(tmp_path, tiny_state, [10])
    ts2 = dataclasses.replace(ts, episode=99)
    save_checkpoint(root, 10, ts2)
    assert sorted(os.listdir(root)) == ["10"]
    assert load_checkpoint(os.path.join(root, "10"),
                           exp.init_state(0)).episode == 99


def test_retention_keeps_last_k_and_every_nth(tmp_path, tiny_state):
    root = _save_steps(tmp_path, tiny_state, [10, 20, 30, 40, 50])
    removed = prune_checkpoints(root, keep_last=2, keep_every=20)
    assert sorted(removed) == [10, 30]
    assert sorted(int(n) for n in os.listdir(root)) == [20, 40, 50]


def test_layout_mismatch_names_the_flag(tmp_path, tiny_state):
    root = _save_steps(tmp_path, tiny_state, [10])       # compact storage
    dense = Experiment.build(tiny(tmp_path, replay=dict(
        compact_entity_store=False)), "cpu")
    with pytest.raises(ValueError, match="compact_entity_store=true"):
        load_checkpoint(os.path.join(root, "10"), dense.init_state(0))


def test_other_shapes_rejected_and_model_only_restore(tmp_path, tiny_state):
    """A checkpoint from 2 lanes: the full restore into 4 lanes names the
    leaf; the learner alone restores; another MODEL is refused."""
    _, ts = tiny_state
    root = _save_steps(tmp_path, tiny_state, [10])
    d = os.path.join(root, "10")
    wide = Experiment.build(tiny(tmp_path, batch_size_run=4), "cpu")
    with pytest.raises(ValueError, match="different config"):
        load_checkpoint(d, wide.init_state(0))
    restored = load_learner_state(d, wide.init_state(1))
    assert all(torch.equal(p, restored.learner.params["agent"][k])
               for k, p in ts.learner.params["agent"].items())
    big = Experiment.build(tiny(tmp_path, model=dict(emb=16,
                                                     mixer_emb=16)), "cpu")
    with pytest.raises(ValueError, match="different MODEL"):
        load_learner_state(d, big.init_state(0))


# ---------------------------------------------------------------------------
# the non-finite guard's escalation
# ---------------------------------------------------------------------------

def test_nan_injection_recovers_end_to_end(tmp_path):
    """A NaN at train step 2 trips the guard; the driver restores the
    newest checkpoint (saved the same iteration, so its train_steps is
    already past 2) and the run completes."""
    ts = _run(tmp_path, t_max=120,
              resilience=dict(inject_nan_at_step=2, nonfinite_tolerance=1,
                              max_restores=2))
    assert ts.runner.t_env > 120 and int(ts.learner.train_steps) > 3
    keys = set()
    for p in glob.glob(os.path.join(tmp_path, "*", "metrics.jsonl")):
        with open(p) as f:
            keys.update(json.loads(line)["key"] for line in f)
    assert "nonfinite_steps" in keys
    assert all(bool(torch.isfinite(v).all()) for sub in
               ts.learner.params.values() for v in sub.values())


def test_nan_without_checkpoint_aborts_with_diagnosis(tmp_path):
    with pytest.raises(_NonFiniteEscalation,
                       match="diverged.*no valid checkpoint"):
        _run(tmp_path, save_model=False,
             resilience=dict(inject_nan_at_step=0, nonfinite_tolerance=1))


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def test_shutdown_guard_latches_real_signal():
    prev = signal.getsignal(signal.SIGTERM)
    with resilience.ShutdownGuard.install() as guard:
        assert guard.installed and not guard.triggered
        signal.raise_signal(signal.SIGTERM)
        assert guard.triggered and guard.signame == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is prev


def test_sigterm_writes_emergency_checkpoint_and_returns(tmp_path):
    """A real SIGTERM mid-run: the loop breaks at the next dispatch
    boundary, writes one emergency checkpoint and returns normally."""

    def preempt(t_env, **_):
        if t_env >= 24:
            signal.raise_signal(signal.SIGTERM)

    resilience.register_fault("driver.iteration", preempt)
    ts = _run(tmp_path, t_max=100_000, save_model_interval=10_000)
    assert ts.runner.t_env == 24
    model_dir = glob.glob(os.path.join(tmp_path, "models", "*"))[0]
    dirname, step = find_checkpoint(model_dir)
    assert step == 24 and verify_checkpoint(dirname)
    exp = Experiment.build(tiny(tmp_path), "cpu")
    restored = load_checkpoint(dirname, exp.init_state(1))
    assert restored.episode == 4
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


_TRAIN = ("import sys; sys.path.insert(0, {repo!r}); "
          "from t2omca_tpu_torch.config import load_config; "
          "from t2omca_tpu_torch.run import run; "
          "from t2omca_tpu_torch.utils.logging import Logger; "
          "run(load_config(None, tuple(sys.argv[1:])), Logger(), "
          "device='cpu')")


def test_sigterm_subprocess_exits_zero(tmp_path):
    """SIGTERM to a training process (the CLI's body on the CPU): exit 0,
    a valid emergency checkpoint and the resume hint."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _TRAIN.format(repo=REPO),
         "t_max=1000000", "batch_size_run=2", "batch_size=4",
         "env_args.agv_num=3", "env_args.episode_limit=6",
         "model.emb=8", "model.heads=2", "model.depth=1",
         "model.mixer_emb=8", "model.mixer_heads=2", "model.mixer_depth=1",
         "replay.buffer_size=8", "test_interval=1000000",
         "log_interval=120", "runner_log_interval=120",
         "save_model_interval=1000000", f"local_results_path={tmp_path}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + 120
        for line in proc.stdout:
            if "t_env:" in line or time.time() > deadline:
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "resume with checkpoint_path=" in out
    model_dirs = glob.glob(os.path.join(tmp_path, "models", "*"))
    assert model_dirs and find_checkpoint(model_dirs[0]) is not None


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

def test_injected_stall_fires_watchdog_with_flight_tail(tmp_path):
    """A hang injected inside a warm rollout dispatch: the watchdog fires
    within its timeout, writes ``stall_diagnosis.json`` with the flight
    tail (the hanging span last), trips the guard and saves the stamped
    pre-dispatch state; the run then exits at the next boundary."""
    # the timeout has wide headroom over a warm tiny dispatch (tens of
    # ms, a few hundred on a loaded box); the hang dwarfs it
    hang_s, hung = 6.0, []

    def hang(t_env, **_):
        if t_env >= 24 and not hung:
            hung.append(t_env)
            time.sleep(hang_s)

    resilience.register_fault("dispatch.rollout", hang)
    ts = _run(tmp_path, t_max=120, save_model_interval=10_000,
              obs=dict(enabled=True),
              resilience=dict(dispatch_timeout=2.0, stall_grace_s=0.0))
    assert hung == [24] and ts.runner.t_env == 36
    model_dir = glob.glob(os.path.join(tmp_path, "models", "*"))[0]
    with open(os.path.join(model_dir, "stall_diagnosis.json")) as f:
        diag = json.load(f)
    assert diag["phase"] == "dispatch.rollout" and diag["t_env"] == 24
    assert 2.0 <= diag["elapsed_s"] < hang_s
    assert diag["backend"] == "cpu"
    last = diag["recent_spans"][-1]
    assert last["phase"] == "dispatch.rollout" and last["open"] is True
    steps = sorted(int(n) for n in os.listdir(model_dir) if n.isdigit())
    # the save cadence's first save, the stall's, the exit's
    assert steps == [12, 24, 36]
    assert all(verify_checkpoint(os.path.join(model_dir, str(s)))
               for s in steps)


def test_watchdog_fires_once_per_stamp_with_diagnosis():
    fired = []
    wd = watchdog.Watchdog(0.05, on_stall=fired.append, backend="cpu",
                           first_timeout_s=0.05)
    with wd:
        with wd.watch("dispatch.train", t_env=7, state="s"):
            time.sleep(0.3)
        time.sleep(0.1)
    assert len(fired) == 1
    d = wd.take_diagnosis()
    assert (d.phase, d.t_env, d.backend) == ("dispatch.train", 7, "cpu")
    assert d.elapsed_s >= 0.05 and "dispatch.train" in d.message()


def test_watchdog_cleared_and_idle_never_fires():
    fired = []
    with watchdog.Watchdog(0.05, on_stall=fired.append) as wd:
        with wd.watch("dispatch.train"):
            pass
        time.sleep(0.2)
    assert fired == []


def test_watchdog_first_occurrence_is_exempt():
    """A phase's first occurrence is bounded only by first_timeout_s."""
    fired = []
    with watchdog.Watchdog(0.05, on_stall=fired.append) as wd:
        with wd.watch("dispatch.train"):
            time.sleep(0.2)               # cold: exempt
        assert fired == []
        with wd.watch("dispatch.train"):
            time.sleep(0.2)               # warm: fires
        time.sleep(0.05)
    assert len(fired) == 1


def test_watchdog_hard_exit_after_grace():
    exits = []
    wd = watchdog.Watchdog(0.05, grace_s=0.1, exit_code=17,
                           first_timeout_s=0.05, _exit=exits.append).start()
    try:
        with wd.watch("dispatch.rollout"):
            time.sleep(0.5)
    finally:
        wd.stop()
    assert exits == [17]


def test_exit_deadline_fires_only_when_the_region_overruns():
    exits = []
    with watchdog.ExitDeadline(0.05, 17, _exit=exits.append):
        time.sleep(0.2)
    assert exits == [17]
    exits.clear()
    with watchdog.ExitDeadline(0.5, 17, _exit=exits.append):
        pass
    time.sleep(0.6)
    assert exits == []


def test_transient_classification_backoff_and_retry():
    assert watchdog.is_transient(ConnectionResetError("x"))
    assert watchdog.is_transient(RuntimeError("connection reset by peer"))
    assert not watchdog.is_transient(ValueError("shape mismatch"))
    assert not watchdog.is_transient(
        RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert watchdog.backoff_delay(3, 0.5, _random=lambda: 0.0) == 2.0
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TimeoutError("timed out")
        return "ok"

    assert watchdog.retry_call(flaky, attempts=3, sleep=sleeps.append) == "ok"
    assert len(sleeps) == 2
    with pytest.raises(ValueError):
        watchdog.retry_call(lambda: (_ for _ in ()).throw(ValueError("x")),
                            attempts=3, sleep=sleeps.append)
    assert watchdog.state_intact(object())


def test_degradation_ladder_rung_order():
    ladder = watchdog.DegradationLadder(max_restores=1)
    assert ladder.next_action(can_degrade=False) == "restore"
    assert ladder.next_action(can_degrade=False) == "abort"
    ladder = watchdog.DegradationLadder(max_restores=1)
    assert [ladder.next_action(True) for _ in range(3)] == \
        ["degrade", "restore", "abort"]


# ---------------------------------------------------------------------------
# telemetry: the span recorder and memwatch
# ---------------------------------------------------------------------------

def test_flight_recorder_tail_open_span_last_and_persist(tmp_path):
    rec = spans.SpanRecorder(ring_size=4,
                             jsonl_path=str(tmp_path / "spans.jsonl"))
    for i in range(6):
        with rec.span("dispatch.rollout", t_env=i):
            pass
    rec.mark("nonfinite", t_env=6)
    with rec.span("dispatch.train", t_env=7):
        tail = rec.tail()
        path = rec.persist(str(tmp_path / "flight.json"),
                           extra={"memwatch": {"supported": False}})
    assert len(tail) == 5 and tail[-1]["phase"] == "dispatch.train"
    assert tail[-1]["open"] is True and tail[-2]["kind"] == "nonfinite"
    with open(path) as f:
        payload = json.load(f)
    assert payload["version"] == 1 and "memwatch" in payload
    rec.close()
    with open(tmp_path / "spans.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert len(events) == 8 and events[0]["first"] is True
    assert spans.make_recorder(None) is spans.NULL_RECORDER
    assert spans.NULL_RECORDER.tail() == []


def test_memwatch_reports_unsupported_on_cpu_and_attributes_peaks():
    cfg = load_config(overrides=("obs.enabled=true", "obs.memwatch=true"))
    mw = memwatch.make_memwatch(cfg.obs)
    assert mw.enabled and mw.snapshot("startup") is None
    assert mw.report()["supported"] is False
    assert memwatch.make_memwatch(load_config().obs) is memwatch.NULL_MEMWATCH
    stats = {"allocated_bytes.all.current": 10,
             "allocated_bytes.all.peak": 50, "allocation.all.allocated": 3}
    fake = memwatch.MemWatch(_devices=lambda: [(0, lambda: dict(stats))])
    fake.snapshot("startup", t_env=0)
    stats["allocated_bytes.all.peak"] = 90
    fake.snapshot("checkpoint.save", t_env=12)
    dev = fake.report()["devices"]["0"]
    assert fake.report()["supported"] is True
    assert (dev["bytes_in_use"], dev["peak_bytes_in_use"]) == (10, 90)
    assert (dev["high_water_phase"], dev["high_water_t_env"]) == \
        ("checkpoint.save", 12)


# ---------------------------------------------------------------------------
# the stats accumulator against JAX's
# ---------------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.rows = []

    def log_stat(self, key, value, t):
        self.rows.append((key, value, t))


_FIELDS = [f.name for f in dataclasses.fields(RolloutStats)]


def _stats(rng, shape, eps):
    vals = {k: (rng.standard_normal(shape)
                * 10.0 ** rng.integers(-2, 4, shape)).astype(np.float32)
            for k in _FIELDS if k not in ("epsilon", "scenario")}
    vals["episode_limit"] = np.ones(shape, np.float32)
    scenario = np.zeros(shape, np.int32)
    eps = np.asarray(eps, np.float32)
    port = RolloutStats(**{k: torch.from_numpy(v) for k, v in vals.items()},
                        epsilon=torch.from_numpy(eps),
                        scenario=torch.from_numpy(scenario))
    jax_ = JaxStats(**{k: jnp.asarray(v) for k, v in vals.items()},
                    epsilon=jnp.asarray(eps), scenario=jnp.asarray(scenario))
    return port, jax_


def test_stats_fold_and_flush_match_jax_accumulator():
    """Rollout pushes of (B,) and stacked (K, B) stats, a fold forced by
    FOLD_EVERY, the runner-log flush with epsilon and a test-prefixed
    flush: the same rows, values and fetch counts as JAX's accumulator."""
    from t2omca_tpu_torch.utils.stats import StatsAccumulator
    rng = np.random.default_rng(0)
    ours, theirs = StatsAccumulator(), JaxAccumulator()
    sink_o, sink_t = _Sink(), _Sink()
    pushes = [((1024,), 0.5), ((4, 1024), [0.5, 0.4, 0.3, 0.2]),
              ((37,), 0.25)] + [((3,), 0.1)] * 70
    for i, (shape, eps) in enumerate(pushes):
        p, j = _stats(rng, shape, eps)
        ours.push(p)
        theirs.push(j)
        if i in (2, 72):
            ours.flush(sink_o, i)
            theirs.flush(sink_t, i)
            sink_o.log_stat("epsilon", ours.epsilon, i)
            sink_t.log_stat("epsilon", theirs.epsilon, i)
    p, j = _stats(rng, (8,), 0.0)
    ours.push(p)
    theirs.push(j)
    assert ours.n_episodes == theirs.n_episodes == 8
    ours.flush(sink_o, 99, prefix="test_")
    theirs.flush(sink_t, 99, prefix="test_")
    assert sink_o.rows == sink_t.rows
    assert len(sink_o.rows) == 3 * 10 + 2     # + the two epsilons
    assert ours.fetches == theirs.fetches == 4


@pytest.mark.parametrize("n", [1, 7, 8, 129, 1024, 4096, 8193])
def test_np_sum_f32_is_numpys_sum(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n))
         * 10.0 ** rng.integers(-3, 5, (3, n))).astype(np.float32)
    got = np_sum_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.array([np.sum(r) for r in x]))
