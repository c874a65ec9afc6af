"""Port parity of the post-mortem readers and of per-program device time:
``obs/report.py``, ``obs/timeline.py``, ``obs/device_time.py`` and the
driver's run header.

* A cut config 6 run of the port on the CPU (``configs/
  config6_scenarios.yaml``: the four-family mixture, K = 2; lanes, T,
  ring and widths cut), recorded with ``obs.enabled``, ``obs.sight`` and
  ``obs.program_trace`` over a ``profile_dir`` window of one dispatch:
  its ``run`` mark equals JAX's for the same config (``scenario:
  "mixture"``), and it writes ``device_times.json`` and
  ``device_ms_<program>`` rows;
* ``report`` on the same run directory through JAX's ``report_main`` and
  the port's, with a given programs file: stdout, stderr and exit code
  byte-equal; likewise a synthetic directory with slice rows and its
  degraded forms (a torn tail, only the flight recorder, no
  ``device_times.json``, an empty ``metrics.jsonl``, a missing
  directory); without a programs file the port's budget columns read
  ``-`` and one line says so;
* ``timeline`` over the checked-in ``BENCH_r*.json`` and the run, table
  and ``--json``, byte-equal;
* ``parse_trace_device_times`` on a synthetic ``torch.profiler``-style
  trace: nested ranges, correlated kernels, two overlapping streams
  (union, not sum), the kernel rows, and the CPU's host fallback;
* the post-mortem modules import neither torch nor jax, and the copies
  they keep (family names, slice columns, audit shapes, the phase map,
  the programs loader, the program and kernel names) are pinned against
  their sources.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from t2omca_tpu.analysis import baseline as jax_baseline
from t2omca_tpu.analysis import registry as jax_registry
from t2omca_tpu.config import load_config as jax_load_config
from t2omca_tpu.obs import report as jax_report
from t2omca_tpu.obs import timeline as jax_timeline
from t2omca_tpu.run import run as jax_run
from t2omca_tpu.utils import resilience as jax_resilience
from t2omca_tpu.utils.logging import Logger as JaxLogger
from t2omca_tpu_torch.config import load_config
from t2omca_tpu_torch.envs.graftworld import FAMILY_NAMES
from t2omca_tpu_torch.obs import __main__ as obs_cli
from t2omca_tpu_torch.obs import device_time, report, timeline
from t2omca_tpu_torch.run import run
from t2omca_tpu_torch.utils.logging import Logger
from t2omca_tpu_torch.utils.stats import SLICE_KEYS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG6 = os.path.join(REPO, "configs", "config6_scenarios.yaml")
PROGRAMS_JSON = str(jax_baseline.DEFAULT_PROGRAMS)

#: config 6 cut: lanes, T, ring, widths and t_max; the mixture, the
#: padding and the mixer shape's form as shipped; K = 2
CUT = ("batch_size_run=8", "batch_size=8", "env_args.episode_limit=12",
       "replay.buffer_size=16", "model.emb=8", "model.mixer_emb=8",
       "superstep=2", "test_nepisode=8", "test_interval=192",
       "log_interval=192", "runner_log_interval=192", "t_max=400",
       "kernels.attention=pallas")


def _run_dir(root):
    dirs = [d for d in os.listdir(root) if not d.startswith("models")
            and os.path.isdir(os.path.join(root, d))]
    assert len(dirs) == 1, dirs
    return os.path.join(root, dirs[0])


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("report")
    cfg = load_config(CONFIG6, CUT + (
        f"local_results_path={root / 'res'}", "obs.sight.enabled=true",
        "obs.program_trace=true", f"profile_dir={root / 'trace'}",
        "profile_start=0", "profile_iterations=1"))
    run(cfg, Logger(), device="cpu")
    return _run_dir(root / "res"), root


def _run_mark(run_dir):
    with open(os.path.join(run_dir, "spans.jsonl")) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("kind") == "run":
                return {k: v for k, v in ev.items() if k != "t0"}
    raise AssertionError("no run mark")


class _Stop(Exception):
    pass


def test_run_header_scenario_matches_jax(port_run, tmp_path):
    """JAX's driver, stopped at its first iteration (its run mark is
    written before it), against the port's whole run."""
    def stop(**kw):
        raise _Stop()

    jax_resilience.register_fault("driver.iteration", stop)
    try:
        with pytest.raises(_Stop):
            jax_run(jax_load_config(CONFIG6, CUT + (
                f"local_results_path={tmp_path}",)), JaxLogger())
    finally:
        jax_resilience.clear_faults()
    want = _run_mark(_run_dir(tmp_path))
    got = _run_mark(port_run[0])
    assert got == want
    assert got["scenario"] == "mixture" and got["superstep"] == 2


def test_program_trace_writes_device_times(port_run):
    run_dir, root = port_run
    with open(os.path.join(run_dir, "device_times.json")) as f:
        dt = json.load(f)
    assert dt["version"] == 1
    progs = dt["programs"]
    # the window's one dispatch: the fused program's range, the CPU's
    # host durations (no kernel rows without a card)
    assert set(progs) == {"superstep"}, progs
    assert progs["superstep"]["events"] == 1
    assert progs["superstep"]["device_ms"] > 0
    assert progs["superstep"]["median_ms"] == progs["superstep"]["device_ms"]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        keys = {json.loads(line)["key"] for line in f}
    assert "device_ms_superstep" in keys
    assert any(k.startswith("slice") for k in keys)
    assert any(k.startswith("sight_") for k in keys)
    traces = os.listdir(root / "trace")
    assert len(traces) == 1 and traces[0].startswith("trace_")


# ---------------------------------------------------------------------------
# report: byte-equal to JAX's
# ---------------------------------------------------------------------------


def _captured(fn, *args, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(*args, **kw)
    return rc, out.getvalue(), err.getvalue()


def _synthetic(root, torn=False, spans=True, device=True, metrics=True,
               flight=False):
    """A run directory of the schemas the driver writes: a run header,
    dispatch and other spans (one an error), slice rows for three
    families (one return negative), device times with a trace-only
    kernel row."""
    os.makedirs(root, exist_ok=True)
    evs = [{"event": "mark", "kind": "run", "t_env": 0, "backend": "cuda",
            "batch_size_run": 32, "episode_limit": 150, "batch_size": 32,
            "superstep": 4, "population": 0, "scenario": "mixture"}]
    for i in range(3):
        evs.append({"event": "span", "phase": "dispatch.superstep",
                    "wall_ms": 1400.5 + 10 * i, "first": i == 0})
    evs += [{"event": "span", "phase": "dispatch.test", "wall_ms": 1826.0},
            {"event": "span", "phase": "checkpoint.save", "wall_ms": 12.25,
             "outcome": "error: OSError"},
            {"event": "span", "phase": "fetch.train_stats", "wall_ms": 0.5},
            {"event": "span", "phase": "dispatch.rollout", "open": True}]
    lines = [json.dumps(e) for e in evs]
    if torn:
        lines.append('{"event": "span", "phase": "dispa')
    if spans:
        with open(os.path.join(root, "spans.jsonl"), "w") as f:
            f.write("\n".join(lines) + "\n")
    if flight:
        with open(os.path.join(root, "flight_recorder.json"), "w") as f:
            json.dump({"events": evs[:4]}, f)
    if device:
        with open(os.path.join(root, "device_times.json"), "w") as f:
            json.dump({"version": 1, "t_env": 4800, "programs": {
                "superstep": {"device_ms": 1820.25, "events": 1,
                              "median_ms": 1820.25},
                "attn_pallas": {"device_ms": 90.5, "events": 2408,
                                "median_ms": 0.03},
                "attn_pallas_bwd": {"device_ms": 120.125, "events": 2400,
                                    "median_ms": 0.04}}}, f)
    if metrics is not None:
        rows = []
        if metrics:
            for fam, ret in ((0, 12.5), (1, -3.25), (3, 7.0)):
                for pre in ("", "test_"):
                    rows += [{"key": f"{pre}slice{fam}_n", "t": 4800,
                              "value": 8},
                             {"key": f"{pre}slice{fam}_return_mean",
                              "t": 4800, "value": ret},
                             {"key": f"{pre}slice{fam}_conflict_ratio_mean",
                              "t": 4800, "value": 0.125}]
            rows.append({"key": "loss", "t": 4800, "value": 0.5})
        with open(os.path.join(root, "metrics.jsonl"), "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))


@pytest.mark.parametrize("case", [
    "port_run", "synthetic", "torn_tail", "flight_only", "no_device_times",
    "empty_metrics", "missing_dir", "no_spans_no_flight"])
def test_report_byte_equal_to_jax(case, port_run, tmp_path):
    d = str(tmp_path / "run")
    if case == "port_run":
        d = port_run[0]
    elif case == "synthetic":
        _synthetic(d)
    elif case == "torn_tail":
        _synthetic(d, torn=True)
    elif case == "flight_only":
        _synthetic(d, spans=False, device=False, metrics=None, flight=True)
    elif case == "no_device_times":
        _synthetic(d, device=False)
    elif case == "empty_metrics":
        _synthetic(d, metrics=False)
    elif case == "no_spans_no_flight":
        _synthetic(d, spans=False)
    got = _captured(report.report_main, d, PROGRAMS_JSON, 989000.0, 3350.0)
    want = _captured(jax_report.report_main, d, PROGRAMS_JSON, 989000.0,
                     3350.0)
    assert got == want
    if case in ("missing_dir", "no_spans_no_flight"):
        assert got[0] == 2
    else:
        assert got[0] == 0
    if case == "port_run":
        out = got[1]
        assert "superstep" in out and "dispatch.superstep" in out
        assert "scenario slices (train" in out
        assert "graftsight learning report" in out
    if case == "synthetic":
        assert "attn_pallas_bwd" in got[1] and "hetfleet" in got[1]
    assert _captured(obs_cli.main, ["report", d, "--programs-json",
                                    PROGRAMS_JSON, "--peak-gflops",
                                    "989000", "--peak-gbps", "3350"]) == got


def test_report_without_programs_json_renders_dashes(tmp_path):
    d = str(tmp_path / "run")
    _synthetic(d)
    rc, out, _ = _captured(report.report_main, d)
    assert rc == 0
    assert "budgets: none given (--programs-json" in out
    row = next(line for line in out.splitlines()
               if line.startswith("superstep"))
    assert row.split()[-4:] == ["-", "-", "-", "-"]
    rc2, out2, _ = _captured(jax_report.report_main, d, PROGRAMS_JSON)
    assert out2.splitlines()[:4] == out.splitlines()[:4]


# ---------------------------------------------------------------------------
# timeline: byte-equal to JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("as_json", [False, True], ids=["table", "json"])
def test_timeline_byte_equal_to_jax(as_json, port_run, tmp_path,
                                    monkeypatch):
    torn = tmp_path / "torn"
    torn.mkdir()
    (torn / "metrics.jsonl").write_text(
        '{"key": "env_steps_per_sec", "t": 96, "value": 123.5}\n{"key"')
    runs = [port_run[0], str(torn), str(tmp_path / "nothing")]
    monkeypatch.chdir(REPO)
    for paths, rs in (([], []), ([], runs),
                      (sorted(p for p in os.listdir(REPO)
                              if p.startswith("BENCH_r")), runs)):
        got = _captured(timeline.timeline_main, paths, rs, as_json=as_json)
        want = _captured(jax_timeline.timeline_main, paths, rs,
                         as_json=as_json)
        assert got == want
        assert got[0] == 0 and got[1]
    argv = ["timeline", "--runs", *runs] + (["--json"] if as_json else [])
    assert _captured(obs_cli.main, argv) == _captured(
        jax_timeline.timeline_main, [], runs, as_json=as_json)
    monkeypatch.chdir(tmp_path)
    assert _captured(timeline.timeline_main, [], []) == _captured(
        jax_timeline.timeline_main, [], [])


# ---------------------------------------------------------------------------
# device time from a torch.profiler-style trace
# ---------------------------------------------------------------------------


def _x(name, cat, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def test_parse_trace_device_times_synthetic(tmp_path):
    """Host thread 1: a superstep range (0..100) holding a rollout range
    (10..40); thread 2: a serve_step range. Kernels on two streams of
    device 0 overlap, so a program's union is below its sum."""
    evs = [
        _x("superstep", "user_annotation", 0, 100),
        _x("rollout", "user_annotation", 10, 30),
        _x("serve_step", "user_annotation", 200, 50, tid=2),
        _x("other", "user_annotation", 0, 1000),
        # runtime calls: in rollout (1, 2), in superstep only (3, 4), a
        # graph replay (5), on thread 2 (6), outside any range (7)
        _x("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 15, 1, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 50, 1, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 52, 1, correlation=4),
        _x("cudaGraphLaunch", "cuda_runtime", 60, 2, correlation=5),
        _x("cudaLaunchKernel", "cuda_runtime", 210, 1, tid=2,
           correlation=6),
        _x("cudaLaunchKernel", "cuda_runtime", 500, 1, correlation=7),
        # device events (pid 0 = the device, tid = the stream)
        _x("void flash_fwd_dmma_kernel<64>(P)", "kernel", 20, 10, pid=0,
           tid=7, correlation=1),
        _x("gemm", "kernel", 25, 10, pid=0, tid=8, correlation=2),
        _x("void flash_bwd_dq_3xtf32_kernel<32>(P)", "kernel", 60, 20,
           pid=0, tid=7, correlation=3),
        _x("void flash_bwd_dkv_3xtf32_kernel<32>(P)", "kernel", 70, 20,
           pid=0, tid=8, correlation=4),
        _x("Memcpy HtoD", "gpu_memcpy", 95, 5, pid=0, tid=7,
           correlation=5),
        _x("void flash_fwd_tc_kernel<64>(P)", "kernel", 220, 4, pid=0,
           tid=9, correlation=6),
        _x("gemm", "kernel", 510, 4, pid=0, tid=7, correlation=7),
    ]
    path = tmp_path / "trace_1.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    got = device_time.parse_trace_device_times(str(path))
    # rollout: [20,30] ∪ [25,35] = 15 us (sum 20)
    assert got["rollout"] == {"device_ms": 0.015, "events": 1,
                              "median_ms": 0.015}
    # superstep: [60,80] ∪ [70,90] ∪ [95,100] = 35 us (sum 45)
    assert got["superstep"] == {"device_ms": 0.035, "events": 1,
                                "median_ms": 0.035}
    assert got["serve_step"]["device_ms"] == 0.004
    assert got["attn_pallas"] == {"device_ms": 0.014, "events": 2,
                                  "median_ms": 0.01}
    assert got["attn_pallas_bwd"] == {"device_ms": 0.03, "events": 2,
                                      "median_ms": 0.02}
    assert "other" not in got
    assert device_time.parse_trace_device_times(str(tmp_path)) == got
    # the CPU: no device events, the ranges' host durations; a nested
    # range of the same name counts once
    cpu = [_x("superstep", "user_annotation", 0, 100),
           _x("superstep", "user_annotation", 0, 100),
           _x("superstep", "user_annotation", 150, 50),
           _x("rollout", "user_annotation", 10, 30)]
    (tmp_path / "cpu").mkdir()
    (tmp_path / "cpu" / "trace_2.json").write_text(
        json.dumps({"traceEvents": cpu}))
    got = device_time.parse_trace_device_times(str(tmp_path / "cpu"))
    assert got == {"superstep": {"device_ms": 0.15, "events": 2,
                                 "median_ms": 0.1},
                   "rollout": {"device_ms": 0.03, "events": 1,
                               "median_ms": 0.03}}
    assert device_time.parse_trace_device_times(str(tmp_path / "none")) \
        == {}


# ---------------------------------------------------------------------------
# no torch, no jax; the copies pinned
# ---------------------------------------------------------------------------


def test_post_mortem_modules_import_neither_torch_nor_jax():
    code = ("import sys\n"
            "import t2omca_tpu_torch.obs.__main__\n"
            "import t2omca_tpu_torch.obs.report\n"
            "import t2omca_tpu_torch.obs.timeline\n"
            "import t2omca_tpu_torch.obs.learning\n"
            "bad = [m for m in ('torch', 'jax', 't2omca_tpu')\n"
            "       if m in sys.modules]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_copies_pinned_against_their_sources():
    assert report.SCENARIO_FAMILY_NAMES == FAMILY_NAMES \
        == jax_report.SCENARIO_FAMILY_NAMES
    assert report.SLICE_METRICS == jax_report.SLICE_METRICS
    assert [k for _, k in report.SLICE_METRICS[1:]] == [
        f"{k}_mean" for k in SLICE_KEYS]
    assert report.PHASE_PROGRAMS == jax_report.PHASE_PROGRAMS
    cfg = jax_registry.audit_config()
    assert report.AUDIT_SHAPES == {
        "batch_size_run": cfg.batch_size_run,
        "episode_limit": cfg.env_args.episode_limit,
        "batch_size": cfg.batch_size,
        "superstep": jax_registry.AUDIT_SUPERSTEP_K}
    assert report.PROGRAMS_VERSION == jax_baseline.PROGRAMS_VERSION
    assert report.load_programs(PROGRAMS_JSON) \
        == jax_baseline.load_programs(jax_baseline.DEFAULT_PROGRAMS)
    assert report.load_programs(None) == jax_baseline.load_programs(
        "/nonexistent/programs.json")
    names = set(jax_registry.TRACE_SYMBOLS)
    assert set(device_time.PROGRAMS) <= names
    assert set(device_time.KERNEL_SYMBOLS) <= names
    csrc = os.path.join(REPO, "t2omca_tpu_torch", "kernels", "csrc")
    text = "".join(open(os.path.join(csrc, f)).read()
                   for f in os.listdir(csrc) if f.endswith(".cu"))
    for syms in device_time.KERNEL_SYMBOLS.values():
        for sym in syms:
            assert f"{sym}(" in text or f"{sym}<" in text, sym
