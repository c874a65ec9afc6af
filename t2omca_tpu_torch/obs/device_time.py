"""Device time attributed to named programs (port of
``t2omca_tpu/obs/device_time.py``).

``utils/profiling.TraceWindow`` captures a ``torch.profiler`` Chrome
trace. This module maps its events back to the programs the JAX
registry names (``analysis/registry.TRACE_SYMBOLS``), so per-program
device time becomes a stat (``device_ms_<program>`` in the Logger
sinks) and a run artifact (``<run_dir>/device_times.json``, which
``python -m t2omca_tpu_torch.obs report`` joins).

**Program names.** The port names its programs with
``torch.profiler.record_function`` ranges at the dispatch sites, under
JAX's names (:data:`PROGRAMS`): ``rollout``, ``insert`` and
``train_iter`` (``run.Experiment.programs``, the classic loop and the
test rollouts), ``superstep`` and ``superstep_pop`` (the fused programs
of ``train/superstep.py``: the range covers the first call's eager
warm-up and capture and each later call's graph replays) and
``serve_step`` (``serve/program.py``).

**Kernel rows.** ``attn_pallas`` (K1 and K1 + residuals) and
``attn_pallas_bwd`` (K2 and K3) are matched by the device kernels' own
names (:data:`KERNEL_SYMBOLS`, the ``__global__`` functions of
``kernels/csrc``).

**Parsing** (:func:`parse_trace_device_times`). A device event (a
kernel, a memcpy or a memset) carries the correlation id of the runtime
call that launched it (``cudaLaunchKernel``, ``cudaGraphLaunch``, ...);
that call sits on a host thread, inside zero or more program ranges of
the same thread. The event is attributed to the innermost one. A
program's time in one dispatch (one range) is the **union** of its
device events' intervals across streams, not their sum: a population's
members overlap on their own streams. ``device_ms`` sums that over the
window's dispatches, ``events`` counts the dispatches and ``median_ms``
is the median dispatch, as JAX writes them. A kernel row's
``device_ms`` is the union of its kernels' intervals, ``events`` the
kernel count and ``median_ms`` the median kernel.

A kernel inside a replayed CUDA graph carries the correlation id of the
``cudaGraphLaunch`` that replayed it: on the H100, 998 992 of the
999 713 kernel events of a config 6 dispatch's trace do, the rest being
the eager kernels around the replays
(``scripts/torch_graph_launch_cupti.py``), and
``chip_smoke.py``'s ``[report]`` checks that the kernel rows count a
train replay's launches. A graph whose kernels a trace did not hold
would add nothing to any row.

**Cost.** A window's trace holds every kernel it saw: about a million
events for one config 6 dispatch, which take about a minute to export
and parse (``PERF.md``). Once a window has run, CUPTI stays attached to
the process and every later graph launch costs more host time unless
the environment sets ``TEARDOWN_CUPTI=1`` (README, ``obs.program_trace``).

**The CPU.** A CPU trace holds no device events. Programs are then
attributed by their ranges' host durations (the JAX parser's host
fallback rank: a nested range of the same name counts once), and the
kernel rows stay empty. No match yields an empty result, never a crash.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.ioutil import write_json_atomic
from ..utils.profiling import TraceWindow

#: the programs a ``record_function`` range names (JAX's registry names)
PROGRAMS = ("rollout", "insert", "train_iter", "superstep",
            "superstep_pop", "serve_step")

#: kernel row -> substrings of the device kernels' names
KERNEL_SYMBOLS = {
    "attn_pallas": ("flash_fwd_tc_kernel", "flash_fwd_dmma_kernel"),
    "attn_pallas_bwd": ("flash_bwd_dq_tc_kernel",
                        "flash_bwd_dq_3xtf32_kernel",
                        "flash_bwd_dkv_tc_kernel",
                        "flash_bwd_dkv_3xtf32_kernel"),
}

#: device-side event categories of a ``torch.profiler`` trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_files(path: str) -> List[str]:
    if os.path.isfile(path):
        return [path]
    out: List[str] = []
    for pat in ("*.json", "*.json.gz"):
        out.extend(glob.glob(os.path.join(path, "**", pat), recursive=True))
    return sorted(out)


def _iter_trace_events(path: str) -> Iterable[dict]:
    """Every traceEvent dict in the trace file ``path`` or in the trace
    files under the directory ``path`` (unreadable files skipped)."""
    for f in _trace_files(path):
        try:
            opener = gzip.open if f.endswith(".gz") else open
            with opener(f, "rt") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            continue
        if not isinstance(data, dict):
            continue
        for ev in data.get("traceEvents", []) or []:
            if isinstance(ev, dict):
                yield ev


def _union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start_us, end_us)`` intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1000.0


def _row(per_event_ms: List[float], device_ms: float) -> Dict[str, float]:
    per = sorted(per_event_ms)
    return {"device_ms": round(device_ms, 3), "events": len(per),
            "median_ms": round(per[len(per) // 2], 3)}


def _span(ev: dict) -> Optional[Tuple[float, float]]:
    ts, dur = ev.get("ts"), ev.get("dur")
    if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
        return None
    return float(ts), float(ts) + float(dur)


def parse_trace_device_times(trace_path: str
                             ) -> Dict[str, Dict[str, float]]:
    """→ ``{name: {"device_ms", "events", "median_ms"}}`` for every
    program (:data:`PROGRAMS`) and kernel row (:data:`KERNEL_SYMBOLS`)
    with at least one event in the ``torch.profiler`` Chrome trace at
    ``trace_path`` (a file, or a directory of trace files)."""
    ranges: Dict[tuple, list] = {}      # (pid, tid) -> [(s, e, prog, id)]
    runtime: Dict[object, tuple] = {}   # correlation -> (lane, s, e)
    device: List[tuple] = []            # (correlation, s, e, name, cat)
    for ev in _iter_trace_events(trace_path):
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), ev.get("name")
        span = _span(ev)
        if span is None or not isinstance(name, str):
            continue
        args = ev.get("args") or {}
        lane = (ev.get("pid"), ev.get("tid"))
        if cat == "user_annotation" and name in PROGRAMS:
            lst = ranges.setdefault(lane, [])
            lst.append((span[0], span[1], name, len(lst)))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                runtime[args["correlation"]] = (lane, span[0], span[1])
        elif cat in _DEVICE_CATS:
            device.append((args.get("correlation"), span[0], span[1], name,
                           cat))
    for lst in ranges.values():
        lst.sort()
    starts = {lane: [r[0] for r in lst] for lane, lst in ranges.items()}

    def innermost(lane, s: float, e: float):
        lst = ranges.get(lane)
        if not lst:
            return None
        i = bisect.bisect_right(starts[lane], s)
        for r in reversed(lst[:i]):
            if r[1] >= e:
                return r
        return None

    out: Dict[str, Dict[str, float]] = {}
    per_range: Dict[tuple, list] = {}
    per_kernel: Dict[str, list] = {}
    for corr, s, e, name, cat in device:
        if cat == "kernel":
            for row, syms in KERNEL_SYMBOLS.items():
                if any(sym in name for sym in syms):
                    per_kernel.setdefault(row, []).append((s, e))
                    break
        call = runtime.get(corr)
        if call is None:
            continue
        r = innermost(call[0], call[1], call[2])
        if r is not None:
            per_range.setdefault((call[0], r[3], r[2]), []).append((s, e))
    if device:
        by_prog: Dict[str, list] = {}
        for (_, _, prog), iv in per_range.items():
            by_prog.setdefault(prog, []).append(_union_ms(iv))
        for prog, per in by_prog.items():
            out[prog] = _row(per, sum(per))
        for row, iv in per_kernel.items():
            out[row] = _row([(e - s) / 1000.0 for s, e in iv],
                            _union_ms(iv))
        return out
    # the CPU: the ranges' host durations, a nested same-name range once
    by_prog = {}
    for lst in ranges.values():
        end: Dict[str, float] = {}
        for s, e, prog, _ in lst:
            if s < end.get(prog, -1.0) and e <= end[prog]:
                continue
            end[prog] = max(end.get(prog, -1.0), e)
            by_prog.setdefault(prog, []).append((e - s) / 1000.0)
    for prog, per in by_prog.items():
        out[prog] = _row(per, sum(per))
    return out


class ProgramTraceWindow(TraceWindow):
    """A :class:`TraceWindow` that, on stop, attributes its trace to the
    named programs and kernels: logs ``device_ms_<name>`` through the
    metric stream and writes ``<out_dir>/device_times.json`` (the report
    CLI's device-time source). Identical to the base window while the
    trace runs, and a no-op when ``trace_dir`` is empty."""

    def __init__(self, trace_dir: str, start_t_env: int = 0,
                 n_iterations: int = 3, out_dir: Optional[str] = None):
        super().__init__(trace_dir, start_t_env, n_iterations)
        self.out_dir = out_dir
        self.device_times: Dict[str, Dict[str, float]] = {}
        self.parse_s: Optional[float] = None

    def _on_stop(self, logger, t_env: int) -> None:
        super()._on_stop(logger, t_env)
        t0 = time.perf_counter()
        try:
            self.device_times = parse_trace_device_times(self.path)
        except Exception:  # noqa: BLE001 — diagnostics only
            if logger is not None:
                logger.console_logger.exception(
                    "device-time attribution of the trace failed")
            return
        self.parse_s = time.perf_counter() - t0
        if logger is not None:
            logger.console_logger.info(
                f"device time by program parsed in {self.parse_s:.2f} s")
            for prog, d in sorted(self.device_times.items()):
                logger.log_stat(f"device_ms_{prog}", d["device_ms"], t_env)
            if not self.device_times:
                logger.console_logger.info(
                    "no named-program events in the trace")
        if self.out_dir:
            try:
                write_json_atomic(
                    os.path.join(self.out_dir, "device_times.json"),
                    {"version": 1, "t_env": int(t_env),
                     "programs": self.device_times})
            except (OSError, TypeError, ValueError):
                pass                    # best-effort, like the spans sink
