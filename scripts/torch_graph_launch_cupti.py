#!/usr/bin/env python3
"""Host cost of replaying captured CUDA graphs before and after a
``torch.profiler`` window in the same process, on the card, under the
profiler's CUPTI settings, and what a window's trace holds of a replay:

    python3 scripts/torch_graph_launch_cupti.py [--variant NAME]

Each variant runs in a fresh process (CUPTI's state is per process),
with its environment set before torch is imported: ``default`` (none
set), ``teardown`` (``TEARDOWN_CUPTI=1``: ask Kineto to tear CUPTI down
when a window stops), ``teardown_nolazy`` (that and
``DISABLE_CUPTI_LAZY_REINIT=1``), ``keep`` (``TEARDOWN_CUPTI=0``).
Without ``--variant`` every variant runs, one subprocess each.

A variant builds the kernels, then config 6 as shipped
(``configs/config6_scenarios.yaml`` with ``kernels.attention=pallas``: 32
lanes, T = 150, K = 4, f32) and its fused program (``Experiment.
superstep_program(4)``), which captures the rollout and train graphs in
its first dispatches. It times, twice each before any window, after one
``obs/device_time.ProgramTraceWindow`` over one dispatch of replays, and
after a second window: one replay launch of the train graph (host clock
around ``replay()``) and a whole dispatch of replays (host clock to its
return, and to the device's end after ``torch.cuda.synchronize()``).
For the first window it prints how many kernel events the trace holds,
how many of them carry the correlation id of a ``cudaGraphLaunch``, and
the window's ``device_times`` rows. Every line carries the card's name
and power limit. Needs one NVIDIA GPU; a variant takes about four
minutes (each window's trace holds ~1 M kernel events), all four about
fifteen.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "default": {},
    "teardown": {"TEARDOWN_CUPTI": "1"},
    "teardown_nolazy": {"TEARDOWN_CUPTI": "1",
                        "DISABLE_CUPTI_LAZY_REINIT": "1"},
    "keep": {"TEARDOWN_CUPTI": "0"},
}


def graph_kernels(path: str) -> tuple:
    """→ (kernel events, those whose correlation is a cudaGraphLaunch's)
    in one ``torch.profiler`` Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    graph = {e["args"]["correlation"] for e in events
             if e.get("name") == "cudaGraphLaunch"
             and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return len(kernels), sum(e.get("args", {}).get("correlation") in graph
                             for e in kernels)


def run_variant(name: str) -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.kernels import build
    from t2omca_tpu_torch.obs.device_time import ProgramTraceWindow
    from t2omca_tpu_torch.run import Experiment

    build.build()
    build.load()
    smi = cs.smi_line()
    cfg = load_config(os.path.join(ROOT, "configs/config6_scenarios.yaml"),
                      ("kernels.attention=pallas",))
    exp = Experiment.build(cfg)
    ts = exp.init_state(0)
    sup = exp.superstep_program(cfg.superstep)
    mirror = {"key": prng.PRNGKey(1, "cuda"), "t_env": 0, "episode": 0,
              "filled": 0}
    for _ in range(3):          # warm-up, captures, replays
        ts = cs.fused_dispatch(torch, sup, ts, mirror)[0]
    torch.cuda.synchronize()

    def timed(tag: str) -> None:
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sup.graphs["train"].replay()
            t2 = time.perf_counter()
            cs.fused_dispatch(torch, sup, ts, mirror)
            t3 = time.perf_counter()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            print(f"[{name}] {tag}: one train replay launch "
                  f"{(t2 - t1) * 1e3:.1f} ms; a dispatch of replays host "
                  f"{(t3 - t2) * 1e3:.0f} ms, to the device's end "
                  f"{(t4 - t2) * 1e3:.0f} ms | {smi}", flush=True)

    def window(tag: str) -> None:
        tmp = tempfile.mkdtemp(prefix="cupti_")
        win = ProgramTraceWindow(tmp, 0, 1, out_dir=tmp)
        win.maybe_start(0)
        cs.fused_dispatch(torch, sup, ts, mirror)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        win.tick(None, 1)
        stop_s = time.perf_counter() - t0
        n, in_graph = graph_kernels(win.path)
        shutil.rmtree(tmp, ignore_errors=True)    # ~0.5 GB of trace
        rows = {k: (v["device_ms"], v["events"])
                for k, v in sorted(win.device_times.items())}
        print(f"[{name}] {tag}: window stop + export + parse "
              f"{stop_s:.2f} s; {n} kernel events, {in_graph} correlated to "
              f"a cudaGraphLaunch; device_times (ms, events) {rows} | {smi}",
              flush=True)

    timed("before any window")
    window("first window")
    timed("after one window")
    window("second window")
    timed("after two windows")
    return 0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--variant", choices=sorted(VARIANTS), default=None)
    args = p.parse_args()
    if args.variant is not None:
        for k, v in VARIANTS[args.variant].items():
            os.environ[k] = v
        return run_variant(args.variant)
    rc = 0
    for name in VARIANTS:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--variant", name], timeout=600)
        print(f"[{name}] exit {r.returncode}", flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
