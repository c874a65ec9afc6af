#!/usr/bin/env python3
"""Host time of eager config 6 iterations before and after a
``torch.profiler`` session, with and without ``TEARDOWN_CUPTI=1``:

    python3 scripts/torch_eager_cupti.py

Each setting runs in a fresh process (CUPTI's state is per process),
with its environment set before torch is imported. A process builds the
kernels and config 6 as shipped (``kernels.attention=pallas``), runs one
``run_classic`` iteration to warm up, times two (``sync=True``: rollout,
train and the whole iteration, host clocks ending in a synchronize),
runs one short profiler session (ten 256 x 256 matmuls, CPU and CUDA
activity) and times two more. Prints one line per setting and phase
with the card's name and power limit. Needs one NVIDIA GPU; about a
minute and a half.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SETTINGS = {"default": {}, "teardown": {"TEARDOWN_CUPTI": "1"}}


def run_setting(name: str) -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.kernels import build
    from t2omca_tpu_torch.run import Experiment, run_classic
    build.build()
    build.load()
    cfg = load_config(os.path.join(ROOT, "configs/config6_scenarios.yaml"),
                      ("kernels.attention=pallas",))
    exp = Experiment.build(cfg)
    ts, cur, _ = run_classic(exp, exp.init_state(0), 1)
    torch.cuda.synchronize()

    def timed(tag: str) -> None:
        nonlocal ts, cur
        out = []
        for _ in range(2):
            t0 = time.perf_counter()
            ts, cur, recs = run_classic(exp, ts, 1, cur, sync=True)
            out.append((recs[0].rollout_s * 1e3, recs[0].train_s * 1e3,
                        (time.perf_counter() - t0) * 1e3))
        print(f"[{name}] {tag}: rollout/train/iteration ms "
              + "; ".join(f"{a:.0f}/{b:.0f}/{c:.0f}" for a, b, c in out)
              + f" | {cs.smi_line()}", flush=True)

    timed("before any session")
    x = torch.randn(256, 256, device="cuda")
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(10):
            x = x @ x
        torch.cuda.synchronize()
    prof.key_averages()
    timed("after one session")
    return 0


def main() -> int:
    if len(sys.argv) > 1:
        return run_setting(sys.argv[1])
    rc = 0
    for name, env in SETTINGS.items():
        r = subprocess.run([sys.executable, os.path.abspath(__file__), name],
                           env=dict(os.environ, **env), timeout=400)
        print(f"[{name}] exit {r.returncode}", flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
