#!/usr/bin/env python3
"""Host cost of replaying captured CUDA graphs before and after a
``torch.profiler`` session in the same process, on the card:

    python3 scripts/torch_graph_launch_cupti.py

Builds the kernels, then config 6 as shipped (``configs/
config6_scenarios.yaml`` with ``kernels.attention=pallas``: 32 lanes,
T = 150, K = 4, f32) and its fused program (``Experiment.
superstep_program(4)``), which captures the rollout and train graphs in
its first dispatches. It then times, twice before and twice after one
short profiler session (ten 256 x 256 matmuls, CPU and CUDA activity):
one replay launch of the train graph (host clock around ``replay()``),
and a whole dispatch of replays (host clock to its return, and to the
device's end after ``torch.cuda.synchronize()``). Prints one line per
measurement with the card's name and power limit. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.kernels import build
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
            print(f"{tag}: one train replay launch {(t2 - t1) * 1e3:.1f} ms;"
                  f" a dispatch of replays host {(t3 - t2) * 1e3:.0f} ms, to "
                  f"the device's end {(t4 - t2) * 1e3:.0f} ms | {smi}",
                  flush=True)

    timed("before any profiler session")
    x = torch.randn(256, 256, device="cuda")
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(10):
            x = x @ x
        torch.cuda.synchronize()
    prof.key_averages()
    timed("after one profiler session")
    return 0


if __name__ == "__main__":
    sys.exit(main())
