#!/usr/bin/env python3
"""Time the rollouts of one checkout of the PyTorch port on the card.
Run it once per checkout, in turns (parent, change, change, parent),
inside one chip call, to compare two versions on one card:

    python3 scripts/torch_rollout_ab.py --repo DIR [--label NAME]

``--repo`` is the root of the checkout whose ``t2omca_tpu_torch`` and
``chip_smoke.py`` are used. The configuration is that checkout's
``chip_smoke.loop_cfg()`` (here config 3's ``[loop]``: the north-star
widths of ``configs/config3_tpu_northstar.yaml`` at its own 1024 lanes,
T = 150, bf16, the default stack of entity tables and compact storage;
checkouts before the entity tables used 128 lanes with
``model.use_entity_tables: false``, so compare checkouts that share
it), the runner state and params from
``Experiment.init_state(0)``. Times four chained training rollouts
(``ParallelRunner.run``, host clock ending in
``torch.cuda.synchronize()``); the first warms up. Prints one JSON
line: the label, the card and its power limit, each rollout's ms, the
p50 of the last three, the last rollout's mean return (equal returns
show that two versions drew the same episodes), and one more rollout's
compute ops at the dispatcher with the PRNG's share (``chip_smoke.py``'s
``count_rollout_ops``; on the card each op is about one launch). Needs
one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROLLOUTS = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_rollout_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    import chip_smoke
    from t2omca_tpu_torch.run import Experiment

    exp = Experiment.build(chip_smoke.loop_cfg())
    ts = exp.init_state(0)
    params, rs = ts.learner.params["agent"], ts.runner
    times = []
    for _ in range(ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs, batch, stats = exp.runner.run(params, rs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del batch
    ops = chip_smoke.count_rollout_ops(torch, exp, ts)
    total, in_prng = sum(ops.values()), ops.get("prng", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "label": args.label or args.repo, "card": smi,
        "rollout_ms": times, "p50_ms": statistics.median(times[1:]),
        "mean_return": float(stats.episode_return.mean()),
        "t_env": rs.t_env, "rollout_ops": total, "prng_ops": in_prng}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
