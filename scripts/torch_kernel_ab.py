#!/usr/bin/env python3
"""Time one checkout of the PyTorch port on the card: its bf16 serve
dispatch and its flash-attention kernels. Run it once per checkout, in
turns (parent, change, change, parent), inside one chip call, to compare
two versions on one card:

    python3 scripts/torch_kernel_ab.py --repo DIR [--label NAME]
        [--train-steps N] [--train-only]

``--repo`` is the root of the checkout whose ``t2omca_tpu_torch`` is
timed (its kernels build there at first use). Prints one JSON line: the
label, the card and its power limit, the bf16 bucket-64 dispatch p50
(host clock around ``ServeFrontend.select`` incl. H2D/D2H, north-star
widths of ``configs/config3_tpu_northstar.yaml``, use_qslice=false,
kernels.attention=pallas, random weights from seed 0) and CUDA-event
times of K1 (serve, learner agent and mixer shapes), K1 + residuals, K2
and K3 (agent and mixer) at bf16 and f32, with k and v one tensor at the
learner shapes as the query-slice call passes them and apart, and
SDPA's backward alone (``torch.autograd.grad`` after one
``scaled_dot_product_attention`` forward, never on the path) at the
learner shapes in both dtypes as the yardstick of the same run: the
device time of its kernels from a torch.profiler trace, since the host's
trip through the autograd engine takes longer than those kernels.
With ``--train-steps N`` it also times N f32 trainer steps as
``chip_smoke.py``'s ``[train]`` runs them (north-star widths, batch 32,
T = 50, kernels.attention=pallas, dense replay, the checkout's own
``chip_smoke.py`` helpers): their p50 on the host clock, and the device
busy time of one more step from a torch.profiler trace, which the host's
share of the step does not blur; ``--train-only`` skips the dispatch and
kernel times. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
REPS = 30            # dispatches timed after the warm-up
NORTH_STAR = {
    "env_args": {"agv_num": 64, "mec_num": 8, "num_channels": 8,
                 "episode_limit": 150},
    "model": {"emb": 256, "heads": 4, "depth": 2, "mixer_emb": 256,
              "mixer_heads": 4, "mixer_depth": 2, "standard_heads": True,
              "dtype": "bfloat16", "use_qslice": False},
    "kernels": {"attention": "pallas"},
}
SHAPES = {"serve": (4096, 4, 65, 65, 64), "agent": (2048, 1, 4, 65, 256),
          "mixer": (32, 1, 268, 131, 256)}


def cuda_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Self device time of the kernels one call of ``fn`` launches, from a
    torch.profiler trace of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
    return us / 1e3 / iters


def dispatch_p50(torch) -> float:
    import numpy as np
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.envs.registry import make_env
    from t2omca_tpu_torch.serve.frontend import ServeFrontend
    cfg = from_dict(json.loads(json.dumps(NORTH_STAR)))
    info = make_env(cfg.env_args).get_env_info()
    params = BasicMAC.build(cfg, info).init_params(
        torch.Generator().manual_seed(SEED))
    fe = ServeFrontend(cfg, params, (64,), dtype="bfloat16")
    fe.warmup()
    rng = np.random.default_rng(SEED)
    a, od, na = info["n_agents"], info["obs_shape"], info["n_actions"]
    times = []
    for _ in range(REPS):
        obs = rng.standard_normal((64, a, od)).astype(np.float32)
        avail = rng.random((64, a, na)) < 0.6
        avail[..., 0] = True
        t0 = time.perf_counter()
        fe.select(obs, avail)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_times(torch, att) -> dict:
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        sfx = "" if dt == torch.bfloat16 else " f32"
        for name, (b, h, tq, tk, d) in SHAPES.items():
            q, k = ((torch.randn(b, h, t, d, device=dev, generator=g)
                     * d ** -0.25).to(dt) for t in (tq, tk))
            v = torch.randn(b, h, tk, d, device=dev, generator=g).to(dt)
            do = torch.randn(b, h, tq, d, device=dev, generator=g).to(dt)
            if name == "serve":     # the serve path's (B, T, H, D) views
                q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                           for x in (q, k, v))
                out[f"flash_fwd serve{sfx}"] = cuda_ms(
                    torch, lambda: att._launch(q, k, v, None, False))
                continue
            qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qr, kr, vr, scale=1.0)
            out[f"sdpa_bwd {name}{sfx}"] = device_ms(
                torch, lambda: torch.autograd.grad(sdpa, (qr, kr, vr), do,
                                                   retain_graph=True))
            del qr, kr, vr, sdpa
            for kv_name, vv in (("", v), (" k_is_v", k)):
                o, m, l = att._launch_res(q, k, vv, None, False)
                delta = (do.float() * o.float()).sum(dim=-1)
                tag = name + kv_name + sfx
                out[f"flash_bwd_dq {tag}"] = cuda_ms(
                    torch, lambda: att._launch_bwd_dq(q, k, vv, None, False,
                                                      do, m, l, delta))
                out[f"flash_fwd {tag}"] = cuda_ms(
                    torch, lambda: att._launch(q, k, vv, None, False))
                out[f"flash_fwd_res {tag}"] = cuda_ms(
                    torch, lambda: att._launch_res(q, k, vv, None, False))
                out[f"flash_bwd_dkv {tag}"] = cuda_ms(
                    torch, lambda: att._launch_bwd_dkv(q, k, vv, None, False,
                                                       do, m, l, delta))
    return out


def f32_train_step(torch, steps: int) -> dict:
    """p50 host ms of ``steps`` f32 trainer steps after one warm-up step,
    and the device busy ms of one more, profiled."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.components.episode_buffer import \
        PrioritizedReplayBuffer
    from t2omca_tpu_torch.envs.registry import make_env
    from t2omca_tpu_torch.train.program import TrainState, build_train_iter
    t = 50
    cfg = cs.train_cfg("float32", episode_limit=t)
    info = make_env(cfg.env_args).get_env_info()
    buffer = PrioritizedReplayBuffer(
        capacity=cs.RING, episode_limit=t, n_agents=info["n_agents"],
        n_actions=info["n_actions"], obs_dim=info["obs_shape"],
        state_dim=info["state_shape"], store_dtype="bfloat16",
        alpha=cfg.replay.per_alpha, beta0=cfg.replay.per_beta,
        t_max=cfg.t_max)
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    ring = buffer.insert_episode_batch(
        buffer.init(), cs.make_episodes(torch, info, cs.RING, t, g,
                                        torch.bfloat16))
    learner = cs.build_learner(cfg, info)
    ts = TrainState(learner=learner.init_state(
        torch.Generator().manual_seed(SEED)), buffer=ring, episode=cs.RING)
    train_iter = build_train_iter(buffer, learner, cfg)
    keys = prng.split(prng.PRNGKey(SEED + 12, "cuda"), steps + 2)
    times = []
    for i in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = train_iter(ts, keys[i], 1000 * (i + 1))
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train_iter(ts, keys[steps + 1], 1000 * (steps + 2))
        torch.cuda.synchronize()
    busy = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            busy += e.self_cuda_time_total if us is None else us
    return {"train_f32_T50_p50_ms": statistics.median(times),
            "train_f32_T50_ms": times,
            "train_f32_T50_device_busy_ms": busy / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--train-only", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    from t2omca_tpu_torch.kernels import attention as att
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    result = {"label": args.label or args.repo, "card": smi}
    if not args.train_only:
        result["dispatch_bf16_b64_p50_ms"] = dispatch_p50(torch)
        result.update(kernel_times(torch, att))
    if args.train_steps:
        result.update(f32_train_step(torch, args.train_steps))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
