#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``t2omca_tpu_torch``) on one NVIDIA GPU.

Drives the port's main paths — greedy serving, the QMIX learner's
trainer step, and the classic training loop (rollout, insert, train) on
the default stack, on its kill switch and with NoisyNet's noise —
at the north-star model widths through the hand-written flash-attention
kernels, and holds every kernel of those paths against its plain
PyTorch version. Phases, one line each (any
failed check ends the script with a non-zero exit):

1. device    require CUDA; the card's name and power limit (nvidia-smi)
2. build     compile the kernels from the checkout's sources (nvcc);
             registers and spills of each kernel (ptxas) and its
             tensor-core instructions (HMMA, DMMA; cuobjdump): every body
             of K1, K3 and K2 at both dtypes (bf16 on m16n8k16; the f32
             K2 and K3 as 3xTF32 on m16n8k8, the f32 K1 on the FP64
             tensor cores, m16n8k4) spills nothing and runs on the tensor
             cores, and no instance of the old CUDA-core K1, K2 and K3
             bodies exists
3. kernels   each kernel against its plain version at the main path's
             shapes (config 6's mixer at D = 32 f32 included) and the
             odd / masked / causal / all-masked cases,
             plus the tensor-core edges at bf16 and f32 (Tq 4/65/268, Tk
             65/131, D 8/12/64/256, the serve shape as strided (B, T, H,
             D) views, k is v, causal per-head masks, all-negative
             logits); times of kernel, plain version and the one-call
             library yardstick (scaled_dot_product_attention, never on
             the path) at the serve shape in both dtypes
4. serve     the serving front end at the north-star widths
             (configs/config3_tpu_northstar.yaml: 64 AGVs, 8 MECs,
             8 channels, emb 256, 4 heads, depth 2, standard heads) with
             use_qslice=false and kernels.attention=pallas, f32 and bf16,
             random weights from a seeded torch.Generator: requests of
             1, 7, 64 and 150 rows and a 3-turn session; legal actions,
             finite hidden, launch counts, and at f32 agreement with the
             query-slice path
   population  configs/config7_population.yaml as shipped (4 members over
             config 6: the lr grid, per-member seeds, the scenario salt,
             K = 4, f32) with kernels.attention=pallas: one dispatch that
             captures every member's graphs on its own stream and pool,
             then a dispatch of replays with the members overlapped
             against the same dispatch with the members run one after
             another, each synced (P solo dispatches), from one state,
             bit for bit (params, Adam, rings, priorities, runners,
             stats, infos), with no host sync and P x 4 x a train
             replay's launches; host ms, each member's device ms an
             iteration, capture seconds, peak and reserved memory,
             experiments_per_sec against serialized_experiments_per_sec
             and their ratio population_speedup; a seed_stride=0 pair
             (T cut to 20) bit-identical to each other; then python -m
             t2omca_tpu_torch train cut in t_max to two dispatches with
             a save (its test cadence cut to the first) and the live
             plane on 9465: the launches, pop<i>_*
             rows for every member, the sight-pop<i>-* checks on
             /healthz, the population checkpoint restored by a resume
             bit for bit, obs learning's member table; and a PBT variant
             (T cut to 20, one dispatch, a flush before the save) that
             logs pbt_copies. It runs before the first profiler session:
             with CUPTI attached, each graph replay costs ~60 ms of host
             time and the members' launches serialize
5. profile   device time of one max-bucket dispatch by kernel, f32 and
             bf16 (torch.profiler), after the launch counts are read
6. kernels-bwd  K1 + residuals, K2 and K3 against their plain versions
             at the learner agent (2048, 1, 4, 65, 256) and mixer
             (32, 1, 268, 131, 256) shapes in f32 and bf16 and config 6's
             mixer (32, 1, 22, 19, 32) in f32, the dense learner's
             heads, odd shapes, masks, causal, the all-masked row, and
             the bf16 and f32 edges of phase 3; times of each kernel at
             the learner shapes (and with k is v) beside its
             bound, its plain version and its SDPA yardstick (forward for
             K1 and K1 + residuals; backward alone for K2 and K3, as the
             device time of its kernels in a profiler trace; never on the
             path), and the fwd+bwd totals
7. train     the trainer step (sample -> train -> priority feedback,
             train/program.py) at the north-star widths, bf16,
             kernels.attention=pallas, dense replay; 3 steps with exact
             launch counts of all four kernels, the p50 step time (bf16,
             and f32), the f32 pallas-vs-xla cross-check at batch 2
             (query slice and dense; loss, grad_norm, gradients and the
             params after one step), and a profile of one bf16 step that
             must run the tensor-core K1, K2 and K3 and no old CUDA-core
             body
8. entity    the entity-table forward at the north-star widths (8
             lanes, 3 env steps, random weights): compact_obs rebuilds the
             env's dense obs (rtol 1e-5, atol 1e-6), and the entity
             forward equals the query-slice forward on that obs (f32 rtol
             2e-4, atol 2e-5; bf16 within 32 bf16 ULPs); one bf16 acting
             forward at 1024 lanes each way, timed
9. loop      config 3's own loop at its widths, T cut to 50 (the smoke's
             time limit): three iterations of the classic
             training loop (run.run_classic: rollout -> ring insert ->
             gated train) at 1024 lanes and a ring of 2048 (it wraps in
             the third), bf16, pallas, PER, on the default stack
             (entity-table acting, compact storage). Checks each train
             iteration's exact kernel launches (the mixer's alone: a
             rollout launches none), stored actions available, finite
             compact leaves with MEC ids in [0, 8), finite state and
             rewards, rates in [0, 1], t_env and episode, finite loss and
             grad_norm, moving priorities; prints rollout p50,
             env-steps/s, trainer step and iteration p50, peak memory,
             launches and PRNG ops of a rollout by part, and a profiled
             rollout's device busy/idle share and top device ops
   sight     the learning-health probes (obs.sight) on [loop]'s trainer
             step (its ring: compact storage, batch 32, T = 50, bf16):
             off and on from one state, two steps each in turns; params,
             target, Adam and priorities bit-identical, the same kernel
             launches, the probes finite (histograms summing to 1,
             entropies in [0, 1]); the probes' extra compute ops at the
             dispatcher and the step p50 both ways
   remat     model.remat on the same step, off and on: loss, grad_norm
             and every param bit-identical (or, printed, within
             tests/test_torch_loop.py's tolerances), K1 + residuals twice
             per online mixer step, the peak memory lower; then f32 at
             [loop]'s T under remat (two steps: p50, peak, finite loss,
             moving params) and the f32 pallas-vs-xla cross-check on one
             remat step
   superstep the fused superstep (Experiment.superstep_program) at config
             3's width on [loop]'s experiment and state (1024 lanes, ring
             2048, K = 4, bf16, pallas, PER, obs.sight on): K eager
             run_classic iterations and the program's first fused
             dispatch (the capture of the rollout + insert and the train
             graphs, then K replays; [population] warmed the process's
             stages up) from one state, bit for
             bit (learner, ring, priorities, runner, counters, the driver
             key, each iteration's stats and info) with the same kernel
             launches; a dispatch of replays with no host sync (CUDA sync
             debug mode), the state at the same addresses, its host time
             and each iteration's device time; a profiled iteration (one
             replay of each graph): the
             device busy share and the flash kernels a train replay from
             the profiler's rows beside LAUNCHES; capture and instantiate
             seconds, graph nodes, peak memory with the graphs' pool
   loop-dense  the kill switch model.use_entity_tables=false (dense obs,
             query-slice acting, the agent's unrolls through the kernels)
             at 128 lanes and a ring of 256: threefry on CUDA against the
             CPU bit for bit, three iterations with their exact launches
   loop-noisy  one iteration with action_selector noisy-new on the
             default stack at 128 lanes: [loop]'s launches, the noisy q
             differs from the mu q, and the sigma params' gradients are
             finite and not all zero
10. driver   the training driver as a user runs it: ``python -m
             t2omca_tpu_torch``'s ``main`` on configs/
             config3_tpu_northstar.yaml (1024 lanes, ring 2048, K = 4,
             spans, memwatch, the learning-health probes and the live
             plane on port 9464 on) with kernels.attention=pallas and T
             cut to 50 (since PR 16; t_max to one K = 4 dispatch): one
             fused dispatch to t_env 204800 that
             captures and replays the superstep's graphs, with launches
             4 x [loop]'s, the metric keys (the sight keys
             finite, histograms summing to 1, entropies in [0, 1]),
             /metrics and /healthz read from a thread during the call
             (t_env, the watchdog gauges, HBM in use; the watchdog, guard
             and five detector checks, whose verdicts it prints), a
             verified checkpoint and no staging leftover; the same call
             resumed from it to 409600 (every restored tensor, the ring
             cursor and the driver key equal to the checkpoint's before
             the first new dispatch, launches as before); a SIGTERM'd
             training subprocess (4 lanes, ring 256, K = 1) takes a
             PULSE_TRACE capture (a one-iteration torch.profiler Chrome
             trace in pulse_trace_01_t*) and exits 0 with an emergency
             checkpoint, the resume hint and a flight recorder with the
             memwatch peak; evaluate with benchmark.csv from a
             full-state restore and from the model-only fallback. Prints
             startup, the dispatch's and each iteration's time beside
             [loop]'s, the test rollout, the checkpoint's bytes and its
             save, hash and restore times, an evaluate episode and
             SIGTERM to exit. Runs under a temporary directory in the
             checkout that it deletes.
   artifact  the serving artifact: [driver]'s resumed checkpoint
             exported through ``python -m t2omca_tpu_torch.serve
             export``'s ``main`` as shipped (query slice, no kernel) and
             with model.use_qslice=false kernels.attention=pallas (K1
             once a block), each loaded with ServeFrontend.load on the
             card in f32 and bf16: export and load seconds, bytes a
             variant, first-request and warm p50 at 1, 7, 64 and 150
             rows, K1 launches a dispatch; the f32 actions and hiddens
             equal an in-memory front end's from the same agent leaves,
             and a tampered blob is refused
   fleet     the serving fleet (serve/fleet.py) over [artifact]'s
             dense pallas artifact, 2 engines on their own CUDA streams:
             requests of 1, 7, 64 and 150 rows and a 3-turn session
             through fleet.select equal to one front end bit for bit, K1
             launches exact across the engine threads, the per-size
             p50; a rolling refresh to [driver]'s first checkpoint (equal
             to an in-memory front end of its agent leaves afterwards),
             serve refresh's dry run, a checkpoint of another width
             refused while serving; JAX's bench_serve_chaos schedule
             (8 s of bursty Pareto traffic, engine 0 killed, a refresh
             to a missing checkpoint, engine 1 hung): nothing
             unresolved, the refresh refused, both engines serving at the
             end, legal actions, K1 launches exact by dtype
11. scenarios  configs/config6_scenarios.yaml as shipped (the four-
             family mixture, min_agents 4, the mixer padding mask, K = 4,
             f32) with kernels.attention=pallas: the CPU path's launches
             a train iteration (the plain versions counted, lanes cut to
             2); the mixture draw of 4096 lanes on the card equal to the
             CPU's, n_active in [4, 8], padded agents with and taking
             action 0 only; 4 eager run_classic iterations against one
             fused dispatch from one state, bit for bit, with the CPU
             path's launches a train replay; a dispatch of replays with
             no host sync, each iteration's device time; then python -m
             t2omca_tpu_torch train cut in t_max to two dispatches: the
             launches, slice<fam>_* rows for at least three families in
             train and test, the dispatch times, the capture seconds
   report    python -m t2omca_tpu_torch train (a subprocess) on config 6
             with T cut to 20, obs.program_trace and a profile_dir window
             over the third of four K = 4 dispatches: device_times.json
             with the superstep and the two kernel rows (their events K
             train replays' launches), obs report and obs timeline exit
             0; the host time of the dispatches before and after the
             window (CUPTI's cost)
   dp        data parallelism at configs/config5_dp8.yaml's widths
             (256 AGVs, emb 256, bf16, compact storage, pallas; cut to
             256 lanes, ring 512, batch 8): the dp code at world 1 over
             NCCL; the CLI with dp_devices=2, its two ranks started by
             the port's launcher (NCCL with two cards, else both on the
             card over gloo, --share-cards), two dispatches and a save,
             every rank's launches exact, the ranks' replicated state
             equal, the checkpoint's ring, loss and params against world
             1's; a one-rank resume; the timing table
   dp-superstep  configs/config3_tpu_northstar.yaml as shipped (K = 4,
             obs.sight, 1024 lanes, ring 2048; T cut to 30) at
             dp_devices=2: the CLI's two fused dispatches (each stage
             captured as segments split at the rank's collectives) and
             their checkpoints bit for bit against the classic dp loop
             from the same seed, the sight rows too; exact launches a
             rank, the replicated state equal; a dispatch with dropout
             and noisy-new (128 lanes) with exact flash and dropout_mask
             launches; the dispatch against the classic loop's K
             iterations, segments, nodes, capture seconds, peak a rank
   sebulba   configs/config3_sebulba.yaml at its widths (T cut to 50):
             lockstep against the classic loop bit for bit, the CLI's
             overlapped run with the race checks, env-steps/s, utilization
   pop-dp    config 7 (T = 20) through the CLI at dp_devices=2, two whole
             members a rank: both checkpoints bit for bit [population]'s
             one-process ones; its PBT variant at 4 ranks against
             pbt_step in one process; experiments/s against one process
   pop-sebulba  config 7 under 2 actor + 1 learner streams in lockstep
             against the classic population loop bit for bit; the race
             checks, launches, env-steps/s, each side's utilization
   pop-reshape  [population]'s P = 4 checkpoint restored as P = 2 (ranked,
             one dispatch) and as P = 6 (re-salted copies)
12. summary  the kernels JSON line, the card line, the result line

Run from the repository root: ``python3 chip_smoke.py``. The last line
is ``{"ok": true, "device": {...}}``; it is printed only when every
phase passed. The script sets ``TEARDOWN_CUPTI=1`` for itself (unless the
caller set it), so the phases after its first profiler session measure
without CUPTI's per-launch callbacks; [report]'s training subprocess
runs without it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

NORTH_STAR = {
    "batch_size_run": 1024, "batch_size": 32,
    "env_args": {"agv_num": 64, "mec_num": 8, "num_channels": 8,
                 "episode_limit": 150},
    "model": {"emb": 256, "heads": 4, "depth": 2, "mixer_emb": 256,
              "mixer_heads": 4, "mixer_depth": 2, "standard_heads": True},
}
BUCKETS = (1, 2, 4, 8, 16, 32, 64)
REQUEST_SIZES = (1, 7, 64, 150)
REPEATS = 5
SEED = 0
#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by
#: operand type (float32 outside the tensor cores; bf16, tf32 and float64
#: tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 494.7e12,
              "float64": 67e12,
              # 32-bit integer operations on the CUDA cores at their
              # peak issue rate: one an FP32 lane a clock, the rate whose
              # FMAs (2 FLOPs each) give the 67 TFLOP/s above
              "int32": 67e12 / 2}
#: 32-bit operations a dropout-mask element needs (csrc/dropout_mask.cu):
#: the counter add, the hash's 20 rounds (add, rotate, xor), its 5 key
#: injections (2 adds each, the round constant folded into the key),
#: then the words' xor, the mantissa shift and or, the f32 subtract and
#: the compare. The key's fold is one more hash a draw.
MASK_OPS = 1 + 20 * 3 + 5 * 2 + 5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: backward kernels (and K1 + residuals' output) against their plain
#: versions: f32 reassociation of D- and T-long sums; bf16 one rounding
#: of each gradient, at the gradient's scale
GRAD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (0.05, 0.02)}
#: the learner's attention shapes at the north-star widths (B, H, Tq,
#: Tk, D): the agent query slice (batch 32 x 64 agents, 1 row x 4
#: heads, 65 tokens, emb 256) and the mixer query slice (67 rows x 4
#: heads against 64 entities + 64 agents + 3 hyper tokens)
AGENT_SHAPE = (2048, 1, 4, 65, 256)
MIXER_SHAPE = (32, 1, 268, 131, 256)
#: a Sebulba learner placement's share of them (a learner set of 2 splits
#: the batch of 32 into two blocks of 16 episodes)
AGENT_HALF_SHAPE = (1024, 1, 4, 65, 256)
MIXER_HALF_SHAPE = (16, 1, 268, 131, 256)
#: the dense modules' attention at config 3's widths (standard heads, D =
#: emb / heads = 64), which dropout (or model.use_qslice false) sends
#: through the kernels: the agent over B·64 sequences of 65 tokens
#: (its hidden token and 64 entities), the mixer over B sequences of 131
#: (64 entities, 64 agents' hidden tokens, 3 hyper tokens), batch 32
DENSE_SHAPES = {"agent_dense": (2048, 4, 65, 65, 64),
                "mixer_dense": (32, 4, 131, 131, 64)}
#: config 6's mixer query slice (configs/config6_scenarios.yaml, f32):
#: batch 32, 11 rows (8 agents + 3 hyper) x 2 heads against 19 tokens,
#: D = emb 32, no mask, not causal, k and v one tensor (the CPU path's
#: shapes of that config)
MIXER6_SHAPE = (32, 1, 22, 19, 32)
#: replay ring of the trainer step, cut from config 3's 2048 episodes:
#: 64 episodes of 151 steps (bf16 storage, ~0.75 GB) are enough to
#: sample batches of 32
RING = 64
TRAIN_STEPS = 2                     # 3 -> 2 since PR 16 (the smoke's limit)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
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


def device_rows(prof, n_iter: int = 1) -> list:
    """[(device ms per iteration, launches per iteration, name)] of every
    kernel and copy in a torch.profiler trace, by self device time. The
    program ranges (``obs/device_time.PROGRAMS``: ``record_function``
    annotations, which the profiler also lays on the device's timeline
    over their kernels) are not kernels and are left out."""
    from t2omca_tpu_torch.obs.device_time import PROGRAMS
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or e.key in PROGRAMS:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3 / n_iter, e.count // n_iter, e.key))
    return rows


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the self device time of the
    kernels it launches, summed from a torch.profiler trace of ``iters``
    calls. Unlike ``cuda_ms`` it leaves out the host's gaps between
    launches, which dominate a call that goes through the autograd
    engine."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(r[0] for r in device_rows(prof, iters))
    check(busy > 0, "profiler saw no device time")
    return busy


def bound_ms(nbytes: float, flops: float, peak: str) -> tuple:
    """→ (least ms, "bytes"|"operations"): the larger of the bytes over
    the HBM rate and the FLOPs over the ``peak`` type's rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def kernel_bounds(shape, dtype_name: str, kv_same: bool = False) -> dict:
    """Bounds of K1, K1 + residuals, K2 and K3 on these inputs: each
    input read once, each output written once (m, l, Δ are f32 rows),
    against 4, 4, 6 and 8 x B·H·Tq·Tk·D FLOPs. bf16 runs them at the
    bf16 tensor-core peak. At f32, K1 (both launches) runs its products
    on the FP64 tensor cores (one f64 product for each f32 one, at the
    f64 tensor-core peak) and K2 and K3 as 3xTF32 (three tf32 products
    for each f32 one: 18 and 24 x B·H·Tq·Tk·D, at the tf32 peak).
    ``kv_same``: k and v are one tensor (the query-slice call), read
    once."""
    b, h, tq, tk, d = shape
    it = 4 if dtype_name == "float32" else 2
    bh, mn = b * h, b * h * tq * tk * d
    qd, kd, row = bh * tq * d * it, bh * tk * d * it, bh * tq * 4
    kv = kd if kv_same else 2 * kd
    f32 = dtype_name == "float32"
    ops = 3 * mn if f32 else mn   # 3xTF32: three tf32 products an f32 one
    peak = "tf32" if f32 else dtype_name
    fwd_peak = "float64" if f32 else dtype_name
    return {
        "flash_fwd": bound_ms(2 * qd + kv, 4 * mn, fwd_peak),
        "flash_fwd_res": bound_ms(2 * qd + kv + 2 * row, 4 * mn, fwd_peak),
        "flash_bwd_dq": bound_ms(3 * qd + kv + 3 * row, 6 * ops, peak),
        "flash_bwd_dkv": bound_ms(2 * qd + kv + 2 * kd + 3 * row, 8 * ops,
                                  peak),
    }


#: the tensor-core bodies: K1 (both launches), K3 and K2 at bf16, and the
#: same three at f32 (K1 on the FP64 tensor cores, K3 and K2 as 3xTF32);
#: the bf16 trainer step runs the first three
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
              "flash_bwd_dq_tc_kernel", "flash_fwd_dmma_kernel",
              "flash_bwd_dkv_3xtf32_kernel", "flash_bwd_dq_3xtf32_kernel")
BF16_TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
                   "flash_bwd_dq_tc_kernel")
#: the CUDA-core bodies of the first slices (K1, K3, K2), which must exist
#: at no dtype
GONE_BODIES = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
               "flash_bwd_dq_kernel")


def kernel_label(mangled: str) -> str:
    """flash_..._kernel<args> from a mangled kernel name (the template
    arguments this repo uses: ints, bools, float and bf16)."""
    import re
    m = re.search(r"\d+(flash_\w+?_kernel)I(.+?)EEv", mangled)
    if m is None:
        return mangled
    args = re.sub(r"Li(\d+)E", r"\1, ", m.group(2))
    args = args.replace("Lb0E", "false, ").replace("Lb1E", "true, ")
    args = args.replace("13__nv_bfloat16", "bf16").rstrip(", ")
    return f"{m.group(1)}<{'float' if args == 'f' else args}>"


def phase_build_report(lib: str, build) -> dict:
    """ptxas registers and spills of every kernel (from the build log),
    and the tensor-core instructions in each kernel's SASS (cuobjdump):
    HMMA (bf16 and tf32 mma) and DMMA (f64 mma). Fails if a tensor-core
    kernel spills or has neither, or if any instance of an old CUDA-core
    body was built. → {kernel: HMMA + DMMA count}."""
    import re
    with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
        log = f.read()
    fn, usage = None, {}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and fn:
            usage.setdefault(fn, {})["spill"] = (int(m.group(1)),
                                                 int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            usage.setdefault(fn, {})["regs"] = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", lib],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    fn, hmma, dmma = None, {}, {}
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            hmma[fn] = dmma[fn] = 0
        elif fn is not None and "HMMA" in ln:
            hmma[fn] += 1
        elif fn is not None and "DMMA" in ln:
            dmma[fn] += 1
    for name in sorted(set(usage) | set(hmma)):
        u = usage.get(name, {})
        st, ld = u.get("spill", (0, 0))
        label = kernel_label(name)
        mma = hmma.get(name, 0) + dmma.get(name, 0)
        print(f"[build] {label}: {u.get('regs')} registers, spill "
              f"{st}/{ld} bytes, HMMA {hmma.get(name, 0)}, DMMA "
              f"{dmma.get(name, 0)}", flush=True)
        if any(k in name for k in TC_KERNELS):
            check(st == 0 and ld == 0, f"{label} spills {st}/{ld} bytes")
            check(mma > 0, f"{label} has no HMMA or DMMA in its SASS")
        for gone in GONE_BODIES:
            check(f"{len(gone)}{gone}I" not in name,
                  f"an instance of the old {gone} was built: {name}")
        if "dropout_mask_kernel" in name:
            check(st == 0 and ld == 0, f"{label} spills {st}/{ld} bytes")
    check(all(any(k in n and hmma[n] + dmma[n] > 0 for n in hmma)
              for k in TC_KERNELS),
          "a tensor-core kernel is missing from the library")
    check(any("dropout_mask_kernel" in n for n in hmma),
          "the dropout-mask kernel is missing from the library")
    return {kernel_label(n): hmma[n] + dmma[n] for n in hmma
            if any(k in n for k in TC_KERNELS)}


def make_inputs(torch, g, shape, dt, mask, extra=None):
    """Seeded q, k, v, dO on the card (q and k with the module's Q1
    scaling) and the boolean mask → (q, k, v, do, mask). ``extra``:
    "kv" passes k as v (the query-slice call), "strided" gives the serve
    path's (B, T, H, D) views, "negative" makes every real logit
    negative (zero-filled pad keys would then win the row max if they
    entered it)."""
    dev = torch.device("cuda")
    b, h, tq, tk, d = shape
    dtype = getattr(torch, dt)
    q, k = (torch.randn(b, h, t, d, device=dev, generator=g)
            * d ** -0.25 for t in (tq, tk))       # Q1 scaling
    if extra == "negative":
        q, k = q.abs(), -k.abs()
    v = torch.randn(b, h, tk, d, device=dev, generator=g)
    do = torch.randn(b, h, tq, d, device=dev, generator=g)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    if extra == "kv":
        v = k
    if extra == "strided":
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in (q, k, v))
    m = None
    if mask is not None:
        hm = h if mask == "per_head" else 1
        m = torch.rand(b, hm, tq, tk, device=dev, generator=g) > 0.3
        if mask == "all_masked_row":
            m[:, :, 3] = False
    return q, k, v, do, m


#: bf16 cases at the tensor-core kernels' edges, shared by [kernels] and
#: [kernels-bwd]: Tq 4/65/268 and Tk 65/131 (neither a multiple of the
#: tiles), D 8/12/64/256, k is v, causal with a per-head mask, the
#: all-masked row, and the pad-key trap of all-negative logits
BF16_EDGES = [
    ("agent_k_is_v", AGENT_SHAPE, "bfloat16", None, False, "kv"),
    ("mixer_k_is_v", MIXER_SHAPE, "bfloat16", None, False, "kv"),
    ("odd_d12", (8, 2, 5, 7, 12), "bfloat16", "broadcast", False, None),
    ("causal_per_head_d12", (4, 3, 33, 70, 12), "bfloat16", "per_head",
     True, None),
    ("causal_per_head", (64, 4, 65, 65, 64), "bfloat16", "per_head", True,
     None),
    ("all_masked_row_d8", (16, 2, 40, 40, 8), "bfloat16", "all_masked_row",
     True, None),
    ("negative_logits_agent", (256, 1, 4, 65, 256), "bfloat16", None, False,
     "negative"),
    ("negative_logits_d64", (64, 2, 65, 131, 64), "bfloat16", None, False,
     "negative"),
]
#: f32 cases at the f32 tensor-core bodies' edges, shared by [kernels] and
#: [kernels-bwd]: k is v at both learner shapes (staged once), the serve
#: shape as strided (B, T, H, D) views, the pad-key trap of all-negative
#: logits at Tq 4, 65 and 268 (D 256 and 64), and causal with a per-head
#: mask at D 12 (scalar staging); with the cases of each phase they cover
#: Tq 4/65/268, Tk 65/131 and D 8/12/64/256
F32_EDGES = [
    ("agent_k_is_v", AGENT_SHAPE, "float32", None, False, "kv"),
    ("mixer_k_is_v", MIXER_SHAPE, "float32", None, False, "kv"),
    ("serve_strided", (4096, 4, 65, 65, 64), "float32", None, False,
     "strided"),
    ("negative_logits_agent", (256, 1, 4, 65, 256), "float32", None, False,
     "negative"),
    ("negative_logits_d64", (64, 2, 65, 131, 64), "float32", None, False,
     "negative"),
    ("negative_logits_mixer", (4, 1, 268, 131, 256), "float32", None, False,
     "negative"),
    ("causal_per_head_d12", (4, 3, 33, 70, 12), "float32", "per_head", True,
     None),
]


def phase_kernels(torch, att):
    """Kernel vs plain at every case; times at the serve shape."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [
        # (name, (B, H, Tq, Tk, D), dtype, mask, causal, extra)
        ("serve", (4096, 4, 65, 65, 64), "float32", None, False, None),
        ("serve", (4096, 4, 65, 65, 64), "bfloat16", None, False, None),
        ("serve_strided", (4096, 4, 65, 65, 64), "bfloat16", None, False,
         "strided"),
        ("q1_heads_d256", (1024, 4, 65, 65, 256), "float32", None, False,
         None),
        ("qslice_rows", (4096, 1, 4, 65, 256), "float32", None, False, None),
        ("odd", (8, 2, 5, 7, 12), "float32", "broadcast", False, None),
        ("masked_per_head_causal", (64, 4, 65, 65, 64), "float32",
         "per_head", True, None),
        ("masked_broadcast_bf16", (64, 4, 65, 65, 64), "bfloat16",
         "broadcast", False, None),
        ("all_masked_row", (16, 2, 40, 40, 8), "float32",
         "all_masked_row", True, None),
        ("agent", AGENT_SHAPE, "bfloat16", None, False, None),
        ("mixer", MIXER_SHAPE, "bfloat16", None, False, None),
        ("agent", AGENT_SHAPE, "float32", None, False, None),
        ("mixer", MIXER_SHAPE, "float32", None, False, None),
        ("mixer6", MIXER6_SHAPE, "float32", None, False, None),
        ("mixer6_k_is_v", MIXER6_SHAPE, "float32", None, False, "kv"),
    ] + [(name, shape, dt, None, False, None)
         for name, shape in DENSE_SHAPES.items()
         for dt in ("float32", "bfloat16")] + [
        (name, shape, dt, None, False, extra)
        for name, shape, extra in (("agent5", AGENT5_SHAPE, None),
                                   ("mixer5", MIXER5_SHAPE, "kv"))
        for dt in ("float32", "bfloat16")] + BF16_EDGES + F32_EDGES
    errs = {}
    inputs = {}
    for name, (b, h, tq, tk, d), dt, mask, causal, extra in cases:
        dtype = getattr(torch, dt)
        q, k, v, _, m = make_inputs(torch, g, (b, h, tq, tk, d), dt, mask,
                                    extra)
        out = att.flash_attention(q, k, v, mask=m, causal=causal)
        torch.cuda.synchronize()
        bias = None if m is None else torch.where(m, 0.0,
                                                  att.NEG_MASK_VALUE)
        ref = att.flash_attention_reference(q, k, v, bias, causal)
        err = (out.float() - ref.float()).abs().max().item()
        check(out.dtype == dtype and out.shape == q.shape and
              out.stride() == q.stride(),
              f"{name} output {out.dtype} {tuple(out.shape)}")
        check(err <= TOL[dt], f"{name} {dt} max|kernel-plain| {err:.3e} "
                              f"> {TOL[dt]:.0e}")
        if mask == "all_masked_row":
            uni = (out[:, :, 3].float() - v.float().mean(dim=2)).abs().max()
            check(uni.item() <= TOL[dt], f"all-masked row not uniform "
                                         f"({uni.item():.3e})")
        errs[(name, dt)] = err
        print(f"[kernels] flash_fwd {name} B,H,Tq,Tk,D={b},{h},{tq},{tk},"
              f"{d} {dt} mask={mask} causal={causal} extra={extra} "
              f"max_abs_err={err:.3e} limit={TOL[dt]:.0e} ok", flush=True)
        if name in ("serve", "serve_strided"):
            inputs[(name, dt)] = (q, k, v)
        del q, k, v, out, ref

    import torch.nn.functional as F
    times = {}
    for (name, dt), (q, k, v) in inputs.items():
        b, h, tq, d = q.shape
        tk = k.shape[2]
        ms = cuda_ms(lambda: att.flash_attention(q, k, v))
        plain = cuda_ms(lambda: att.flash_attention_reference(q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                             scale=1.0))
        bound, by = kernel_bounds((b, h, tq, tk, d), dt)["flash_fwd"]
        times[(name, dt)] = (ms, plain, lib, bound, by)
        print(f"[kernels] flash_fwd time at {name} shape {b}x{h}x{tq}x{d} "
              f"{dt}: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa "
              f"{lib:.4f} ms, bound {bound:.4f} ms ({by}), kernel/bound "
              f"{ms / bound:.2f}x", flush=True)
    del inputs
    torch.cuda.empty_cache()
    return errs, times


def phase_serve(torch, att):
    import numpy as np
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.envs.registry import make_env
    from t2omca_tpu_torch.serve.frontend import ServeFrontend, SessionStore

    rng = np.random.default_rng(SEED)

    def cfg_for(dtype, use_qslice=False, attention="pallas"):
        d = json.loads(json.dumps(NORTH_STAR))
        d["model"].update(dtype=dtype, use_qslice=use_qslice)
        d["kernels"] = {"attention": attention}
        return from_dict(d)

    cfg32 = cfg_for("float32")
    info = make_env(cfg32.env_args).get_env_info()
    a, od, na = info["n_agents"], info["obs_shape"], info["n_actions"]
    emb, depth = cfg32.model.emb, cfg32.model.depth
    check((a, od, na) == (64, 576, 9), f"north-star sizes {a}/{od}/{na}")
    params = BasicMAC.build(cfg32, info).init_params(
        torch.Generator().manual_seed(SEED))

    def requests(n):
        obs = rng.standard_normal((n, a, od)).astype(np.float32)
        avail = rng.random((n, a, na)) < 0.6
        avail[..., 0] = True
        return obs, avail

    def legal(actions, avail):
        n = actions.shape[0]
        return bool(avail[np.arange(n)[:, None], np.arange(a)[None],
                          actions].all())

    fes = {}
    att.reset_launches()                 # ---- the main path starts here
    dispatches = 0
    for dt in ("float32", "bfloat16"):
        fe = ServeFrontend(cfg_for(dt), params, BUCKETS, dtype=dt)
        fes[dt] = fe
        fe.warmup()
        dispatches += len(BUCKETS)
        lat = {}
        for n in REQUEST_SIZES:
            hidden = None
            for r in range(REPEATS):
                obs, avail = requests(n)
                t0 = time.perf_counter()
                actions, hidden = fe.select(obs, avail, hidden)
                lat.setdefault(n, []).append(
                    (time.perf_counter() - t0) * 1e3)
                dispatches += -(-n // BUCKETS[-1])
                check(actions.shape == (n, a) and legal(actions, avail),
                      f"{dt} n={n}: illegal action")
                check(np.isfinite(hidden).all(), f"{dt} n={n}: hidden "
                                                 f"not finite")
        per_bucket = {}
        for b in BUCKETS:
            for _ in range(REPEATS):
                obs, avail = requests(b)
                t0 = time.perf_counter()
                fe.select(obs, avail)
                per_bucket.setdefault(b, []).append(
                    (time.perf_counter() - t0) * 1e3)
                dispatches += 1
        store = SessionStore(fe)
        ids = [f"s{i}" for i in range(7)]
        for turn in range(3):
            obs, avail = requests(len(ids))
            actions, fresh = store.select(ids, obs, avail)
            dispatches += 1
            check(bool(fresh.all()) if turn == 0 else not fresh.any(),
                  f"{dt} session turn {turn}: fresh={fresh}")
            check(legal(actions, avail), f"{dt} session: illegal action")
        check(len(store) == len(ids) and all(
            np.isfinite(h).all() for h in store._h.values()),
            f"{dt} session carry")
        print(f"[serve] {dt} requests p50 ms: " + ", ".join(
            f"n={n}: {statistics.median(v):.3f}" for n, v in lat.items()),
            flush=True)
        print(f"[serve] {dt} per-bucket p50 ms (one dispatch, host clock "
              f"incl. H2D/D2H): " + ", ".join(
                  f"b={b}: {statistics.median(v):.3f}"
                  for b, v in per_bucket.items()), flush=True)
    launches = dict(att.LAUNCHES)        # ---- the main path ends here
    check(launches["flash_fwd"] == depth * dispatches,
          f"flash_fwd launched {launches['flash_fwd']} times on the main "
          f"path, expected depth*dispatches = {depth * dispatches}")
    print(f"[serve] main path: {dispatches} dispatches, flash_fwd launches "
          f"{launches['flash_fwd']} (= depth {depth} x dispatches)",
          flush=True)

    # f32 cross-check: kernel-path dense forward vs the query-slice path
    fe = fes["float32"]
    mac_qs = BasicMAC.build(cfg_for("float32", use_qslice=True,
                                    attention="xla"), info)
    folded = mac_qs.prepare_acting_params(
        {k: v.cuda() for k, v in params.items()})
    obs, avail = requests(BUCKETS[-1])
    o = torch.from_numpy(obs).cuda()
    av = torch.from_numpy(avail).cuda()
    h0 = torch.zeros(o.shape[0], a, emb, device="cuda")
    with torch.inference_mode():
        q_k, h_k = fe.mac.forward(fe.params, o, h0)
        q_s, h_s = mac_qs.forward_qslice(folded, o, h0)
        masked_s = torch.where(av, q_s, float("-inf"))
        top2 = masked_s.topk(2, dim=-1).values
    dq = (q_k - q_s).abs().max().item()
    dh = (h_k - h_s).abs().max().item()
    check(dq <= 1e-4, f"kernel path vs query slice: max|dq| {dq:.3e} > 1e-4")
    a_k = torch.where(av, q_k, float("-inf")).argmax(-1)
    a_s = masked_s.argmax(-1)
    # a row may flip only where the slice's own top-2 gap is within the
    # measured q difference (a tie at f32 resolution)
    near_tie = (top2[..., 0] - top2[..., 1]) <= 2 * dq
    flips = (a_k != a_s)
    check(not bool((flips & ~near_tie).any()),
          f"kernel path and query slice pick different actions on "
          f"{int((flips & ~near_tie).sum())} non-tied rows")
    print(f"[serve] f32 kernel path vs query slice over {o.shape[0]}x{a} "
          f"rows: max|dq|={dq:.3e} (limit 1e-4) max|dh|={dh:.3e} action "
          f"mismatches={int(flips.sum())} (near-ties {int(near_tie.sum())})",
          flush=True)
    return launches, fes, requests


def phase_profile(torch, fe, requests, dt: str, n_iter: int = 3):
    """Where one max-bucket dispatch at ``dt`` spends device time: kernels
    and copies by self device time (torch.profiler), against the host
    clock of the same dispatches."""
    from torch.profiler import ProfilerActivity, profile
    obs, avail = requests(BUCKETS[-1])
    fe.select(obs, avail)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_iter):
            fe.select(obs, avail)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_iter
    rows = device_rows(prof, n_iter)
    busy = sum(r[0] for r in rows)
    check(busy > 0, "profiler saw no device time")
    rows.sort(reverse=True)
    print(f"[profile] {dt} bucket-{BUCKETS[-1]} dispatch: host {wall:.3f} ms,"
          f" device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%", flush=True)
    for ms, n, name in rows[:8]:
        print(f"[profile]   {ms:8.3f} ms {100 * ms / busy:5.1f}% x{n} "
              f"{name[:90]}", flush=True)


def phase_kernels_bwd(torch, att):
    """K1 + residuals, K2 and K3 against their plain versions; times at
    the learner shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    cases = [
        # (name, (B, H, Tq, Tk, D), dtype, mask, causal, extra)
        ("agent", AGENT_SHAPE, "float32", None, False, None),
        ("agent", AGENT_SHAPE, "bfloat16", None, False, None),
        ("mixer", MIXER_SHAPE, "float32", None, False, None),
        ("mixer", MIXER_SHAPE, "bfloat16", None, False, None),
        ("dense_heads", (64, 4, 65, 65, 64), "float32", None, False, None),
        ("odd", (8, 2, 5, 7, 12), "float32", "broadcast", False, None),
        ("masked_per_head_causal", (64, 4, 65, 65, 64), "float32",
         "per_head", True, None),
        ("masked_broadcast_bf16", (64, 4, 65, 65, 64), "bfloat16",
         "broadcast", False, None),
        ("all_masked_row", (16, 2, 40, 40, 8), "float32",
         "all_masked_row", True, None),
        ("mixer6", MIXER6_SHAPE, "float32", None, False, None),
        ("mixer6_k_is_v", MIXER6_SHAPE, "float32", None, False, "kv"),
    ] + [(name, shape, dt, None, False, None)
         for name, shape in DENSE_SHAPES.items()
         for dt in ("float32", "bfloat16")] + [
        (name, shape, dt, None, False, None)
        for name, shape in (("agent5", AGENT5_SHAPE),
                            ("mixer5", MIXER5_SHAPE))
        for dt in ("float32", "bfloat16")] + [
        (name, shape, "bfloat16", None, False, None)
        for name, shape in (("agent_half", AGENT_HALF_SHAPE),
                            ("mixer_half", MIXER_HALF_SHAPE))
    ] + BF16_EDGES + F32_EDGES
    errs, inputs = {}, {}
    for name, (b, h, tq, tk, d), dt, mask, causal, extra in cases:
        dtype = getattr(torch, dt)
        q, k, v, do, m = make_inputs(torch, g, (b, h, tq, tk, d), dt, mask,
                                     extra)
        bias = None if m is None else torch.where(m, 0.0,
                                                  att.NEG_MASK_VALUE)
        o, mm, ll = att._launch_res(q, k, v, bias, causal)
        dq, dk, dv = att._launch_bwd(q, k, v, bias, causal, o, mm, ll, do)
        torch.cuda.synchronize()
        o_r, m_r, l_r = att.flash_attention_fwd_reference(q, k, v, bias,
                                                          causal)
        ref = att.flash_attention_bwd_reference(q, k, v, bias, causal, o_r,
                                                m_r, l_r, do)
        rel_rows = lambda a, b_: ((a.double() - b_.double()).abs()
                                  / b_.double().abs().clamp(min=1e-30))
        m_rows = rel_rows(mm, m_r)
        m_err, l_err = m_rows.max().item(), rel_rows(ll, l_r).max().item()
        m_note, m_ok = "", m_err <= 1e-5
        if dt == "bfloat16" or not m_ok:
            # the row max in f64 from the same inputs: the exact value both
            # f32 versions approximate. Where a row's max is near 0, two f32
            # summation orders differ by more than 1e-5 relative and the
            # plain f32 value is itself that far from exact: such rows are
            # held to the exact value, at the same 1e-5
            _, m64, _ = att.flash_attention_fwd_reference(
                q.double(), k.double(), v.double(), bias, causal)
            off = m_rows > 1e-5
            k64, p64 = rel_rows(mm, m64), rel_rows(m_r, m64)
            m_note = (f" (m vs f64: kernel {k64.max().item():.1e}, plain "
                      f"{p64.max().item():.1e}")
            if bool(off.any()):
                m_ok = k64[off].max().item() <= 1e-5
                m_note += (f"; {int(off.sum())} rows off the plain f32 "
                           f"value by > 1e-5, where the kernel is "
                           f"{k64[off].max().item():.1e} and the plain f32 "
                           f"{p64[off].max().item():.1e} from f64")
            m_note += ")"
        check(m_ok and l_err <= 1e-5,
              f"{name} {dt} residuals: rel err m {m_err:.2e} l {l_err:.2e}"
              f"{m_note}")
        o_err = (o.float() - o_r.float()).abs().max().item()
        check(o_err <= TOL[dt], f"{name} {dt} K1+res output err {o_err:.3e}")
        rtol, atol = GRAD_TOL[dt]
        gerr = {}
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            check(got.dtype == dtype and got.shape == want.shape,
                  f"{name} {gname} {got.dtype} {tuple(got.shape)}")
            w32, g32 = want.float(), got.float()
            scale = max(w32.abs().max().item(), 1.0)
            lim = atol * (scale if dt == "bfloat16" else 1.0) \
                + rtol * w32.abs()
            bad = ((g32 - w32).abs() > lim).sum().item()
            gerr[gname] = (g32 - w32).abs().max().item()
            check(bad == 0, f"{name} {dt} {gname}: {bad} elements outside "
                            f"rtol {rtol} atol {atol} (max err "
                            f"{gerr[gname]:.3e})")
        if mask == "all_masked_row":
            check(dq[:, :, 3].abs().max().item() == 0.0,
                  "all-masked row: dq not exactly 0")
            check(dv.abs().max().item() > 0.0, "all-masked row: dv is 0")
            check(bool((mm[:, :, 3] == att.NEG_MASK_VALUE).all()) and
                  bool((ll[:, :, 3] == tk).all()),
                  "all-masked row: m != -1e9 or l != Tk")
        if extra == "negative":
            check(bool((mm < 0).all()), "a pad key entered a row's max")
        errs[(name, dt)] = {"flash_fwd_res": o_err,
                            "flash_bwd_dq": gerr["dq"],
                            "flash_bwd_dkv": max(gerr["dk"], gerr["dv"])}
        print(f"[kernels-bwd] {name} B,H,Tq,Tk,D={b},{h},{tq},{tk},{d} {dt}"
              f" mask={mask} causal={causal} extra={extra}: m/l rel err "
              f"{m_err:.1e}/{l_err:.1e}{m_note}, o {o_err:.2e}, dq "
              f"{gerr['dq']:.2e}, dk {gerr['dk']:.2e}, dv {gerr['dv']:.2e} "
              f"ok", flush=True)
        if (name in ("agent", "mixer", "mixer6", "agent5", "mixer5",
                     "agent_half", "mixer_half")
                or name in DENSE_SHAPES):
            inputs[(name, dt)] = (q, k, v, do)
        del q, k, v, do, o, dq, dk, dv, ref, o_r
    torch.cuda.empty_cache()

    import torch.nn.functional as F
    times = {}
    for (name, dt), (q, k, v, do) in inputs.items():
        shape = (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3])
        qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qr, kr, vr, scale=1.0)
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0))
        # device time: the host's trip through the autograd engine takes
        # longer than SDPA's backward kernels at these shapes
        sdpa_bwd = device_ms(lambda: torch.autograd.grad(
            out, (qr, kr, vr), do, retain_graph=True))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qr, kr, vr,
                                           scale=1.0).backward(do)

        def flash_fwd_bwd():
            att.flash_attention(qr, kr, vr).backward(do)

        sdpa = cuda_ms(sdpa_fwd_bwd)
        flash_total = cuda_ms(flash_fwd_bwd)
        # k is v (the query-slice call): K1, K1 + residuals, K2 and K3 read
        # the one tensor once; the dense modules project k and v apart
        # config 5's rows time their path's call alone: the mixer's k is
        # v, the agent's query slice projects them apart
        for kv_same in ((False,) if name in DENSE_SHAPES
                        or name == "agent5" else (True,)
                        if name == "mixer5" else (False, True)):
            vv = k if kv_same else v
            o, mm, ll = att._launch_res(q, k, vv, None, False)
            delta = (do.float() * o.float()).sum(dim=-1)
            bounds = kernel_bounds(shape, dt, kv_same)
            row = {
                "flash_fwd": (
                    cuda_ms(lambda: att._launch(q, k, vv, None, False)),
                    cuda_ms(lambda: att.flash_attention_reference(q, k, vv)),
                    sdpa_fwd),
                "flash_fwd_res": (
                    cuda_ms(lambda: att._launch_res(q, k, vv, None, False)),
                    cuda_ms(lambda: att.flash_attention_fwd_reference(
                        q, k, vv)), sdpa_fwd),
                "flash_bwd_dq": (
                    cuda_ms(lambda: att._launch_bwd_dq(
                        q, k, vv, None, False, do, mm, ll, delta)), None,
                    sdpa_bwd),
                "flash_bwd_dkv": (
                    cuda_ms(lambda: att._launch_bwd_dkv(
                        q, k, vv, None, False, do, mm, ll, delta)), None,
                    sdpa_bwd),
            }
            plain_bwd = cuda_ms(lambda: att.flash_attention_bwd_reference(
                q, k, vv, None, False, o, mm, ll, do))
            tag = name + ("_k_is_v" if kv_same else "")
            for kname, (ms, plain, lib) in row.items():
                bnd, by = bounds[kname]
                times[(kname, tag, dt)] = dict(
                    ms=ms, plain_ms=plain if plain is not None else plain_bwd,
                    bound_ms=bnd, bound_by=by, library_ms=lib,
                    shape=list(shape), dtype=dt, k_is_v=kv_same)
                print(f"[kernels-bwd] time {kname} {tag} {dt}: kernel "
                      f"{ms:.4f} ms, plain "
                      f"{times[(kname, tag, dt)]['plain_ms']:.4f} ms, bound "
                      f"{bnd:.4f} ms ({by}), sdpa "
                      f"{'fwd' if kname.startswith('flash_fwd') else 'bwd'} "
                      f"{lib:.4f} ms, kernel/bound {ms / bnd:.1f}x, "
                      f"kernel/sdpa {ms / lib:.2f}x", flush=True)
            del o, mm, ll, delta
        print(f"[kernels-bwd] time {name} {dt}: flash fwd+bwd through the "
              f"autograd Function {flash_total:.4f} ms vs sdpa fwd+bwd "
              f"{sdpa:.4f} ms (sdpa fwd {sdpa_fwd:.4f}, bwd alone "
              f"{sdpa_bwd:.4f} device time; plain bwd covers dq, dk, dv "
              f"together)",
              flush=True)
        del qr, kr, vr, out
    del inputs
    torch.cuda.empty_cache()
    return errs, times


def train_cfg(dtype: str, attention: str = "pallas", use_qslice=True,
              batch_size: int = 32, episode_limit: int = 150,
              remat: bool = False, dropout: float = 0.0):
    from t2omca_tpu_torch.config import from_dict
    d = json.loads(json.dumps(NORTH_STAR))
    d["batch_size"] = batch_size
    d["env_args"]["episode_limit"] = episode_limit
    d["model"].update(dtype=dtype, use_qslice=use_qslice, remat=remat,
                      dropout=dropout)
    d["kernels"] = {"attention": attention}
    d["replay"] = {"buffer_size": RING, "store_dtype": "bfloat16",
                   "compact_entity_store": False}
    return from_dict(d)


def make_episodes(torch, info, b: int, t: int, g, store_dtype):
    """Seeded episodes on the card: obs/state ~N(0, 1), action 0 always
    available and every action legal, rewards ~N(0, 1); every 4th
    episode terminates mid-way (filled stops after it), every 4th + 1 is
    cut short."""
    from t2omca_tpu_torch.components.episode_buffer import EpisodeBatch
    dev = torch.device("cuda")
    a, n = info["n_agents"], info["n_actions"]
    r = lambda *s: torch.rand(*s, device=dev, generator=g)
    avail = r(b, t + 1, a, n) < 0.6
    avail[..., 0] = True
    actions = torch.where(avail[:, :-1], r(b, t, a, n), -1.0).argmax(-1)
    stop = torch.randint(t // 2, t, (b,), device=dev, generator=g)
    steps = torch.arange(t, device=dev)
    kind = torch.arange(b, device=dev) % 4
    term = (kind == 0)[:, None] & (steps[None] == stop[:, None])
    cut = (kind <= 1)[:, None] & (steps[None] > stop[:, None])
    return EpisodeBatch(
        obs=torch.randn(b, t + 1, a, info["obs_shape"], device=dev,
                        generator=g).to(store_dtype),
        state=torch.randn(b, t + 1, info["state_shape"], device=dev,
                          generator=g).to(store_dtype),
        avail_actions=avail, actions=actions.to(torch.int32),
        reward=torch.randn(b, t, device=dev, generator=g),
        terminated=term, filled=~cut)


def build_learner(cfg, info):
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.learners import QMixLearner
    return QMixLearner.build(cfg, BasicMAC.build(cfg, info), info)


def phase_train(torch, att):
    """The trainer step at the north-star widths through the kernels."""
    import numpy as np
    from t2omca_tpu_torch.components.episode_buffer import \
        PrioritizedReplayBuffer
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.envs.registry import make_env
    from t2omca_tpu_torch.train.program import TrainState, build_train_iter

    cfg = train_cfg("bfloat16")
    info = make_env(cfg.env_args).get_env_info()
    t, depth = cfg.env_args.episode_limit, cfg.model.depth
    check(cfg.model.mixer_depth == depth, "agent and mixer depth differ")
    buffer = PrioritizedReplayBuffer(
        capacity=RING, episode_limit=t, n_agents=info["n_agents"],
        n_actions=info["n_actions"], obs_dim=info["obs_shape"],
        state_dim=info["state_shape"], store_dtype="bfloat16",
        alpha=cfg.replay.per_alpha, beta0=cfg.replay.per_beta,
        t_max=cfg.t_max)
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    ring = buffer.insert_episode_batch(
        buffer.init(), make_episodes(torch, info, RING, t, g, torch.bfloat16))
    print(f"[train] north-star widths: {info['n_agents']} agents, obs "
          f"{info['obs_shape']}, state {info['state_shape']}, "
          f"{info['n_actions']} actions, T={t}, batch {cfg.batch_size}, "
          f"bf16, kernels.attention=pallas, dense replay; ring cut from "
          f"2048 to {RING} episodes", flush=True)

    def run(cfg, steps, keys, buffer, ring):
        learner = build_learner(cfg, info)
        ls = learner.init_state(torch.Generator().manual_seed(SEED))
        # the priority feedback writes in place: each run steps on its
        # own copy of the ring's priorities, so the ring keeps the ones
        # it was built with (the cross-checks below sample from it)
        ts = TrainState(learner=ls, buffer=dataclasses.replace(
            ring, priorities=ring.priorities.clone()),
            episode=torch.tensor(RING, dtype=torch.int32, device="cuda"))
        train_iter = build_train_iter(buffer, learner, cfg)
        p0 = {m: {k: v.clone() for k, v in sub.items()}
              for m, sub in ls.params.items()}
        times, infos = [], []
        for i in range(steps):
            before = ts.buffer.priorities.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, info_i = train_iter(ts, keys[i], 1000 * (i + 1))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            loss, gn = float(info_i["loss"]), float(info_i["grad_norm"])
            check(np.isfinite(loss) and np.isfinite(gn),
                  f"step {i}: loss {loss} grad_norm {gn}")
            check(bool(info_i["all_finite"]), f"step {i}: all_finite False")
            check(bool((ts.buffer.priorities != before).any()),
                  f"step {i}: no sampled priority changed")
            infos.append((loss, gn))
        moved = max((ts.learner.params[m][k] - p0[m][k]).abs().max().item()
                    for m in p0 for k in p0[m])
        check(moved > 0.0, "params did not move")
        return ts, learner, times, infos, moved

    keys = prng.split(prng.PRNGKey(SEED + 12, "cuda"), TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()                 # ---- the train path starts here
    ts, learner, times, infos, moved = run(cfg, TRAIN_STEPS, keys, buffer,
                                           ring)
    launches = dict(att.LAUNCHES)        # ---- the train path ends here
    peak_bf16 = torch.cuda.max_memory_allocated() / 2 ** 30
    # per step: the target agent and mixer unrolls (T+1 steps each) and
    # the online agent's bootstrap step T run K1; the online agent and
    # mixer unrolls (T steps each) run K1 + residuals, then K2 and K3
    want = {"flash_fwd": TRAIN_STEPS * (2 * (t + 1) + 1) * depth,
            "flash_fwd_res": TRAIN_STEPS * 2 * t * depth,
            "flash_bwd_dq": TRAIN_STEPS * 2 * t * depth,
            "flash_bwd_dkv": TRAIN_STEPS * 2 * t * depth}
    check(launches == want, f"train launches {launches} != {want}")
    p50 = statistics.median(times)
    print(f"[train] bf16 {TRAIN_STEPS} trainer steps: p50 {p50:.1f} ms "
          f"(each: {', '.join(f'{x:.1f}' for x in times)}), loss/grad_norm "
          f"{', '.join(f'{a:.4g}/{b:.4g}' for a, b in infos)}, max param "
          f"move {moved:.3e}, peak memory {peak_bf16:.2f} GiB", flush=True)
    print(f"[train] launches over {TRAIN_STEPS} steps: {launches} (= per "
          f"step: K1 (2(T+1)+1)·depth for the target unrolls and the "
          f"online agent's bootstrap step, which feeds only the detached "
          f"double-Q argmax; K1+res, K2, K3 2T·depth for the online "
          f"unrolls)", flush=True)
    result = {"p50_bf16_ms": p50, "launches": launches,
              "peak_bf16_gib": peak_bf16}
    del ts, learner
    torch.cuda.empty_cache()

    # f32 at full length when twice the bf16 peak fits with room to spare
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    t32 = t if 2.2 * peak_bf16 < 0.85 * total else t // 3
    cfg32 = train_cfg("float32", episode_limit=t32)
    buf32, ring32 = buffer, ring
    if t32 != t:
        buf32 = dataclasses.replace(buffer, episode_limit=t32)
        ring32 = buf32.insert_episode_batch(
            buf32.init(), make_episodes(torch, info, RING, t32, g,
                                        torch.bfloat16))
    torch.cuda.reset_peak_memory_stats()
    times32 = run(cfg32, TRAIN_STEPS, keys, buf32, ring32)[2]
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    p50_32 = statistics.median(times32)
    print(f"[train] f32 {TRAIN_STEPS} trainer steps at T={t32}"
          f"{'' if t32 == t else ' (episode_limit cut: f32 would not fit)'}"
          f": p50 {p50_32:.1f} ms, peak memory {peak32:.2f} GiB", flush=True)
    result.update(p50_f32_ms=p50_32, f32_episode_limit=t32)
    torch.cuda.empty_cache()

    # f32 cross-check, full width, batch 2: pallas against xla
    batch, _, w = buffer.sample(
        ring, None, 2, 1000, u=torch.tensor([0.25, 0.75], device="cuda"))
    for use_qslice in (True, False):
        outs = {attention: cross_check_step(torch, info, attention,
                                            use_qslice, batch, w)
                for attention in ("pallas", "xla")}
        report = compare_steps(torch, outs["pallas"], outs["xla"],
                               cfg.lr, cfg.optim_eps)
        what = "query slice" if use_qslice else "dense"
        print(f"[train] f32 cross-check ({what}, batch 2, T={t}, gate "
              f"{CROSS_GATE}): pallas vs xla {report}", flush=True)
        del outs
        torch.cuda.empty_cache()
    result["cross_batch"] = (batch, w)    # [remat]'s cross-check reuses it
    return result, buffer, ring, cfg, info


#: the f32 cross-check's operating point: the zero-init mixer gate
#: (model.mixer_zero_init) opened to this value. At the reference init
#: the mixer's q_tot at emb 256 is O(1e3), the loss O(1e7) and the
#: pre-clip gradient norm O(1e7), where two f32 lowerings of the same
#: function differ by ~1e-4 in grad_norm from rounding alone (PERF.md).
CROSS_GATE = 1e-3


def cross_check_step(torch, info, attention, use_qslice, batch, w,
                     remat: bool = False, dropout: float = 0.0, key=None,
                     episode_limit: int = 150):
    """One f32 train step at batch 2 → (loss, grad_norm, clipped
    gradients, params after the step). With ``dropout`` the step draws
    its masks from ``key``."""
    from t2omca_tpu_torch.learners.qmix_learner import (
        clip_by_global_norm, global_norm)
    cfg = train_cfg("float32", attention, use_qslice, batch_size=2,
                    remat=remat, dropout=dropout,
                    episode_limit=episode_limit)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, mixer_zero_init=True))
    lrn = build_learner(cfg, info)
    ls = lrn.init_state(torch.Generator().manual_seed(SEED))
    for tree in (ls.params, ls.target_params):
        tree["mixer"]["out_gate"].fill_(CROSS_GATE)
    params = {m: {k: v.detach().requires_grad_() for k, v in sub.items()}
              for m, sub in ls.params.items()}
    loss, _ = lrn._loss(params, ls.target_params, batch, w, key)
    leaves = [(m, k) for m in params for k in params[m]]
    grads = torch.autograd.grad(loss, [params[m][k] for m, k in leaves],
                                allow_unused=True)
    tree = {m: {} for m in params}
    for (m, k), g in zip(leaves, grads):
        tree[m][k] = torch.zeros_like(params[m][k]) if g is None else g
    clipped = clip_by_global_norm(tree, global_norm(tree),
                                  cfg.grad_norm_clip)
    ls2, inf = lrn.train(ls, batch, w, 1000, RING, key)
    return (float(inf["loss"]), float(inf["grad_norm"]), clipped,
            ls2.params)


def compare_steps(torch, pallas, xla, lr: float, eps: float) -> str:
    """Hold one pallas step against one xla step: loss rtol 1e-5,
    grad_norm rtol 1e-4, every clipped gradient tensor within 1e-3 of
    its own max, params within atol 1e-5 wherever Adam's first step is
    well-conditioned (clipped |g| >= 10·eps) and, elsewhere, within the
    step's own sensitivity lr·|Δg|/eps (+1e-6): Adam's first update
    -lr·g/(|g| + eps) has slope lr/eps there."""
    (lp, gp, cp, pp), (lx, gx, cx, px) = pallas, xla
    dl = abs(lp - lx) / max(abs(lx), 1e-30)
    dg = abs(gp - gx) / max(abs(gx), 1e-30)
    check(dl <= 1e-5, f"loss rel {dl:.2e} > 1e-5")
    check(dg <= 1e-4, f"grad_norm rel {dg:.2e} > 1e-4")
    worst_g = worst_well = worst_all = 0.0
    for m in px:
        for k in px[m]:
            gdiff = (cp[m][k] - cx[m][k]).abs()
            scale = cx[m][k].abs().max().item()
            rel = gdiff.max().item() / max(scale, 1e-30)
            check(rel <= 1e-3, f"{m}.{k}: clipped gradient off by {rel:.2e}"
                               f" of its max")
            worst_g = max(worst_g, rel)
            pdiff = (pp[m][k] - px[m][k]).abs()
            well = cx[m][k].abs() >= 10 * eps
            if bool(well.any()):
                worst_well = max(worst_well, pdiff[well].max().item())
            bad = pdiff > lr * gdiff / eps + 1e-6
            check(not bool((bad & ~well).any()),
                  f"{m}.{k}: params off by more than lr·|Δg|/eps")
            worst_all = max(worst_all, pdiff.max().item())
    check(worst_well <= 1e-5, f"params (well-conditioned) off by "
                              f"{worst_well:.2e} > 1e-5")
    return (f"loss {lp:.6g}/{lx:.6g} rel {dl:.2e} (1e-5), grad_norm rel "
            f"{dg:.2e} (1e-4), clipped grads {worst_g:.2e} of each "
            f"tensor's max (1e-3), params {worst_well:.2e} where |g| >= "
            f"10·eps (1e-5), {worst_all:.2e} over all elements "
            f"(<= lr·|Δg|/eps) ok")


def phase_profile_train(torch, buffer, ring, cfg, info):
    """Where one bf16 trainer step spends device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.train.program import TrainState, build_train_iter
    learner = build_learner(cfg, info)
    ts = TrainState(learner=learner.init_state(
        torch.Generator().manual_seed(SEED)), buffer=ring,
        episode=torch.tensor(RING, dtype=torch.int32, device="cuda"))
    train_iter = build_train_iter(buffer, learner, cfg)
    k1, k2 = prng.split(prng.PRNGKey(SEED + 13, "cuda")).unbind(0)
    ts, _ = train_iter(ts, k1, 1000)
    torch.cuda.synchronize()
    # the device rows are all that is read: no CPU activity, whose ~200 k
    # op events cost more to trace and fold than the step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_iter(ts, k2, 2000)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    names = [r[2] for r in rows]
    for k in BF16_TC_KERNELS:
        check(any(k in n for n in names),
              f"the bf16 trainer step ran no {k}")
    for gone in GONE_BODIES:
        check(not any(f"{gone}<" in n for n in names),
              f"the bf16 trainer step ran the old {gone}")
    busy = sum(r[0] for r in rows)
    check(busy > 0, "profiler saw no device time in the trainer step")
    rows.sort(reverse=True)
    print(f"[profile] bf16 trainer step: host {wall:.1f} ms (profiled), "
          f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%", flush=True)
    for ms, n, name in rows[:12]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n} "
              f"{name[:90]}", flush=True)


#: the loop phases, at config 3's widths (bf16, kernels.attention=pallas
#: as the port's kernels are on that switch, PER with bf16 storage):
#: [loop] on the default stack (entity-table acting, compact storage) at
#: config 3's own 1024 lanes and 2048-episode ring, uncut; [loop-dense]
#: with the config's kill switch model.use_entity_tables=false, which
#: stores dense bf16 obs (11.1 MB a lane-episode) and so is cut to 128
#: lanes and a ring of 256; [loop-noisy] one iteration of NoisyNet's
#: q-head noise (action_selector noisy-new) on the default stack at 128
#: lanes
LOOP_LANES = 1024                   # batch_size_run, config 3's own
LOOP_RING = 2048                    # replay.buffer_size, config 3's own
LOOP_ITERATIONS = 3                 # 3072 episodes: the ring wraps
LOOP_T = 50                         # [loop] (and [sight], [remat] and
#                                     [superstep] on its state):
#                                     episode_limit 150 -> 50, the
#                                     smoke's time limit (PERF.md §4)
DENSE_LANES = 128                   # [loop-dense]: 1024 -> 128
DENSE_RING = 256                    # [loop-dense]: 2048 -> 256
DENSE_ITERATIONS = 2                # [loop-dense]: 3 -> 2, to fit [dp] in
#                                     the limit ([loop] keeps the ring's wrap)
NOISY_LANES = 128                   # [loop-noisy]: 1024 -> 128
#: the public samplers of the PRNG module, wrapped to count their ops
PRNG_FUNCS = ("split", "fold_in", "random_bits", "uniform", "bernoulli",
              "randint", "gumbel", "normal")


def loop_cfg(lanes: int = LOOP_LANES, ring: int = LOOP_RING,
             entity_tables: bool = True, selector: str = "epsilon_greedy",
             dtype: str = "bfloat16"):
    from t2omca_tpu_torch.config import from_dict
    d = json.loads(json.dumps(NORTH_STAR))
    d["batch_size_run"] = lanes
    d["action_selector"] = selector
    d["model"].update(dtype=dtype, use_entity_tables=entity_tables)
    d["kernels"] = {"attention": "pallas"}
    d["replay"] = {"buffer_size": ring, "store_dtype": "bfloat16",
                   "prioritized": True}
    return from_dict(d)


def loop_launches(cfg) -> dict:
    """Kernel launches of one train iteration. The mixer's unrolls run
    the flash kernels: the target unroll K1 (T+1)·depth, the online one
    K1 + residuals, K2 and K3 T·depth. Under compact storage the agent's
    unrolls go through the entity tables and launch nothing; with dense
    obs they add the [train] phase's agent-shape launches: K1 (T+1)·depth
    for the target unroll and depth for the online bootstrap step, K1 +
    residuals, K2, K3 T·depth."""
    from t2omca_tpu_torch.ops.query_slice import entity_store_eligible
    t, depth = cfg.env_args.episode_limit, cfg.model.depth
    check(cfg.model.mixer_depth == depth, "agent and mixer depth differ")
    if entity_store_eligible(cfg):
        return {"flash_fwd": (t + 1) * depth, "flash_fwd_res": t * depth,
                "flash_bwd_dq": t * depth, "flash_bwd_dkv": t * depth}
    return {"flash_fwd": (2 * (t + 1) + 1) * depth,
            "flash_fwd_res": 2 * t * depth, "flash_bwd_dq": 2 * t * depth,
            "flash_bwd_dkv": 2 * t * depth}


def assert_close_bf16_ulp(torch, actual, desired, max_ulp: int = 32
                          ) -> float:
    """bf16 agreement per element in bf16 ULPs, the ULP floored at the
    tensor's RMS (tests/test_entity_tables.py's bound) → worst ULPs."""
    a = actual.to(torch.bfloat16).double()
    d = desired.to(torch.bfloat16).double()
    scale = torch.maximum(torch.maximum(a.abs(), d.abs()),
                          d.pow(2).mean().sqrt())
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7.0)
    worst = float(((a - d).abs() / ulp).max())
    check(worst <= max_ulp, f"bf16 agreement {worst:.1f} ULPs > {max_ulp}")
    return worst


def phase_entity(torch):
    """The entity-table forward at the north-star widths against the
    query-slice forward on the env's dense obs; one acting forward at
    1024 lanes each way."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.run import Experiment
    lanes, steps = 8, 3
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = loop_cfg(lanes=lanes, ring=64, dtype=dt)
        exp = Experiment.build(cfg)
        env, mac = exp.env, exp.mac
        check(mac.use_entity_tables, "the default stack does not act "
                                     "through the entity tables")
        params = mac.init_params(torch.Generator().manual_seed(SEED))
        g = torch.Generator(device="cuda").manual_seed(SEED + 21)
        keys = prng.split(prng.PRNGKey(SEED + 22, "cuda"), lanes)
        state, (dense, compact), _, avail = env.reset(keys,
                                                      obs_form="both")
        ep = env.default_params(lanes)
        worst_obs = 0.0
        for i in range(steps + 1):
            rows, same_mec, mean, std = compact
            b, a, f = rows.shape[0], env.n_agents, env.obs_entity_feats
            rows9 = torch.cat([rows, rows.new_zeros(b, a, 1)], dim=-1)
            raw = torch.where(same_mec[..., None], rows9[:, None], 0.0)
            diag = torch.arange(a, device="cuda")
            raw[:, diag, diag, f - 1] = 1.0
            rebuilt = ((raw - mean[:, None]) / (std + 1e-8)[:, None]
                       ).reshape(b, a, a * f)
            torch.testing.assert_close(rebuilt, dense, rtol=1e-5,
                                       atol=1e-6)
            worst_obs = max(worst_obs, float((rebuilt - dense).abs().max()))
            if i == steps:
                break
            acts = torch.where(avail > 0, torch.rand(
                avail.shape, device="cuda", generator=g), -1.0).argmax(-1)
            state, _, _, _, (dense, compact), _, avail = env.step(
                state, acts, prng.split(prng.PRNGKey(SEED + 30 + i, "cuda"),
                                        lanes), ep, obs_form="both")
        hidden = torch.randn(lanes, env.n_agents, cfg.model.emb,
                             device="cuda", generator=g)
        q_obs, h_obs = mac.forward_qslice(params, dense, hidden)
        q_ent, h_ent = mac.forward_entity(params, compact, hidden)
        if dt == "float32":
            torch.testing.assert_close(q_ent, q_obs, rtol=2e-4, atol=2e-5)
            torch.testing.assert_close(h_ent, h_obs, rtol=2e-4, atol=2e-5)
            err = max(float((q_ent - q_obs).abs().max()),
                      float((h_ent - h_obs).abs().max()))
            what = f"max abs err {err:.2e} (rtol 2e-4, atol 2e-5)"
        else:
            worst = max(assert_close_bf16_ulp(torch, q_ent, q_obs),
                        assert_close_bf16_ulp(torch, h_ent, h_obs))
            what = f"worst {worst:.1f} bf16 ULPs (bound 32)"
        print(f"[entity] {dt}: {lanes} lanes, {env.n_agents} AGVs, "
              f"{env.n_mec} MECs, {steps} env steps: compact_obs rebuilds "
              f"the dense obs (max abs err {worst_obs:.2e}, rtol 1e-5 / atol "
              f"1e-6); entity forward = query-slice forward on the dense "
              f"obs, q and h {what}", flush=True)
        del exp, mac, env
    # one acting forward at 1024 lanes each way (bf16, folded params)
    cfg = loop_cfg(lanes=LOOP_LANES, ring=64)
    exp = Experiment.build(cfg)
    env, mac = exp.env, exp.mac
    params = mac.prepare_acting_params(
        mac.init_params(torch.Generator().manual_seed(SEED)))
    keys = prng.split(prng.PRNGKey(SEED + 23, "cuda"), LOOP_LANES)
    state, (dense, compact), _, _ = env.reset(keys, obs_form="both")
    hidden = mac.init_hidden(LOOP_LANES)
    ms_ent = cuda_ms(lambda: mac.forward_entity(params, compact, hidden,
                                                acting=True))
    ms_obs = cuda_ms(lambda: mac.forward_qslice(params, dense, hidden,
                                                acting=True))
    print(f"[entity] one bf16 acting forward at {LOOP_LANES} lanes (CUDA "
          f"events, 20 calls after 3 warm-up): entity tables {ms_ent:.3f} "
          f"ms, query slice on the dense obs {ms_obs:.3f} ms", flush=True)
    out.update(entity_ms=ms_ent, qslice_ms=ms_obs)
    del exp, mac, env, dense, compact
    torch.cuda.empty_cache()
    return out


def count_rollout_ops(torch, exp, ts) -> dict:
    """Compute ops (view ops excluded) of one rollout, counted at the
    dispatcher and attributed to the innermost of the PRNG's samplers,
    the env's parts and the MAC's acting calls that issued them (the
    rest: the runner): on the card each op is about one launch."""
    import collections
    from torch.utils._python_dispatch import TorchDispatchMode
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.envs.mec_offload import MultiAgvOffloadingEnv

    counts, stack = collections.Counter(), ["runner"]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                counts[stack[-1]] += 1
            return out

    def wrap(fn, label):
        def inner(*a, **kw):
            stack.append(label)
            try:
                return fn(*a, **kw)
            finally:
                stack.pop()
        return inner

    targets = [(prng, n, "prng") for n in PRNG_FUNCS]
    targets += [(MultiAgvOffloadingEnv, n, f"env.{n}") for n in (
        "step", "get_obs", "get_state", "get_avail_actions", "_reward",
        "_update_users", "reset")]
    targets += [(BasicMAC, n, f"mac.{n}") for n in (
        "select_actions", "exploration_draws")]
    targets = [(obj, n, label) for obj, n, label in targets
               if hasattr(obj, n)]
    saved = [(obj, n, getattr(obj, n)) for obj, n, _ in targets]
    try:
        for obj, n, label in targets:
            setattr(obj, n, wrap(getattr(obj, n), label))
        with Counter():
            exp.runner.run(ts.learner.params["agent"], ts.runner)
        torch.cuda.synchronize()
    finally:
        for obj, n, fn in saved:
            setattr(obj, n, fn)
    return dict(counts)


def check_threefry_cuda_equals_cpu(torch, exp, ts) -> int:
    """The port's threefry on the card against the port's on the CPU, bit
    for bit, at the rollout's key shapes: the runner key, the T step
    keys, the T × B lane keys, and the draws a rollout makes from them
    ((T, B, A) for the env, (T, B, A) and (T, B, A, n) for the
    selector). → number of draws compared."""
    from t2omca_tpu_torch import prng
    b, a = exp.cfg.batch_size_run, exp.env.n_agents
    n, t = exp.env.n_actions, exp.cfg.env_args.episode_limit
    key = ts.runner.key
    steps = prng.split(key, t)
    lanes = prng.split(steps, b)
    draws = [
        (key, lambda k: prng.split(k, 3)),
        (key, lambda k: prng.fold_in(k, 0x5CE7)),
        (steps, lambda k: prng.split(k)),
        (steps, lambda k: prng.uniform(k, (b, a))),
        (steps, lambda k: prng.random_bits(k, (b, a, n))),
        (lanes, lambda k: prng.split(k, 3)),
        (lanes, lambda k: prng.fold_in(k, 7)),
        (lanes, lambda k: prng.randint(k, (a,), 0, exp.env.n_mec)),
        (lanes, lambda k: prng.uniform(k, (a,))),
        (lanes, lambda k: prng.uniform(k, (a,), 0.0, 2 * 3.141592653589793)),
        (lanes, lambda k: prng.uniform(k, (a,), 4000.0, 12000.0)),
    ]
    for k, f in draws:
        got, want = f(k).cpu(), f(k.cpu())
        check(torch.equal(got, want), "threefry on CUDA differs from the "
                                      "CPU")
    return len(draws)


def run_loop(torch, att, exp, ts, tag: str, iterations: int, want=None,
             cursor=None):
    """``iterations`` classic iterations (rollout → insert → gated train)
    through ``run.run_classic``, each with its exact kernel launches
    (``want``, else ``loop_launches``) and its checks → (ts', records,
    result dict with the launch totals). ``cursor`` continues a driver
    key chain."""
    import numpy as np
    from t2omca_tpu_torch.run import run_classic
    cfg = exp.cfg
    b, t = cfg.batch_size_run, cfg.env_args.episode_limit
    want = loop_launches(cfg) if want is None else want
    host = exp.host_buffer
    first_t = 0 if cursor is None else cursor.t_env
    totals = dict.fromkeys(want, 0)
    records, iter_s = [], []
    for i in range(iterations):
        if not host:
            # what the insert alone would leave: the new slots at the stamp
            stamp = ts.buffer.max_priority ** cfg.replay.per_alpha
            inserted = ts.buffer.priorities.clone()
            inserted[(ts.buffer.insert_pos
                      + torch.arange(b, device="cuda"))
                     % cfg.replay.buffer_size] = stamp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        att.reset_launches()             # ---- the loop path starts here
        ts, cursor, (rec,) = run_classic(exp, ts, 1, cursor, sync=True)
        launches = dict(att.LAUNCHES)    # ---- and ends here
        iter_s.append(time.perf_counter() - t0)
        check(launches == want, f"{tag} iteration {i}: launches {launches} "
                                f"!= {want}")
        for k in totals:
            totals[k] += launches[k]
        check(rec.info is not None, f"{tag} iteration {i} did not train")
        loss, gn = float(rec.info["loss"]), float(rec.info["grad_norm"])
        check(np.isfinite(loss) and np.isfinite(gn),
              f"{tag} iteration {i}: loss {loss} grad_norm {gn}")
        check(bool(rec.info["all_finite"]), f"{tag} iteration {i}: "
                                            f"all_finite")
        if not host:
            check(bool((ts.buffer.priorities != inserted).any()),
                  f"{tag} iteration {i}: no sampled priority changed")
        rate = rec.stats.task_completion_rate
        check(bool(((rate >= 0) & (rate <= 1)).all()),
              f"{tag} iteration {i}: task_completion_rate outside [0, 1]")
        check(bool(torch.isfinite(rec.stats.episode_return).all()),
              f"{tag} iteration {i}: non-finite return")
        records.append((rec, loss, gn))
        print(f"[{tag}] iteration {i}: rollout+insert "
              f"{rec.rollout_s * 1e3:.1f} ms, trainer step "
              f"{rec.train_s * 1e3:.1f} ms, loss {loss:.4g}, grad_norm "
              f"{gn:.4g}, launches {launches}", flush=True)
    check(cursor.t_env - first_t == iterations * b * t,
          f"{tag}: t_env {cursor.t_env} != {first_t + iterations * b * t}")
    check(cursor.episode == int(ts.episode) == cursor.t_env // t,
          f"{tag}: episode {cursor.episode} != {cursor.t_env // t}")
    st = exp.buffer._storage if host else ts.buffer.storage
    n = (exp.buffer.episodes_in_buffer if host
         else int(ts.buffer.episodes_in_buffer))
    check(n == min(cursor.episode, cfg.replay.buffer_size),
          f"{tag}: ring holds {n} episodes")
    taken = torch.gather(st.avail_actions[:n, :-1], -1,
                         st.actions[:n].long().unsqueeze(-1))
    check(bool(taken.all()), f"{tag}: a stored action was not available")
    for name in ("state", "reward"):
        x = getattr(st, name)[:n]
        check(bool(torch.isfinite(x.float()).all()),
              f"{tag}: non-finite {name}")
    roll = [r.rollout_s * 1e3 for r, _, _ in records]
    train = [r.train_s * 1e3 for r, _, _ in records]
    p50_roll, p50_train = statistics.median(roll), statistics.median(train)
    p50_iter = statistics.median(iter_s) * 1e3
    print(f"[{tag}] {iterations} iterations, each trained: t_env "
          f"{cursor.t_env}, episode {cursor.episode}, ring {n} of "
          f"{cfg.replay.buffer_size}; loss/grad_norm "
          f"{', '.join(f'{l:.4g}/{g:.4g}' for _, l, g in records)}; "
          f"launches per train iteration {want} (all {iterations} exact), "
          f"per rollout 0", flush=True)
    result = {"launches": totals, "rollout_p50_ms": p50_roll,
              "train_p50_ms": p50_train, "iteration_p50_ms": p50_iter,
              "env_steps_per_s": b * t / (p50_roll / 1e3),
              "cursor": cursor}
    return ts, records, result


def check_stored_obs(torch, ts, env, tag: str) -> str:
    """The ring's obs: compact leaves finite with MEC ids in [0, n_mec)
    (config 3 pads no agent), or finite dense obs."""
    from t2omca_tpu_torch.components.episode_buffer import CompactEntityObs
    n = int(ts.buffer.episodes_in_buffer)
    obs = ts.buffer.storage.obs
    if not isinstance(obs, CompactEntityObs):
        check(bool(torch.isfinite(obs[:n].float()).all()),
              f"{tag}: non-finite obs")
        return f"dense {tuple(obs.shape[-2:])} {obs.dtype}"
    for name in ("rows", "mean", "std"):
        x = getattr(obs, name)[:n]
        check(x.dtype == torch.float32, f"{tag}: compact {name} {x.dtype}")
        check(bool(torch.isfinite(x).all()), f"{tag}: non-finite {name}")
    mec = obs.mec_index[:n]
    check(mec.dtype == torch.int8, f"{tag}: mec_index {mec.dtype}")
    check(bool(((mec >= 0) & (mec < env.n_mec)).all()),
          f"{tag}: mec_index outside [0, {env.n_mec})")
    nbytes = sum(getattr(obs, f).element_size() * getattr(obs, f).numel()
                 for f in ("rows", "mec_index", "mean", "std"))
    return (f"compact (rows f32, mec_index int8 in [0, {env.n_mec}), mean "
            f"and std f32), {nbytes / obs.rows.shape[0] / 2 ** 20:.2f} MiB "
            f"an episode")


def profile_rollout(torch, att, exp, ts, tag: str) -> dict:
    """One more rollout alone: no kernel launch, its ops by part at the
    dispatcher, and its device time under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    t = exp.cfg.env_args.episode_limit
    att.reset_launches()
    by_part = count_rollout_ops(torch, exp, ts)
    check(sum(att.LAUNCHES.values()) == 0,
          f"{tag}: a rollout launched kernels: {att.LAUNCHES}")
    ops, ops_prng = sum(by_part.values()), by_part.get("prng", 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exp.runner.run(ts.learner.params["agent"], ts.runner)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    kernel_launches = sum(r[1] for r in rows)
    check(busy > 0, f"{tag}: profiler saw no device time in the rollout")
    rows.sort(reverse=True)
    print(f"[{tag}] one rollout: {kernel_launches} device launches "
          f"(profiler; {kernel_launches / t:.0f} a step), {ops} compute "
          f"ops at the dispatcher, {ops_prng} ({100 * ops_prng / ops:.1f}%)"
          f" of them in the threefry PRNG", flush=True)
    print(f"[{tag}] ops of that rollout by part (total, a step): " + ", ".join(
        f"{k} {v} ({v / t:.1f})" for k, v in sorted(
            by_part.items(), key=lambda kv: -kv[1])), flush=True)
    print(f"[profile] {tag} rollout: host {wall:.1f} ms (profiled), device "
          f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%", flush=True)
    for ms, cnt, name in rows[:10]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / busy:5.1f}% x{cnt} "
              f"{name[:90]}", flush=True)
    return {"rollout_launches": kernel_launches, "rollout_ops": ops,
            "rollout_prng_ops": ops_prng, "rollout_ops_by_part": by_part,
            "rollout_busy_share": busy / wall}


def phase_loop(torch, att):
    """Config 3's own loop on the default stack: 1024 lanes, a ring of
    2048, T cut to ``LOOP_T``, three classic iterations through
    ``run.run_classic``."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.run import Experiment
    cfg = _episode_cfg(loop_cfg(), LOOP_T)
    exp = Experiment.build(cfg)
    check(exp.mac.use_entity_tables and exp.buffer.compact_obs
          and exp.runner.obs_form == "compact",
          "config 3's loop is not on the default stack")
    b, t = cfg.batch_size_run, cfg.env_args.episode_limit
    info = exp.env.get_env_info()
    print(f"[loop] config 3 uncut: {b} lanes, ring of "
          f"{cfg.replay.buffer_size}, {info['n_agents']} AGVs, "
          f"{exp.env.n_mec} MECs, {info['n_actions']} actions, T={t}, bf16, "
          f"kernels.attention=pallas, PER; the default stack: entity-table "
          f"acting, compact storage, the dense obs never built", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ts = exp.init_state(SEED)
    ts, records, result = run_loop(torch, att, exp, ts, "loop",
                                   LOOP_ITERATIONS)
    stored = check_stored_obs(torch, ts, exp.env, "loop")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[loop] stored obs: {stored}", flush=True)
    print(f"[loop] rollout+insert p50 {result['rollout_p50_ms']:.1f} ms "
          f"(each: {', '.join(f'{r.rollout_s * 1e3:.1f}' for r, _, _ in records)}"
          f"), {result['env_steps_per_s']:.0f} env-steps/s; trainer step "
          f"p50 {result['train_p50_ms']:.1f} ms; iteration p50 "
          f"{result['iteration_p50_ms']:.1f} ms; peak memory {peak:.2f} GiB",
          flush=True)
    # where the peak is: a rollout alone, then a trainer step alone
    torch.cuda.reset_peak_memory_stats()
    result.update(peak_gib=peak, **profile_rollout(torch, att, exp, ts,
                                                  "loop"))
    peak_roll = torch.cuda.max_memory_allocated() / 2 ** 30
    train_iter = exp.programs()[2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    ts, _ = train_iter(ts, prng.PRNGKey(SEED + 24, "cuda"), b * t)
    torch.cuda.synchronize()
    peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[loop] memory: {base:.2f} GiB held between stages (params, "
          f"optimizer state, the ring of {cfg.replay.buffer_size}); peak "
          f"{peak_roll:.2f} GiB over a rollout alone, {peak_train:.2f} GiB "
          f"over a trainer step alone", flush=True)
    result.update(peak_rollout_gib=peak_roll, peak_train_gib=peak_train,
                  held_gib=base)
    return result, exp, ts


#: [sight] and [remat]: trainer steps of [loop]'s config 3 (compact
#: storage, batch 32, T = LOOP_T, bf16) on [loop]'s ring, each variant from
#: the same state with the same keys, in turns; the first step of each
#: counted (kernel launches, and compute ops at the dispatcher, each
#: about one device launch), the rest timed
AB_STEPS = 2
F32_REMAT_STEPS = 1                 # 2 -> 1 since PR 16 (the smoke's limit)


def count_ops(torch, fn):
    """→ (fn(), compute ops (view ops excluded) it dispatched, backward
    included)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    n = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                n[0] += 1
            return func(*args, **(kwargs or {}))

    with Counter():
        out = fn()
    torch.cuda.synchronize()
    return out, n[0]


def count_syncs(torch, fn):
    """→ (fn(), the host synchronizations it made as ``file:line`` of the
    calling frame: the calls CUDA's sync debug mode flags, such as a
    device→host copy or ``.item()``)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}"
                 for w in caught if "synchroniz" in str(w.message)]


def learner_leaves(ls) -> dict:
    """Every tensor of a learner state: params, target, optimizer."""
    out = {}
    for name, tree in (("params", ls.params), ("target", ls.target_params),
                       ("mu", ls.opt_state["mu"]),
                       ("nu", ls.opt_state["nu"])):
        for m, sub in tree.items():
            for k, v in sub.items():
                out[f"{name}.{m}.{k}"] = v
    return out


def ab_steps(torch, att, exp, ts, variants: dict, n: int = AB_STEPS):
    """The same ``n`` trainer steps from ``ts`` under each config of
    ``variants`` ({name: cfg}, built on [loop]'s MAC and ring), in turns
    step by step. → {name: {"ts": state after the last step, "first":
    state and info after the first, "ops" (first step), "syncs" (each
    step's), "launches" (a
    step: every step's are checked equal), "launch_total", "times_ms"
    (all but the first), "peak_gib"}}."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.learners import QMixLearner
    from t2omca_tpu_torch.train.program import build_train_iter
    info = exp.env.get_env_info()
    iters = {name: build_train_iter(exp.buffer, QMixLearner.build(
        cfg, exp.mac, info), cfg) for name, cfg in variants.items()}
    keys = prng.split(prng.PRNGKey(SEED + 50, "cuda"), n)
    t_env = exp.cfg.batch_size_run * exp.cfg.env_args.episode_limit * 4
    # the priority feedback writes the ring's priorities in place: each
    # variant steps on its own copy of them (the storage is only read)
    own = lambda: dataclasses.replace(ts, buffer=dataclasses.replace(
        ts.buffer, priorities=ts.buffer.priorities.clone()))
    out = {name: {"ts": own(), "times_ms": [], "peak_gib": 0.0,
                  "launch_total": {}, "syncs": []} for name in variants}
    for i in range(n):
        for name, train_iter in iters.items():
            r = out[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            att.reset_launches()         # ---- a trainer step starts here
            if i == 0:
                ((r["ts"], inf), r["ops"]), syncs = count_syncs(
                    torch, lambda: count_ops(
                        torch, lambda: train_iter(r["ts"], keys[i], t_env)))
                r["launches"] = dict(att.LAUNCHES)
                r["first"] = (r["ts"], inf)
            else:
                t0 = time.perf_counter()
                (r["ts"], _), syncs = count_syncs(
                    torch, lambda: train_iter(r["ts"], keys[i], t_env))
                torch.cuda.synchronize()
                r["times_ms"].append((time.perf_counter() - t0) * 1e3)
            r["syncs"].append(syncs)
            check(att.LAUNCHES == r["launches"], f"{name} step {i}: "
                  f"launches {att.LAUNCHES} != {r['launches']}")
            for k, v in att.LAUNCHES.items():
                r["launch_total"][k] = r["launch_total"].get(k, 0) + v
            r["peak_gib"] = max(r["peak_gib"],
                                torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def _with(cfg, **sections):
    """``cfg`` with fields of its sections replaced: ``model={...}``."""
    for sect, kw in sections.items():
        cfg = dataclasses.replace(cfg, **{sect: dataclasses.replace(
            getattr(cfg, sect), **kw)})
    return cfg


def phase_sight(torch, att, exp, ts) -> dict:
    """The learning-health probes (obs.sight) on config 3's trainer step:
    on against off from the same state — the update bit-identical, the
    same kernel launches, the probes' extra dispatcher ops and the step
    p50 both ways; the probes finite and in range."""
    import numpy as np
    cfg = exp.cfg
    sg = dataclasses.replace(cfg.obs.sight, enabled=True)
    runs = ab_steps(torch, att, exp, ts, {
        "off": cfg, "on": _with(cfg, obs={"sight": sg})})
    off, on = runs["off"], runs["on"]
    for when, (a, b) in (("after one step", (off["first"][0], on["first"][0])),
                         (f"after {AB_STEPS} steps", (off["ts"], on["ts"]))):
        la, lb = learner_leaves(a.learner), learner_leaves(b.learner)
        diff = [k for k in la if not torch.equal(la[k], lb[k])]
        check(not diff, f"[sight] params {when} differ with the probes on: "
                        f"{diff[:4]}")
        check(torch.equal(a.buffer.priorities, b.buffer.priorities),
              f"[sight] priorities {when} differ with the probes on")
    i_off, i_on = off["first"][1], on["first"][1]
    for k in i_off:
        check(torch.equal(i_off[k], i_on[k]), f"[sight] info {k} differs")
    check(off["launches"] == on["launches"] == loop_launches(cfg),
          f"[sight] launches {off['launches']} / {on['launches']}")
    # the first step of a process may sync once more (one-time setup):
    # the steady state is the later steps'
    check(off["syncs"][1:] == on["syncs"][1:], f"[sight] the probes "
          f"change the host syncs: off {off['syncs']}, on {on['syncs']}")
    keys = sorted(k for k in i_on if k.startswith("sight_"))
    vals = {k: i_on[k].float().cpu().numpy() for k in keys}
    for k, v in vals.items():
        check(bool(np.isfinite(v).all()), f"[sight] {k} not finite: {v}")
        if k.endswith("_hist"):
            check(v.shape == (sg.bins,) and abs(float(v.sum()) - 1) < 1e-5,
                  f"[sight] {k} {v}")
        if k.startswith("sight_attn_entropy"):
            check(v.shape == (cfg.model.depth,)
                  and bool(((v >= 0) & (v <= 1 + 1e-6)).all()),
                  f"[sight] {k} {v}")
    check(len(keys) == 15, f"[sight] keys {keys}")
    p50 = {n: statistics.median(r["times_ms"]) for n, r in runs.items()}
    extra = on["ops"] - off["ops"]
    print(f"[sight] config 3's trainer step ([loop]'s ring: compact "
          f"storage, batch {cfg.batch_size}, T={cfg.env_args.episode_limit}"
          f", bf16), obs.sight off and on from one state, {AB_STEPS} steps "
          f"each in turns: params, target, Adam and priorities "
          f"bit-identical after one step and after {AB_STEPS}; kernel "
          f"launches {on['launches']} a step both ways; host syncs of "
          f"each step (CUDA sync debug mode) off {off['syncs']}, on "
          f"{on['syncs']}", flush=True)
    print(f"[sight] compute ops a step at the dispatcher (~ device "
          f"launches): off {off['ops']}, on {on['ops']}, the probes "
          f"+{extra} ({100 * extra / off['ops']:.2f}%); step p50 off "
          f"{p50['off']:.1f} ms, on {p50['on']:.1f} ms "
          f"({100 * (p50['on'] / p50['off'] - 1):+.1f}%; each: off "
          f"{', '.join(f'{x:.1f}' for x in off['times_ms'])}, on "
          f"{', '.join(f'{x:.1f}' for x in on['times_ms'])})", flush=True)
    scal = {k: float(v) for k, v in vals.items() if v.ndim == 0}
    print("[sight] probes of the first step: " + ", ".join(
        f"{k[6:]} {v:.4g}" for k, v in scal.items()) + "; attention "
          "entropy agent " + "/".join(f"{x:.3f}" for x in
                                      vals["sight_attn_entropy_agent"])
          + ", mixer " + "/".join(f"{x:.3f}" for x in
                                  vals["sight_attn_entropy_mixer"]),
          flush=True)
    return {"ops_off": off["ops"], "ops_on": on["ops"], "extra_ops": extra,
            "syncs": on["syncs"][-1],
            "p50_off_ms": p50["off"], "p50_on_ms": p50["on"],
            "launches": {k: off["launch_total"][k] + on["launch_total"][k]
                         for k in on["launch_total"]}}


def phase_remat(torch, att, exp, ts, cross_batch) -> dict:
    """model.remat on config 3's trainer step: off against on from one
    state (the update bit-identical or within tests/test_torch_loop.py's
    tolerances, K1 + residuals twice per online mixer step, the peak
    falls); then f32 at [loop]'s T with remat (at T = 150 it does not
    fit without),
    and the f32 pallas-vs-xla cross-check on one remat step."""
    import numpy as np
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.learners import QMixLearner
    from t2omca_tpu_torch.train.program import build_train_iter
    from t2omca_tpu_torch import prng
    cfg = exp.cfg
    runs = ab_steps(torch, att, exp, ts, {
        "off": cfg, "on": _with(cfg, model={"remat": True})})
    off, on = runs["off"], runs["on"]
    want = loop_launches(cfg)
    want_on = dict(want, flash_fwd_res=2 * want["flash_fwd_res"])
    check(off["launches"] == want, f"[remat] off: launches "
                                   f"{off['launches']} != {want}")
    check(on["launches"] == want_on, f"[remat] on: launches "
                                     f"{on['launches']} != {want_on}")
    (ta, ia), (tb, ib) = off["first"], on["first"]
    la, lb = learner_leaves(ta.learner), learner_leaves(tb.learner)
    same = (all(torch.equal(la[k], lb[k]) for k in la)
            and all(torch.equal(ia[k], ib[k]) for k in ia))
    if same:
        agree = "bit-identical (loss, grad_norm, every info value and " \
                "every param, target and Adam moment)"
    else:
        # tests/test_torch_loop.py's tolerances
        worst = max(float((la[k].float() - lb[k].float()).abs().max())
                    for k in la)
        for k in ("loss", "td_error_abs", "q_taken_mean", "target_mean"):
            a, b = float(ia[k]), float(ib[k])
            check(abs(a - b) <= 1e-6 + 1e-5 * abs(a), f"[remat] {k} {a} "
                                                      f"vs {b}")
        a, b = float(ia["grad_norm"]), float(ib["grad_norm"])
        check(abs(a - b) <= 1e-6 + 1e-4 * abs(a), f"[remat] grad_norm")
        for m in ta.learner.params:
            d = torch.cat([(ta.learner.params[m][k]
                            - tb.learner.params[m][k]).abs().flatten()
                           for k in ta.learner.params[m]])
            check(float((d > 1e-5).float().mean()) <= 0.01
                  and float(d.max()) <= 2 * cfg.lr, f"[remat] {m} params")
        agree = (f"NOT bit-identical: largest param/moment difference "
                 f"{worst:.3e}; loss, grad_norm and params within "
                 f"tests/test_torch_loop.py's tolerances")
    p50 = {n: statistics.median(r["times_ms"]) for n, r in runs.items()}
    check(on["peak_gib"] < off["peak_gib"],
          f"[remat] peak {on['peak_gib']:.2f} GiB not below "
          f"{off['peak_gib']:.2f}")
    print(f"[remat] config 3's trainer step ([loop]'s ring, bf16, batch "
          f"{cfg.batch_size}, T={cfg.env_args.episode_limit}), model.remat "
          f"off and on from one state, {AB_STEPS} steps each in turns: "
          f"{agree}", flush=True)
    print(f"[remat] launches a step: off {off['launches']}, on "
          f"{on['launches']}; compute ops at the dispatcher off "
          f"{off['ops']}, on {on['ops']}; step p50 off {p50['off']:.1f} ms, "
          f"on {p50['on']:.1f} ms (x{p50['on'] / p50['off']:.2f}); peak "
          f"memory off {off['peak_gib']:.2f} GiB, on {on['peak_gib']:.2f} "
          f"GiB", flush=True)
    result = {"p50_off_ms": p50["off"], "p50_on_ms": p50["on"],
              "peak_off_gib": off["peak_gib"], "peak_on_gib": on["peak_gib"],
              "bit_identical": same,
              "launches": {k: off["launch_total"][k] + on["launch_total"][k]
                           for k in want}}
    del runs, off, on, ta, tb, la, lb
    torch.cuda.empty_cache()

    # f32 at [loop]'s T under remat
    cfg32 = _with(cfg, model={"dtype": "float32", "remat": True})
    info = exp.env.get_env_info()
    learner = QMixLearner.build(cfg32, BasicMAC.build(cfg32, info), info)
    train_iter = build_train_iter(exp.buffer, learner, cfg32)
    keys = prng.split(prng.PRNGKey(SEED + 60, "cuda"), F32_REMAT_STEPS)
    t32 = ts
    times, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()
    for i in range(F32_REMAT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t32, inf = train_iter(t32, keys[i], 1000 * (i + 1))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        loss, gn = float(inf["loss"]), float(inf["grad_norm"])
        check(np.isfinite(loss) and np.isfinite(gn) and
              bool(inf["all_finite"]), f"[remat] f32 step {i}: loss {loss}"
                                       f" grad_norm {gn}")
        losses.append((loss, gn))
    launches32 = dict(att.LAUNCHES)
    check(launches32 == {k: F32_REMAT_STEPS * v for k, v in want_on.items()},
          f"[remat] f32 launches {launches32}")
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = max(float((t32.learner.params[m][k]
                       - ts.learner.params[m][k]).abs().max())
                for m in ts.learner.params for k in ts.learner.params[m])
    check(moved > 0.0, "[remat] f32 params did not move")
    p50_32 = statistics.median(times)
    print(f"[remat] f32 at T={cfg.env_args.episode_limit} with remat, "
          f"{F32_REMAT_STEPS} trainer steps: p50 {p50_32:.1f} ms (each: "
          f"{', '.join(f'{x:.1f}' for x in times)}), peak memory "
          f"{peak32:.2f} GiB, loss/grad_norm "
          f"{', '.join(f'{a:.4g}/{b:.4g}' for a, b in losses)}, max param "
          f"move {moved:.3e}, launches {launches32}", flush=True)
    result.update(p50_f32_ms=p50_32, peak_f32_gib=peak32)
    for k, v in launches32.items():
        result["launches"][k] += v
    del learner, train_iter, t32
    torch.cuda.empty_cache()

    # the f32 pallas-vs-xla cross-check on one remat step ([train]'s)
    batch, w = cross_batch
    outs = {attention: cross_check_step(torch, info, attention, True, batch,
                                        w, remat=True)
            for attention in ("pallas", "xla")}
    report = compare_steps(torch, outs["pallas"], outs["xla"], cfg.lr,
                           cfg.optim_eps)
    print(f"[remat] f32 cross-check under remat (query slice, batch 2, "
          f"T={cfg.env_args.episode_limit}, gate {CROSS_GATE}): pallas vs "
          f"xla {report}", flush=True)
    del outs
    torch.cuda.empty_cache()
    return result


#: [superstep]: config 3's fused program uncut on [loop]'s experiment and
#: state (1024 lanes, ring 2048, bf16, pallas, PER), with obs.sight on as
#: the config ships it; K cut from the config's 4 to 2 (its depth: the
#: smoke's time limit), [driver] runs the shipped K = 4
SUPERSTEP_K = 1                     # 2 -> 1 since PR 16 ([driver], [scenarios]
#                                     and [dropout] keep K > 1)


def fused_dispatch(torch, sup, ts, mirror):
    """One fused dispatch the driver's way: the host mirror of the
    counters (``mirror``: key, t_env, episode, filled; advanced here)
    gates each sub-iteration and the key splits only for gated ones →
    (ts', stacked stats, stacked infos, gates)."""
    from t2omca_tpu_torch import prng
    cfg = sup.exp.cfg
    rows, gated = [], []
    for _ in range(sup.k):
        mirror["episode"] += cfg.batch_size_run
        mirror["filled"] = min(mirror["filled"] + cfg.batch_size_run,
                               cfg.replay.buffer_size)
        gated.append(mirror["filled"] >= cfg.batch_size
                     and mirror["episode"] >= cfg.accumulated_episodes)
        if gated[-1]:
            mirror["key"], k_sample = prng.split(
                mirror["key"], 2, cfg.prng_impl).unbind(0)
            rows.append(k_sample)
        else:
            rows.append(torch.zeros_like(mirror["key"]))
    out = sup(ts, torch.stack(rows), mirror["t_env"], gated)
    mirror["t_env"] += (sup.k * cfg.batch_size_run
                        * cfg.env_args.episode_limit)
    return out + (gated,)


def phase_superstep(torch, att, exp, ts, smi: str) -> dict:
    """The fused superstep (``Experiment.superstep_program``) as captured
    CUDA graphs at config 3's width: K eager ``run_classic`` iterations
    against the program's first fused dispatch from the same state (the
    captures, then K replays; bit for bit), then a dispatch of replays
    timed (host time, each iteration's device time, no host sync, the
    state's addresses kept) and one iteration of replays profiled (busy
    share, kernels a replay)."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.learners import QMixLearner
    from t2omca_tpu_torch.run import LoopCursor, run_classic
    from t2omca_tpu_torch.train.superstep import clone_state
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    cfg = _with(exp.cfg, obs={"sight": dataclasses.replace(
        exp.cfg.obs.sight, enabled=True)})
    exp = dataclasses.replace(exp, cfg=cfg, learner=QMixLearner.build(
        cfg, exp.mac, exp.env.get_env_info()))
    k, b, t = SUPERSTEP_K, cfg.batch_size_run, cfg.env_args.episode_limit
    sup = exp.superstep_program(k)
    mirror = {"key": prng.PRNGKey(SEED + 60, "cuda"),
              "t_env": ts.runner.t_env, "episode": int(ts.episode),
              "filled": int(ts.buffer.episodes_in_buffer)}
    want = {name: k * n for name, n in loop_launches(cfg).items()}
    print(f"[superstep] config 3 uncut ([loop]'s experiment and state: "
          f"{b} lanes, ring {cfg.replay.buffer_size}, T={t}, bf16, pallas,"
          f" PER, obs.sight on), K={k}: rollout + insert_time_major and "
          f"sample + train + priority feedback as two CUDA graphs in one "
          f"pool | {smi}", flush=True)
    # 1. K eager classic iterations from a copy of the state (first: a
    # captured train graph's pool and an eager train step do not fit in
    # one card at this width) ...
    start = dict(mirror)
    ref = clone_state(ts)
    att.reset_launches()
    t0 = time.perf_counter()
    ref, cursor, recs = run_classic(exp, ref, k, LoopCursor(
        key=start["key"], t_env=start["t_env"], episode=start["episode"],
        buffer_filled=start["filled"]))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = dict(att.LAUNCHES)
    check(eager == want, f"[superstep] eager launches {eager} != {want}")
    gc.collect()
    torch.cuda.empty_cache()
    # 2. ... against the program's first fused dispatch from the state:
    # it captures both stages (the process warmed them up in
    # [population]) and replays the graphs (the launches of the fused
    # dispatches are counted from here)
    att.reset_launches()
    t0 = time.perf_counter()
    ts, stats, infos, gated = fused_dispatch(torch, sup, ts, mirror)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fused = dict(att.LAUNCHES)
    check(all(gated), f"[superstep] gates {gated}")
    check(set(sup.graphs) == {"rollout", "train"},
          f"[superstep] graphs after the first dispatch {sorted(sup.graphs)}")
    check(fused == eager, f"[superstep] fused launches {fused} != eager "
                          f"{eager}")
    check(sum(sup.launches["rollout"].values()) == 0
          and sup.launches["train"] == loop_launches(cfg),
          f"[superstep] launches a replay {sup.launches}")
    a, ha = flatten_state(ts)
    r, hr = flatten_state(ref)
    check(ha == hr and set(a) == set(r), f"[superstep] host {ha} != {hr}")
    diff = [name for name in a if not torch.equal(a[name], r[name])]
    check(not diff, f"[superstep] fused state differs from {k} eager "
                    f"iterations: {diff[:5]} ({len(diff)} leaves)")
    check(torch.equal(cursor.key, mirror["key"]), "[superstep] driver key")
    for i, rec in enumerate(recs):
        for f in dataclasses.fields(stats):
            got, exp_v = getattr(stats, f.name)[i], getattr(rec.stats,
                                                             f.name)
            check(torch.equal(got.cpu(), exp_v.reshape(got.shape).cpu()),
                  f"[superstep] stats {f.name} of iteration {i}")
        bad = [name for name, v in rec.info.items()
               if not torch.equal(infos[name][i], v)]
        check(not bad, f"[superstep] info of iteration {i}: {bad}")
    n_leaves, n_bytes = len(a), sum(v.numel() * v.element_size()
                                    for v in a.values())
    losses = [float(x) for x in infos["loss"]]
    del ref, recs, r
    gc.collect()
    torch.cuda.empty_cache()
    ptrs = {name: v.data_ptr() for name, v in a.items()}
    del a
    torch.cuda.reset_peak_memory_stats()
    # 3. replays only: host time, device time by iteration, no sync
    sup.timing = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (ts2, _, infos, _), syncs = count_syncs(
        torch, lambda: fused_dispatch(torch, sup, ts, mirror))
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    iters = [(e0.elapsed_time(e1), e1.elapsed_time(e2))
             for e0, e1, e2 in sup.events]
    sup.timing = False
    check(not syncs, f"[superstep] host syncs inside a dispatch: {syncs}")
    check(ts2 is ts and {n: v.data_ptr() for n, v in
                         flatten_state(ts)[0].items()} == ptrs,
          "[superstep] a state tensor moved between dispatches")
    check(bool(infos["all_finite"].all()), "[superstep] non-finite step")
    launches = dict(att.LAUNCHES)        # ---- the fused path ends here
    check(launches == {name: 2 * n for name, n in want.items()},
          f"[superstep] launches of 2 fused dispatches {launches}")
    # 4. one iteration of replays profiled (the rollout graph, then the
    # train graph, as a dispatch replays them; a whole dispatch's 1.2 M
    # trace events took minutes to fold): device busy share, kernels a
    # replay
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sup.graphs["rollout"].replay()
        sup.graphs["train"].replay()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(x[0] for x in rows)
    device_launches = sum(x[1] for x in rows)
    # the bf16 bodies: K1 and K1 + residuals share flash_fwd_tc_kernel
    flash = {name: sum(x[1] for x in rows if body in x[2])
             for name, body in zip(("flash_fwd", "flash_bwd_dkv",
                                    "flash_bwd_dq"), BF16_TC_KERNELS)}
    per_replay = dict(flash)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    nodes = {s: sup.nodes.get(s) for s in ("rollout", "train")}
    print(f"[superstep] {k} eager run_classic iterations and one fused "
          f"dispatch from one state: bit-identical ({n_leaves} state "
          f"leaves, {n_bytes / 2 ** 30:.2f} GiB: learner, ring, priorities,"
          f" runner, counters; the driver key; stats and infos of each "
          f"iteration); launches {fused} both ways ({sup.launches['train']}"
          f" a train replay, none a rollout replay); losses "
          f"{', '.join(f'{x:.4g}' for x in losses)}", flush=True)
    print(f"[superstep] capture: rollout {sup.capture_s['rollout']:.2f} s "
          f"+ instantiate {sup.instantiate_s['rollout']:.2f} s, train "
          f"{sup.capture_s['train']:.2f} s + instantiate "
          f"{sup.instantiate_s['train']:.2f} s; graph nodes {nodes}",
          flush=True)
    print(f"[superstep] dispatch host times: {k} eager run_classic "
          f"iterations {eager_s * 1e3:.0f} ms; the first fused dispatch "
          f"(the captures, {k} replays) "
          f"{first_s * 1e3:.0f} ms; a dispatch of replays "
          f"{host_ms:.0f} ms to return ({wall_ms:.0f} ms to the device's "
          f"end); device time "
          f"by iteration (rollout + train, ms): "
          + ", ".join(f"{x:.1f} + {y:.1f}" for x, y in iters)
          + f"; host syncs inside the dispatch: {len(syncs)}", flush=True)
    print(f"[superstep] profiled iteration (one rollout and one train "
          f"replay): host {prof_ms:.0f} ms, device "
          f"busy {busy:.0f} ms ({100 * busy / prof_ms:.1f}%), idle "
          f"{100 * (1 - busy / prof_ms):.1f}%; {device_launches} device "
          f"kernels and copies in the trace; flash kernels a train replay "
          f"(profiler rows) {per_replay} against LAUNCHES "
          f"{sup.launches['train']}; peak memory over the dispatches of "
          f"replays {peak:.2f} GiB allocated, {reserved:.2f} GiB reserved "
          f"(the graphs' pool included) | "
          f"{smi}", flush=True)
    check(busy > 0, "[superstep] the profiler saw no device time")
    lt = sup.launches["train"]
    check(per_replay["flash_fwd"] == lt["flash_fwd"] + lt["flash_fwd_res"]
          and per_replay["flash_bwd_dq"] == lt["flash_bwd_dq"]
          and per_replay["flash_bwd_dkv"] == lt["flash_bwd_dkv"],
          f"[superstep] profiler flash rows a replay {per_replay} != "
          f"LAUNCHES {lt}")
    capture = {s: (sup.capture_s[s], sup.instantiate_s[s])
               for s in ("rollout", "train")}
    sup.close()
    del sup, ts2
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "capture_s": capture,
            "first_s": first_s, "eager_s": eager_s,
            "host_ms": host_ms, "wall_ms": wall_ms, "iters_ms": iters,
            "busy_share": busy / prof_ms, "peak_gib": peak,
            "reserved_gib": reserved, "nodes": nodes}


def phase_loop_dense(torch, att):
    """The kill switch model.use_entity_tables=false: query-slice acting
    on the dense obs, dense storage, the agent's unrolls through the
    kernels; 128 lanes and a ring of 256."""
    from t2omca_tpu_torch.run import Experiment
    cfg = loop_cfg(DENSE_LANES, DENSE_RING, entity_tables=False)
    exp = Experiment.build(cfg)
    check(not exp.mac.use_entity_tables and not exp.buffer.compact_obs,
          "the kill switch left the entity tables on")
    print(f"[loop-dense] model.use_entity_tables=false (dense obs, "
          f"query-slice acting); cuts: batch_size_run 1024 -> "
          f"{cfg.batch_size_run}, buffer_size 2048 -> "
          f"{cfg.replay.buffer_size} (dense bf16 obs are 11.1 MB a "
          f"lane-episode)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ts = exp.init_state(SEED)
    n_draws = check_threefry_cuda_equals_cpu(torch, exp, ts)
    print(f"[loop-dense] threefry on CUDA = CPU bit for bit over {n_draws} "
          f"draws at the rollout's key shapes", flush=True)
    ts, _, result = run_loop(torch, att, exp, ts, "loop-dense",
                             DENSE_ITERATIONS)
    check_stored_obs(torch, ts, exp.env, "loop-dense")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[loop-dense] rollout+insert p50 {result['rollout_p50_ms']:.1f} "
          f"ms, {result['env_steps_per_s']:.0f} env-steps/s; trainer step "
          f"p50 {result['train_p50_ms']:.1f} ms; iteration p50 "
          f"{result['iteration_p50_ms']:.1f} ms; peak memory {peak:.2f} GiB",
          flush=True)
    result["peak_gib"] = peak
    del exp, ts
    torch.cuda.empty_cache()
    return result


def phase_loop_noisy(torch, att):
    """One classic iteration of NoisyNet's q-head noise on the default
    stack: the noisy q differs from the mu q, and the sigma params get
    finite, non-zero gradients."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.run import Experiment
    cfg = loop_cfg(NOISY_LANES, DENSE_RING, selector="noisy-new")
    exp = Experiment.build(cfg)
    check(exp.learner.needs_rngs and exp.buffer.compact_obs,
          "the noisy loop is not on the default stack")
    ts = exp.init_state(SEED)
    ts, _, result = run_loop(torch, att, exp, ts, "loop-noisy", 1)
    check_stored_obs(torch, ts, exp.env, "loop-noisy")
    # the noisy q against the mu q on the same inputs
    mac, env = exp.mac, exp.env
    params = mac.prepare_acting_params(ts.learner.params["agent"])
    compact = env.compact_obs(ts.runner.env_states, ts.runner.env_params)
    hidden = mac.init_hidden(cfg.batch_size_run)
    key = prng.PRNGKey(SEED + 41, "cuda")
    q_mu, _ = mac.forward_entity(params, compact, hidden, acting=True)
    q_noisy, _ = mac.forward_entity(params, compact, hidden, key=key,
                                    deterministic=False, acting=True)
    dq = float((q_noisy - q_mu).abs().max())
    check(dq > 0.0, "the noisy q equals the mu q")
    # the sigma gradients of one loss on a sampled batch
    k_sample, k_learn = prng.split(prng.PRNGKey(SEED + 42, "cuda")).unbind(0)
    batch, _, w = exp.buffer.sample(ts.buffer, k_sample, cfg.batch_size,
                                    1000)
    lrn = exp.learner
    p = {m: {k: v.detach().requires_grad_() for k, v in sub.items()}
         for m, sub in ts.learner.params.items()}
    loss, _ = lrn._loss(p, ts.learner.target_params, batch, w, k_learn)
    names = sorted(k for k in p["agent"] if "sigma" in k)
    check(len(names) == 2, f"sigma params {names}")
    grads = torch.autograd.grad(loss, [p["agent"][k] for k in names])
    norms = {k: float(g.norm()) for k, g in zip(names, grads)}
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "a sigma gradient is not finite")
    check(any(v > 0.0 for v in norms.values()), "every sigma gradient is 0")
    print(f"[loop-noisy] action_selector noisy-new, {cfg.batch_size_run} "
          f"lanes, ring {cfg.replay.buffer_size}: launches as [loop]'s "
          f"{loop_launches(cfg)}; noisy q - mu q max |d| {dq:.3e}; sigma "
          f"gradient norms " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in norms.items()),
          flush=True)
    del exp, ts, batch, p, grads
    torch.cuda.empty_cache()
    return result


# ============= dropout, the agent and mixer families, host-RAM replay
#
# [dropout], [families] and [host-replay]: single-card options of the
# TrainConfig, at config 3's model widths (64 AGVs, obs 576,
# emb 256, 4 heads, depth 2, standard heads, bf16, pallas). Lanes, ring
# and T are cut where printed.

DROPOUT = 0.1
DROPOUT_LANES = 128                 # [dropout]: 1024 -> 128, as [loop-dense]
DROPOUT_RING = 256                  # [dropout]: 2048 -> 256, as [loop-dense]
DROPOUT_T = 30                      # [dropout]: episode_limit 150 -> 50
#                                     (PR 15), -> 30 (PR 17): the limit
DROPOUT_K = 2
FAMILY_LANES = 32                   # [families]: 1024 -> 32 lanes
FAMILY_RING = 64                    # [families]: 2048 -> 64
FAMILY_T = 30                       # [families]: episode_limit 150 -> 30
#                                     (the smoke's limit, PERF.md §4)
FAMILIES = (("rnn", "vdn"), ("rnn", "qmix_ff"), ("transformer", "qmix_ff"),
            ("rnn", "transformer"))
HOST_LANES = 128                    # [host-replay]: 1024 -> 128 lanes
HOST_RING = 256                     # [host-replay]: 2048 -> 256, f32
HOST_T = 30                         # [host-replay]: episode_limit 150 -> 50
#                                     (PR 16), -> 30 (PR 17): the limit


def _episode_cfg(cfg, t: int):
    return _with(cfg, env_args={"episode_limit": t})


def dropout_launches(cfg) -> dict:
    """Launches of one iteration of the dense agent and dense mixer
    (dropout, or the dense agent's noise: both query-slice reductions
    ineligible): the rollout acts
    through the dense agent, K1 T·depth (pallas in the acting module, no
    gradient); the train step launches the dense formula of
    ``loop_launches`` with K1 + residuals twice under remat (forward and
    recompute)."""
    t, depth = cfg.env_args.episode_limit, cfg.model.depth
    want = loop_launches(cfg)
    if cfg.model.remat:
        want["flash_fwd_res"] *= 2
    want["flash_fwd"] += t * depth
    return want


def dropout_mask_launches(cfg) -> int:
    """Launches of the dropout-mask kernel in one iteration: a draw for
    each block's Dropout_0 and Dropout_1 in every forward of a
    transformer that drops. The rollout's acting forward T times (a
    training-mode rollout drops, as JAX's does); the learner's online
    agent unroll T + 1 steps (the T steps with a gradient twice under
    remat: forward and recompute), its target unroll T + 1, the online
    mixer unroll T (twice under remat) and the target mixer T + 1."""
    t, d, dm = (cfg.env_args.episode_limit, cfg.model.depth,
                cfg.model.mixer_depth)
    grad = 2 if cfg.model.remat else 1
    agent = t + (grad * t + 1) + (t + 1)
    mixer = grad * t + (t + 1)
    return 2 * d * agent + 2 * dm * mixer


def family_launches(cfg) -> dict:
    """Launches of one iteration of an agent/mixer family on dense
    storage: the transformer agent's query-slice unrolls (target K1
    (T+1)·depth and the bootstrap step's depth, online K1 + residuals,
    K2 and K3 T·depth) and the transformer mixer's (K1 (T+1)·depth, K1 +
    residuals, K2, K3 T·depth); the GRU agent, qmix_ff and vdn launch
    none, and acting (query slice on the plain path, or the GRU) none."""
    t, d = cfg.env_args.episode_limit, cfg.model.depth
    want = dict.fromkeys(("flash_fwd", "flash_fwd_res", "flash_bwd_dq",
                          "flash_bwd_dkv"), 0)
    parts = []
    if cfg.agent == "transformer":
        parts.append(((t + 1) * d + d, t * d))
    if cfg.mixer == "transformer":
        parts.append(((t + 1) * d, t * d))
    for fwd, grad in parts:
        want["flash_fwd"] += fwd
        for k in ("flash_fwd_res", "flash_bwd_dq", "flash_bwd_dkv"):
            want[k] += grad
    return want


def _params_moved(torch, before, after) -> int:
    """The count of param tensors that changed."""
    return sum(not torch.equal(before[m][k], after[m][k])
               for m in before for k in before[m])


#: the ranks of [dropout]'s row-map gate
ROW_MAP_RANKS = 2


def dropout_row_maps(torch, key, fold: int, keep: float, bs: int,
                     lanes: int) -> dict:
    """The mask kernel with a row map (``keep_mask(..., rows)``) against
    the same rows of its whole mask, bit for bit, and against its plain
    version with the map, for each rank of ``ROW_MAP_RANKS``: the
    learner's agent and mixer shapes with the rank's contiguous block of
    the batch, the rollout's shape with the rank's lanes ``r, r + N,
    ...`` (``flax_rng.Rows``). Times rank 0's agent-shape draw (plain,
    and the bound at its own elements) → {name: row}."""
    from t2omca_tpu_torch.flax_rng import Rows
    from t2omca_tpu_torch.kernels import dropout as dk
    n = ROW_MAP_RANKS
    out = {}
    for name, shape, per, layout in (
            ("agent", (bs * 64, 65, 256), 64, "block"),
            ("mixer", (bs, 131, 256), 1, "block"),
            ("rollout", (lanes * 64, 65, 256), 64, "lanes")):
        batch = shape[0] // per
        whole = dk.keep_mask(key, fold, keep, shape)
        for r in range(n):
            own = (torch.arange(r * batch // n, (r + 1) * batch // n,
                                device="cuda") if layout == "block" else
                   torch.arange(r, batch, n, device="cuda"))
            rows, total = Rows(own, batch).of(shape[0] // n)
            check(total == shape[0], f"[dropout] row map of {shape}")
            got = dk.keep_mask(key, fold, keep, shape, rows)
            ref = dk.keep_mask_reference(key, fold, keep, shape, rows)
            torch.cuda.synchronize()
            check(torch.equal(got, whole[rows]) and torch.equal(got, ref),
                  f"[dropout] the mask kernel with rank {r}'s row map at "
                  f"{shape} ({layout}) differs: "
                  f"{int((got != whole[rows]).sum())} elements from the "
                  f"whole mask's rows, {int((got != ref).sum())} from the "
                  f"plain version")
            if r == 0:
                m = got.numel()
                bound, by = bound_ms(m + 16 + rows.numel() * 8,
                                     (m + 1) * MASK_OPS, "int32")
                out[name] = {
                    "shape": [rows.numel()] + list(shape[1:]),
                    "of": list(shape), "layout": layout,
                    "ms": cuda_ms(lambda: dk.keep_mask(key, fold, keep,
                                                       shape, rows)),
                    "plain_ms": cuda_ms(lambda: dk.keep_mask_reference(
                        key, fold, keep, shape, rows), iters=3, warmup=1),
                    "bound_ms": bound, "bound_by": by, "library_ms": None}
            del got, ref
        del whole
        row = out[name]
        print(f"[dropout] mask kernel with a row map at {shape} "
              f"({layout} of {n} ranks): every rank's rows equal to the "
              f"whole mask's rows and to the plain version bit for bit; "
              f"rank 0's {tuple(row['shape'])} {row['ms']:.3f} ms (bound "
              f"{row['bound_ms']:.3f} ms by {row['bound_by']}, plain "
              f"{row['plain_ms']:.2f} ms)", flush=True)
    return out


def phase_dropout(torch, att, smi: str) -> dict:
    """Config 3 with ``model.dropout`` and ``model.remat``: the dense
    agent and mixer through the kernels (the query-slice reductions are
    ineligible), every mask a threefry draw from an explicit key. Three
    classic iterations with exact launches; one fused K = 2 dispatch
    (captured graphs) from the state before the last 2 of them, bit for
    bit against them; masks under two keys; the loss with dropout on and off; an f32
    pallas-vs-xla step with the same masks; the mask kernel against its
    plain version at the path's three shapes, bit for bit, and its
    launches on the path (``dropout_mask_launches``). Then
    the noisy leg: noisy-new with use_qslice false, one iteration, the
    noisy q against the mu q and the sigma gradients."""
    import gc
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.flax_rng import Scope
    from t2omca_tpu_torch.kernels import dropout as dk
    from t2omca_tpu_torch.learners import QMixLearner
    from t2omca_tpu_torch.models.transformer import dropout
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.train.superstep import clone_state
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    cfg = _with(_episode_cfg(loop_cfg(DROPOUT_LANES, DROPOUT_RING,
                                      entity_tables=False), DROPOUT_T),
                model={"dropout": DROPOUT, "remat": True})
    exp = Experiment.build(cfg)
    lrn = exp.learner
    check(not exp.mac.use_qslice and exp.mac.stochastic
          and lrn.needs_rngs and not lrn._agent_qslice
          and not lrn._mixer_qslice and not exp.buffer.compact_obs,
          "[dropout] the config is not on the dense path")
    b, t, bs = cfg.batch_size_run, cfg.env_args.episode_limit, \
        cfg.batch_size
    print(f"[dropout] config 3 with model.dropout={DROPOUT}, model.remat="
          f"true: dense agent and dense mixer through the kernels, bf16, "
          f"pallas, PER, batch {bs}, T={t}; cuts: batch_size_run 1024 -> "
          f"{b}, buffer_size 2048 -> {cfg.replay.buffer_size} (as "
          f"[loop-dense]: dense bf16 obs are 11.1 MB a lane-episode) | "
          f"{smi}", flush=True)
    result = {}
    # ---- the mask kernel against its plain version at the path's shapes
    key = prng.PRNGKey(SEED + 70, "cuda")
    keep = 1.0 - DROPOUT
    scope = Scope(key, ("transformer", "block_0", "Dropout_0"))
    fold = scope.fold_data()
    mask_ms, kernel = {}, {}
    for name, shape in (("agent", (bs * 64, 65, 256)),
                        ("mixer", (bs, 131, 256)),
                        ("rollout", (b * 64, 65, 256))):
        got = dk.keep_mask(key, fold, keep, shape)
        ref = dk.keep_mask_reference(key, fold, keep, shape)
        torch.cuda.synchronize()
        check(got.dtype == torch.bool and torch.equal(got, ref),
              f"[dropout] the mask kernel differs from its plain version "
              f"at {shape}: {int((got != ref).sum())} elements")
        err = float((got.float() - ref.float()).abs().max())
        del got, ref
        n = math.prod(shape)
        bound, by = bound_ms(n + 16, (n + 1) * MASK_OPS, "int32")
        row = {"shape": list(shape), "max_abs_err": err,
               "ms": cuda_ms(lambda: dk.keep_mask(key, fold, keep, shape)),
               "plain_ms": cuda_ms(lambda: dk.keep_mask_reference(
                   key, fold, keep, shape), iters=3, warmup=1),
               "bound_ms": bound, "bound_by": by, "library_ms": None}
        kernel[name] = row
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
        mask_ms[name] = cuda_ms(lambda: dropout(x, DROPOUT, scope),
                                iters=10, warmup=2)
        del x
        print(f"[dropout] mask kernel at the {name} shape {shape}: equal "
              f"to the plain version bit for bit; {row['ms']:.3f} ms "
              f"(bound {bound:.3f} ms by {by}, plain "
              f"{row['plain_ms']:.2f} ms); one dropout (mask + select, "
              f"bf16) {mask_ms[name]:.3f} ms", flush=True)
    result.update(mask_ms=mask_ms, mask_kernel=kernel)
    # ---- a data-parallel rank's rows of the masks (a row map): the
    # learner's block of rows and the rollout's interleaved lanes, each
    # lane's agent rows together, at 2 ranks
    result["row_map"] = dropout_row_maps(torch, key, fold, keep, bs, b)
    # ---- masks differ under two keys, match on one
    x = torch.randn(bs * 64, 65, 256, device="cuda", dtype=torch.bfloat16)
    k1, k2 = prng.split(key).unbind(0)
    m1 = dropout(x, DROPOUT, Scope(k1)) == 0
    check(torch.equal(m1, dropout(x, DROPOUT, Scope(k1)) == 0),
          "[dropout] one key drew two masks")
    check(not torch.equal(m1, dropout(x, DROPOUT, Scope(k2)) == 0),
          "[dropout] two keys drew one mask")
    drop_share = float(m1.float().mean())
    check(abs(drop_share - DROPOUT) < 0.01,
          f"[dropout] {drop_share:.4f} of the elements dropped")
    del x, m1
    # ---- three classic iterations; the last DROPOUT_K of them are the
    # eager reference of one fused dispatch from the state before them
    torch.cuda.reset_peak_memory_stats()
    ts = exp.init_state(SEED)
    per_iter = dropout_mask_launches(cfg)
    want = dropout_launches(cfg)
    dk.reset_launches()                  # ---- the dropout path starts here
    ts, rec_first, first = run_loop(torch, att, exp, ts, "dropout",
                                    3 - DROPOUT_K, want=want)
    cursor = first.pop("cursor")
    mirror = {"key": cursor.key, "t_env": cursor.t_env,
              "episode": cursor.episode, "filled": cursor.buffer_filled}
    start = clone_state(ts)
    ts, rec_rest, rest = run_loop(torch, att, exp, ts, "dropout",
                                  DROPOUT_K, want=want, cursor=cursor)
    masks = dk.LAUNCHES["dropout_mask"]  # ---- and ends here
    check(masks == 3 * per_iter, f"[dropout] {masks} mask launches in 3 "
                                 f"iterations, want 3 x {per_iter}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cursor = rest.pop("cursor")
    recs = [r for r, _, _ in rec_first + rec_rest]
    loop = {"rollout_p50_ms": statistics.median(r.rollout_s for r in recs)
            * 1e3,
            "train_p50_ms": statistics.median(r.train_s for r in recs) * 1e3,
            "launches": {k: first["launches"][k] + rest["launches"][k]
                         for k in want}}
    print(f"[dropout] 3 iterations: rollout+insert p50 "
          f"{loop['rollout_p50_ms']:.1f} ms, trainer step p50 "
          f"{loop['train_p50_ms']:.1f} ms, peak {peak:.2f} GiB; {masks} "
          f"mask launches ({per_iter} an iteration)", flush=True)
    result.update(loop, peak_gib=peak)
    # ---- the loss with dropout on and off, from one state and batch
    batch, _, w = exp.buffer.sample(ts.buffer, k1, bs, cursor.t_env)
    off = QMixLearner.build(_with(cfg, model={"dropout": 0.0}), exp.mac,
                            exp.env.get_env_info())
    with torch.no_grad():
        l_on, _ = lrn._loss(ts.learner.params, ts.learner.target_params,
                            batch, w, k2)
        l_on2, _ = lrn._loss(ts.learner.params, ts.learner.target_params,
                             batch, w, k2)
        l_off, _ = off._loss(ts.learner.params, ts.learner.target_params,
                             batch, w)
    check(float(l_on) == float(l_on2), "[dropout] one key, two losses")
    check(float(l_on) != float(l_off), "[dropout] the loss ignores dropout")
    print(f"[dropout] loss on one batch: dropout {float(l_on):.6g} (the "
          f"same key twice: equal), off {float(l_off):.6g}", flush=True)
    del batch, w, off
    gc.collect()
    torch.cuda.empty_cache()
    # ---- one fused K = 2 dispatch from the state before the last two
    # classic iterations, against them
    sup = exp.superstep_program(DROPOUT_K)
    att.reset_launches()
    dk.reset_launches()
    t0 = time.perf_counter()
    start, _, _, gated = fused_dispatch(torch, sup, start, mirror)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused = dict(att.LAUNCHES)
    fused_masks = dk.LAUNCHES["dropout_mask"]
    check(fused_masks == DROPOUT_K * per_iter,
          f"[dropout] fused mask launches {fused_masks}, want {DROPOUT_K} "
          f"x {per_iter}")
    check(all(gated) and (exp.device.type != "cuda"
                          or set(sup.graphs) == {"rollout", "train"}),
          f"[dropout] gates {gated}, graphs {sorted(sup.graphs)}")
    check(fused == rest["launches"],
          f"[dropout] launches eager {rest['launches']}, fused {fused}")
    fa, _ = flatten_state(ts)
    fb, _ = flatten_state(start)
    diff = [k for k in fa if not torch.equal(fa[k], fb[k])]
    check(not diff and torch.equal(cursor.key, mirror["key"]),
          f"[dropout] fused K={DROPOUT_K} differs from eager in {diff[:5]}")
    print(f"[dropout] one fused K={DROPOUT_K} dispatch (captured rollout "
          f"and train graphs, {fused_s:.2f} s with the captures) = the "
          f"last {DROPOUT_K} classic iterations bit for bit over "
          f"{len(fa)} state tensors; launches {fused}, mask launches "
          f"{fused_masks}", flush=True)
    sup.close()
    del sup, start, ts, exp, lrn, fa, fb
    gc.collect()
    torch.cuda.empty_cache()
    result["launches"] = {k: loop["launches"][k] + fused[k] for k in fused}
    result["mask_launches"] = masks + fused_masks
    # ---- f32 pallas against xla on one short dropout step, same masks
    info = Experiment.build(cfg).env.get_env_info()
    g = torch.Generator(device="cuda").manual_seed(SEED + 71)
    batch = make_episodes(torch, info, 2, 20, g, torch.float32)
    w = torch.tensor([1.0, 0.6], device="cuda")
    outs = {attention: cross_check_step(torch, info, attention, False,
                                        batch, w, remat=True,
                                        dropout=DROPOUT, key=k2,
                                        episode_limit=20)
            for attention in ("pallas", "xla")}
    report = compare_steps(torch, outs["pallas"], outs["xla"], cfg.lr,
                           cfg.optim_eps)
    print(f"[dropout] f32 cross-check (dense, dropout {DROPOUT}, remat, "
          f"batch 2, T=20, one key): pallas vs xla {report}", flush=True)
    del outs, batch
    torch.cuda.empty_cache()
    # ---- the noisy leg: the dense agent's noise
    # remat: the dense agent's unroll at T = 150 keeps every token's
    # activations, as under dropout
    ncfg = _with(_episode_cfg(loop_cfg(DROPOUT_LANES, DROPOUT_RING,
                                       entity_tables=False,
                                       selector="noisy-new"), DROPOUT_T),
                 model={"use_qslice": False, "remat": True})
    nexp = Experiment.build(ncfg)
    check(nexp.learner.needs_rngs and not nexp.mac.use_qslice
          and not nexp.learner._mixer_qslice,
          "[dropout] the noisy leg is not the dense agent's noise")
    nts = nexp.init_state(SEED)
    before = {m: {k: v.clone() for k, v in sub.items()}
              for m, sub in nts.learner.params.items()}
    want = dropout_launches(ncfg)
    nts, _, noisy = run_loop(torch, att, nexp, nts, "dropout-noisy", 1,
                             want=want)
    noisy.pop("cursor")
    moved = _params_moved(torch, before, nts.learner.params)
    mac = nexp.mac
    obs = nexp.buffer.sample(nts.buffer, k1, 4, 0)[0].obs[:, 0].float()
    hidden = mac.init_hidden(4)
    p = nts.learner.params["agent"]
    q_mu, _ = mac.forward(p, obs, hidden)
    q_noisy, _ = mac.forward(p, obs, hidden, key=k2, deterministic=False)
    dq = float((q_noisy - q_mu).abs().max())
    check(dq > 0.0, "[dropout] noisy leg: the noisy q equals the mu q")
    batch, _, w = nexp.buffer.sample(nts.buffer, k1, ncfg.batch_size, 0)
    params = {m: {k: v.detach().requires_grad_() for k, v in sub.items()}
              for m, sub in nts.learner.params.items()}
    loss, _ = nexp.learner._loss(params, nts.learner.target_params, batch,
                                 w, k2)
    names = sorted(k for k in params["agent"] if "sigma" in k)
    # every leaf, as the learner's step takes them: a backward pruned to
    # the sigmas leaves remat's recomputed activations unconsumed
    leaves = [v for sub in params.values() for v in sub.values()]
    grads = dict(zip([(m, k) for m, sub in params.items() for k in sub],
                     torch.autograd.grad(loss, leaves, allow_unused=True)))
    grads = [grads[("agent", k)] for k in names]
    norms = {k: float(gr.norm()) for k, gr in zip(names, grads)}
    check(len(names) == 2 and all(bool(torch.isfinite(gr).all())
                                  for gr in grads)
          and any(v > 0.0 for v in norms.values()),
          f"[dropout] noisy leg: sigma gradients {norms}")
    print(f"[dropout] noisy leg (noisy-new, use_qslice false, remat, "
          f"dropout 0: the dense agent's noise; the dense mixer, "
          f"deterministic): "
          f"{moved} param tensors moved, launches {noisy['launches']}, "
          f"noisy q - mu q max |d| {dq:.3e}, sigma gradient norms "
          + ", ".join(f"{k} {v:.3e}" for k, v in norms.items()),
          flush=True)
    check(moved > 0, "[dropout] noisy leg: no param moved")
    result["launches"] = {k: result["launches"][k] + noisy["launches"][k]
                          for k in want}
    result["noisy"] = noisy
    del nexp, nts, batch, params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_families(torch, att, smi: str) -> dict:
    """One classic iteration of each agent/mixer family at config 3's
    widths (GRU hidden 256, obs 576): a finite loss, params that move and
    the launches each combination makes."""
    import gc
    from t2omca_tpu_torch.run import Experiment
    out = {"launches": dict.fromkeys(("flash_fwd", "flash_fwd_res",
                                      "flash_bwd_dq", "flash_bwd_dkv"), 0)}
    for agent, mixer in FAMILIES:
        cfg = _episode_cfg(loop_cfg(FAMILY_LANES, FAMILY_RING,
                                    entity_tables=False), FAMILY_T)
        cfg = dataclasses.replace(cfg, agent=agent, mixer=mixer)
        exp = Experiment.build(cfg)
        tag = f"families {agent}+{mixer}"
        ts = exp.init_state(SEED)
        n_params = {m: sum(v.numel() for v in sub.values())
                    for m, sub in ts.learner.params.items()}
        before = {m: {k: v.clone() for k, v in sub.items()}
                  for m, sub in ts.learner.params.items()}
        want = family_launches(cfg)
        ts, records, res = run_loop(torch, att, exp, ts, tag, 1, want=want)
        res.pop("cursor")
        moved = _params_moved(torch, before, ts.learner.params)
        total = sum(len(sub) for sub in before.values())
        check(moved == total, f"[{tag}] {moved} of {total} param tensors "
                              f"moved")
        (rec, loss, gn), = records
        print(f"[families] {agent}+{mixer}: {n_params['agent']} agent and "
              f"{n_params['mixer']} mixer params, all {total} tensors moved, "
              f"loss {loss:.4g}, grad_norm {gn:.4g}, launches {want}, "
              f"rollout+insert {rec.rollout_s * 1e3:.1f} ms, trainer step "
              f"{rec.train_s * 1e3:.1f} ms (cuts: batch_size_run 1024 -> "
              f"{FAMILY_LANES}, buffer_size 2048 -> {FAMILY_RING}, "
              f"episode_limit 150 -> {FAMILY_T})",
              flush=True)
        for k in out["launches"]:
            out["launches"][k] += res["launches"][k]
        out[f"{agent}+{mixer}"] = {"loss": loss, "grad_norm": gn,
                                   "train_ms": rec.train_s * 1e3,
                                   "rollout_ms": rec.rollout_s * 1e3}
        del exp, ts, records, before
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _rss_gib() -> float:
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) / 2 ** 20
    return float("nan")


def phase_host_replay(torch, att, smi: str) -> dict:
    """``replay.buffer_cpu_only``: the ring in pinned host RAM at config
    3's widths (f32 storage), three classic iterations: the card's
    sampled indices against the sum-trees' and the weights against numpy's
    (N·p/Σp)^-β on the same priorities, one device-to-host copy a sample (counted in a
    profiler trace), the deferred feedback one iteration late; then the
    CLI to one log cadence."""
    import gc
    import glob
    import shutil
    import tempfile
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch.components import host_replay as hr
    from t2omca_tpu_torch.run import Experiment, LoopCursor
    cfg = _episode_cfg(loop_cfg(HOST_LANES, HOST_RING), HOST_T)
    cfg = dataclasses.replace(cfg, replay=dataclasses.replace(
        cfg.replay, buffer_cpu_only=True, store_dtype="float32"))
    rss0 = _rss_gib()
    t0 = time.perf_counter()
    exp = Experiment.build(cfg)
    build_s = time.perf_counter() - t0
    buf = exp.buffer
    check(exp.host_buffer and buf._storage.obs.is_pinned(),
          "[host-replay] the ring is not in pinned host memory")
    ring_gib = sum(getattr(buf._storage, f.name).nbytes for f in
                   dataclasses.fields(buf._storage)) / 2 ** 30
    b, t = cfg.batch_size_run, cfg.env_args.episode_limit
    print(f"[host-replay] replay.buffer_cpu_only: a ring of {HOST_RING} "
          f"episodes in pinned host RAM, f32 ({ring_gib:.2f} GiB, "
          f"{buf._storage.obs[0].nbytes / 1e6:.1f} MB of obs an episode; "
          f"allocated in {build_s:.1f} s), entity-table acting, dense "
          f"storage; cuts: batch_size_run 1024 -> {b}, buffer_size 2048 "
          f"-> {HOST_RING}, episode_limit 150 -> {t} | RSS {rss0:.2f} -> "
          f"{_rss_gib():.2f} GiB | {smi}",
          flush=True)
    calls = []
    real = hr.stratified_sample

    def recording(pri, us, n, beta):
        idx, w = real(pri, us, n, beta)
        calls.append((pri.cpu().numpy().copy(), us.cpu().numpy().copy(),
                      n, beta, idx.cpu().numpy(), w.cpu().numpy()))
        return idx, w
    ts = exp.init_state(SEED)
    cursor, records, tds = None, [], []
    hr.stratified_sample = recording
    try:
        for i in range(3):
            pri_before = buf._pri.copy()
            ts, recs, res = run_loop(torch, att, exp, ts, "host-replay", 1,
                                     cursor=cursor)
            cursor = res.pop("cursor")
            rec = recs[0][0]
            records.append(res)
            n_calls = len(calls)
            if rec.info is None:
                continue
            # the deferred feedback: the previous step's |TD| landed at
            # this iteration's insert (one iteration late), this step's is
            # pending, and the mirror is exactly that
            check(buf._pending_update is not None,
                  f"[host-replay] iteration {i}: no deferred update")
            ref = pri_before.copy()
            if tds:
                pidx, ptd = tds[-1]
                ref[pidx] = ((ptd + 1e-6) ** cfg.replay.per_alpha).astype(
                    np.float32)
            ref[(np.arange(b) + i * b) % HOST_RING] = np.float32(
                buf._max_priority ** cfg.replay.per_alpha)
            check(np.array_equal(buf._pri, ref),
                  f"[host-replay] iteration {i}: the priority mirror is not "
                  f"the previous step's |TD| one iteration late")
            check(np.array_equal(buf._pri_dev.cpu().numpy(), buf._pri),
                  f"[host-replay] iteration {i}: the mirrors differ")
            tds.append((calls[-1][4], rec.info["td_errors_abs"].double()
                        .cpu().numpy()))
            check(n_calls >= 1, "[host-replay] no device sample")
    finally:
        hr.stratified_sample = real
    # the device's indices and weights against the sum-tree formulation
    trees = [("py", hr.PySumTree)]
    try:
        hr.NativeSumTree(8)
        trees.append(("native", hr.NativeSumTree))
    except Exception as e:                   # noqa: BLE001
        check(False, f"[host-replay] the native sum-tree did not build: "
                     f"{e}")
    for pri, us, n, beta, idx, w in calls:
        for name, cls in trees:
            tree = cls(len(pri))
            tree.set_batch(np.arange(len(pri)), pri.astype(np.float64))
            ti, _ = tree.sample(us.astype(np.float64))
            ti = np.minimum(ti, n - 1)
            check(np.array_equal(ti, idx),
                  f"[host-replay] {name} sum-tree indices differ")
        # (N·p/Σp)^-β max-normalized from the leaf priorities, in f64
        mass = np.where(np.arange(len(pri)) < n, pri, 0).astype(np.float64)
        w_ref = (max(n, 1) * mass[ti] / mass.sum()) ** -float(beta)
        w_ref /= w_ref.max()
        check(np.allclose(w, w_ref, rtol=1e-6, atol=0),
              f"[host-replay] weights differ from (N·p/Σp)^-β at the "
              f"tree's indices by {np.abs(w / w_ref - 1).max():.2e} "
              f"(rtol 1e-6)")
    # one device-to-host copy a sample, in a profiler trace
    torch.cuda.synchronize()
    before = dict(buf.copies)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batch, idx, w = buf.sample(cfg.batch_size, cursor.t_env)
        torch.cuda.synchronize()
    d2h = sum(1 for e in prof.events()
              if "Memcpy DtoH" in e.name or "Memcpy D2H" in e.name)
    h2d_bytes = sum(x.nbytes for x in (batch.obs, batch.state,
                                       batch.avail_actions, batch.actions,
                                       batch.reward, batch.terminated,
                                       batch.filled))
    check(d2h == 1 and buf.copies["d2h"] - before["d2h"] == 1
          and buf.copies["h2d"] - before["h2d"] == 1,
          f"[host-replay] a sample made {d2h} device-to-host copies in the "
          f"trace, counts {buf.copies} from {before}")
    t0 = time.perf_counter()
    for _ in range(3):
        buf.sample(cfg.batch_size, cursor.t_env)
    torch.cuda.synchronize()
    sample_ms = (time.perf_counter() - t0) / 3 * 1e3
    del batch
    rss = _rss_gib()
    p50_iter = statistics.median(r["iteration_p50_ms"] for r in records)
    p50_train = statistics.median(r["train_p50_ms"] for r in records
                                  if r["train_p50_ms"] is not None) \
        if any(r["train_p50_ms"] for r in records) else float("nan")
    print(f"[host-replay] {len(calls)} device samples: indices equal to "
          f"the Python and native sum-trees', weights within rtol 1e-6 "
          f"of (N·p/Σp)^-β in numpy at the trees' indices; a sample: 1 device-to-host "
          f"copy in the trace (the indices), 1 host-to-device copy of "
          f"{h2d_bytes / 1e6:.1f} MB, {sample_ms:.1f} ms; the deferred "
          f"|TD| lands one iteration late; iteration p50 {p50_iter:.1f} ms,"
          f" trainer step p50 {p50_train:.1f} ms; RSS {rss:.2f} GiB",
          flush=True)
    launches = {k: sum(r["launches"][k] for r in records)
                for k in records[0]["launches"]}
    result = {"launches": launches, "iteration_p50_ms": p50_iter,
              "train_p50_ms": p50_train, "sample_ms": sample_ms,
              "rss_gib": rss, "ring_gib": ring_gib}
    del exp, ts, buf
    gc.collect()
    torch.cuda.empty_cache()
    # the CLI with it, to one log cadence
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_driver_", dir=root)
    steps = HOST_LANES * t
    try:
        att.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["train", "--config",
                       os.path.join(root, DRIVER_CONFIG),
                       "kernels.attention=pallas",
                       "replay.buffer_cpu_only=true",
                       f"replay.buffer_size={HOST_RING}",
                       f"batch_size_run={HOST_LANES}",
                       f"env_args.episode_limit={t}",
                       f"t_max={steps}", f"log_interval={steps}",
                       f"runner_log_interval={steps}",
                       "test_interval=1000000000", f"test_nepisode={b}",
                       f"save_model_interval={steps}",
                       "obs.pulse_port=0", f"local_results_path={tmp}"])
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"[host-replay] the CLI returned {rc}")
        rows = _metric_rows(tmp)
        keys = {r["key"] for r in rows}
        for k in ("loss", "grad_norm", "return_mean",
                  "sight_priority_entropy"):
            check(k in keys, f"[host-replay] the CLI logged no {k}")
        ckpts = glob.glob(os.path.join(tmp, "models", "*", "*",
                                       "state.pt"))
        check(ckpts, "[host-replay] the CLI saved no checkpoint")
        state = torch.load(ckpts[-1], weights_only=True)
        check(not any(k.startswith("buffer.") for k in state),
              "[host-replay] the checkpoint holds the ring")
        size = os.path.getsize(ckpts[-1])
        print(f"[host-replay] python -m t2omca_tpu_torch train --config "
              f"{DRIVER_CONFIG} kernels.attention=pallas "
              f"replay.buffer_cpu_only=true (cut as above; the three-"
              f"program path, superstep ineligible): {len(rows)} metric "
              f"rows to the log cadence at t_env {steps} in "
              f"{cli_s:.1f} s, a checkpoint of {size / 1e6:.1f} MB without "
              f"the ring", flush=True)
        result["cli_s"] = cli_s
        result["launches"] = {k: launches[k] + att.LAUNCHES[k]
                              for k in launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return result


#: [driver]: config 3 through the CLI, as a user runs it, with the one
#: override it needs on the port (the flash kernels on; the file leaves
#: kernels.attention at xla), so with the learning-health probes
#: (obs.sight) and the live plane on port 9464 (obs.pulse_port); the
#: SIGTERM and the full-state evaluate steps run a cut copy (4 lanes, a
#: ring of 256, and for SIGTERM K = 1 and a one-iteration trace window),
#: so as not to pay another full-width startup
DRIVER_CONFIG = "configs/config3_tpu_northstar.yaml"
#: episode_limit 150 -> 20, cut in steps for the smoke's limit (the
#: captures, the dispatches and the checkpoint scale with T; PERF.md §4),
#: t_max to its one K = 4 dispatch of 1024 lanes
DRIVER_T = 20
DRIVER_OVERRIDES = ("kernels.attention=pallas",
                    f"env_args.episode_limit={DRIVER_T}",
                    f"t_max={4 * 1024 * DRIVER_T - 1}")
SIGTERM_LANES = 4                   # batch_size_run 1024 -> 4
SIGTERM_RING = 256                  # replay.buffer_size 2048 -> 256
SIGTERM_T = 30                      # episode_limit 150 -> 30: its trace
#                                     and dispatches, the smoke's limit
EVAL_EPISODES = 4
#: the metric keys a config-3 run must write. At K = 4 the dispatch is
#: timed as time_superstep_ms, as the JAX driver times its fused one, and
#: env_steps_per_sec needs a second log cadence (the first only starts
#: its clock, as in JAX): the SIGTERM run, which logs every dispatch,
#: must write it
DRIVER_KEYS = ("return_mean", "test_return_mean", "reward_mean",
               "task_completion_rate_mean", "episode_limit_mean", "epsilon",
               "loss", "grad_norm", "episode", "time_superstep_ms",
               "time_test_ms")
#: the learning-health keys (obs.sight) the log cadence writes: scalars,
#: the histograms (obs.sight.bins long, each summing to 1) and the
#: per-layer attention entropies (depth long, in [0, 1])
SIGHT_KEYS = tuple(f"sight_{k}" for k in (
    "grad_norm_agent_tf", "grad_norm_embed", "grad_norm_mixer",
    "update_norm_agent_tf", "update_norm_embed", "update_norm_mixer",
    "per_ess", "target_drift", "priority_entropy", "priority_entropy_norm",
    "td_hist", "q_taken_hist", "target_hist", "attn_entropy_agent",
    "attn_entropy_mixer"))
#: the /healthz checks of a config-3 run: the watchdog, the shutdown
#: guard and one per learning-health detector
HEALTH_CHECKS = ("watchdog-main", "shutdown-guard") + tuple(
    f"sight-{d}" for d in ("loss_plateau", "q_divergence",
                           "priority_collapse", "attention_collapse",
                           "grad_starvation"))


class _Scraper:
    """Reads the live plane's /metrics and /healthz from a thread every
    ``every`` seconds while a run goes on, and once more on demand (the
    driver's last read, just before the plane closes)."""

    def __init__(self, port: int, every: float = 1.0):
        import threading
        self.base = f"http://127.0.0.1:{port}"
        self.every = every
        self.metrics, self.health = [], []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def scrape(self) -> None:
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(self.base + "/metrics",
                                        timeout=5) as r:
                self.metrics.append(r.read().decode())
        except OSError:
            pass
        try:
            with urllib.request.urlopen(self.base + "/healthz",
                                        timeout=5) as r:
                self.health.append((r.status, json.loads(r.read())))
        except urllib.error.HTTPError as e:
            self.health.append((e.code, json.loads(e.read())))
        except OSError:
            pass

    def _loop(self) -> None:
        while not self.stop.wait(self.every):
            self.scrape()

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=30)
        check(not self.thread.is_alive(), "[driver] the scraper hung")


def _metric_rows(results: str) -> list:
    rows = []
    for path in sorted(__import__("glob").glob(
            os.path.join(results, "*", "metrics.jsonl"))):
        with open(path) as f:
            rows += [json.loads(line) for line in f]
    return rows


def _spans(results: str) -> list:
    out = []
    for path in __import__("glob").glob(os.path.join(results, "*",
                                                     "spans.jsonl")):
        with open(path) as f:
            out += [json.loads(line) for line in f if line.strip()]
    return out


def _one_dir(pattern: str) -> str:
    found = __import__("glob").glob(pattern)
    check(len(found) == 1, f"expected one match of {pattern}: {found}")
    return found[0]


class _LogLines:
    """Collects the driver's console lines (the ``t2omca`` logger)."""

    def __init__(self):
        import logging
        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: self.lines.append(rec.getMessage())
        logging.getLogger("t2omca").addHandler(self.handler)

    def has(self, text: str) -> bool:
        return any(text in line for line in self.lines)

    def close(self):
        import logging
        logging.getLogger("t2omca").removeHandler(self.handler)


def _timed_dispatches(torch, superstep_mod):
    """Turn on the fused program's own per-iteration CUDA events
    (``SuperstepProgram.timing``: recorded on the stream, no added
    synchronize) for every program the driver builds, and record each
    call's program. → (list of programs called, one entry a dispatch;
    restore function)."""
    cls = superstep_mod.SuperstepProgram
    original = cls.__call__
    calls = []

    def timed(self, *args, **kw):
        self.timing = True
        out = original(self, *args, **kw)
        calls.append((self, list(self.events),
                      dict(self.capture_s), dict(self.instantiate_s)))
        return out

    cls.__call__ = timed
    return calls, lambda: setattr(cls, "__call__", original)


def phase_driver(torch, att, loop: dict, after=None) -> dict:
    """The training driver through ``python -m t2omca_tpu_torch``'s
    ``main``: config 3 uncut (one K = 4 dispatch, the test, save and log
    cadences), an exact resume, a SIGTERM'd subprocess and evaluate.
    ``after(models_dir, first_agent)`` runs on the resumed run's
    checkpoint directory and a checkpoint of the first run's agent leaves
    before they are deleted; its result is ``result["after"]`` and its
    seconds ``result["after_s"]``."""
    import gc
    import glob
    import shutil
    import signal
    import tempfile
    import numpy as np
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.obs import pulse as pulse_mod
    from t2omca_tpu_torch.runners.episode_runner import EpisodeRunner
    from t2omca_tpu_torch.train import superstep as superstep_mod
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    from t2omca_tpu_torch.utils import resilience
    root = os.path.dirname(os.path.abspath(__file__))
    cfg3 = os.path.join(root, DRIVER_CONFIG)
    cfg = load_config(cfg3, DRIVER_OVERRIDES)
    k = cfg.superstep
    per = k * cfg.batch_size_run * cfg.env_args.episode_limit
    check(k > 1 and cfg.t_max < per, f"[driver] {DRIVER_CONFIG} does not "
          f"train exactly one K={k} dispatch (t_max {cfg.t_max})")
    port = cfg.obs.pulse_port
    check(cfg.obs.sight.enabled and port > 0 and cfg.obs.memwatch,
          f"[driver] {DRIVER_CONFIG} does not turn on obs.sight, the live "
          f"plane and memwatch")
    want = {name: k * v for name, v in loop_launches(cfg).items()}
    timeout = max(120.0, round(4 * k * loop["iteration_p50_ms"] / 1e3))
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_driver_", dir=root)
    base = ["--config", cfg3, *DRIVER_OVERRIDES]
    result = {}
    logs = _LogLines()
    try:
        # ---- 1. train: config 3 uncut, one dispatch of K = 4 ----------
        out1 = os.path.join(tmp, "train")
        calls, unwrap = _timed_dispatches(torch, superstep_mod)
        scraper = _Scraper(port)
        close = pulse_mod.PulseHandle.close

        def read_then_close(handle):
            # the plane's last read: after the run's last log cadence,
            # just before the driver closes it
            scraper.scrape()
            close(handle)

        pulse_mod.PulseHandle.close = read_then_close
        n_lines = len(logs.lines)
        att.reset_launches()             # ---- the driver path starts here
        t_start = time.time()
        try:
            with scraper:
                rc = cli.main(["train", *base,
                               f"resilience.dispatch_timeout={timeout}",
                               f"local_results_path={out1}"])
        finally:
            unwrap()
            pulse_mod.PulseHandle.close = close
        torch.cuda.synchronize()
        train_wall = time.time() - t_start
        launches = dict(att.LAUNCHES)    # ---- and ends here
        check(rc == 0, f"[driver] train returned {rc}")
        check(len(calls) == 1, f"[driver] {len(calls)} fused dispatches, "
                               f"expected one")
        check(launches == want, f"[driver] launches {launches} != {want}")
        _, marks, cap, inst = calls[0]
        iters_ms = [e0.elapsed_time(e2) for e0, _, e2 in marks]
        check(len(iters_ms) == k and set(cap) == {"rollout", "train"},
              f"[driver] the dispatch replayed no captured graphs "
              f"({len(iters_ms)} iterations, captured {sorted(cap)})")
        rows = _metric_rows(out1)
        keys = {r["key"] for r in rows}
        missing = [k for k in DRIVER_KEYS + SIGHT_KEYS if k not in keys]
        check(not missing, f"[driver] metrics.jsonl lacks {missing}")
        newest = {r["key"]: r["value"] for r in rows}
        for key in SIGHT_KEYS:
            v = np.asarray(newest[key], np.float64)
            if key.endswith("_hist"):
                check(v.shape == (cfg.obs.sight.bins,)
                      and abs(float(v.sum()) - 1.0) < 1e-5,
                      f"[driver] {key} {v}")
            elif key.startswith("sight_attn_entropy"):
                check(v.shape == (cfg.model.depth,)
                      and bool(((v >= 0) & (v <= 1 + 1e-6)).all()),
                      f"[driver] {key} {v}")
            else:
                check(v.shape == (), f"[driver] {key} {v}")
        # the live plane answered during the call, and bound its port
        said = logs.lines[n_lines:]
        check(not any("could not bind" in x for x in said),
              f"[driver] the live plane could not bind 127.0.0.1:{port}")
        check(any(f"metrics endpoint on 127.0.0.1:{port}" in x
                  for x in said), "[driver] the live plane did not start")
        check(scraper.metrics and scraper.health,
              f"[driver] /metrics or /healthz never answered on {port}")
        scraped = "\n".join(scraper.metrics)
        for name in ("t2omca_t_env ", "t2omca_episode ",
                     'watchdog_heartbeat_age_seconds{side="main"}',
                     'watchdog_stalls_total{side="main"}',
                     'hbm_bytes_in_use{device="0"}',
                     'backend_info{backend="cuda"}', "t2omca_superstep_k 4"):
            check(name in scraped, f"[driver] /metrics never showed {name}")
        code, health = scraper.health[-1]
        check(set(HEALTH_CHECKS) == set(health["checks"]),
              f"[driver] /healthz checks {sorted(health['checks'])}")
        check(code == (200 if health["status"] == "ok" else 503),
              f"[driver] /healthz {code} with status {health['status']}")
        check(max(r["t"] for r in rows) == per,
              f"[driver] last t {max(r['t'] for r in rows)} != {per}")
        for r in rows:
            v = r["value"]
            check(all(np.isfinite(v if isinstance(v, list) else [v])),
                  f"[driver] non-finite {r}")
        model_dir = _one_dir(os.path.join(out1, "models", "*"))
        found = ckpt.find_checkpoint(model_dir)
        check(found is not None and found[1] == per,
              f"[driver] checkpoint {found}")
        check(ckpt.verify_checkpoint(found[0]), "[driver] verify failed")
        check(not glob.glob(os.path.join(model_dir, "tmp.*")),
              "[driver] a staging directory was left over")
        save = dict(ckpt.LAST_TIMES)
        spans = _spans(out1)
        check(any(sp.get("phase") == "memwatch.snapshot" for sp in spans)
              and any(sp.get("phase") == "checkpoint.save" for sp in spans),
              "[driver] spans.jsonl lacks the memwatch / checkpoint spans")
        by_phase = {}
        for sp in spans:
            if sp.get("event") == "span":
                by_phase.setdefault(sp["phase"], []).append(sp)
        disp = by_phase["dispatch.superstep"][0]
        startup_s = disp["t0"] - t_start
        test_ms = [r["value"] for r in rows if r["key"] == "time_test_ms"]
        print(f"[driver] train: config 3 uncut via python -m "
              f"t2omca_tpu_torch train --config {DRIVER_CONFIG} "
              f"{' '.join(DRIVER_OVERRIDES)} (+ resilience.dispatch_timeout="
              f"{timeout}, local_results_path): {cfg.batch_size_run} lanes, "
              f"ring {cfg.replay.buffer_size}, one K={k} dispatch to t_env "
              f"{per}, launches {launches} ({k} x [loop]'s), "
              f"{len(rows)} metric rows, checkpoint {found[1]} verified",
              flush=True)
        print(f"[driver] times: startup to the first dispatch "
              f"{startup_s:.2f} s (kernels prebuilt); dispatch host "
              f"{disp['wall_ms']:.0f} ms (the fused program: capture "
              f"rollout {cap['rollout']:.2f} s + instantiate "
              f"{inst['rollout']:.2f} s, train {cap['train']:.2f} s + "
              f"{inst['train']:.2f} s, in the first iteration); iterations "
              f"(device timeline) {', '.join(f'{x:.0f}' for x in iters_ms)}"
              f" ms against [loop]'s eager iteration p50 "
              f"{loop['iteration_p50_ms']:.0f} ms; test rollout "
              f"{test_ms[0] if test_ms else float('nan'):.0f} ms; whole "
              f"call {train_wall:.1f} s", flush=True)
        print(f"[driver] checkpoint: {save['save_bytes'] / 1e9:.3f} GB, "
              f"device->host {save['save_copy_s']:.2f} s, write+fsync "
              f"{save['save_write_s']:.2f} s "
              f"({save['save_bytes'] / 1e9 / save['save_write_s']:.2f} GB/s),"
              f" hash {save['save_hash_s']:.2f} s", flush=True)
        alerts = sorted(r["key"][len("sight_alert_"):] for r in rows
                        if r["key"].startswith("sight_alert_")
                        and r["value"])
        print(f"[driver] live plane on 127.0.0.1:{port}: "
              f"{len(scraper.metrics)} /metrics and {len(scraper.health)} "
              f"/healthz reads during the call (every 1 s and one after the "
              f"last log cadence); the last: /healthz {code} "
              f"{health['status']}; " + "; ".join(
                  f"{n} {'ok' if c['ok'] else 'DEGRADED'} ({c['detail']})"
                  for n, c in sorted(health["checks"].items())), flush=True)
        fmt = lambda k: "/".join(f"{x:.3f}" for x in np.atleast_1d(
            np.asarray(newest[k], np.float64)))
        print(f"[driver] learning health at t_env {per}: attention entropy "
              f"agent {fmt('sight_attn_entropy_agent')}, mixer "
              f"{fmt('sight_attn_entropy_mixer')}; PER ESS "
              f"{fmt('sight_per_ess')}, priority entropy / log n "
              f"{fmt('sight_priority_entropy_norm')}; grad norm agent_tf/"
              f"embed/mixer {newest['sight_grad_norm_agent_tf']:.4g}/"
              f"{newest['sight_grad_norm_embed']:.4g}/"
              f"{newest['sight_grad_norm_mixer']:.4g}; target drift "
              f"{fmt('sight_target_drift')}; detector trips: "
              f"{', '.join(alerts) or 'none'}", flush=True)
        result.update(launches=launches, iterations_ms=iters_ms,
                      dispatch_host_ms=disp["wall_ms"], startup_s=startup_s,
                      test_ms=test_ms[0] if test_ms else None,
                      train_wall_s=train_wall, **save)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 2. resume: the same call from the checkpoint ------------
        saved = torch.load(os.path.join(found[0], "state.pt"),
                           map_location="cpu", weights_only=True, mmap=True)
        meta = ckpt.read_meta(found[0])
        seen = {}

        def compare(t_env, state, key, **_):
            if seen:
                return
            tensors, host = ckpt.flatten_state(state)
            check(set(tensors) == set(saved), "[driver] resumed leaves")
            diff = [k for k, v in tensors.items()
                    if not torch.equal(v.cpu(), saved[k])]
            check(not diff, f"[driver] resumed state differs: {diff[:5]}")
            host_want = dict(meta["host"], **{"runner.t_env": per})
            check(host == host_want, f"[driver] host {host} != {host_want}")
            check(key.tolist() == meta["driver"]["key"],
                  "[driver] the driver key was not restored")
            seen.update(t_env=t_env, n=len(tensors),
                        bytes=sum(v.numel() * v.element_size()
                                  for v in tensors.values()))
            att.reset_launches()         # the new dispatch starts here

        out2 = os.path.join(tmp, "resume")
        resilience.register_fault("driver.iteration", compare)
        n_lines = len(logs.lines)
        t0 = time.time()
        try:
            rc = cli.main(["train", *base,
                           f"resilience.dispatch_timeout={timeout}",
                           f"checkpoint_path={model_dir}", f"t_max={per}",
                           f"local_results_path={out2}"])
        finally:
            resilience.clear_faults()
        resume_wall = time.time() - t0
        launches2 = dict(att.LAUNCHES)
        restore = dict(ckpt.LAST_TIMES)
        check(rc == 0 and seen.get("t_env") == per,
              f"[driver] resume rc {rc}, first t_env {seen.get('t_env')}")
        check(launches2 == want, f"[driver] resume launches {launches2}")
        check(any(f"metrics endpoint on 127.0.0.1:{port}" in x
                  for x in logs.lines[n_lines:]),
              f"[driver] the resumed call did not bind {port} again")
        rows2 = _metric_rows(out2)
        check(max(r["t"] for r in rows2) == 2 * per,
              f"[driver] resume ended at {max(r['t'] for r in rows2)}")
        check(ckpt.find_checkpoint(_one_dir(os.path.join(
            out2, "models", "*")))[1] == 2 * per, "[driver] resume save")
        print(f"[driver] resume: from t_env {seen['t_env']} to {2 * per}; "
              f"{seen['n']} restored tensors ({seen['bytes'] / 1e9:.3f} GB: "
              f"params, Adam, ring, priorities, env states, runner key), "
              f"the ring cursor and counters and the driver key equal the "
              f"checkpoint bit for bit before the first new dispatch; "
              f"launches {launches2}; restore: verify hash "
              f"{restore['verify_hash_s']:.2f} s, load "
              f"{restore['load_s']:.2f} s; whole call {resume_wall:.1f} s",
              flush=True)
        result.update(restore_hash_s=restore["verify_hash_s"],
                      restore_load_s=restore["load_s"], launches_resume=
                      launches2, resume_wall_s=resume_wall)
        del saved
        gc.collect()
        torch.cuda.empty_cache()
        # the first checkpoint's agent leaves, for what runs after the
        # phase (a refresh target), before its 2.7 GB go
        first_agent = os.path.join(tmp, "first_agent")
        ckpt.save_checkpoint(first_agent, found[1], {"learner": {"params": {
            "agent": ckpt._read_tensors(found[0], False, "cpu", mmap=True,
                                        prefix="learner.params.agent.")}}})
        shutil.rmtree(model_dir, ignore_errors=True)   # free the disk early
        resumed_models = _one_dir(os.path.join(out2, "models", "*"))

        # ---- 3. SIGTERM: a subprocess, after its first dispatch logged -
        out3 = os.path.join(tmp, "sigterm")
        cut = [f"batch_size_run={SIGTERM_LANES}",
               f"replay.buffer_size={SIGTERM_RING}",
               f"env_args.episode_limit={SIGTERM_T}"]
        # K = 1 here: a SIGTERM waits for the dispatch in flight, and one
        # iteration bounds that wait (and runs the K = 1 dispatches)
        proc = subprocess.Popen(
            [sys.executable, "-m", "t2omca_tpu_torch", "train", *base, *cut,
             "superstep=1", "t_max=100000000",
             "save_model_interval=100000000", "profile_iterations=1",
             f"log_interval={SIGTERM_LANES * SIGTERM_T}",
             f"test_nepisode={SIGTERM_LANES}", f"local_results_path={out3}"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        lines, armed, traced = [], None, False
        try:
            deadline = time.time() + 300
            for line in proc.stdout:
                lines.append(line)
                if (armed is None and "Recent stats" in line
                        and "env_steps_per_sec" in line):
                    # the second log cadence: touch PULSE_TRACE, then
                    # wait for the one-iteration capture it arms
                    armed = os.path.dirname(_one_dir(os.path.join(
                        out3, "*", "metrics.jsonl")))
                    open(os.path.join(armed, "PULSE_TRACE"), "w").close()
                    t_arm = time.time()
                elif armed and "profiler trace written to" in line:
                    traced = True
                    trace_s = time.time() - t_arm
                    break
                if time.time() > deadline:
                    break
            t_sig = time.time()
            proc.send_signal(signal.SIGTERM)
            rest, _ = proc.communicate(timeout=300)
            sig_s = time.time() - t_sig
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        text = "".join(lines) + rest
        check(proc.returncode == 0,
              f"[driver] SIGTERM exit {proc.returncode}: {text[-2000:]}")
        check(armed is not None and traced, "[driver] the PULSE_TRACE "
              f"capture did not land: {text[-2000:]}")
        trace = _one_dir(os.path.join(armed, "pulse_trace_01_t*",
                                      "trace_*.json"))
        check(not os.path.exists(os.path.join(armed, "PULSE_TRACE")),
              "[driver] PULSE_TRACE was not consumed")
        with open(trace, "rb") as f:
            head = f.read(1 << 16)
        check(head.lstrip().startswith(b"{") and b'"traceEvents"' in head
              and os.path.getsize(trace) > 1 << 20,
              f"[driver] the pulse trace {trace} is not a Chrome trace")
        sig_models = _one_dir(os.path.join(out3, "models", "*"))
        sig_found = ckpt.find_checkpoint(sig_models)
        check(sig_found is not None, "[driver] no emergency checkpoint")
        check("resume with checkpoint_path=" in text,
              "[driver] no resume hint in the SIGTERM'd run's log")
        check("env_steps_per_sec" in {r["key"] for r in _metric_rows(out3)},
              "[driver] the SIGTERM run logged no env_steps_per_sec")
        with open(_one_dir(os.path.join(out3, "*",
                                        "flight_recorder.json"))) as f:
            mem = json.load(f).get("memwatch", {})
        hw = [d.get("high_water_bytes", -1)
              for d in mem.get("devices", {}).values()]
        check(mem.get("supported") is True and hw and max(hw) > 0,
              f"[driver] flight recorder memwatch block {mem}")
        print(f"[driver] SIGTERM: subprocess (cut: batch_size_run "
              f"{cfg.batch_size_run} -> {SIGTERM_LANES}, buffer_size "
              f"{cfg.replay.buffer_size} -> {SIGTERM_RING}, episode_limit "
              f"{cfg.env_args.episode_limit} -> {SIGTERM_T}, superstep {k} -> "
              f"1, log_interval -> one dispatch) "
              f"SIGTERM'd after its first dispatch logged: exit 0 in "
              f"{sig_s:.2f} s, emergency checkpoint at t_env "
              f"{sig_found[1]} verified, resume hint logged, "
              f"flight_recorder.json with memwatch (peak "
              f"{max(hw, default=0) / 2 ** 30:.2f} GiB)", flush=True)
        print(f"[driver] PULSE_TRACE touched in the SIGTERM'd run after its "
              f"second log cadence: a one-iteration torch.profiler capture "
              f"landed in {os.path.relpath(trace, armed)} "
              f"({os.path.getsize(trace) / 1e6:.1f} MB) {trace_s:.1f} s "
              f"after the touch; the trigger file was "
              f"consumed", flush=True)
        result.update(sigterm_to_exit_s=sig_s, pulse_trace_s=trace_s)

        # ---- 4. evaluate: full state, then the model-only fallback ---
        ep_s = []
        original_run = EpisodeRunner.run

        def timed_run(self, *a, **k):
            t0 = time.perf_counter()
            out = original_run(self, *a, **k)
            torch.cuda.synchronize()
            ep_s.append(time.perf_counter() - t0)
            return out

        EpisodeRunner.run = timed_run
        evals = {}
        try:
            for tag, ckpt_dir, extra in (
                    ("full", sig_models, cut),
                    ("model-only", resumed_models,
                     [f"batch_size_run={SIGTERM_LANES}"])):
                out4 = os.path.join(tmp, "eval_" + tag)
                n_lines = len(logs.lines)
                rc = cli.main(["evaluate", *base, *extra,
                               f"checkpoint_path={ckpt_dir}",
                               f"test_nepisode={EVAL_EPISODES}",
                               "benchmark_mode=true",
                               f"local_results_path={out4}"])
                said = logs.lines[n_lines:]
                full = any("loaded full state" in x for x in said)
                only = any("loaded learner (model-only)" in x for x in said)
                check(rc == 0 and (full if tag == "full" else only),
                      f"[driver] evaluate {tag}: rc {rc}, log {said[-5:]}")
                rows4 = _metric_rows(out4)
                ret = [r["value"] for r in rows4
                       if r["key"] == "test_return_mean"]
                check(len(ret) == 1 and np.isfinite(ret[0]),
                      f"[driver] evaluate {tag}: test_return_mean {ret}")
                with open(_one_dir(os.path.join(out4, "*",
                                                "benchmark.csv"))) as f:
                    n_rows = len(f.read().strip().splitlines()) - 1
                check(n_rows == EVAL_EPISODES,
                      f"[driver] benchmark.csv has {n_rows} rows")
                evals[tag] = ret[0]
        finally:
            EpisodeRunner.run = original_run
        per_ep = statistics.median(ep_s)
        print(f"[driver] evaluate: {EVAL_EPISODES} greedy episodes each "
              f"({SIGTERM_LANES} lanes), full-state restore of the SIGTERM "
              f"checkpoint (test_return_mean {evals['full']:.4g}) and the "
              f"model-only fallback from the resumed run's "
              f"{cfg.batch_size_run}-lane checkpoint "
              f"(test_return_mean {evals['model-only']:.4g}); benchmark.csv"
              f" {EVAL_EPISODES} rows each; {per_ep * 1e3:.0f} ms an "
              f"episode (p50, B=1, T={cfg.env_args.episode_limit})",
              flush=True)
        result["eval_episode_ms"] = per_ep * 1e3
        if after is not None:
            t0 = time.perf_counter()
            result["after"] = after(resumed_models, first_agent)
            result["after_s"] = time.perf_counter() - t0
    finally:
        logs.close()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return result


ARTIFACT_VARIANTS = {
    # as shipped: the query slice folds the agent and launches no kernel
    "qslice": (),
    # the dense agent through K1 (once a block a dispatch)
    "pallas": ("model.use_qslice=false", "kernels.attention=pallas"),
}


def phase_artifact(torch, att, model_dir: str, then=None) -> dict:
    """[driver]'s config 3 checkpoint exported through ``python -m
    t2omca_tpu_torch.serve export`` (its ``main``) as shipped and with
    the dense agent on K1, each loaded with ``ServeFrontend.load`` on the
    card in f32 and bf16: export seconds, bytes a variant, load seconds,
    first-request and warm p50 at each request size, K1 launches a
    dispatch; the f32 actions equal an in-memory front end's built from
    the same checkpoint's agent leaves, and a tampered blob is refused.
    ``then(artifact_dirs)`` (``{tag: dir}``) runs before they are
    deleted; its result is ``result["then"]``."""
    import shutil
    import tempfile
    import numpy as np
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.serve import __main__ as serve_cli
    from t2omca_tpu_torch.serve.export import AGENT_PREFIX
    from t2omca_tpu_torch.serve.frontend import ServeFrontend
    from t2omca_tpu_torch.utils.checkpoint import (_read_tensors,
                                                   find_checkpoint)
    root = os.path.dirname(os.path.abspath(__file__))
    cfg3 = os.path.join(root, DRIVER_CONFIG)
    ckpt_dir, t_env = find_checkpoint(model_dir)
    rng = np.random.default_rng(SEED + 90)
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_artifact_", dir=root)
    result = {"launches": {name: 0 for name in att.LAUNCHES}}
    try:
        agent = _read_tensors(ckpt_dir, False, "cpu", mmap=True,
                              prefix=AGENT_PREFIX)
        for tag, over in ARTIFACT_VARIANTS.items():
            out = os.path.join(tmp, tag)
            t0 = time.perf_counter()
            rc = serve_cli.main(["export", model_dir, "--config", cfg3,
                                 "--out", out, *over])
            export_s = time.perf_counter() - t0
            check(rc == 0, f"[artifact] {tag}: export returned {rc}")
            with open(os.path.join(out, "meta.json")) as f:
                meta = json.load(f)
            cfg = load_config(cfg3, over)
            depth = cfg.model.depth
            check(meta["checkpoint"]["t_env"] == t_env
                  and (meta["n_agents"], meta["obs_dim"], meta["n_actions"],
                       meta["emb"]) == (64, 576, 9, 256)
                  and meta["folded"] == (tag == "qslice"),
                  f"[artifact] {tag}: meta {meta['checkpoint']} "
                  f"{meta['n_agents']}/{meta['emb']}/{meta['folded']}")
            sizes = {dt: p["bytes"] for dt, p in meta["params"].items()}
            a, od, na = meta["n_agents"], meta["obs_dim"], meta["n_actions"]
            buckets = meta["buckets"]
            per_dispatch = 0 if tag == "qslice" else depth
            for dt in ("float32", "bfloat16"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fe = ServeFrontend.load(out, dtype=dt)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                att.reset_launches()     # ---- the served path starts here
                dispatches, first, warm = 0, {}, {}
                for n in REQUEST_SIZES:
                    lat = []
                    for r in range(1 + REPEATS):
                        obs = rng.standard_normal((n, a, od)).astype(
                            np.float32)
                        avail = rng.random((n, a, na)) < 0.6
                        avail[..., 0] = True
                        t0 = time.perf_counter()
                        actions, hidden = fe.select(obs, avail)
                        lat.append((time.perf_counter() - t0) * 1e3)
                        dispatches += -(-n // buckets[-1])
                        check(bool(avail[np.arange(n)[:, None],
                                         np.arange(a)[None], actions].all())
                              and np.isfinite(hidden).all(),
                              f"[artifact] {tag} {dt} n={n}: illegal "
                              f"action or non-finite hidden")
                    first[n], warm[n] = lat[0], statistics.median(lat[1:])
                launches = dict(att.LAUNCHES)  # ---- and ends here
                for name, v in launches.items():
                    result["launches"][name] += v
                check(launches["flash_fwd"] == per_dispatch * dispatches
                      and sum(launches.values()) == launches["flash_fwd"],
                      f"[artifact] {tag} {dt}: launches {launches} for "
                      f"{dispatches} dispatches")
                print(f"[artifact] {tag} {dt}: export {export_s:.2f} s "
                      f"(both variants), params {sizes[dt] / 1e6:.3f} MB, "
                      f"load {load_s:.2f} s (meta, SHA-256, torch.load, "
                      f"one warm dispatch a bucket); first request / warm "
                      f"p50 ms: " + ", ".join(
                          f"n={n}: {first[n]:.2f}/{warm[n]:.2f}"
                          for n in REQUEST_SIZES)
                      + f"; flash_fwd {launches['flash_fwd']} over "
                      f"{dispatches} dispatches "
                      f"({launches['flash_fwd'] / dispatches:g} a dispatch)",
                      flush=True)
                result[(tag, dt)] = dict(export_s=export_s,
                                         bytes=sizes[dt], load_s=load_s,
                                         first_ms=first, warm_ms=warm)
                if dt == "float32":
                    mem = ServeFrontend(cfg, agent, buckets)
                    obs = rng.standard_normal((150, a, od)).astype(
                        np.float32)
                    avail = rng.random((150, a, na)) < 0.6
                    avail[..., 0] = True
                    a1, h1 = fe.select(obs, avail)
                    a2, h2 = mem.select(obs, avail)
                    check(np.array_equal(a1, a2) and np.array_equal(h1, h2),
                          f"[artifact] {tag}: loaded f32 front end differs "
                          f"from the in-memory one ({int((a1 != a2).sum())} "
                          f"actions, max|dh| {np.abs(h1 - h2).max():.3e})")
                    del mem
                del fe
            bad = os.path.join(out, meta["params"]["float32"]["file"])
            with open(bad, "r+b") as f:
                f.seek(os.path.getsize(bad) // 2)
                byte = f.read(1)
                f.seek(-1, 1)
                f.write(bytes([byte[0] ^ 1]))
            try:
                ServeFrontend.load(out, dtype="float32")
                refused = False
            except ValueError as e:
                refused = "integrity" in str(e)
            check(refused, f"[artifact] {tag}: a tampered blob loaded")
            # the intact blob back, for what runs after this phase
            with open(bad, "r+b") as f:
                f.seek(os.path.getsize(bad) // 2)
                f.write(byte)
        print(f"[artifact] checkpoint t_env {t_env}: f32 actions and "
              f"hiddens of each loaded front end equal an in-memory one "
              f"built from the checkpoint's agent leaves (150 rows); a "
              f"tampered blob is refused", flush=True)
        if then is not None:
            result["then"] = then({tag: os.path.join(tmp, tag)
                                   for tag in ARTIFACT_VARIANTS})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return result


#: the chaos leg of [fleet]: JAX's ``bench_serve_chaos`` schedule
#: (``bench.py``) over this many seconds of open-loop arrivals
CHAOS_SECONDS = 8.0


def _legal(avail, actions) -> bool:
    import numpy as np
    n, a = actions.shape
    return bool(avail[np.arange(n)[:, None], np.arange(a)[None],
                      actions].all())


def phase_fleet(torch, att, art: str, over, first_ckpt: str,
                profiled: bool) -> dict:
    """The serving fleet (``serve/fleet.py``) over [artifact]'s dense
    pallas artifact at the north-star widths: 2 engines, each on its own
    stream. Clean: requests of 1, 7, 64 and 150 rows and a 3-turn session
    through ``fleet.select``, f32 actions and hiddens equal to one front
    end's bit for bit, K1's launches exact across both engine threads
    (depth a dispatch), the per-size p50. Refresh: both engines rolled to
    [driver]'s first checkpoint (the artifact holds the resumed one's
    params), then equal to an in-memory front end of its agent leaves; the
    ``serve refresh`` CLI says compatible; a checkpoint of another width
    is refused while the fleet serves. Chaos: JAX's ``bench_serve_chaos``
    schedule (bursty Pareto traffic, engine 0 killed, a refresh to a
    checkpoint that does not exist, engine 1 hung): every request
    resolved, the refresh refused, both engines serving at the end, every
    ok result's actions legal, K1's launches exact over the window (a bf16
    rung served through bf16 K1 if it fired)."""
    import shutil
    import tempfile
    import numpy as np
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.serve.frontend import ServeFrontend
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, DRIVER_CONFIG), over)
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    rng = np.random.default_rng(SEED + 95)
    one = ServeFrontend.load(art)
    a, od, na = one.n_agents, one.obs_dim, one.n_actions
    check((a, cfg.model.emb, cfg.model.depth) == (64, 256, 2)
          and not cfg.model.use_qslice
          and cfg.kernels.attention == "pallas",
          "[fleet] the artifact is not the north-star dense pallas one")

    def request(n):
        obs = rng.standard_normal((n, a, od)).astype(np.float32)
        avail = rng.random((n, a, na)) < 0.6
        avail[..., 0] = True
        return obs, avail

    tmp = tempfile.mkdtemp(prefix=".chip_smoke_fleet_", dir=root)
    try:
        return _fleet_legs(torch, att, art, cfg, meta, one, request, tmp,
                           first_ckpt, profiled, t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def _fleet_legs(torch, att, art, cfg, meta, one, request, tmp, first_ckpt,
                profiled, t_phase) -> dict:
    """[fleet]'s three legs (``phase_fleet``)."""
    import contextlib
    import io
    import threading
    import numpy as np
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.serve import __main__ as serve_cli
    from t2omca_tpu_torch.serve.export import AGENT_PREFIX
    from t2omca_tpu_torch.serve.fleet import FleetConfig, ServeFleet
    from t2omca_tpu_torch.serve.frontend import ServeFrontend
    from t2omca_tpu_torch.utils import resilience
    from t2omca_tpu_torch.utils.checkpoint import (_read_tensors,
                                                   find_checkpoint,
                                                   save_checkpoint)
    rng = np.random.default_rng(SEED + 96)
    depth, bmax = cfg.model.depth, meta["buckets"][-1]
    # no hedging in the clean leg: a hedge dispatches a request twice,
    # and the launch count below is exact
    fleet = ServeFleet(art, n_engines=2, cfg=FleetConfig(
        poll_s=0.005, hedge_after_s=3600.0)).start()
    try:
        # ---- 1. clean ----------------------------------------------------
        check(fleet.serving_engines() == 2, f"[fleet] {fleet.stats()}")
        streams = [e.stream for e in fleet.engines]
        check(all(s is not None for s in streams)
              and streams[0] != streams[1]
              and all(s != torch.cuda.current_stream() for s in streams),
              "[fleet] the engines do not have streams of their own")
        reqs = [request(n) for n in REQUEST_SIZES for _ in range(1 + REPEATS)]
        want = [one.select(o, av) for o, av in reqs]
        # a 3-turn session: the hidden carried through one front end, and
        # below through the fleet
        sess = request(7)
        turns, h_1 = [], None
        for _ in range(3):
            a1, h_1 = one.select(*sess, h_1)
            turns.append((a1, h_1))
        att.reset_launches()             # ---- the fleet path starts here
        pending = [fleet.submit(o, av) for o, av in reqs]
        got = [r.wait(60.0) for r in pending]
        h_f = None
        for a1, h1 in turns:
            r = fleet.select(*sess, hidden=h_f)
            check(r.ok, f"[fleet] session turn: {r.status} {r.error}")
            check(np.array_equal(r.actions, a1)
                  and np.array_equal(r.hidden, h1),
                  "[fleet] a session turn differs from one front end")
            h_f = r.hidden
        launches = dict(att.LAUNCHES)    # ---- and ends here
        dispatches = sum(-(-o.shape[0] // bmax) for o, _ in reqs) \
            + 3 * -(-7 // bmax)
        for r, (aw, hw), (o, av) in zip(got, want, reqs):
            check(r.ok, f"[fleet] clean request: {r.status} {r.error}")
            check(np.array_equal(r.actions, aw)
                  and np.array_equal(r.hidden, hw),
                  f"[fleet] n={o.shape[0]}: the fleet's f32 actions or "
                  f"hiddens differ from one front end's")
            check(_legal(av, r.actions), "[fleet] illegal action")
        engines = {r.engine for r in got}
        check(engines == {0, 1}, f"[fleet] requests served by {engines}")
        check(launches == {"flash_fwd": depth * dispatches,
                           "flash_fwd_res": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0},
              f"[fleet] launches {launches} for {dispatches} dispatches "
              f"across both engine threads")
        p50 = {}
        for n in REQUEST_SIZES:
            lat = []
            for _ in range(REPEATS):
                r = fleet.select(*request(n))
                check(r.ok, f"[fleet] n={n}: {r.status} {r.error}")
                lat.append(r.latency_ms)
            p50[n] = statistics.median(lat)
        print(f"[fleet] clean: 2 engines on their own streams over the "
              f"{meta['n_agents']}-AGV dense pallas artifact; "
              f"{len(reqs)} concurrent requests (1, 7, 64, 150 rows) and a "
              f"3-turn session equal one front end bit for bit (f32 actions "
              f"and hiddens), served by engines {sorted(engines)}; "
              f"flash_fwd {launches['flash_fwd']} = {depth} x {dispatches} "
              f"dispatches across both threads; fleet.select p50 ms: "
              + ", ".join(f"n={n}: {v:.2f}" for n, v in p50.items()),
              flush=True)
        result = {"launches": launches, "p50_ms": p50}

        # ---- 2. refresh --------------------------------------------------
        first_dir, first_t = find_checkpoint(first_ckpt)
        check(first_t != meta["checkpoint"]["t_env"],
              "[fleet] the first checkpoint is the artifact's")
        obs, avail = request(150)
        before = fleet.select(obs, avail)
        t0 = time.perf_counter()
        out = fleet.refresh(first_ckpt)
        refresh_s = time.perf_counter() - t0
        check(out["status"] == "ok" and out["engines"] == 2,
              f"[fleet] refresh {out}")
        agent = _read_tensors(first_dir, False, "cpu", mmap=True,
                              prefix=AGENT_PREFIX)
        mem = ServeFrontend(cfg, agent, meta["buckets"])
        aw, hw = mem.select(obs, avail)
        after = [fleet.submit(obs, avail) for _ in range(4)]
        after = [r.wait(60.0) for r in after]
        check(all(r.ok and np.array_equal(r.actions, aw)
                  and np.array_equal(r.hidden, hw) for r in after),
              "[fleet] after the refresh the actions differ from an "
              "in-memory front end of the first checkpoint")
        changed = int((before.actions != aw).sum())
        check(changed > 0, "[fleet] the refresh changed no action")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve_cli.main(["refresh", art, first_ckpt])
        check(rc == 0 and "refresh compatible" in buf.getvalue(),
              f"[fleet] serve refresh: {rc} {buf.getvalue()!r}")
        small = from_dict({
            "batch_size_run": 2, "batch_size": 2,
            "env_args": {"agv_num": 4, "mec_num": 2, "num_channels": 2,
                         "episode_limit": 4},
            "model": {"emb": 16, "heads": 2, "depth": 2, "mixer_emb": 16,
                      "mixer_heads": 2, "mixer_depth": 1},
            "replay": {"buffer_size": 4}})
        wide = os.path.join(tmp, "wide")
        save_checkpoint(wide, 8, Experiment.build(small).init_state(0))
        bad = fleet.refresh(wide)
        check(bad["status"] == "refused", f"[fleet] other width: {bad}")
        r = fleet.select(obs, avail)
        check(r.ok and np.array_equal(r.actions, aw)
              and fleet.serving_engines() == 2,
              "[fleet] serving after the refused refresh")
        print(f"[fleet] refresh: both engines rolled to [driver]'s first "
              f"checkpoint (t_env {first_t}; the artifact's is "
              f"{meta['checkpoint']['t_env']}) in {refresh_s:.2f} s "
              f"({out['leaves_checked']} leaves checked), {changed} of "
              f"{aw.size} actions changed, all equal to an in-memory front "
              f"end of its agent leaves bit for bit; serve refresh: "
              f"compatible; a checkpoint of another width refused "
              f"({bad['reason'][:80]}...) while both engines served",
              flush=True)
        result["refresh_s"] = refresh_s
    finally:
        fleet.stop()
    del one, mem
    torch.cuda.empty_cache()

    # ---- 3. chaos: bench_serve_chaos's schedule ---------------------------
    duration, n_eng = CHAOS_SECONDS, 2
    fcfg = FleetConfig(queue_depth=32, deadline_s=max(2.0, duration / 2.5),
                       dispatch_timeout_s=max(0.75, min(2.0, duration / 6.0)),
                       restart_backoff_s=0.05, restart_backoff_max_s=0.5,
                       ladder_cooldown_s=0.25)
    counts = {"float32": 0, "bfloat16": 0}
    lock = threading.Lock()
    original = ServeFrontend._dispatch

    def counted(self, *args):
        out = original(self, *args)
        with lock:
            counts[self.dtype] += 1
        return out

    fleet = ServeFleet(art, n_engines=n_eng, cfg=fcfg).start()
    levels = []
    try:
        check(fleet.serving_engines() == 2, f"[fleet] chaos start "
                                            f"{fleet.stats()}")
        sizes = np.minimum(1 + rng.pareto(1.1, 4096).astype(np.int64),
                           2 * bmax)
        pool = {int(n): request(int(n)) for n in np.unique(sizes)}
        kill_at, refresh_at = 0.25 * duration, 0.40 * duration
        hang_at = 0.55 * duration
        hang_s = fcfg.dispatch_timeout_s + min(1.5, 0.2 * duration)
        killed, hung = [], []
        t_warm0 = time.perf_counter()
        check(fleet.select(*pool[min(pool)]).ok, "[fleet] chaos warm")
        warm_s = max(time.perf_counter() - t_warm0, 1e-4)
        base_rate = max(10.0, min(200.0, 1.5 * n_eng / warm_s))
        bursts = [(0.2 * duration, 0.3 * duration),
                  (0.5 * duration, 0.65 * duration),
                  (0.8 * duration, 0.9 * duration)]
        ServeFrontend._dispatch = counted
        att.reset_launches()             # ---- the chaos window starts here
        t0 = time.monotonic()

        def schedule(engine, attempt, rid, **kw):
            now = time.monotonic() - t0
            if engine == 0 and not killed and now >= kill_at:
                killed.append(now)
                raise RuntimeError("chaos: engine killed (injected)")
            if engine == 1 % n_eng and not hung and now >= hang_at:
                hung.append(now)
                time.sleep(hang_s)

        resilience.register_fault("fleet.dispatch", schedule)
        refresh_out = {}
        poison = threading.Timer(refresh_at, lambda: refresh_out.update(
            fleet.refresh(os.path.join(art, "_no_such_checkpoint"))))
        poison.daemon = True
        poison.start()
        sent = []
        t, i = 0.0, 0
        while t < duration:
            now = time.monotonic() - t0
            levels.append(fleet._ladder.level)
            if now < t:
                time.sleep(min(t - now, 0.05))
                continue
            n = int(sizes[i % len(sizes)])
            burst = any(lo <= t < hi for lo, hi in bursts)
            sent.append((fleet.submit(*pool[n]), n, burst))
            i += 1
            t += rng.exponential(1.0 / (base_rate * (5.0 if burst
                                                     else 1.0)))
        results = [r.wait(timeout=fcfg.deadline_s + 2.0) for r, _, _ in
                   sent]
        poison.join(timeout=30.0)
        # the hung engine's restart: both serving again, bounded wait
        end = time.monotonic() + 10.0
        while fleet.serving_engines() < n_eng and time.monotonic() < end:
            time.sleep(0.05)
        # quiesce before reading the counts: no dispatch in flight
        end = time.monotonic() + 10.0
        while any(e.current is not None for e in fleet.engines) \
                and time.monotonic() < end:
            time.sleep(0.01)
        torch.cuda.synchronize()
        launches = dict(att.LAUNCHES)    # ---- and ends here
        with lock:
            done = dict(counts)
        stats = fleet.stats()
    finally:
        ServeFrontend._dispatch = original
        resilience.clear_faults("fleet.dispatch")
        serving_end = fleet.serving_engines()
        fleet.stop()
    by = {}
    for r in results:
        by[r.status] = by.get(r.status, 0) + 1
    unresolved = sum(1 for r in results if r.status == "error"
                     and "unresolved" in (r.error or ""))
    ok_lat = sorted(r.latency_ms for r in results if r.ok)
    burst_lat = sorted(r.latency_ms for r, (_, _, b) in zip(results, sent)
                       if r.ok and b)
    check(unresolved == 0, f"[fleet] chaos: {unresolved} unresolved")
    check(bool(ok_lat), f"[fleet] chaos: no request served {by}")
    check(sum(by.values()) == len(sent), "[fleet] chaos: unaccounted")
    check(refresh_out.get("status") == "refused",
          f"[fleet] chaos: poisoned refresh {refresh_out}")
    check(serving_end == n_eng, f"[fleet] chaos: {serving_end} engines "
                                f"serving at the end: {stats['engines']}")
    check(killed and hung and stats.get("fleet_stalls_total", 0) >= 1
          and stats.get("fleet_restarts_total", 0) >= 2,
          f"[fleet] chaos: faults did not land: killed {killed}, hung "
          f"{hung}, {stats}")
    for r, (_, n, _) in zip(results, sent):
        if r.ok:
            check(_legal(pool[n][1], r.actions), "[fleet] chaos: illegal "
                                                  "action")
    bf16_rung = max(levels) == len(fleet._ladder.rungs) - 1
    check(launches["flash_fwd"] == depth * (done["float32"]
                                            + done["bfloat16"])
          and sum(launches.values()) == launches["flash_fwd"],
          f"[fleet] chaos launches {launches} for dispatches {done}")
    check(done["bfloat16"] > 0 if bf16_rung else True,
          f"[fleet] chaos: the bf16 rung fired but served no bf16 K1 "
          f"dispatch {done}")
    p50, p99 = np.percentile(ok_lat, [50, 99]) if ok_lat else (None, None)
    bp50, bp99 = (np.percentile(burst_lat, [50, 99]) if burst_lat
                  else (float("nan"), float("nan")))
    recov = stats["recoveries_s"]
    print(f"[fleet] chaos ({duration:.0f} s, JAX's bench_serve_chaos "
          f"schedule, {base_rate:.0f}/s base, 5x bursts): {len(sent)} "
          f"requests — {by.get('ok', 0)} ok, {by.get('shed', 0)} shed "
          f"(fraction {by.get('shed', 0) / max(len(sent), 1):.4f}), "
          f"{by.get('deadline', 0)} deadline, {by.get('error', 0)} error, "
          f"{unresolved} unresolved; latency p50 {p50:.2f} / p99 "
          f"{p99:.2f} ms, under burst p50 {bp50:.2f} / p99 {bp99:.2f} ms; "
          f"hedges {stats.get('fleet_hedges_total', 0)}, stalls "
          f"{stats.get('fleet_stalls_total', 0)}, restarts "
          f"{stats.get('fleet_restarts_total', 0)}, recoveries "
          f"{recov} s; kill at {killed[0]:.2f} s, hang at {hung[0]:.2f} s,"
          f" poisoned refresh {refresh_out.get('status')}; ladder peak "
          f"level {max(levels)}/{len(fleet._ladder.rungs) - 1} "
          f"({'the bf16 rung fired' if bf16_rung else 'no bf16 rung'}); "
          f"dispatches f32 {done['float32']} / bf16 {done['bfloat16']}, "
          f"flash_fwd {launches['flash_fwd']}; both engines serving at the "
          f"end; a profiler session ran earlier in this process: "
          f"{'yes' if profiled else 'no'} (TEARDOWN_CUPTI="
          f"{os.environ.get('TEARDOWN_CUPTI', 'unset')}) | {smi_line()}",
          flush=True)
    result.update(chaos={"requests": len(sent), **by,
                         "unresolved": unresolved, "p50_ms": p50,
                         "p99_ms": p99, "burst_p99_ms": bp99,
                         "recoveries_s": recov},
                  seconds=time.perf_counter() - t_phase)
    result["launches"] = {k: result["launches"][k] + launches[k]
                          for k in launches}
    return result


SCENARIO_CONFIG = "configs/config6_scenarios.yaml"
#: episode_limit 150 -> 50 (the smoke's limit); the CLI's two K = 4
#: dispatches must pass config 6's log_interval
SCENARIO_T = 50
SCENARIO_OVERRIDES = ("kernels.attention=pallas",
                      f"env_args.episode_limit={SCENARIO_T}")


def counted_plain_launches(att):
    """Wrap the kernels' plain versions so that a CPU run counts into
    ``att.LAUNCHES`` what the card would launch → restore function."""
    names = ("flash_attention_reference", "flash_attention_fwd_reference",
             "flash_attention_bwd_reference")
    keys = (("flash_fwd",), ("flash_fwd_res",),
            ("flash_bwd_dq", "flash_bwd_dkv"))
    saved = {n: getattr(att, n) for n in names}

    def counted(fn, ks):
        def wrapper(*a, **kw):
            for k in ks:
                att.LAUNCHES[k] += 1
            return fn(*a, **kw)
        return wrapper

    for n, ks in zip(names, keys):
        setattr(att, n, counted(saved[n], ks))
    return lambda: [setattr(att, n, f) for n, f in saved.items()]


def phase_scenarios(torch, att, smi: str) -> dict:
    """Config 6 as shipped (the four-family mixture, min_agents 4, the
    padding mask, K = 4, f32) with kernels.attention=pallas: the CPU
    path's launches a train iteration; the mixture draw on the card
    against the CPU's; K eager iterations against one fused dispatch, bit
    for bit, and a dispatch of replays with no host sync; then ``python
    -m t2omca_tpu_torch train`` cut in t_max to two dispatches, with its
    slice rows, launches and times."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.run import Experiment, LoopCursor, run_classic
    from t2omca_tpu_torch.train import superstep as superstep_mod
    from t2omca_tpu_torch.train.superstep import clone_state
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    root = os.path.dirname(os.path.abspath(__file__))
    cfg6 = os.path.join(root, SCENARIO_CONFIG)
    cfg = load_config(cfg6, SCENARIO_OVERRIDES)
    k, b, t = cfg.superstep, cfg.batch_size_run, cfg.env_args.episode_limit
    a = cfg.env_args.agv_num
    lo = cfg.env_args.scenario.min_agents
    check(k == 4 and cfg.model.dtype == "float32" and lo == 4 and a == 8,
          f"[scenarios] {SCENARIO_CONFIG} is not config 6 as shipped")
    # 1. the CPU path's launches a train iteration (the plain versions
    # counted): lanes, batch and ring cut, T and the model as shipped
    cut = load_config(cfg6, SCENARIO_OVERRIDES + (
        "batch_size_run=2", "batch_size=2", "replay.buffer_size=2"))
    cpu_exp = Experiment.build(cut, device="cpu")
    cpu_ts = cpu_exp.init_state(0)
    check(cpu_exp.learner._mask_padded, "[scenarios] padding mask off")
    restore = counted_plain_launches(att)
    try:
        cpu_ts, _, recs = run_classic(cpu_exp, cpu_ts, 1)
        att.reset_launches()
        run_classic(cpu_exp, cpu_ts, 1)
        want_step = dict(att.LAUNCHES)
    finally:
        restore()
    check(recs[0].info is not None and want_step["flash_fwd_res"] > 0,
          f"[scenarios] the CPU path trained nothing {want_step}")
    del cpu_exp, cpu_ts
    # 2. the mixture draw: the card against the CPU on the same keys
    exp = Experiment.build(cfg)
    dist = exp.runner.scenario
    keys = prng.split(prng.PRNGKey(SEED + 70, "cpu"), 4096)
    env_cpu = type(exp.env)(exp.env.cfg, device="cpu")
    d_cpu, d_gpu = dist.sample(keys, env_cpu), dist.sample(keys.cuda(),
                                                           exp.env)
    diff = [f.name for f in dataclasses.fields(d_cpu)
            if not torch.equal(getattr(d_gpu, f.name).cpu(),
                               getattr(d_cpu, f.name))]
    check(not diff, f"[scenarios] mixture draw CUDA != CPU: {diff}")
    n_act = d_cpu.n_active
    fams = np.bincount(d_cpu.family.numpy(), minlength=4)
    check(int(n_act.min()) == lo and int(n_act.max()) == a
          and bool((fams > 0).all()),
          f"[scenarios] draws: n_active {int(n_act.min())}..."
          f"{int(n_act.max())}, families {fams}")
    # padded agents act 0 only: one rollout on the card
    ts0 = exp.init_state(0)
    rs, batch, _ = exp.runner.run(ts0.learner.params["agent"], ts0.runner)
    n_lane = rs.env_params.n_active.cpu()
    pad = torch.arange(a)[None, :] >= n_lane[:, None]        # (B, A)
    acts = batch.actions.cpu()                                # (B, T, A)
    check(bool(pad.any()) and bool((acts.transpose(1, 2)[pad] == 0).all())
          and bool((batch.avail_actions.cpu()[..., 1:].transpose(1, 2)
                    [pad] == 0).all()),
          "[scenarios] a padded agent had or took a non-idle action")
    print(f"[scenarios] config 6 ({b} lanes, {a} AGVs, emb "
          f"{cfg.model.emb}, mixer {cfg.model.mixer_emb}/"
          f"{cfg.model.mixer_heads}/{cfg.model.mixer_depth}, T={t}, ring "
          f"{cfg.replay.buffer_size}, K={k}, f32, pallas): the CPU path "
          f"launches {want_step} a train iteration; the mixture draw of "
          f"{len(keys)} lanes equal on the card and the CPU (families "
          f"{fams.tolist()}, n_active {int(n_act.min())}..."
          f"{int(n_act.max())}); a rollout's {int(pad.sum())} padded "
          f"agents of {b * a} had and took action 0 only", flush=True)
    # 3. K eager iterations against one fused dispatch, from one state
    sup = exp.superstep_program(k)
    mirror = {"key": prng.PRNGKey(SEED + 71, "cuda"), "t_env": 0,
              "episode": 0, "filled": 0}
    ref = clone_state(ts0)
    att.reset_launches()
    t0 = time.perf_counter()
    ref, cursor, recs = run_classic(exp, ref, k, LoopCursor(
        key=mirror["key"]))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = dict(att.LAUNCHES)
    att.reset_launches()
    t0 = time.perf_counter()
    ts, stats, infos, gated = fused_dispatch(torch, sup, ts0, mirror)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fused = dict(att.LAUNCHES)
    check(set(sup.graphs) == {"rollout", "train"},
          f"[scenarios] graphs {sorted(sup.graphs)}")
    n_train = sum(gated)
    check(eager == fused == {n: n_train * v for n, v in want_step.items()}
          and sup.launches["train"] == want_step,
          f"[scenarios] launches eager {eager}, fused {fused}, a train "
          f"replay {sup.launches['train']}, the CPU's {want_step}")
    x, hx = flatten_state(ts)
    y, hy = flatten_state(ref)
    diff = [n for n in x if not torch.equal(x[n], y[n])]
    check(hx == hy and set(x) == set(y) and not diff,
          f"[scenarios] fused state differs from {k} eager iterations: "
          f"{diff[:5]}")
    check(torch.equal(cursor.key, mirror["key"]), "[scenarios] driver key")
    for i, rec in enumerate(recs):
        for f in dataclasses.fields(stats):
            got = getattr(stats, f.name)[i]
            check(torch.equal(got.cpu(), getattr(rec.stats, f.name)
                              .reshape(got.shape).cpu()),
                  f"[scenarios] stats {f.name} of iteration {i}")
        if rec.info is not None:
            bad = [n for n, v in rec.info.items()
                   if not torch.equal(infos[n][i], v)]
            check(not bad, f"[scenarios] info of iteration {i}: {bad}")
    del ref, recs
    sup.timing = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (ts2, _, infos, _), syncs = count_syncs(
        torch, lambda: fused_dispatch(torch, sup, ts, mirror))
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    iters = [(e0.elapsed_time(e1), e1.elapsed_time(e2))
             for e0, e1, e2 in sup.events]
    sup.timing = False
    check(not syncs, f"[scenarios] host syncs in a dispatch: {syncs}")
    check(bool(infos["all_finite"].all()), "[scenarios] non-finite step")
    print(f"[scenarios] {k} eager run_classic iterations and one fused "
          f"dispatch from one state, padding mask on: bit-identical "
          f"({len(x)} leaves, the driver key, stats, infos); launches "
          f"{fused} ({sup.launches['train']} a train replay = the CPU "
          f"path's, none a rollout replay); capture rollout "
          f"{sup.capture_s['rollout']:.2f} + instantiate "
          f"{sup.instantiate_s['rollout']:.2f} s, train "
          f"{sup.capture_s['train']:.2f} + {sup.instantiate_s['train']:.2f}"
          f" s; graph nodes {sup.nodes}; host: {k} eager iterations "
          f"{eager_s * 1e3:.0f} ms, the first fused dispatch "
          f"{first_s * 1e3:.0f} ms, a dispatch of replays {host_ms:.0f} ms"
          f" (no host sync); device time by iteration (rollout + train, "
          f"ms): " + ", ".join(f"{p:.1f} + {q:.1f}" for p, q in iters)
          + f" | {smi}", flush=True)
    capture = {s: (sup.capture_s[s], sup.instantiate_s[s])
               for s in ("rollout", "train")}
    sup.close()
    del sup, ts, ts2, exp, ts0, x, y
    gc.collect()
    torch.cuda.empty_cache()
    # 4. the driver: two K = 4 dispatches through the CLI
    per = k * b * t
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_scenarios_", dir=root)
    calls, unwrap = _timed_dispatches(torch, superstep_mod)
    try:
        att.reset_launches()             # ---- the driver path starts here
        t0 = time.time()
        try:
            rc = cli.main(["train", "--config", cfg6, *SCENARIO_OVERRIDES,
                           f"t_max={2 * per - 1}",
                           f"local_results_path={tmp}"])
        finally:
            unwrap()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(att.LAUNCHES)    # ---- and ends here
        check(rc == 0, f"[scenarios] train returned {rc}")
        check(len(calls) == 2, f"[scenarios] {len(calls)} dispatches")
        check(launches == {n: 2 * k * v for n, v in want_step.items()},
              f"[scenarios] driver launches {launches}")
        rows = _metric_rows(tmp)
        keys_seen = {r["key"] for r in rows}
        for prefix in ("", "test_"):
            fam_rows = {f for f in range(4)
                        if f"{prefix}slice{f}_n" in keys_seen
                        and f"{prefix}slice{f}_return_mean" in keys_seen}
            check(len(fam_rows) >= 3, f"[scenarios] {prefix}slice rows "
                                      f"for families {sorted(fam_rows)}")
        for r in rows:
            v = r["value"]
            check(all(np.isfinite(v if isinstance(v, list) else [v])),
                  f"[scenarios] non-finite {r}")
        spans = [sp for sp in _spans(tmp) if sp.get("event") == "span"
                 and sp.get("phase") == "dispatch.superstep"]
        disp_ms = [sp["wall_ms"] for sp in spans]
        cap = [c[2] for c in calls]
        inst = [c[3] for c in calls]
        newest = {}
        for r in rows:
            if r["key"].startswith(("slice", "test_slice")):
                newest[r["key"]] = r["value"]
        table = ", ".join(
            f"{f}: n {newest.get(f'slice{f}_n', 0):g} return "
            f"{newest.get(f'slice{f}_return_mean', float('nan')):.1f} / "
            f"test n {newest.get(f'test_slice{f}_n', 0):g} return "
            f"{newest.get(f'test_slice{f}_return_mean', float('nan')):.1f}"
            for f in range(4))
        test_ms = [r["value"] for r in rows if r["key"] == "time_test_ms"]
        print(f"[scenarios] driver: python -m t2omca_tpu_torch train "
              f"--config {SCENARIO_CONFIG} {' '.join(SCENARIO_OVERRIDES)} "
              f"t_max={2 * per - 1}: two K={k} dispatches to t_env "
              f"{2 * per}, launches {launches} (2 x {k} x the CPU path's), "
              f"{len(rows)} metric rows; slice rows by family (newest "
              f"cadence): {table}; dispatch host ms "
              f"{', '.join(f'{x:.0f}' for x in disp_ms)} (the first "
              f"captures: rollout {cap[0].get('rollout', 0):.2f} + "
              f"{inst[0].get('rollout', 0):.2f} s, train "
              f"{cap[0].get('train', 0):.2f} + {inst[0].get('train', 0):.2f}"
              f" s); test rollouts ms "
              f"{', '.join(f'{x:.0f}' for x in test_ms)}; whole call "
              f"{wall:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": launches, "want_step": want_step, "cfg": cfg,
            "capture_s": capture, "eager_s": eager_s, "first_s": first_s,
            "host_ms": host_ms, "iters_ms": iters,
            "driver_dispatch_ms": disp_ms, "driver_wall_s": wall}


#: [report]: config 6 through the CLI with per-program device time over
#: one dispatch of replays. T is cut from 150 to 20 (30 before PR 17): a
#: window's trace holds every kernel it saw (~1 M for one K = 4 dispatch
#: at T = 150, ~65 s to export and parse on the card), and the phase must
#: fit the script's time limit; the kernels, the graphs and K are config
#: 6's
REPORT_OVERRIDES = ("kernels.attention=pallas", "obs.enabled=true",
                    "obs.program_trace=true", "profile_iterations=1",
                    "env_args.episode_limit=20")


def phase_report(torch, smi: str) -> dict:
    """``python -m t2omca_tpu_torch train`` in a subprocess (a fresh
    process: no profiler session before its window) on config 6 with T
    cut to 20 (``REPORT_OVERRIDES``), ``obs.program_trace`` and a
    ``profile_dir`` window over the third of four K = 4 dispatches (the
    first captures the graphs, the second and the fourth replay them
    before and after the window): ``device_times.json`` holds
    ``superstep``, ``attn_pallas`` and ``attn_pallas_bwd``, each > 0, the
    kernel rows within the superstep's and it within the window's
    dispatch span; the kernel rows count K train replays' launches
    (``loop_launches``: the trace holds the replayed graphs' kernels);
    ``obs report`` and ``obs timeline`` (over the repo's BENCH records
    and this run) exit 0 with the program table and the family slices.
    Prints the host time of the dispatch before the window and of the
    one after it (with ``profile_dir`` the driver syncs each dispatch, so
    each is its device time plus the host's launch cost: CUPTI's cost is
    the difference)."""
    import shutil
    import tempfile
    from t2omca_tpu_torch.config import load_config
    root = os.path.dirname(os.path.abspath(__file__))
    cfg6 = os.path.join(root, SCENARIO_CONFIG)
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_report_", dir=root)
    try:
        over = REPORT_OVERRIDES + (f"profile_dir={os.path.join(tmp, 'tr')}",)
        cfg = load_config(cfg6, over)
        k = cfg.superstep
        per = k * cfg.batch_size_run * cfg.env_args.episode_limit
        res = os.path.join(tmp, "res")
        cmd = [sys.executable, "-m", "t2omca_tpu_torch", "train",
               "--config", cfg6, *over, f"profile_start={2 * per}",
               f"t_max={4 * per - 1}", f"local_results_path={res}"]
        t0 = time.perf_counter()
        env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=400, env=env)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"[report] train exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        run_dir = _one_dir(os.path.join(res, "qmix*"))
        said = proc.stdout + proc.stderr
        costs = [line.split("] ", 1)[-1] for line in said.splitlines()
                 if "stop and export" in line or "parsed in" in line]
        with open(os.path.join(run_dir, "device_times.json")) as f:
            dt = json.load(f)["programs"]
        spans = [e for e in _spans(res) if e.get("event") == "span"
                 and e.get("phase") == "dispatch.superstep"]
        check(len(spans) == 4, f"[report] {len(spans)} dispatch spans")
        disp_ms = [e["wall_ms"] for e in spans]
        sup = dt.get("superstep")
        check(sup is not None and sup["device_ms"] > 0
              and sup["events"] == 1, f"[report] superstep row {dt}")
        for row in ("attn_pallas", "attn_pallas_bwd"):
            check(dt.get(row, {}).get("device_ms", 0) > 0
                  and dt[row]["device_ms"] <= sup["device_ms"],
                  f"[report] {row} row {dt.get(row)} against the "
                  f"superstep's {sup}")
        check(sup["device_ms"] <= disp_ms[2],
              f"[report] superstep device {sup['device_ms']} ms above the "
              f"window's dispatch span {disp_ms[2]} ms")
        step = loop_launches(cfg)
        want = {"attn_pallas": k * (step["flash_fwd"]
                                    + step["flash_fwd_res"]),
                "attn_pallas_bwd": k * (step["flash_bwd_dq"]
                                        + step["flash_bwd_dkv"])}
        got = {row: dt.get(row, {}).get("events") for row in want}
        check(got == want, f"[report] kernel events {got}, a K={k} train "
                           f"replay's launches {want}")
        rep = subprocess.run([sys.executable, "-m", "t2omca_tpu_torch.obs",
                              "report", run_dir], cwd=root,
                             capture_output=True, text=True, timeout=120)
        check(rep.returncode == 0
              and "dispatch.superstep" in rep.stdout
              and "attn_pallas_bwd" in rep.stdout
              and "scenario slices (train" in rep.stdout
              and "scenario slices (test" in rep.stdout,
              f"[report] obs report: {rep.returncode} {rep.stdout[-1500:]}"
              f" {rep.stderr[-500:]}")
        tl = subprocess.run([sys.executable, "-m", "t2omca_tpu_torch.obs",
                             "timeline", *sorted(
                                 __import__("glob").glob(os.path.join(
                                     root, "BENCH_r*.json"))),
                             "--runs", run_dir], cwd=root,
                            capture_output=True, text=True, timeout=120)
        check(tl.returncode == 0 and os.path.basename(run_dir) in tl.stdout,
              f"[report] obs timeline: {tl.returncode} {tl.stderr[-500:]}")
        print(f"[report] python -m t2omca_tpu_torch train --config "
              f"{SCENARIO_CONFIG} {' '.join(REPORT_OVERRIDES)} in a "
              f"subprocess (T = {cfg.env_args.episode_limit}), a window "
              f"over dispatch 3 of 4: device_times "
              + ", ".join(f"{n} {v['device_ms']:.1f} ms / {v['events']} "
                          f"events" for n, v in sorted(dt.items()))
              + f" (the kernel rows' events = a K={k} train replay's "
              f"launches); obs report and obs timeline exit 0 with the "
              f"program table and the family slices; the dispatches' host "
              f"ms, each synced: {', '.join(f'{x:.0f}' for x in disp_ms)} "
              f"(1: the captures; 2: before the window {disp_ms[1]:.0f}; "
              f"4: after it {disp_ms[3]:.0f}, CUPTI attached); the "
              f"window: {'; '.join(costs)}; whole call {wall:.1f} s | {smi}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"device_times": dt, "dispatch_ms": disp_ms, "wall_s": wall}


POPULATION_CONFIG = "configs/config7_population.yaml"
POPULATION_OVERRIDES = ("kernels.attention=pallas",)
POPULATION_PORT = 9465
#: a config 6 train replay's launches (the mixer's alone, f32, D = 32),
#: which [scenarios] counts again from the CPU path
CONFIG6_STEP = {"flash_fwd": 302, "flash_fwd_res": 300, "flash_bwd_dq": 300,
                "flash_bwd_dkv": 300}
#: [population]'s variants cut T (and so their captures) to this: the
#: seed_stride=0 pair, the CLI run (since PR 16) and the PBT run
VARIANT_T = 20
#: [population]'s overlapped-against-serial dispatches: episode_limit 150
#: -> 50 in PR 16, -> 20 in PR 17 (the smoke's limit: a member's captures
#: scale with T)
POPULATION_T = 20


def pop_rows(torch, prog, mirror):
    """The population driver's host mirror for one dispatch of ``prog``
    (``mirror``: the P keys, t_env, episode, filled; advanced here) → (the
    (P, K, 2) keys, the gates, t_env0)."""
    from t2omca_tpu_torch import prng
    cfg = prog.exp.cfg
    rows, gated = [], []
    for _ in range(prog.k):
        mirror["episode"] += cfg.batch_size_run
        mirror["filled"] = min(mirror["filled"] + cfg.batch_size_run,
                               cfg.replay.buffer_size)
        g = (mirror["filled"] >= cfg.batch_size
             and mirror["episode"] >= cfg.accumulated_episodes)
        gated.append(g)
        row = []
        for m, key in enumerate(mirror["keys"]):
            if g:
                mirror["keys"][m], k_s = prng.split(key).unbind(0)
                row.append(k_s)
            else:
                row.append(torch.zeros_like(key))
        rows.append(torch.stack(row))
    t0 = mirror["t_env"]
    mirror["t_env"] += (prog.k * cfg.batch_size_run
                        * cfg.env_args.episode_limit)
    return torch.stack(rows, dim=1), gated, t0


def _pop_snapshot(torch, pts, stats, infos) -> dict:
    """Every tensor of the members' states, the stats and the infos, as
    clones keyed by path."""
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    out = {}
    for m, t in enumerate(pts):
        out.update({f"ts.{m}.{k}": v.clone()
                    for k, v in flatten_state(t)[0].items()})
    out.update({f"stats.{k}": v.clone()
                for k, v in flatten_state(stats)[0].items()})
    out.update({f"info.{k}": v.clone() for k, v in infos.items()})
    return out


def phase_population(torch, att, smi: str, want_step=None) -> dict:
    """Config 7 as shipped (4 members over config 6, the lr grid, per-member
    seeds, the scenario salt, K = 4, f32) with kernels.attention=pallas:
    one population dispatch of replays with the members on their own
    streams, bit for bit against the same members run one after another
    (each synced: P solo dispatches), with no host sync and exact
    launches; its times against the serial ones; a seed_stride=0 pair
    bit-identical to each other; then ``python -m t2omca_tpu_torch
    train`` cut in t_max to two dispatches (pop<i>_* rows, the
    sight-pop<i>-* checks on /healthz, the population checkpoint and a
    bit-exact resume from it, ``obs learning``'s member table) and a PBT
    variant that logs pbt_copies."""
    import atexit
    import contextlib
    import gc
    import io
    import shutil
    import tempfile
    import numpy as np
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch import population as pop
    from t2omca_tpu_torch.config import load_config, sanity_check
    from t2omca_tpu_torch.obs import pulse as pulse_mod
    from t2omca_tpu_torch.obs.sight import learning_main
    from t2omca_tpu_torch.run import Experiment, run
    from t2omca_tpu_torch.train.superstep import clone_state
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    from t2omca_tpu_torch.utils.logging import Logger
    root = os.path.dirname(os.path.abspath(__file__))
    cfg7 = os.path.join(root, POPULATION_CONFIG)
    shipped = load_config(cfg7, POPULATION_OVERRIDES)
    cfg = load_config(cfg7, POPULATION_OVERRIDES + (
        f"env_args.episode_limit={POPULATION_T}",))
    p, k = cfg.population.size, cfg.superstep
    b, t = cfg.batch_size_run, cfg.env_args.episode_limit
    check(p == 4 and k == 4 and cfg.model.dtype == "float32"
          and len(cfg.population.lr) == 4 and cfg.population.scenario_salt
          and not cfg.population.pbt.enabled,
          f"[population] {POPULATION_CONFIG} is not config 7 as shipped")
    check(loop_launches(shipped) == CONFIG6_STEP,
          f"[population] {POPULATION_CONFIG}'s train iteration launches "
          f"{loop_launches(shipped)}, not {CONFIG6_STEP}")
    want_step = want_step or loop_launches(cfg)
    # the sync debug mode's one-time prototype notice would read as a sync
    # where this phase is the process's first to count them
    count_syncs(torch, lambda: None)
    # 1. one dispatch that captures every member, then a dispatch of
    # replays with the members overlapped, against the same members one
    # after another, from one state
    exp = Experiment.build(cfg)
    pts, spec = pop.init_population(exp, cfg)
    prog = exp.population_superstep_program(k)
    mirror = {"keys": pop.member_keys(cfg, "cuda"), "t_env": 0,
              "episode": 0, "filled": 0}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the first dispatch captures every member (a process that ran no
    # fused stage yet warms them up eagerly first, and captures at the
    # next)
    for _ in range(2):
        keys, gated, t_env0 = pop_rows(torch, prog, mirror)
        pts, _, infos = prog(pts, keys, t_env0, gated, spec)
        if all(set(m.graphs) == {"rollout", "train"}
               for m in prog.members):
            break
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(all(set(m.graphs) == {"rollout", "train"}
              and m.launches["train"] == want_step for m in prog.members),
          f"[population] members captured "
          f"{[sorted(m.graphs) for m in prog.members]}, a train replay "
          f"launching {[m.launches.get('train') for m in prog.members]}")
    start = [clone_state(x) for x in pts]
    keys, gated, t_env0 = pop_rows(torch, prog, mirror)
    runs = {}
    for mode in ("overlap", "serial", "overlap2"):
        prog.adopt([clone_state(x) for x in start])
        prog.timing = mode == "overlap"
        torch.cuda.synchronize()
        att.reset_launches()
        t0 = time.perf_counter()
        call = lambda: prog(pts, keys, t_env0, gated, spec,  # noqa: E731
                            serial=mode.startswith("serial"))
        if mode == "overlap":
            (pts, stats, infos), syncs = count_syncs(torch, call)
            host_ms = (time.perf_counter() - t0) * 1e3
        else:
            pts, stats, infos = call()
        torch.cuda.synchronize()
        runs[mode] = {"s": time.perf_counter() - t0,
                      "launches": dict(att.LAUNCHES)}
        if mode == "overlap":
            iters = [[(e0.elapsed_time(e1), e1.elapsed_time(e2))
                      for e0, e1, e2 in m.events] for m in prog.members]
            check(not syncs, f"[population] host syncs in a dispatch: "
                             f"{syncs}")
        if mode in ("overlap", "serial"):
            runs[mode]["snap"] = _pop_snapshot(torch, pts, stats, infos)
    prog.timing = False
    want = {n: p * sum(gated) * v for n, v in want_step.items()}
    check(all(r["launches"] == want for r in runs.values()),
          f"[population] launches {[r['launches'] for r in runs.values()]}"
          f", want {want} (P x {sum(gated)} x a train replay)")
    a, c = runs["overlap"]["snap"], runs["serial"]["snap"]
    diff = [n for n in a if not torch.equal(a[n], c[n])]
    check(set(a) == set(c) and not diff,
          f"[population] overlapped members differ from serial: {diff[:5]}")
    check(bool(a["info.all_finite"].all()), "[population] non-finite step")
    lr = [round(x, 6) for x in spec.lr_scale.tolist()]
    overlap_s = min(runs["overlap"]["s"], runs["overlap2"]["s"])
    serial_s = runs["serial"]["s"]
    eps_ps, ser_ps = p * k / overlap_s, p * k / serial_s
    dev_ms = [sum(x + y for x, y in m) / len(m) for m in iters]
    cap = [(m.capture_s["rollout"] + m.capture_s["train"],
            m.instantiate_s["rollout"] + m.instantiate_s["train"])
           for m in prog.members]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    print(f"[population] config 7 (P={p}, lr_scale {lr}, {b} lanes, T={t}, "
          f"K={k}, f32, pallas): the first dispatch (captures) "
          f"{first_s * 1e3:.0f} ms; a dispatch of replays with the members "
          f"overlapped bit-identical to the members run one after another "
          f"({len(a)} tensors: params, Adam, rings, priorities, runners, "
          f"stats, infos), no host sync, launches {runs['overlap']['launches']}"
          f"; host {host_ms:.0f} ms, to the device's end "
          f"{runs['overlap']['s'] * 1e3:.0f} / "
          f"{runs['overlap2']['s'] * 1e3:.0f} ms against serial "
          f"{runs['serial']['s'] * 1e3:.0f} ms: experiments_per_sec "
          f"{eps_ps:.3f}, serialized_experiments_per_sec {ser_ps:.3f}, "
          f"population_speedup {eps_ps / ser_ps:.3f}; device ms a member "
          f"iteration (overlapped) "
          + ", ".join(f"{x:.0f}" for x in dev_ms)
          + "; by iteration (rollout + train) of member 0: "
          + ", ".join(f"{x:.1f} + {y:.1f}" for x, y in iters[0])
          + "; capture + instantiate s a member: "
          + ", ".join(f"{x:.2f} + {y:.2f}" for x, y in cap)
          + f"; peak {peak:.2f} GiB allocated, {reserved:.2f} GiB reserved"
          f" | {smi}", flush=True)
    result = {"first_s": first_s, "host_ms": host_ms,
              "overlap_s": [runs["overlap"]["s"], runs["overlap2"]["s"]],
              "serial_s": [runs["serial"]["s"]],
              "experiments_per_sec": eps_ps,
              "serialized_experiments_per_sec": ser_ps,
              "population_speedup": eps_ps / ser_ps,
              "member_iteration_ms": dev_ms, "iters_ms": iters,
              "capture_s": cap, "peak_gib": peak, "reserved_gib": reserved}
    prog.close()
    del prog, pts, start, runs, a, c, stats, infos, exp
    gc.collect()
    torch.cuda.empty_cache()
    # 2. seed_stride=0 without a grid or salt: two identical members
    pc = dataclasses.replace(cfg.population, size=2, seed_stride=0, lr=(),
                             scenario_salt=False)
    cfg0 = sanity_check(cfg.replace(population=pc, env_args=dataclasses
                                    .replace(cfg.env_args,
                                             episode_limit=VARIANT_T)))
    exp0 = Experiment.build(cfg0)
    pts0, spec0 = pop.init_population(exp0, cfg0)
    prog0 = exp0.population_superstep_program(k)
    mirror = {"keys": pop.member_keys(cfg0, "cuda"), "t_env": 0,
              "episode": 0, "filled": 0}
    for _ in range(2):
        keys, gated, t_env0 = pop_rows(torch, prog0, mirror)
        pts0, stats0, infos0 = prog0(pts0, keys, t_env0, gated, spec0)
    torch.cuda.synchronize()
    one = _pop_snapshot(torch, pts0[:1], stats0, infos0)
    two = _pop_snapshot(torch, pts0[1:], stats0, infos0)
    same = [n for n in one if n.startswith("ts.")
            and not torch.equal(one[n], two[n])]
    same += [n for n, v in list(ckpt.flatten_state(stats0)[0].items())
             + list(infos0.items()) if not torch.equal(v[0], v[1])]
    check(not same, f"[population] seed_stride=0 members differ: {same[:5]}")
    print(f"[population] seed_stride=0, no grid, no salt (P=2, T="
          f"{VARIANT_T}, two K={k} dispatches): the members bit-identical "
          f"({len(one)} tensors each)", flush=True)
    prog0.close()
    del prog0, pts0, exp0, one, two
    gc.collect()
    torch.cuda.empty_cache()
    # 3. the CLI: config 7 cut in t_max to two dispatches (one save), its
    # test cadence to the first and its T to VARIANT_T
    per = k * b * VARIANT_T
    cut_t = f"env_args.episode_limit={VARIANT_T}"
    step_cli = loop_launches(load_config(cfg7, POPULATION_OVERRIDES
                                         + (cut_t,)))
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_population_", dir=root)
    scraper = _Scraper(POPULATION_PORT)
    close = pulse_mod.PulseHandle.close

    def read_then_close(handle):
        scraper.scrape()
        close(handle)

    try:
        out1 = os.path.join(tmp, "train")
        pulse_mod.PulseHandle.close = read_then_close
        att.reset_launches()             # ---- the driver path starts here
        t0 = time.time()
        try:
            with scraper:
                rc = cli.main(["train", "--config", cfg7,
                               *POPULATION_OVERRIDES, cut_t,
                               f"log_interval={per}",
                               f"runner_log_interval={per}",
                               f"t_max={2 * per - 1}",
                               f"test_interval={2 * per}",
                               f"save_model_interval={per}",
                               "profile_stages=true",
                               f"obs.pulse_port={POPULATION_PORT}",
                               f"local_results_path={out1}"])
        finally:
            pulse_mod.PulseHandle.close = close
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(att.LAUNCHES)    # ---- and ends here
        check(rc == 0, f"[population] train returned {rc}")
        check(launches == {n: 2 * p * k * v for n, v in step_cli.items()},
              f"[population] driver launches {launches}")
        rows = _metric_rows(out1)
        keys_seen = {r["key"] for r in rows}
        for m in range(p):
            need = {f"pop{m}_{x}" for x in (
                "return_mean", "task_completion_rate_mean", "loss",
                "grad_norm", "sight_per_ess")} | {f"test_pop{m}_return_mean"}
            check(need <= keys_seen, f"[population] member {m} lacks "
                                     f"{sorted(need - keys_seen)}")
        for r in rows:
            v = r["value"]
            check(all(np.isfinite(v if isinstance(v, list) else [v])),
                  f"[population] non-finite {r}")
        check(scraper.health, "[population] /healthz never answered")
        code, health = scraper.health[-1]
        sight_checks = sorted(n for n in health["checks"]
                              if n.startswith("sight-"))
        check(len(sight_checks) == 5 * p and all(
            n.startswith(tuple(f"sight-pop{m}-" for m in range(p)))
            for n in sight_checks),
            f"[population] /healthz sight checks {sight_checks}")
        models = _one_dir(os.path.join(out1, "models", "*"))
        saved = ckpt.find_checkpoint(models)
        check(saved is not None, "[population] no checkpoint")
        meta = ckpt.read_meta(saved[0])
        check(meta["topology"]["population"] == p
              and len(meta["driver"]["keys"]) == p,
              f"[population] checkpoint stamp {meta['topology']}")
        # the resume: run() from the checkpoint with t_max below its step
        # restores and returns the state (no dispatch), every tensor
        # equal to the file's and the spec the grid
        flat = torch.load(os.path.join(saved[0], ckpt.STATE_FILE),
                          weights_only=True)
        t1 = time.time()
        ps = run(load_config(cfg7, POPULATION_OVERRIDES + (
            cut_t, f"t_max={saved[1] - 1}", f"checkpoint_path={models}",
            f"local_results_path={os.path.join(tmp, 'resume')}")),
            Logger())
        resume_s = time.time() - t1
        got = ckpt.flatten_state(ps)[0]
        bad = [n for n in flat if not torch.equal(got[n].cpu(), flat[n])]
        check(set(got) == set(flat) and not bad
              and all(x.runner.t_env == saved[1] for x in ps.ts)
              and torch.equal(ps.spec.lr_scale, spec.lr_scale),
              f"[population] resume differs from the checkpoint: {bad[:5]}")
        del ps, got, flat
        # the one-process checkpoints (after each dispatch) that
        # [pop-dp], [pop-sebulba] and [pop-reshape] are held against
        # (removed at exit)
        keep = tempfile.mkdtemp(prefix=".chip_smoke_pop_ckpt_", dir=root)
        atexit.register(shutil.rmtree, keep, True)
        for at in (per, 2 * per):
            shutil.copytree(os.path.join(models, str(at)),
                            os.path.join(keep, str(at)))
        result.update(cli_checkpoints={at: os.path.join(keep, str(at))
                                       for at in (per, 2 * per)},
                      cli_per=per, cli_superstep_ms=[
                          r["value"] for r in rows
                          if r["key"] == "time_superstep_ms"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_l = learning_main(_one_dir(os.path.join(out1, "qmix*")))
        table = buf.getvalue()
        check(rc_l == 0 and f"population members ({p}" in table
              and all(f"pop{m}" in table for m in range(p)),
              "[population] obs learning rendered no member table")
        spans = [sp for sp in _spans(out1) if sp.get("event") == "span"
                 and sp.get("phase") == "dispatch.superstep"]
        disp_ms = [sp["wall_ms"] for sp in spans]
        test_ms = [r["value"] for r in rows if r["key"] == "time_test_ms"]
        newest = {}
        for r in rows:
            newest[r["key"]] = r["value"]
        print(f"[population] driver: python -m t2omca_tpu_torch train "
              f"--config {POPULATION_CONFIG} "
              f"{' '.join(POPULATION_OVERRIDES)} {cut_t} log_interval={per} "
              f"runner_log_interval={per} t_max={2 * per - 1} "
              f"test_interval={2 * per} save_model_interval={per} "
              f"profile_stages=true: two "
              f"dispatches to t_env {2 * per}, launches {launches} (2 x "
              f"{p} x {k} x a train replay), {len(rows)} metric rows, "
              f"return by member "
              + ", ".join(f"{newest[f'pop{m}_return_mean']:.1f}"
                          for m in range(p))
              + f"; /healthz {code} {health['status']} with "
              f"{len(sight_checks)} sight-pop<i>-* checks; the newest "
              f"checkpoint at "
              f"{saved[1]} ({meta['bytes'] / 1e6:.1f} MB, population "
              f"{p}) resumed bit-exact in {resume_s:.1f} s; obs learning's "
              f"member table rendered; dispatch host ms "
              f"{', '.join(f'{x:.0f}' for x in disp_ms)}; test cadences ms "
              f"{', '.join(f'{x:.0f}' for x in test_ms)}; whole call "
              f"{wall:.1f} s", flush=True)
        # 4. PBT through the CLI: one dispatch (T cut), a flush and then
        # a save at its end
        per_v = k * b * VARIANT_T
        out2 = os.path.join(tmp, "pbt")
        rc = cli.main(["train", "--config", cfg7, *POPULATION_OVERRIDES,
                       "population.pbt.enabled=true",
                       f"env_args.episode_limit={VARIANT_T}",
                       f"t_max={per_v - 1}", f"runner_log_interval={per_v}",
                       f"save_model_interval={per_v}",
                       f"local_results_path={out2}"])
        check(rc == 0, f"[population] the PBT run returned {rc}")
        pbt = [r for r in _metric_rows(out2) if r["key"] == "pbt_copies"]
        check(len(pbt) == 1 and pbt[0]["value"] == 1,
              f"[population] pbt_copies rows {pbt}")
        print(f"[population] PBT (population.pbt.enabled=true, T="
              f"{VARIANT_T}, one dispatch, runner_log_interval = "
              f"save_model_interval = {per_v}): pbt_copies "
              f"{pbt[0]['value']:g} at t_env {pbt[0]['t']}", flush=True)
        result.update({"launches": launches, "driver_dispatch_ms": disp_ms,
                       "driver_test_ms": test_ms, "driver_wall_s": wall,
                       "resume_s": resume_s})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return result


# ======================================================================= [dp]

DP_CONFIG = "configs/config5_dp8.yaml"
DP_RANKS = 2
DP_LANES = 256                      # batch_size_run 8192 -> 256
DP_RING = 512                       # replay.buffer_size 16384 -> 512
DP_BATCH = 8                        # batch_size 32 -> 8: 4 episodes a rank,
#                                     config 5's own 32 / 8 devices
DP_T = 30                           # episode_limit 150 -> 50 (PR 15), -> 30
#                                     (PR 17): the smoke's limit (PERF.md §4)
DP_OVERRIDES = (f"batch_size_run={DP_LANES}", f"replay.buffer_size={DP_RING}",
                f"batch_size={DP_BATCH}", f"env_args.episode_limit={DP_T}",
                "kernels.attention=pallas")
#: the learner's attention at config 5's widths for a rank's 4 episodes
#: (B, H, Tq, Tk, D): the agent query slice (4 x 256 agents, 1 row x 4
#: heads, 257 tokens; launched only with dense replay, the default
#: stack's agent unrolls through the entity tables) and the mixer query
#: slice (259 rows x 4 heads against 256 entities + 256 agents + 3 hyper
#: tokens), emb 256; the mixer's k is v
AGENT5_SHAPE = (1024, 1, 4, 257, 256)
MIXER5_SHAPE = (4, 1, 1036, 515, 256)
#: JAX's own DP gate on the loss (tests/test_parallel.py)
DP_LOSS_RTOL = 2e-4
#: the ranks' gradient norm, Adam's first moment and priorities against
#: their step computed in one process (``_blocked_step_probe``): the same
#: rows through the same kernels, the gradients summed in rank order.
#: What is left is the reduction order of sums on the card (the ranks
#: reduce views into one flat all-reduced buffer, the probe separate
#: tensors): ~1e-7 in the norm, the same in every run
DP_STEP_RTOL = 1e-5


def dp_cfg(ranks: int, *extra):
    from t2omca_tpu_torch.config import load_config
    root = os.path.dirname(os.path.abspath(__file__))
    return load_config(os.path.join(root, DP_CONFIG),
                       DP_OVERRIDES + (f"dp_devices={ranks}",) + extra)


def _join_alone(port: int):
    """Join a process group of one rank (the launcher's variables, set
    for this call and cleared after, so that no later subprocess inherits
    them) → (backend, device)."""
    from t2omca_tpu_torch.parallel import distributed as dd
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    os.environ.update(env)
    try:
        dd.maybe_initialize_distributed(timeout_s=300)
    finally:
        for k in env:
            os.environ.pop(k, None)
    return dd.backend(), dd.rank_device()


def _slot_sums(torch, storage) -> dict:
    """A checksum of every ring slot of every storage leaf (the bits,
    position-weighted, summed in int64) → {leaf: (C,) int64 CPU};
    ``storage`` is the global ring's ``EpisodeBatch`` or its leaves by
    dotted path."""
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    tensors = (storage if isinstance(storage, dict)
               else flatten_state(storage)[0])
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int32: torch.int32}
    out = {}
    for name, x in sorted(tensors.items()):
        bits = (x.view(ints[x.dtype]) if x.dtype in ints
                else x.to(torch.uint8)).reshape(x.shape[0], -1).long()
        w = torch.arange(bits.shape[1], device=bits.device) % 1009 + 1
        out[name] = (bits * w).sum(dim=1).cpu()
    return out


class _MaskSum:
    """The one collective of the learner's loss under dp, the mask's sum
    over the ranks, for a block of rows played in one process: it gives
    the global batch's sum and records what the block passed in."""

    def __init__(self, total):
        self.total, self.seen = total, []

    def sum(self, t):
        self.seen.append(t.clone())
        return self.total.clone()


def _blocked_step_probe(torch, blocks: int, keep_blocks: bool = False):
    """Wrap ``QMixLearner.train`` and the ring's ``update_priorities`` for
    their next call. Besides the whole-batch step that the run takes, it
    computes here, without the learner's dp code, the step that
    ``blocks`` ranks should take: each block of rows (rank r's: the
    sampled batch's r-th block) through the loss over the global mask
    sum, its gradients by autograd, the blocks' gradients summed in rank
    order, then the global norm, clip and Adam, and the blocks' TD
    errors. The blocks' mask sums are checked to be what the loss hands
    to the collective, so the ranks' loss, summed as the learner sums it,
    holds their all-reduced denominator. → (dict filled at the call, on
    the CPU: ``loss``, ``grad_norm``, ``all_finite``, ``learner`` (the
    new params and optimizer state by dotted path), ``pa`` (the sampled
    episodes' priorities ``(|TD| + 1e-6)^alpha``), ``idx``, with
    ``keep_blocks`` ``block_grads``, each block's gradients flattened in
    the learner's leaf order; restore function).
    The bf16 learner rounds f32 products to bf16 at every layer, and a
    product's f32 bits depend on how many rows one call holds, so the
    ranks' step differs from the whole-batch one by the batch-size
    variance; from this one only by the card's run-to-run arithmetic.
    The probe's kernel launches are taken back out of the counts."""
    from t2omca_tpu_torch.components.episode_buffer import \
        PrioritizedReplayBuffer
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.learners import qmix_learner as ql
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    train0 = ql.QMixLearner.train
    update0 = PrioritizedReplayBuffer.update_priorities
    seen = {}

    def step(self, ls, batch, weights):
        weights = weights.to(self.device).float()
        n = weights.shape[0] // blocks
        parts = [(batch.map(lambda x, i=i: x[i * n:(i + 1) * n]),
                  weights[i * n:(i + 1) * n]) for i in range(blocks)]
        total = batch.filled.float().sum()
        params = ql._tree_map(lambda p: p.detach().requires_grad_(),
                              ls.params)
        leaves = [p for sub in params.values() for p in sub.values()]
        grads, tds, loss_sum = None, [], None
        for part, w in parts:
            mask = _MaskSum(total)
            loss, info = dataclasses.replace(self, comm=mask)._loss(
                params, ls.target_params, part, w)
            check(len(mask.seen) == 1 and float(mask.seen[0])
                  == float(part.filled.float().sum()),
                  f"[dp] the loss's mask sums {mask.seen}")
            g = [ql._or_zeros(x, p) for x, p in zip(
                torch.autograd.grad(loss, leaves, allow_unused=True),
                leaves)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            if keep_blocks:
                seen.setdefault("block_grads", []).append(
                    torch.cat([x.reshape(-1) for x in g]).cpu())
            tds.append(info["td_errors_abs"])
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        it = iter(grads)
        grads = ql._tree_map(lambda p: next(it), params)
        norm = ql.global_norm(grads)
        clipped = ql.clip_by_global_norm(grads, norm,
                                         self.cfg.grad_norm_clip)
        updates, opt_state = ql.optimizer_update(self.cfg, clipped,
                                                 ls.opt_state)
        new = ql._tree_map(lambda p, u: p.detach() + u, params, updates)
        flat = flatten_state({"params": new, "opt_state": opt_state})[0]
        seen.update(loss=float(loss_sum), grad_norm=float(norm),
                    all_finite=bool(torch.isfinite(norm)),
                    learner={k: v.detach().cpu() for k, v in flat.items()},
                    td=torch.cat(tds))

    def train(self, ls, batch, weights, *a, **kw):
        if "learner" not in seen:
            counts = dict(att.LAUNCHES)
            step(self, ls, batch, weights)
            att.LAUNCHES.update(counts)
        return train0(self, ls, batch, weights, *a, **kw)

    def update_priorities(self, state, idx, *a, **kw):
        if "idx" not in seen:
            seen.update(idx=idx.cpu().clone(),
                        pa=((seen["td"] + 1e-6) ** self.alpha).cpu())
        return update0(self, state, idx, *a, **kw)

    def restore():
        ql.QMixLearner.train = train0
        PrioritizedReplayBuffer.update_priorities = update0

    ql.QMixLearner.train = train
    PrioritizedReplayBuffer.update_priorities = update_priorities
    return seen, restore


def dp_reference(torch, att, port: int) -> dict:
    """The DP code at world 1 over NCCL, in this process: one classic
    iteration of config 5's cut with its exact launches, its params,
    priorities and ring checksums, the peak; and, from the same sampled
    batch, the step that ``DP_RANKS`` ranks take (``_blocked_step_probe``)."""
    from t2omca_tpu_torch.parallel import distributed as dd
    from t2omca_tpu_torch.parallel.mesh import DataParallel, RankComm
    from t2omca_tpu_torch.run import Experiment, run_classic
    backend, dev = _join_alone(port)
    try:
        torch.cuda.reset_peak_memory_stats()
        cfg = dp_cfg(1)
        want = loop_launches(cfg)
        dp = DataParallel(Experiment.build(cfg, dev, comm=RankComm()))
        ts = dp.exp.init_state(SEED)            # born sharded
        probe, restore = _blocked_step_probe(torch, DP_RANKS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        att.reset_launches()        # ---- the dp path starts here
        try:
            ts, _, (rec,) = run_classic(dp.exp, ts, 1, sync=True)
        finally:
            restore()
        launches = dict(att.LAUNCHES)   # ---- and ends here
        wall = time.perf_counter() - t0
        check(launches == want, f"[dp] world 1: launches {launches} != "
                                f"{want}")
        check(rec.info is not None and bool(rec.info["all_finite"]),
              "[dp] world 1 did not train")
        check(probe["all_finite"],
              "[dp] the ranks' step computed at world 1 is not finite")
        leaves = _storage_leaves(ts)
        return {"backend": backend, "wall_ms": wall * 1e3,
                "rollout_ms": rec.rollout_s * 1e3,
                "train_ms": rec.train_s * 1e3,
                "loss": float(rec.info["loss"]),
                "grad_norm": float(rec.info["grad_norm"]),
                "blocked": probe, "launches": launches,
                "slots": _slot_sums(torch, ts.buffer.storage),
                "priorities": ts.buffer.priorities.cpu().clone(),
                "learner": {"learner." + k: v.detach().cpu() for k, v in
                            _flat(ts.learner).items()},
                "batch_bytes": (sum(x.numel() * x.element_size()
                                    for x in leaves)
                                // dp.exp.buffer.local_capacity * DP_BATCH),
                "n_params": sum(v.numel() for p in ts.learner.params.values()
                                for v in p.values()),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    finally:
        dd.shutdown()


def _flat(tree):
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    return flatten_state(tree)[0]


def _time_allreduce(torch, dev, n_params: int, batch_bytes: int) -> dict:
    """Median ms of the default group's all-reduce sum of a step's two
    payloads: the flat f32 gradient and the sampled batch's bytes. Every
    rank calls it at the same point."""
    import torch.distributed as dist
    out = {}
    for name, x in (("grad", torch.zeros(n_params, device=dev)),
                    ("batch", torch.zeros(batch_bytes, dtype=torch.uint8,
                                          device=dev))):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times[1:])
    return out


def _storage_leaves(ts):
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    return list(flatten_state(ts.buffer.storage)[0].values())


def dp_cli_rank_main(argv) -> int:
    """``python -m chip_smoke --dp-cli-rank OUT <the CLI's arguments>``:
    one rank of ``[dp]``'s CLI run, started with the launcher's variables
    (``_start_ranks``, as ``torchrun`` starts a rank) while the reference
    runs; once ``OUT/go`` exists it runs the port's CLI
    (``t2omca_tpu_torch.__main__.main``) and writes to
    ``OUT/rank<r>.json`` the kernel launches and the peak of the whole
    run, and what a ``driver.iteration`` hook measured at the top of the
    second dispatch, where every rank is at once: a digest of the
    replicated state (after the first train step) and the all-reduce
    times of a step's payloads over the run's backend."""
    import hashlib
    import torch
    import torch.distributed as dist
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.kernels import build
    from t2omca_tpu_torch.parallel import distributed as dd
    from t2omca_tpu_torch.parallel.mesh import DataParallel
    from t2omca_tpu_torch.utils import resilience
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    build.build()
    build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, cli_argv = argv[0], argv[1:]
    rank = int(os.environ["RANK"])
    # started while the reference runs: the CLI waits for OUT/go
    end = time.monotonic() + 900
    while not os.path.exists(os.path.join(out, "go")):
        if time.monotonic() > end:
            return 1
        time.sleep(0.05)
    seen = {}

    def at_second_dispatch(t_env, state, **_):
        if t_env == 0 or seen:
            return
        tensors, _ = flatten_state(state)
        h = hashlib.sha256()
        for path in sorted(tensors):
            x = tensors[path]
            if not DataParallel.sharded(path, x):
                h.update(x.detach().cpu().contiguous().reshape(-1)
                         .view(torch.uint8).numpy().tobytes())
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, h.hexdigest(),
                               group=dd.control_group())
        leaves = list(flatten_state(state.buffer.storage)[0].values())
        local = leaves[0].shape[0]
        batch_bytes = (sum(x.numel() * x.element_size() for x in leaves)
                       // local * DP_BATCH)
        n_params = sum(v.numel() for p in state.learner.params.values()
                       for v in p.values())
        seen.update(digests=digests, backend=dd.backend(),
                    device=str(dd.rank_device()),
                    allreduce_ms=_time_allreduce(
                        torch, dd.rank_device(), n_params, batch_bytes))

    resilience.register_fault("driver.iteration", at_second_dispatch)
    att.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(cli_argv)
    seen.update(rank=rank, launches=dict(att.LAUNCHES),
                wall_s=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    spec = os.path.join(out, "shard.json")
    if rc == 0 and os.path.exists(spec):
        with open(spec) as f:
            seen["shard"] = _dp_shard_rank(json.load(f), rank)
        rc = seen["shard"]["rc"]
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(seen, f)
    return rc


def _dp_shard_rank(spec: dict, rank: int) -> dict:
    """``[dp]``'s shard leg, in a rank of its CLI run after that run: the
    CLI again on its own ``MASTER_PORT``, resumed from the first run's
    checkpoint (``spec["resume"]``: its results directory); rank 1 gets a
    SIGTERM at the top of the first dispatch and every rank's preemption
    barrier fails (a peer taken for dead), so each rank writes its own
    shard of the resumed state → the exit code, the seconds and the
    shard's bytes."""
    import glob
    import signal
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    from t2omca_tpu_torch.utils import resilience
    resilience.clear_faults()

    def dead_peer(**_):
        raise RuntimeError("the preemption barrier fails: a peer is taken "
                           "for dead")
    resilience.register_fault("preempt.barrier", dead_peer)
    if rank == 1:
        def sigterm(t_env, **_):
            signal.raise_signal(signal.SIGTERM)
        resilience.register_fault("driver.iteration", sigterm)
    (models,) = glob.glob(os.path.join(spec["resume"], "models", "*"))
    os.environ["MASTER_PORT"] = str(spec["port"])
    ckpt.LAST_TIMES.clear()
    t0 = time.perf_counter()
    rc = cli.main(spec["argv"] + [f"checkpoint_path={models}"])
    resilience.clear_faults()
    return {"rc": rc, "wall_s": time.perf_counter() - t0,
            "save_s": ckpt.LAST_TIMES.get("shard_save_s"),
            "bytes": ckpt.LAST_TIMES.get("shard_bytes")}


def _start_ranks(argv, world: int) -> list:
    """``world`` processes of ``python -m chip_smoke <argv>``, each with
    the launcher's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them)."""
    from t2omca_tpu_torch.parallel.distributed import free_port
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world))
    env.setdefault("OMP_NUM_THREADS", "1")
    return [subprocess.Popen([sys.executable, "-m", "chip_smoke", *argv],
                             cwd=root, env=dict(env, RANK=str(r),
                                                LOCAL_RANK=str(r)))
            for r in range(world)]


def _wait_ranks(procs, timeout_s: float = 600.0) -> list:
    """Wait for the ranks → their exit codes. A rank that fails, or
    ``timeout_s`` passing, ends the others: no process outlives the
    call."""
    end = time.monotonic() + timeout_s
    try:
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.monotonic() < end):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _dp_shard_check(torch, ranks: list, shard_dir: str, whole, smi: str
                    ) -> dict:
    """``[dp]``'s shard leg, after the ranks ran it (``_dp_shard_rank``):
    the set of two shards at the resumed step is stamped ``partial``,
    verifies only while both shards are there, and restores at 1 rank
    (``utils/elastic.resume_state``) to the state, host values and driver
    key that the collective save ``whole`` of the same state restores to,
    bit for bit. → the ranks' shard-save seconds and bytes, the rebuild
    and restore seconds."""
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    from t2omca_tpu_torch.utils import elastic
    for r in ranks:
        check(r.get("shard", {}).get("rc") == 0,
              f"[dp] rank {r['rank']}'s shard leg: {r.get('shard')}")
    found = ckpt.find_checkpoint(_one_dir(os.path.join(shard_dir, "models",
                                                       "*")))
    check(found is not None and found[1] == whole[1],
          f"[dp] the shard set: {found} (the collective save {whole})")
    d = found[0]
    meta = ckpt.read_meta(d)
    names = sorted(n for n in os.listdir(d) if n.startswith("shard."))
    check(meta.get("partial") is True and meta.get("shards") == DP_RANKS
          and not os.path.exists(os.path.join(d, ckpt.STATE_FILE))
          and len(names) == 2 * DP_RANKS,
          f"[dp] the shard set's files {os.listdir(d)}, meta {meta}")
    last = os.path.join(d, f"shard.{DP_RANKS - 1}-of-{DP_RANKS}.pt")
    os.rename(last, last + ".away")
    alone = ckpt.verify_checkpoint(d)
    os.rename(last + ".away", last)
    check(not alone and ckpt.verify_checkpoint(d),
          f"[dp] the set verifies with a shard missing ({alone}) or not "
          f"with both")
    exp = Experiment.build(dp_cfg(0))
    topo = {"loop": "classic"}
    t0 = time.perf_counter()
    a = elastic.resume_state(d, exp.init_state(0), topology=topo)
    restore_s = time.perf_counter() - t0
    rebuild_s = ckpt.LAST_TIMES.get("rebuild_s")
    b = elastic.resume_state(whole[0], exp.init_state(0), topology=topo)
    ta, ha = ckpt.flatten_state(a)
    tb, hb = ckpt.flatten_state(b)
    differ = [k for k in tb if not torch.equal(ta[k].cpu(), tb[k].cpu())]
    ma, mb = ckpt.read_meta(d), ckpt.read_meta(whole[0])
    check(set(ta) == set(tb) and not differ and ha == hb
          and ma["driver"] == mb["driver"] and ma["host"] == mb["host"],
          f"[dp] the shard set restores other leaves than the collective "
          f"save: {differ[:8]}, host {ha} against {hb}")
    shards = [r["shard"] for r in ranks]
    print(f"[dp] shard save ({smi}): the CLI resumed at {DP_RANKS} ranks "
          f"from the t_env {whole[1]} checkpoint, a SIGTERM to rank 1 at "
          f"its first dispatch with every rank's preemption barrier "
          f"failing: each rank wrote its shard ("
          + ", ".join(f"rank {i}: {s['bytes'] / 1e6:.1f} MB in "
                      f"{s['save_s']:.2f} s" for i, s in enumerate(shards))
          + f"), meta partial, shards {meta['shards']}; the set does not "
          f"verify with shard {DP_RANKS - 1} away and does with both; "
          f"restored at 1 rank in {restore_s:.2f} s (the rebuild "
          f"{rebuild_s:.2f} s) equal bit for bit to the collective save's "
          f"restore ({len(tb)} tensors, host values, driver key)",
          flush=True)
    n_leaves = len(tb)
    del a, b, ta, tb, exp
    return {"save_s": [s["save_s"] for s in shards],
            "bytes": [s["bytes"] for s in shards],
            "rebuild_s": rebuild_s, "restore_s": restore_s,
            "leaves": n_leaves}


#: [rbg]: config 3 at [loop]'s cuts under prng_impl rbg (a classic
#: iteration, then one fused dispatch of RBG_K) and unsafe_rbg (a classic
#: iteration); its dropout leg at [dropout]'s cuts, one iteration
RBG_K = 4
RBG_ROLLOUTS = 2                    # timed rollouts an impl, in turns
#: 32-bit operations a dropout-mask element needs on the Philox path
#: (csrc/dropout_mask.cu), one an instruction as in MASK_OPS: a block of
#: 4 elements takes 10 rounds of 2 32x32->64 products (an IMAD.WIDE each,
#: issued at half rate: 2), 2 three-input xors (a LOP3 each) and 2 key
#: adds, and its 128-bit counter add (4); then an element's word select,
#: mantissa shift and or, f32 subtract and compare. The key's fold (2
#: threefry hashes under rbg, an xor under unsafe_rbg) is once a draw.
PHILOX_OPS = (10 * (2 * 2 + 2 + 2) + 4) / 4 + 5
#: the 128-bit carry keys the draws are held at besides a seeded one
CARRY_KEYS = ((0xDEADBEEF, 7, 0xFFFFFFFF, 0xFFFFFFFF),
              (1, 2, 0xFFFFFFFE, 0xFFFFFFFF))


def check_philox_cuda_equals_cpu(torch, impl: str, lanes: int) -> int:
    """The rbg impls' bits, ``uniform`` and ``bernoulli`` on the card
    against the same calls on the CPU, bit for bit, at a seeded key and
    the carry keys, over one key and under the vmap rule over ``lanes``
    keys → number of draws compared."""
    from t2omca_tpu_torch import prng
    keys = [prng.PRNGKey(SEED + 80, "cpu", impl)] + [
        torch.tensor(k) for k in CARRY_KEYS]
    draws = (lambda k: prng.random_bits(k, (64, 9)),
             lambda k: prng.uniform(k, (lanes, 64)),
             lambda k: prng.uniform(k, (lanes, 64), 4000.0, 12000.0),
             lambda k: prng.bernoulli(k, 0.3, (lanes, 64)),
             lambda k: prng.uniform(prng.split(k, lanes, impl), (64,)),
             lambda k: prng.split(k, 150, impl),
             lambda k: prng.fold_in(k, 0x5CE7, impl))
    for key in keys:
        for f in draws:
            got, want = f(key.cuda()).cpu(), f(key)
            check(torch.equal(got, want), f"[rbg] {impl} on CUDA differs "
                                          f"from the CPU")
    return len(keys) * len(draws)


def philox_mask_rows(torch, impl: str, key, fold: int, keep: float,
                     shapes: dict) -> dict:
    """The mask kernel's Philox path against its plain version at
    ``shapes``, whole and with a rank's row map (lanes or batch rows 1, 3,
    ...: rows of a shape's trailing elements, each lane's agent rows
    together), bit for bit, a population member's mask (``prng.seat``)
    against its rows of member 0's draw, and timed (rbg, whole) → {name:
    row}."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.flax_rng import Rows
    from t2omca_tpu_torch.kernels import dropout as dk
    out = {}
    for name, shape in shapes.items():
        got = dk.keep_mask(key, fold, keep, shape, impl=impl)
        ref = dk.keep_mask_reference(key, fold, keep, shape, impl=impl)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        check(got.dtype == torch.bool and torch.equal(got, ref),
              f"[rbg] the {impl} mask kernel differs from its plain "
              f"version at {shape}: {int((got != ref).sum())} elements")
        per = 1 if name == "mixer" else 64
        batch = shape[0] // per
        rows, _ = Rows(torch.arange(1, batch, 2, device="cuda"),
                       batch).of(shape[0] // 2)
        part = dk.keep_mask(key, fold, keep, shape, rows, impl)
        ref_rows = dk.keep_mask_reference(key, fold, keep, shape, rows, impl)
        torch.cuda.synchronize()
        err = max(err, float((part.float() - ref_rows.float()).abs().max()),
                  float((part.float() - got[rows].float()).abs().max()))
        check(torch.equal(part, got[rows]) and torch.equal(part, ref_rows),
              f"[rbg] the {impl} mask kernel with a row map at {shape} "
              f"differs: {int((part != got[rows]).sum())} elements from "
              f"the whole mask's rows")
        # a population member's key (prng.seat): its rows of member 0's
        # draw over 2 members, through the row map
        doubled = dk.keep_mask(key, fold, keep, (2 * shape[0],) + shape[1:],
                               impl=impl)
        member = dk.keep_mask(prng.seat(key, 1), fold, keep, shape,
                              impl=impl)
        torch.cuda.synchronize()
        err = max(err, float((member.float()
                              - doubled[shape[0]:].float()).abs().max()))
        check(torch.equal(member, doubled[shape[0]:]),
              f"[rbg] member 1's {impl} mask at {shape} is not its rows of "
              f"member 0's draw")
        del doubled, member
        row = {"shape": list(shape), "max_abs_err": err,
               "rows_equal": True}
        if impl == "rbg":
            n = math.prod(shape)
            bound, by = bound_ms(n + 32, n * PHILOX_OPS + 2 * MASK_OPS,
                                 "int32")
            row.update(
                ms=cuda_ms(lambda: dk.keep_mask(key, fold, keep, shape,
                                                impl=impl)),
                plain_ms=cuda_ms(lambda: dk.keep_mask_reference(
                    key, fold, keep, shape, impl=impl), iters=3, warmup=1),
                bound_ms=bound, bound_by=by, library_ms=None,
                threefry_ms=cuda_ms(lambda: dk.keep_mask(
                    key[:2].contiguous(), fold, keep, shape)))
            print(f"[rbg] Philox mask kernel at the {name} shape {shape}: "
                  f"equal to its plain version bit for bit, whole and "
                  f"with a row map, under rbg and unsafe_rbg; "
                  f"{row['ms']:.3f} ms (bound {bound:.3f} ms by {by}, "
                  f"{row['ms'] / bound:.2f}x; plain {row['plain_ms']:.2f} "
                  f"ms; the threefry path {row['threefry_ms']:.3f} ms)",
                  flush=True)
        out[name] = row
        del got, ref, part, ref_rows
    return out


def phase_rbg(torch, att, smi: str) -> dict:
    """``prng_impl: rbg`` and ``unsafe_rbg`` on config 3 at [loop]'s cuts
    (1024 lanes, ring 2048, T = ``LOOP_T``, bf16, pallas): the Philox
    draws on the card against the CPU; the dropout-mask kernel's Philox
    path against its plain version at the agent, mixer and rollout
    shapes, whole and with a row map, timed; one classic iteration and
    one fused K = ``RBG_K`` dispatch under rbg and one classic iteration
    under unsafe_rbg with exact launches; the rollout under rbg against
    threefry's in turns; then the dropout leg: config 3 with dropout at
    [dropout]'s cuts, one classic iteration under rbg, its masks drawn by
    the Philox path (the launches counted)."""
    import gc
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.flax_rng import Scope
    from t2omca_tpu_torch.kernels import dropout as dk
    from t2omca_tpu_torch.run import Experiment
    cfgs = {impl: dataclasses.replace(_episode_cfg(loop_cfg(), LOOP_T),
                                      prng_impl=impl)
            for impl in ("threefry", "rbg", "unsafe_rbg")}
    b, t = LOOP_LANES, LOOP_T
    print(f"[rbg] config 3 at [loop]'s cuts ({b} lanes, ring {LOOP_RING}, "
          f"T={t}, bf16, pallas, PER) under prng_impl rbg and unsafe_rbg: "
          f"4-word keys, XLA's CPU Philox4x32-10 stream | {smi}", flush=True)
    result = {}
    n = sum(check_philox_cuda_equals_cpu(torch, impl, b)
            for impl in ("rbg", "unsafe_rbg"))
    print(f"[rbg] Philox bits, uniform and bernoulli on the card = the "
          f"CPU's bit for bit: {n} draws (a seeded key and the carry keys "
          f"{', '.join(f'({k[2]:#x}, {k[3]:#x})' for k in CARRY_KEYS)} in "
          f"the counter words, one key and {b} lanes)", flush=True)
    # ---- the mask kernel's Philox path at the path's shapes
    bs = cfgs["rbg"].batch_size
    shapes = {"agent": (bs * 64, 65, 256), "mixer": (bs, 131, 256),
              "rollout": (DROPOUT_LANES * 64, 65, 256)}
    keep = 1.0 - DROPOUT
    by_impl = {}
    for impl in ("unsafe_rbg", "rbg"):
        key = prng.PRNGKey(SEED + 81, "cuda", impl)
        fold = Scope(key, ("transformer", "block_0", "Dropout_0")).fold_data()
        by_impl[impl] = philox_mask_rows(torch, impl, key, fold, keep,
                                         shapes)
    # the rbg rows carry the times; each shape's error is the larger of
    # the two impls' (whole, row map and member legs)
    kernel = by_impl["rbg"]
    for name, row in kernel.items():
        row["max_abs_err"] = max(row["max_abs_err"],
                                 by_impl["unsafe_rbg"][name]["max_abs_err"])
    result["mask_kernel"] = kernel
    # ---- config 3 under rbg: a classic iteration, a fused dispatch
    exps = {impl: Experiment.build(cfgs[impl]) for impl in ("rbg",
                                                             "unsafe_rbg")}
    totals = dict.fromkeys(loop_launches(cfgs["rbg"]), 0)
    ts = exps["rbg"].init_state(SEED)
    check(ts.runner.key.shape == (4,), "[rbg] the runner key is not 4 words")
    ts, recs, rbg = run_loop(torch, att, exps["rbg"], ts, "rbg", 1)
    cursor = rbg.pop("cursor")
    for k in totals:
        totals[k] += rbg["launches"][k]
    sup = exps["rbg"].superstep_program(RBG_K)
    mirror = {"key": cursor.key, "t_env": cursor.t_env,
              "episode": cursor.episode, "filled": cursor.buffer_filled}
    att.reset_launches()
    t0 = time.perf_counter()
    ts, stats, infos, gated = fused_dispatch(torch, sup, ts, mirror)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused = dict(att.LAUNCHES)
    want = {k: RBG_K * v for k, v in loop_launches(cfgs["rbg"]).items()}
    check(all(gated) and fused == want,
          f"[rbg] fused K={RBG_K}: gates {gated}, launches {fused} != "
          f"{want}")
    check(exps["rbg"].device.type != "cuda"
          or set(sup.graphs) == {"rollout", "train"},
          f"[rbg] graphs {sorted(sup.graphs)}")
    check(bool(torch.isfinite(stats.episode_return).all())
          and bool(torch.isfinite(infos["loss"]).all()),
          "[rbg] the fused dispatch made non-finite values")
    for k in totals:
        totals[k] += fused[k]
    print(f"[rbg] one fused K={RBG_K} dispatch (captured rollout and "
          f"train graphs) in {fused_s:.2f} s with its captures: launches "
          f"{fused} (exact), losses "
          f"{', '.join(f'{float(x):.4g}' for x in infos['loss'])}",
          flush=True)
    sup.close()
    del sup, stats, infos
    gc.collect()
    torch.cuda.empty_cache()
    uts = exps["unsafe_rbg"].init_state(SEED)
    uts, _, unsafe = run_loop(torch, att, exps["unsafe_rbg"], uts,
                              "rbg unsafe", 1)
    unsafe.pop("cursor")
    for k in totals:
        totals[k] += unsafe["launches"][k]
    check(not torch.equal(uts.runner.key, ts.runner.key),
          "[rbg] unsafe_rbg and rbg left one runner key")
    del uts
    # ---- the rollout under rbg against threefry, in turns
    three = Experiment.build(cfgs["threefry"])
    tts = three.init_state(SEED, learner_params=ts.learner.params)
    agent = ts.learner.params["agent"]
    roll = {"rbg": [], "threefry": []}
    for i in range(RBG_ROLLOUTS):
        for impl in (("rbg", "threefry") if i % 2 == 0
                     else ("threefry", "rbg")):
            exp, st = ((exps["rbg"], ts) if impl == "rbg"
                       else (three, tts))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exp.runner.run(agent, st.runner)
            torch.cuda.synchronize()
            roll[impl].append((time.perf_counter() - t0) * 1e3)
    p50 = {k: statistics.median(v) for k, v in roll.items()}
    print(f"[rbg] rollout ({b} lanes, T={t}) in turns: rbg "
          f"{', '.join(f'{x:.1f}' for x in roll['rbg'])} ms, threefry "
          f"{', '.join(f'{x:.1f}' for x in roll['threefry'])} ms; p50 rbg "
          f"{p50['rbg']:.1f} ms against threefry {p50['threefry']:.1f} ms "
          f"({p50['rbg'] / p50['threefry']:.3f}x)", flush=True)
    result.update(rollout_ms=roll, rollout_p50_ms=p50)
    del exps, three, ts, tts, agent
    gc.collect()
    torch.cuda.empty_cache()
    # ---- the dropout leg: the Philox path on the learner's and the
    # rollout's masks
    dcfg = dataclasses.replace(_with(
        _episode_cfg(loop_cfg(DROPOUT_LANES, DROPOUT_RING,
                              entity_tables=False), DROPOUT_T),
        model={"dropout": DROPOUT, "remat": True}), prng_impl="rbg")
    dexp = Experiment.build(dcfg)
    dts = dexp.init_state(SEED)
    dk.reset_launches()                  # ---- the dropout path starts here
    dts, _, drop = run_loop(torch, att, dexp, dts, "rbg dropout", 1,
                            want=dropout_launches(dcfg))
    philox = dk.LAUNCHES["dropout_mask_philox"]  # ---- and ends here
    per_iter = dropout_mask_launches(dcfg)
    check(philox == per_iter and dk.LAUNCHES["dropout_mask"] == 0,
          f"[rbg] dropout iteration: {philox} Philox mask launches "
          f"(threefry {dk.LAUNCHES['dropout_mask']}), want {per_iter}")
    drop.pop("cursor")
    print(f"[rbg] dropout leg (config 3 with dropout {DROPOUT}, remat, "
          f"{DROPOUT_LANES} lanes, T={DROPOUT_T}, rbg): one iteration, "
          f"rollout+insert {drop['rollout_p50_ms']:.1f} ms, trainer step "
          f"{drop['train_p50_ms']:.1f} ms; {philox} Philox mask launches",
          flush=True)
    del dexp, dts
    gc.collect()
    torch.cuda.empty_cache()
    result.update(launches=totals, drop_launches=drop["launches"],
                  mask_launches=philox)
    return result


#: [sp]: config 5's mixer widths (configs/config5_dp8.yaml: 256 AGVs x 16
#: MECs, mixer emb 256, 4 standard heads, depth 2; 256 state entities +
#: 256 agents + 3 hyper tokens = 515), SP_ROWS rows, on 2 and 4
#: placements that are streams of the one card
SP_ROWS = 32
SP_PLACEMENTS = (2, 4)
#: q_tot against the dense forward: at f32 JAX's dry-run bound, 1e-3,
#: or 8 float32 spacings at the output's scale where that is larger (the
#: dry run's q_tot is small; here |q_tot| reaches ~2.5e3, where a spacing
#: is 2.4e-4); at bf16 1e-2 of the output's scale (bf16's spacing at
#: |q_tot| ~ 100 is 0.5, and the dense forward softmaxes in bf16 where
#: the ring accumulates in f32)
SP_BOUND = {"float32": 1e-3, "bfloat16": 1e-2}


def sp_bound(torch, dt: str, y) -> float:
    """``SP_BOUND`` at the scale of the dense q_tot ``y``."""
    top = float(y.abs().max())
    if dt == "float32":
        return max(SP_BOUND[dt], 8 * float(torch.finfo(torch.float32).eps)
                   * top)
    return SP_BOUND[dt] * top


def phase_sp(torch, smi: str) -> dict:
    """Sequence parallelism (``parallel/ring_attention.py``,
    ``parallel/sp_mixer.py``) at config 5's mixer widths: ``mixer_apply_sp``
    over 2 and 4 placements (streams of the card) against the port's
    dense mixer forward at f32 and bf16 (max error < 1e-3, the JAX dry
    run's bound), ``ulysses_attention`` at 2 and 4 against dense softmax
    attention, and the gradient through the ring: finite, the agent
    gradient non-negative (monotonic mixing); the forward's ms at n = 1
    (dense), 2 and 4 and the card's peak over it. The inputs are the dry
    run's kind (``__graft_entry__.py``): normal agent Qs, hidden states,
    state and obs, the hyper tokens at their initial zeros."""
    import gc
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.controllers.basic_mac import init_module_params
    from t2omca_tpu_torch.envs.registry import make_env
    from t2omca_tpu_torch.parallel import (mixer_apply_sp, sp_placements,
                                           ulysses_attention)
    from t2omca_tpu_torch.parallel.ring_attention import gather, scatter
    base = {"env_args": {"agv_num": 256, "mec_num": 16,
                         "num_channels": 16},
            "model": {"emb": 256, "heads": 4, "depth": 2,
                      "mixer_emb": 256, "mixer_heads": 4,
                      "mixer_depth": 2, "standard_heads": True},
            "kernels": {"attention": "xla"}}
    info = make_env(from_dict(base).env_args, "cuda").get_env_info()
    g = torch.Generator().manual_seed(SEED + 90)
    result = {"ms": {}, "peak_gib": {}, "max_err": {}}
    places = {n: sp_placements(n, "cuda", share_cards=True)
              for n in SP_PLACEMENTS}
    for dt in ("float32", "bfloat16"):
        cfg = from_dict(dict(base, model=dict(base["model"], dtype=dt)))
        lrn = build_learner(cfg, info)
        mixer = lrn.mixer.to_empty(device="cuda")
        mixer.load_state_dict(init_module_params(mixer, g, "cuda"))
        a, e = info["n_agents"], cfg.model.mixer_emb
        tokens = mixer.n_entities + a + 3
        x = (torch.randn(SP_ROWS, 1, a, generator=g).cuda(),
             torch.randn(SP_ROWS, a, e, generator=g).cuda(),
             mixer.initial_hyper(SP_ROWS, device="cuda"),
             torch.randn(SP_ROWS, lrn.state_dim, generator=g).cuda(),
             torch.randn(SP_ROWS, a, lrn.obs_dim, generator=g).cuda())
        with torch.no_grad():
            y, h = mixer(*x)
            torch.cuda.reset_peak_memory_stats()
            base_gib = torch.cuda.memory_allocated() / 2 ** 30
            ms = {1: cuda_ms(lambda: mixer(*x), iters=5, warmup=1)}
            peak = {1: torch.cuda.max_memory_allocated() / 2 ** 30
                    - base_gib}
            bound = sp_bound(torch, dt, y)
            for n in SP_PLACEMENTS:
                ys, hs = mixer_apply_sp(mixer, *x, places[n])
                torch.cuda.synchronize()
                err = float((ys - y).abs().max())
                check(err < bound and bool(torch.isfinite(ys).all())
                      and bool(torch.isfinite(hs.float()).all()),
                      f"[sp] {dt} at {n} placements: q_tot max error "
                      f"{err:.3e} against the dense mixer (bound "
                      f"{bound:.3e})")
                result["max_err"][(dt, n)] = err
                torch.cuda.reset_peak_memory_stats()
                ms[n] = cuda_ms(lambda: mixer_apply_sp(mixer, *x,
                                                       places[n]),
                                iters=5, warmup=1)
                peak[n] = torch.cuda.max_memory_allocated() / 2 ** 30 \
                    - base_gib
        result["ms"][dt], result["peak_gib"][dt] = ms, peak
        print(f"[sp] {dt} mixer at config 5's widths ({tokens} tokens, "
              f"{SP_ROWS} rows, |q_tot| up to {float(y.abs().max()):.4g}):"
              f" mixer_apply_sp against the dense forward, q_tot max "
              f"error " + ", ".join(
                  f"{result['max_err'][(dt, n)]:.2e} at {n} placements"
                  for n in SP_PLACEMENTS)
              + "; a forward " + ", ".join(
                  f"n={n} {ms[n]:.2f} ms" for n in ms)
              + "; the card's peak over it (every placement on it) "
              + ", ".join(f"n={n} {peak[n]:.3f} GiB" for n in peak),
              flush=True)
        if dt == "float32":
            # the gradient through the ring and the hand-overs
            qv = x[0].clone().requires_grad_()
            ys, _ = mixer_apply_sp(mixer, qv, *x[1:], places[2])
            gq, *gp = torch.autograd.grad(
                ys.sum(), [qv] + list(mixer.parameters()),
                allow_unused=True)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(gq).all()) and bool((gq >= 0).all()),
                  "[sp] the agent gradient through the ring is not finite "
                  "and non-negative")
            check(all(bool(torch.isfinite(p).all()) for p in gp
                      if p is not None), "[sp] a param gradient is not "
                                         "finite")
            print("[sp] the gradient through the ring at 2 placements: "
                  "finite, the agent gradient >= 0 (monotonic mixing), "
                  "every param gradient finite", flush=True)
        del lrn, mixer, x, y, h
        gc.collect()
        torch.cuda.empty_cache()
    # ---- ulysses: 4 heads over 2 and 4 placements
    q, k, v = (torch.randn(SP_ROWS, 515, 4, 64, generator=g).cuda()
               for _ in range(3))
    dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
        torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1), v)
    for n in SP_PLACEMENTS:
        cut = lambda t: scatter(list(t.tensor_split(n, dim=1)), places[n])
        out = torch.cat(gather(ulysses_attention(cut(q), cut(k), cut(v),
                                                 places[n]), places[n],
                               q.device), dim=1)
        torch.cuda.synchronize()
        err = float((out - dense).abs().max())
        check(err < 1e-3, f"[sp] ulysses at {n} placements: max error "
                          f"{err:.3e}")
        result["max_err"][("ulysses", n)] = err
    print(f"[sp] ulysses_attention (4 heads, 515 tokens, f32) against "
          f"dense softmax attention: max error " + ", ".join(
              f"{result['max_err'][('ulysses', n)]:.2e} at {n} placements"
              for n in SP_PLACEMENTS) + f" | {smi}", flush=True)
    return result


def phase_dp(torch, att, smi: str) -> dict:
    """Data parallelism at config 5's widths (``configs/config5_dp8.yaml``:
    256 AGVs x 16 MEC x 16 channels, emb 256, 4 heads, depth 2, bf16 with
    compact bf16 storage; cut to 256 lanes, a ring of 512 and batch 8, 4
    episodes a rank) with ``kernels.attention=pallas``:

    1. the DP code at world 1 over NCCL, here, one iteration: the
       reference (``dp_reference``), and from its sampled batch the step
       that 2 ranks should take, computed here without the learner's dp
       code (``_blocked_step_probe``);
    2. the CLI with ``dp_devices=2``, its ranks started with the
       launcher's variables while the reference runs (``_start_ranks``;
       each rank this script's ``dp_cli_rank_main``, which waits for the
       reference to end, around the CLI's ``main``), over NCCL where
       the machine shows two cards, else both on this card over gloo by
       the explicit opt-in: two dispatches and a save; every rank's
       launches exact (2 train iterations), the ranks' replicated state
       identical after the first step (a digest each) and at the save
       (the driver's own check); against the reference, from the
       checkpoint after the first dispatch: the ring's slots equal (the
       acting forward is batch-invariant on the card); against that
       step, which holds the gradient exchange: the loss within 2e-4,
       the logged pre-clip gradient norm and Adam's first moment (a tenth
       of the clipped, all-reduced gradient) within ``DP_STEP_RTOL``, the
       params at the CPU test's rule (at most 1% of elements more than
       1e-5 apart, none more than 2 lr), the priorities of the sampled
       episodes within ``DP_STEP_RTOL``; the gaps to the whole-batch step
       (bf16's batch-size variance) printed beside them;
    3. a one-rank resume from that checkpoint for one dispatch, in this
       process: finite values, the placement logged;
    4. the shard save (``_dp_shard_rank``, ``_dp_shard_check``): each
       rank runs the CLI again from that checkpoint on its own port, a
       SIGTERM to rank 1 at the first dispatch and every rank's
       preemption barrier failing, so each rank writes its shard of the
       state it restored; the set verifies only with both shards, and
       its restore at 1 rank equals the collective save's bit for bit.
    """
    import logging
    import shutil
    import tempfile
    import numpy as np
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch.parallel.distributed import free_port
    from t2omca_tpu_torch.utils.checkpoint import find_checkpoint, read_meta
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    share = DP_RANKS > torch.cuda.device_count()
    want_backend = "gloo" if share else "nccl"
    cfg = dp_cfg(DP_RANKS)
    per = DP_LANES * cfg.env_args.episode_limit
    want = {k: 2 * v for k, v in loop_launches(cfg).items()}
    print(f"[dp] config 5 ({DP_CONFIG}) at its widths: "
          f"{cfg.env_args.agv_num} AGVs x {cfg.env_args.mec_num} MEC x "
          f"{cfg.env_args.num_channels} channels, emb {cfg.model.emb}, "
          f"{cfg.model.heads} heads, depth {cfg.model.depth}, "
          f"{cfg.model.dtype}; cuts: batch_size_run 8192 -> {DP_LANES}, "
          f"replay.buffer_size 16384 -> {DP_RING}, batch_size 32 -> "
          f"{DP_BATCH} ({DP_BATCH // DP_RANKS} a rank, config 5's own 32/8), "
          f"dp_devices 8 -> {DP_RANKS}, episode_limit 150 -> "
          f"{cfg.env_args.episode_limit} (the smoke's time limit); "
          f"model.remat {cfg.model.remat}", flush=True)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_driver_dp_", dir=root)
    res_dir = os.path.join(tmp, "cli")
    argv = ["--dp-cli-rank", tmp, "train", "--config",
            os.path.join(root, DP_CONFIG), *DP_OVERRIDES,
            f"dp_devices={DP_RANKS}", f"t_max={2 * per - 1}",
            "save_model=true", f"save_model_interval={2 * per}",
            f"log_interval={per}", f"runner_log_interval={per}",
            f"test_interval={per}", f"local_results_path={res_dir}"]
    # 4.'s shard leg, which each rank runs after the CLI run
    shard_dir = os.path.join(tmp, "shard")
    with open(os.path.join(tmp, "shard.json"), "w") as f:
        json.dump({"port": free_port(), "resume": res_dir, "argv": [
            "train", "--config", os.path.join(root, DP_CONFIG),
            *DP_OVERRIDES, f"dp_devices={DP_RANKS}", f"t_max={2 * per - 1}",
            "save_model=true", f"save_model_interval={4 * per}",
            f"local_results_path={shard_dir}"]
            + (["--share-cards"] if share else [])}, f)
    # the CLI's ranks start up (interpreter, torch, the kernels' library,
    # the card's context) while the reference runs, then wait for OUT/go
    procs = _start_ranks(argv + (["--share-cards"] if share else []),
                         DP_RANKS)
    try:
        # ---- 1. the reference: the DP code at world 1 over NCCL -------
        one = dp_reference(torch, att, free_port())
        blk = one["blocked"]
        check(one["backend"] == "nccl",
              f"[dp] world 1 ran over {one['backend']}")
        print(f"[dp] world 1 over {one['backend']}: one (cold) iteration "
              f"{one['wall_ms']:.0f} ms (rollout+insert "
              f"{one['rollout_ms']:.0f}, train {one['train_ms']:.0f}, with "
              f"{DP_RANKS} ranks' step computed beside it), loss "
              f"{one['loss']:.8g} (the ranks' step {blk['loss']:.8g}), "
              f"launches {one['launches']}, peak {one['peak_gib']:.2f} GiB",
              flush=True)
        torch.cuda.empty_cache()
        # ---- 2. the CLI, its ranks started as torchrun starts them ------
        t0 = time.perf_counter()
        open(os.path.join(tmp, "go"), "w").close()
        codes = _wait_ranks(procs)
        cli_s = time.perf_counter() - t0
        check(codes == [0] * DP_RANKS, f"[dp] the CLI's ranks exited with "
                                       f"{codes}")
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for r in ranks:
            check(r["launches"] == want, f"[dp] rank {r['rank']}: launches "
                                         f"{r['launches']} != {want}")
            check(r["backend"] == want_backend, f"[dp] rank {r['rank']} ran "
                                                f"over {r['backend']}")
            check(len(set(r["digests"])) == 1,
                  f"[dp] the ranks' replicated state differs after the "
                  f"first step: {r['digests']}")
        model_dir = _one_dir(os.path.join(res_dir, "models", "*"))
        found = find_checkpoint(model_dir)
        check(found is not None and found[1] == per,
              f"[dp] the CLI's checkpoint: {found}")
        topo = read_meta(found[0])["topology"]
        check(topo["process_count"] == DP_RANKS
              and topo["mesh_shape"] == [DP_RANKS],
              f"[dp] checkpoint stamp {topo}")
        rows = _metric_rows(res_dir)
        val = {(r["key"], r["t"]): r["value"] for r in rows}
        losses = [val[("loss", t)] for t in (per, 2 * per)]
        check(all(np.isfinite(losses)), f"[dp] the CLI's losses {losses}")
        state = torch.load(os.path.join(found[0], "state.pt"),
                           map_location="cuda", weights_only=True)
        ckpt_gb = os.path.getsize(os.path.join(found[0], "state.pt")) / 1e9
        print(f"[dp] CLI, its ranks started as torchrun starts them: python "
              f"-m t2omca_tpu_torch train --config {DP_CONFIG} "
              f"dp_devices={DP_RANKS}"
              + (" --share-cards" if share else "") + f": exit 0 "
              f"{cli_s:.1f} s after the reference, whose run their start-up "
              f"overlapped ({DP_RANKS} ranks over {want_backend}"
              + (", both on one card by the explicit opt-in" if share
                 else ", a card each") + "; 2 dispatches, a test rollout, a "
              f"t_env {found[1]} checkpoint of {ckpt_gb:.3f} GB stamped "
              f"process_count {topo['process_count']}, device_count "
              f"{topo['device_count']}); losses {losses}; "
              + "; ".join(f"rank {r['rank']} on {r['device']}: launches "
                          f"{r['launches']} (2 train iterations), peak "
                          f"{r['peak_gib']:.2f} GiB, run {r['wall_s']:.1f} s"
                          for r in ranks), flush=True)
        # -- 2 ranks against the step they should take, after the first
        #    dispatch (and against world 1's whole-batch step, printed)
        storage = {k[len("buffer.storage."):]: v for k, v in state.items()
                   if k.startswith("buffer.storage.")}
        slots = _slot_sums(torch, storage)
        slot_diff = {k: int((slots[k] != one["slots"][k]).sum())
                     for k in one["slots"]}
        step = {"learner." + k: v for k, v in blk["learner"].items()}
        loss, norm = losses[0], val[("grad_norm", per)]
        rel = _rel(loss, blk["loss"])
        rel_norm = _rel(norm, blk["grad_norm"])
        mu = [k for k in step if k.startswith("learner.opt_state.mu.")]
        cat = lambda src, keys: torch.cat([src[k].float().cpu().flatten()
                                           for k in keys])
        mu_ref = cat(step, mu)
        rel_mu = float((cat(state, mu) - mu_ref).norm()
                       / mu_ref.norm().clamp(min=1e-30))
        pkeys = [k for k in step if k.startswith("learner.params.")]
        diffs = (cat(state, pkeys) - cat(step, pkeys)).abs()
        off = float((diffs > 1e-5).float().mean())
        whole = (cat(state, pkeys) - cat(one["learner"], pkeys)).abs()
        lr = cfg.lr
        pri_want = one["priorities"].clone()
        pri_want[blk["idx"]] = blk["pa"]
        pri = state["buffer.priorities"].cpu()
        pr_rel = float(((pri - pri_want).abs()
                        / pri_want.abs().clamp(min=1e-30)).max())
        pr_whole = float(((pri - one["priorities"]).abs()
                          / one["priorities"].abs().clamp(min=1e-30)).max())
        del state, storage
        print(f"[dp] 2 ranks vs their step computed at world 1, after "
              f"the first dispatch: loss {loss:.8g} rel {rel:.2e} (limit "
              f"{DP_LOSS_RTOL:.0e}); pre-clip grad norm {norm:.8g} rel "
              f"{rel_norm:.2e}, Adam's first moment rel {rel_mu:.2e} "
              f"(limit {DP_STEP_RTOL:.0e} each); params max |diff| "
              f"{float(diffs.max()):.3e} (limit 2 lr {2 * lr:.1e}), "
              f"{100 * off:.3f}% above 1e-5 (limit 1%), "
              f"{int((diffs == 0).sum())} of {diffs.numel()} equal; "
              f"priorities max rel {pr_rel:.2e} (limit {DP_STEP_RTOL:.0e}); "
              f"ring slots that differ by leaf {slot_diff}. Against world "
              f"1's whole-batch step (bf16's batch-size variance): loss rel "
              f"{_rel(loss, one['loss']):.2e}, grad norm rel "
              f"{_rel(norm, one['grad_norm']):.2e}, params max |diff| "
              f"{float(whole.max()):.3e}, "
              f"{100 * float((whole > 1e-5).float().mean()):.3f}% above "
              f"1e-5, priorities max rel {pr_whole:.2e}", flush=True)
        check(all(v == 0 for v in slot_diff.values()),
              f"[dp] ring slots differ from world 1's: {slot_diff}")
        check(rel <= DP_LOSS_RTOL, f"[dp] loss {loss}: rel {rel:.2e}")
        check(rel_norm <= DP_STEP_RTOL, f"[dp] the logged gradient norm "
                                        f"{norm}: rel {rel_norm:.2e}")
        check(rel_mu <= DP_STEP_RTOL, f"[dp] the all-reduced gradient (Adam's "
                                      f"first moment): rel {rel_mu:.2e}")
        check(off <= 0.01 and float(diffs.max()) <= 2 * lr,
              f"[dp] params: {100 * off:.3f}% above 1e-5, max "
              f"{float(diffs.max()):.3e}")
        check(pr_rel <= DP_STEP_RTOL, f"[dp] priorities: rel {pr_rel:.2e}")
        # ---- 3. a one-rank resume ---------------------------------------
        lines = []
        handler = logging.Handler()
        handler.emit = lambda r: lines.append(r.getMessage())
        elastic_log = logging.getLogger("t2omca_tpu_torch.utils.elastic")
        elastic_log.addHandler(handler)
        res1 = os.path.join(tmp, "one")
        t0 = time.perf_counter()
        try:
            check(cli.main(["train", "--config",
                            os.path.join(root, DP_CONFIG), *DP_OVERRIDES,
                            "dp_devices=0", f"t_max={2 * per - 1}",
                            "save_model=false", f"log_interval={per}",
                            f"runner_log_interval={per}",
                            f"test_interval={4 * per}",
                            f"checkpoint_path={model_dir}",
                            f"local_results_path={res1}"]) == 0,
                  "[dp] the one-rank resume")
        finally:
            elastic_log.removeHandler(handler)
        resume_s = time.perf_counter() - t0
        check(any("process_count: saved 2 -> current 1" in ln
                  for ln in lines), f"[dp] no placement log: {lines}")
        rows1 = {r["key"]: r["value"] for r in _metric_rows(res1)}
        check(np.isfinite(rows1.get("loss", np.nan)),
              f"[dp] the one-rank resume's loss {rows1.get('loss')}")
        print(f"[dp] one-rank resume of the dp checkpoint: one dispatch "
              f"(rollout+insert {rows1['time_rollout_ms']:.0f} ms, train "
              f"{rows1['time_train_ms']:.0f} ms), {resume_s:.1f} s with the "
              f"restore, loss {rows1['loss']:.6g}; placement logged: "
              f"{[ln for ln in lines if 'process_count' in ln][0]}",
              flush=True)
        # ---- 4. the shard save: the ranks' barrier failed ---------------
        shard = _dp_shard_check(torch, ranks, shard_dir, found, smi)
    finally:
        _wait_ranks(procs, timeout_s=0.0)     # ends any rank still alive
        shutil.rmtree(tmp, ignore_errors=True)
    # a warm dispatch (the second; the ranks run in lockstep, rank 0
    # logs) against the warm one-rank dispatch of the resume
    two_ms = val[("time_rollout_ms", 2 * per)] + val[("time_train_ms",
                                                       2 * per)]
    one_ms = rows1["time_rollout_ms"] + rows1["time_train_ms"]
    summary = {
        "backend": want_backend, "shared_card": share,
        "dispatch_ms": two_ms, "dispatch_ms_one": one_ms,
        "rollout_ms": val[("time_rollout_ms", 2 * per)],
        "train_ms": val[("time_train_ms", 2 * per)],
        "env_steps_per_s": per / (two_ms / 1e3),
        "env_steps_per_s_one": per / (one_ms / 1e3),
        "allreduce_ms": ranks[0]["allreduce_ms"],
        "n_params": one["n_params"], "batch_bytes": one["batch_bytes"],
        "peak_gib_by_rank": [r["peak_gib"] for r in ranks],
        "peak_gib_one": one["peak_gib"], "loss_rel": rel,
        "grad_norm_rel": rel_norm, "mu_rel": rel_mu,
        "params_max_diff": float(diffs.max()), "params_off": off,
        "priorities_rel": pr_rel,
        "cli_s": cli_s, "resume_s": resume_s, "checkpoint_gb": ckpt_gb,
        "shard": shard,
        "launches": {k: sum(r["launches"][k] for r in ranks) for k in want},
        "seconds": time.perf_counter() - t_phase}
    print(f"[dp] timings ({smi}): a warm dispatch at {DP_RANKS} ranks "
          f"{two_ms:.0f} ms (rollout+insert {summary['rollout_ms']:.0f}, "
          f"train {summary['train_ms']:.0f}; the ranks in lockstep, rank 0's"
          f" clock), at 1 rank {one_ms:.0f} ms; env-steps/s "
          f"{summary['env_steps_per_s']:.0f} ({DP_RANKS} ranks) vs "
          f"{summary['env_steps_per_s_one']:.0f} (1 rank); all-reduce a step "
          f"{summary['allreduce_ms']['grad']:.2f} ms for the gradient "
          f"({one['n_params']} f32) + {summary['allreduce_ms']['batch']:.2f} "
          f"ms for the batch ({one['batch_bytes'] / 1e6:.1f} MB) over "
          f"{want_backend}; peak by rank "
          + ", ".join(f"{x:.2f}" for x in summary["peak_gib_by_rank"])
          + f" GiB ({one['peak_gib']:.2f} at world 1); phase "
          f"{summary['seconds']:.1f} s", flush=True)
    return summary


# ============================================================ [dp-superstep]

DPS_CONFIG = "configs/config3_tpu_northstar.yaml"
DPS_RANKS = 2
DPS_T = 20                          # episode_limit 150 -> 20: the smoke's
#                                     limit (PERF.md §4)
DPS_DISPATCHES = 2
DPS_OVERRIDES = ("kernels.attention=pallas",
                 f"env_args.episode_limit={DPS_T}", f"dp_devices={DPS_RANKS}")
#: the leg of dropout and NoisyNet noise: [dropout]'s lane and ring cuts
#: and its remat (both query-slice reductions are ineligible under
#: dropout: the dense agent acts, dense obs are stored; without remat
#: two ranks' captured dense train steps do not fit the card), one
#: dispatch
DPS_OPTIONS = ("batch_size_run=128", "replay.buffer_size=256",
               f"model.dropout={DROPOUT}", "model.remat=true",
               "action_selector=noisy-new")


def _dps_flags(cfg, path: str, overrides, results: str, dispatches: int,
               device: str, share: bool) -> list:
    """The CLI's arguments for ``dispatches`` fused dispatches of ``cfg``,
    every cadence and a save at each dispatch."""
    per = cfg.superstep * cfg.batch_size_run * cfg.env_args.episode_limit
    return (["train", "--config", path, *overrides,
             f"t_max={dispatches * per - 1}", "save_model=true",
             f"save_model_interval={per}", f"log_interval={per}",
             f"runner_log_interval={per}", f"test_interval={per}",
             f"local_results_path={results}"]
            + (["--device", device] if device != "cuda" else [])
            + (["--share-cards"] if share else []))


def _rows_of(results: str) -> dict:
    return {(r["key"], r["t"]): r["value"] for r in _metric_rows(results)}


def _logged(x) -> object:
    """A value as the Logger writes it to ``metrics.jsonl``."""
    import numpy as np
    a = np.asarray(x.detach().cpu() if hasattr(x, "detach") else x,
                   dtype=np.float64)
    return [float(v) for v in a.reshape(-1)] if a.ndim else float(a)


def dp_superstep_rank_main(argv) -> int:
    """``python -m chip_smoke --dp-superstep-rank OUT``: one rank of
    ``[dp-superstep]``, started with the launcher's variables
    (``_start_ranks``); ``OUT/spec.json`` holds what to run (the phase's
    docstring). Each part joins the process group on its own port. Writes
    ``OUT/rank<r>.json``."""
    import hashlib
    import torch
    import torch.distributed as dist
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.kernels import build
    from t2omca_tpu_torch.kernels import dropout as dk
    from t2omca_tpu_torch.parallel import distributed as dd
    from t2omca_tpu_torch.parallel.mesh import DataParallel, RankComm
    from t2omca_tpu_torch.run import Experiment, run_classic
    from t2omca_tpu_torch.train import superstep as sm
    from t2omca_tpu_torch.utils import resilience
    from t2omca_tpu_torch.utils.checkpoint import (find_checkpoint,
                                                   flatten_state, read_meta)
    out = argv[0]
    with open(os.path.join(out, "spec.json")) as f:
        spec = json.load(f)
    cuda = spec["device"] == "cuda"
    if cuda:
        build.build()
        build.load()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    restore = None if cuda else counted_plain_launches(att)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rank = int(os.environ["RANK"])
    ports = iter(spec["ports"])
    seen = {"rank": rank}

    # ---- 1. the CLI at K = superstep: dispatches timed, programs kept
    cls = sm.SuperstepProgram
    call0 = cls.__call__
    progs, dispatch_ms = [], []

    def timed(self, *a, **kw):
        sync()
        t0 = time.perf_counter()
        r = call0(self, *a, **kw)
        sync()
        dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        if self not in progs:
            progs.append(self)
        return r

    def at_second_dispatch(t_env, state, **_):
        if t_env == 0 or "digests" in seen:
            return
        tensors, _ = flatten_state(state)
        h = hashlib.sha256()
        for path in sorted(tensors):
            x = tensors[path]
            if not DataParallel.sharded(path, x):
                h.update(x.detach().cpu().contiguous().reshape(-1)
                         .view(torch.uint8).numpy().tobytes())
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, h.hexdigest(),
                               group=dd.control_group())
        seen["digests"] = digests

    cls.__call__ = timed
    resilience.register_fault("driver.iteration", at_second_dispatch)
    att.reset_launches()
    dk.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    os.environ["MASTER_PORT"] = str(next(ports))
    t0 = time.perf_counter()
    try:
        rc = cli.main(spec["k"])
    finally:
        cls.__call__ = call0
        resilience.clear_faults()
    prog = progs[0]
    seen.update(rc=rc, cli_s=time.perf_counter() - t0,
                launches=dict(att.LAUNCHES),
                peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                          if cuda else 0.0),
                dispatch_ms=dispatch_ms, segments=dict(prog.segments),
                nodes=dict(prog.nodes), capture_s=dict(prog.capture_s),
                instantiate_s=dict(prog.instantiate_s),
                programs=len(progs))
    del progs, prog
    # ---- 2. the classic dp loop from the same seed, with the test
    # rollouts where the K dispatches' driver ran them
    cfg = load_config(spec["config"], tuple(spec["overrides"]))
    k, n = cfg.superstep, spec["dispatches"]
    os.environ["MASTER_PORT"] = str(next(ports))
    dd.maybe_initialize_distributed(spec["device"],
                                    share_cards=spec["share"],
                                    timeout_s=300)
    try:
        dp = DataParallel(Experiment.build(cfg, dd.rank_device(),
                                           comm=RankComm()))
        exp = dp.exp
        ts = exp.init_state(cfg.seed)
        n_test = max(1, cfg.test_nepisode // cfg.batch_size_run)
        cursor, infos, states, warm_ms = None, [], [], []
        for d in range(n):
            ts, cursor, recs = run_classic(exp, ts, k, cursor, sync=True)
            infos += [r.info for r in recs]
            if d == n - 1:
                warm_ms = [(r.rollout_s + (r.train_s or 0.0)) * 1e3
                           for r in recs]
            for _ in range(n_test):
                rs, _, _ = exp.runner.run(ts.learner.params["agent"],
                                          ts.runner, test_mode=True)
                ts = dataclasses.replace(ts, runner=rs)
            full = dp.gather(ts)     # (the CPU's shares the live ring's)
            states.append((None if full is None else sm.clone_state(full),
                           cursor.key.tolist(), dp.digest(ts)))
        seen["classic_iteration_ms"] = warm_ms
        if rank == 0:
            # every leaf of each checkpoint against the classic state
            model_dir = _one_dir(os.path.join(spec["k_results"], "models",
                                              "*"))
            per = k * cfg.batch_size_run * cfg.env_args.episode_limit
            diffs, leaves = {}, 0
            for d, (full, key, _) in enumerate(states):
                found = find_checkpoint(model_dir, (d + 1) * per)
                step = (d + 1) * per
                saved = torch.load(os.path.join(found[0], "state.pt"),
                                   map_location="cpu", weights_only=True)
                mine = {p: x.cpu() for p, x in flatten_state(full)[0].items()}
                bad = sorted(set(mine) ^ set(saved)) + [
                    p for p in sorted(mine) if p in saved
                    and not torch.equal(mine[p], saved[p])]
                meta_key = read_meta(found[0])["driver"]["key"]
                if meta_key != key:
                    bad.append("driver.key")
                diffs[step] = bad
                leaves = len(mine)
            rows = _rows_of(spec["k_results"])
            sight_bad, sight_n = [], 0
            for d in range(n):
                step = (d + 1) * per
                last = [i for i in infos[:(d + 1) * k] if i is not None][-1]
                for key_name in sorted(last):
                    if not key_name.startswith("sight_"):
                        continue
                    sight_n += 1
                    if rows.get((key_name, step)) != _logged(last[key_name]):
                        sight_bad.append((key_name, step))
            seen.update(checkpoint_diffs=diffs, leaves=leaves,
                        sight_bad=sight_bad, sight_rows=sight_n,
                        losses=[rows.get(("loss", (d + 1) * per))
                                for d in range(n)])
        del dp, exp, ts, states
    finally:
        dd.shutdown()
    if cuda:
        torch.cuda.empty_cache()
    # ---- 3. dropout and NoisyNet noise under dp: one dispatch
    att.reset_launches()
    dk.reset_launches()
    os.environ["MASTER_PORT"] = str(next(ports))
    t0 = time.perf_counter()
    rc2 = cli.main(spec["options"])
    seen.update(options_rc=rc2, options_s=time.perf_counter() - t0,
                options_launches=dict(att.LAUNCHES),
                options_masks=dk.LAUNCHES["dropout_mask"])
    if rank == 0:
        seen["options_rows"] = {k: v for (k, _), v in
                                _rows_of(spec["o_results"]).items()
                                if k in ("loss", "grad_norm",
                                         "return_mean")}
    if restore is not None:
        restore()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(seen, f)
    return 0 if rc == 0 and rc2 == 0 else 1


def phase_dp_superstep(torch, att, smi: str, path: str = DPS_CONFIG,
                       extra=(), device: str = "cuda") -> dict:
    """Config 3 as shipped (``configs/config3_tpu_northstar.yaml``: 64
    AGVs x 8 MEC x 8 channels, emb 256, 4 heads, depth 2 for agent and
    mixer, bf16 with bf16 compact storage, 1024 lanes, ring 2048, batch
    32, ``superstep: 4``, ``obs.sight`` on) with ``kernels.attention=
    pallas`` at ``dp_devices=2``: both ranks on the one card over gloo
    (``--share-cards``) where the machine has one. T is cut from 150 to
    30. Each rank (``dp_superstep_rank_main``):

    1. the CLI, two K = 4 dispatches (each stage captured as segments
       split at the rank's collectives) with every cadence and a save at
       each: launches exact on every rank, the replicated state equal
       across the ranks at the second dispatch (a digest each) and at the
       saves (the driver's own check), the captured rollout one segment
       (no collective left in it);
    2. the classic dp loop (``run_classic``, 4 iterations a dispatch,
       the test rollouts where the driver ran them) from the same seed:
       every leaf of both checkpoints and the driver key equal to it bit
       for bit (ring, priorities, params, Adam, keys), and rank 0's logged
       ``sight_*`` rows equal to its info values;
    3. dropout and NoisyNet noise (``DPS_OPTIONS``), one dispatch: the
       loss finite, the replicated state equal across the ranks at the
       save, the flash and ``dropout_mask`` launches exact on every rank.

    The CLI's dispatch and the classic loop's K iterations are timed on
    rank 0 (both ranks share the card: every number is a rank's)."""
    import shutil
    import tempfile
    import numpy as np
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.parallel.distributed import free_port
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, path)
    share = (device == "cuda"
             and DPS_RANKS > torch.cuda.device_count())
    backend = "gloo" if share or device != "cuda" else "nccl"
    overrides = DPS_OVERRIDES + tuple(extra)
    cfg = load_config(path, overrides)
    ocfg = load_config(path, overrides + DPS_OPTIONS)
    k, b, t = cfg.superstep, cfg.batch_size_run, cfg.env_args.episode_limit
    per = k * b * t
    want = {key: DPS_DISPATCHES * k * v
            for key, v in loop_launches(cfg).items()}
    ot = ocfg.env_args.episode_limit
    n_test_o = max(1, ocfg.test_nepisode // ocfg.batch_size_run)
    want_o = {key: k * v for key, v in dropout_launches(ocfg).items()}
    want_o["flash_fwd"] += n_test_o * ot * ocfg.model.depth
    want_masks = k * dropout_mask_launches(ocfg)
    print(f"[dp-superstep] config 3 as shipped ({DPS_CONFIG}): "
          f"{cfg.env_args.agv_num} AGVs x {cfg.env_args.mec_num} MEC x "
          f"{cfg.env_args.num_channels} channels, emb {cfg.model.emb}, "
          f"{cfg.model.heads} heads, depth {cfg.model.depth}, "
          f"{cfg.model.dtype}, {b} lanes, ring {cfg.replay.buffer_size}, "
          f"batch {cfg.batch_size}, superstep {k}, obs.sight "
          f"{cfg.obs.sight.enabled}, kernels.attention=pallas, "
          f"dp_devices={DPS_RANKS} over {backend}"
          + (" on one card (--share-cards)" if share else "")
          + f"; cut: episode_limit 150 -> {t}", flush=True)
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_dps_", dir=root)
    k_res, o_res = os.path.join(tmp, "k"), os.path.join(tmp, "o")
    # the classic loop's config: the CLI's (PER's beta anneals over t_max)
    spec = {"device": device, "share": share, "config": path,
            "overrides": list(overrides) + [
                f"t_max={DPS_DISPATCHES * per - 1}"],
            "dispatches": DPS_DISPATCHES,
            "k": _dps_flags(cfg, path, overrides, k_res, DPS_DISPATCHES,
                            device, share),
            "options": _dps_flags(ocfg, path, overrides + DPS_OPTIONS,
                                  o_res, 1, device, share),
            "k_results": k_res, "o_results": o_res,
            "ports": [free_port() for _ in range(3)]}
    with open(os.path.join(tmp, "spec.json"), "w") as f:
        json.dump(spec, f)
    try:
        procs = _start_ranks(["--dp-superstep-rank", tmp], DPS_RANKS)
        codes = _wait_ranks(procs)
        check(codes == [0] * DPS_RANKS,
              f"[dp-superstep] the ranks exited with {codes}")
        ranks = []
        for r in range(DPS_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    for r in ranks:
        check(r["launches"] == want, f"[dp-superstep] rank {r['rank']}: "
                                     f"launches {r['launches']} != {want}")
        check(r["options_launches"] == want_o,
              f"[dp-superstep] rank {r['rank']} with dropout and noise: "
              f"launches {r['options_launches']} != {want_o}")
        check(r["options_masks"] == want_masks,
              f"[dp-superstep] rank {r['rank']}: {r['options_masks']} mask "
              f"launches, want {want_masks}")
        check(r["segments"].get("rollout") == 1,
              f"[dp-superstep] rank {r['rank']}: the rollout's segments "
              f"{r['segments']}")
        check(r["programs"] == 1 and len(r["dispatch_ms"])
              == DPS_DISPATCHES, f"[dp-superstep] rank {r['rank']}: "
                                 f"{r['programs']} programs, dispatches "
                                 f"{r['dispatch_ms']}")
    check(len(set(r0.get("digests", []))) == 1 and len(r0["digests"])
          == DPS_RANKS, f"[dp-superstep] the ranks' replicated state "
                        f"differs: {r0.get('digests')}")
    diffs = r0["checkpoint_diffs"]
    check(all(v == [] for v in diffs.values()),
          f"[dp-superstep] the K = {k} checkpoints differ from the classic "
          f"dp loop's state at {diffs}")
    check(not r0["sight_bad"] and r0["sight_rows"] > 0,
          f"[dp-superstep] {r0['sight_rows']} sight rows, these differ "
          f"from the classic loop's: {r0['sight_bad']}")
    check(all(v is not None and np.isfinite(v) for v in r0["losses"]),
          f"[dp-superstep] losses {r0['losses']}")
    orow = r0["options_rows"]
    check(np.isfinite(orow.get("loss", np.nan)),
          f"[dp-superstep] dropout and noise: rows {orow}")
    warm = r0["dispatch_ms"][-1]
    classic = sum(r0["classic_iteration_ms"])
    launches = {key: sum(r["launches"][key] + r["options_launches"][key]
                         for r in ranks) for key in want}
    summary = {
        "backend": backend, "shared_card": share, "dispatch_ms": warm,
        "first_dispatch_ms": r0["dispatch_ms"][0], "classic_ms": classic,
        "env_steps_per_s": per / (warm / 1e3),
        "classic_env_steps_per_s": per / (classic / 1e3),
        "segments": r0["segments"], "nodes": r0["nodes"],
        "capture_s": r0["capture_s"], "instantiate_s": r0["instantiate_s"],
        "peak_gib_by_rank": [r["peak_gib"] for r in ranks],
        "leaves": r0["leaves"], "sight_rows": r0["sight_rows"],
        "launches": launches,
        "mask_launches": sum(r["options_masks"] for r in ranks),
        "options_s": r0["options_s"], "cli_s": r0["cli_s"],
        "seconds": time.perf_counter() - t_phase}
    print(f"[dp-superstep] {DPS_RANKS} ranks, K = {k}, two dispatches and a "
          f"save at each: both checkpoints ({r0['leaves']} tensors each) and "
          f"the driver key equal bit for bit to the classic dp loop's "
          f"{DPS_DISPATCHES * k} iterations from the same seed (the test "
          f"rollouts where the driver ran them); {r0['sight_rows']} logged "
          f"sight rows equal to its; the replicated state equal across the "
          f"ranks; launches a rank {want}; losses {r0['losses']}", flush=True)
    print(f"[dp-superstep] dropout {DROPOUT} and noisy-new ({DPS_OPTIONS}): "
          f"one dispatch, rows {orow}; launches a rank {want_o}, "
          f"{want_masks} dropout_mask launches a rank; {r0['options_s']:.1f}"
          f" s", flush=True)
    print(f"[dp-superstep] timings ({smi}): a warm dispatch at "
          f"{DPS_RANKS} ranks {warm:.0f} ms (the first, with the captures, "
          f"{r0['dispatch_ms'][0]:.0f} ms) against the classic dp loop's "
          f"{k} iterations {classic:.0f} ms "
          f"({', '.join(f'{x:.0f}' for x in r0['classic_iteration_ms'])}); "
          f"env-steps/s {summary['env_steps_per_s']:.0f} against "
          f"{summary['classic_env_steps_per_s']:.0f}; segments a stage "
          f"{r0['segments']}, graph nodes {r0['nodes']}; capture s "
          + ", ".join(f"{s} {r0['capture_s'][s]:.2f} + "
                      f"{r0['instantiate_s'][s]:.2f}"
                      for s in r0['capture_s'])
          + "; peak by rank "
          + ", ".join(f"{x:.2f}" for x in summary["peak_gib_by_rank"])
          + f" GiB; CLI {r0['cli_s']:.1f} s; phase "
          f"{summary['seconds']:.1f} s", flush=True)
    return summary


# ================================================================== [sebulba]

SEBULBA_CONFIG = "configs/config3_sebulba.yaml"
#: episode_limit 150 -> 30 (the smoke's limit, PERF.md §4: the captures,
#: the eager classic iterations and the rollouts scale with T)
SEBULBA_OVERRIDES = ("kernels.attention=pallas", "env_args.episode_limit=30")
SEBULBA_LOCKSTEP = 2                # iterations held against the classic loop
#: the learner-set legs: 3 actor + this many learner streams on the card
SEBULBA_LEARNERS = 2
#: the learner-set step's episode length, at which the set's step equals
#: the blocked step bit for bit (the rest of [sebulba] runs at 30; at 30
#: the probe's own norm is one ulp off: scripts/torch_sebulba_set_bits.py)
SEBULBA_SET_T = 50
#: the lockstep check's actor set: one stream. The card's GEMMs give
#: results that depend on their row count (cuBLAS picks another kernel
#: for a 32-lane shard than for 96 lanes), so 3 shards act on other bits
#: than one 96-lane rollout; step 4 measures by how much
SEBULBA_LOCKSTEP_ACTORS = 1
SEBULBA_CLI = 5                     # iterations of the CLI's overlapped run
#: the CLI run's test cadence: at its first iteration only. The shipped
#: 10 000 env steps is about one iteration's (14 400 at T = 150, 4800 at
#: 50), so the iterations would drain the queue for their greedy rollouts
#: and no rollout would overlap a train step
SEBULBA_TEST_INTERVAL = 10 ** 9


class _SmiSampler:
    """``nvidia-smi``'s utilization.gpu (the share of each ~100 ms sample
    in which a kernel ran) sampled every 100 ms in a child process while
    the block runs → ``samples``: [(epoch seconds, percent)]."""

    def __enter__(self):
        import subprocess
        import tempfile
        self.out = tempfile.TemporaryFile(mode="w+")
        self.samples = []
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=self.out, stderr=subprocess.DEVNULL)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        import datetime
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 — never outlive the phase
                self.proc.kill()
                self.proc.wait()
        self.out.seek(0)
        self.samples = []
        for line in self.out:
            try:
                ts, util = [x.strip() for x in line.split(",")]
                when = datetime.datetime.strptime(
                    ts, "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.samples.append((when, float(util)))
            except ValueError:
                continue
        self.out.close()

    def share(self, t0: float, t1: float):
        """Mean utilization (0..1) of the samples in [t0, t1], or None."""
        xs = [u for t, u in self.samples if t0 <= t <= t1]
        return sum(xs) / len(xs) / 100.0 if xs else None


def _sebulba_cli(torch, att, smi: str, path: str, tmp: str, spr: int,
                 step: dict, recording, learners: int) -> dict:
    """``[sebulba]``'s CLI leg: the shipped queue (2 slots, staleness 1)
    through ``python -m t2omca_tpu_torch train --share-cards`` for
    ``SEBULBA_CLI`` iterations at ``learners`` learner placements (each a
    stream of the card), the test cadence at the first only, audited
    (``parallel/sebulba.Audit``: every batch's ring rows = its emission,
    every rollout's params within the staleness bound and equal to their
    publish, every learner placement's params at each publish placement
    0's). Checks the rows, a stamped and verified checkpoint, each
    placement's exact attention launches a learner step (a dp rank's) and
    the whole run's. → what it measured: env-steps/s (median
    learner-step period), ``obs report``'s utilization, nvidia-smi's busy
    share, device times, each graph's capture seconds, the peak."""
    import contextlib
    import io
    import numpy as np
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch.obs import report as obs_report
    from t2omca_tpu_torch.parallel import sebulba as seb_mod
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    tag = f"[sebulba] {learners} learner" + ("s" if learners > 1 else "")
    out = os.path.join(tmp, f"train{learners}")
    over = (f"sebulba.learner_devices={learners}",) if learners > 1 else ()
    args = ["train", "--config", path, "--share-cards",
            *SEBULBA_OVERRIDES, *over, f"t_max={SEBULBA_CLI * spr - 1}",
            f"test_interval={SEBULBA_TEST_INTERVAL}",
            f"save_model_interval={SEBULBA_CLI * spr}",
            f"log_interval={spr}", f"local_results_path={out}"]
    timed = []

    def timing(*a, **kw):
        timed.append(recording(*a, **kw))
        timed[-1].timing = True
        return timed[-1]
    seb_mod.make_sebulba = timing
    audit = seb_mod.AUDIT = seb_mod.Audit()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()             # ---- the driver path starts here
    t0 = time.time()
    try:
        with _SmiSampler() as smi_samples:
            rc = cli.main(args)
            torch.cuda.synchronize()
    finally:
        seb_mod.AUDIT = None
        seb_mod.make_sebulba = recording
    wall = time.time() - t0
    launches = dict(att.LAUNCHES)    # ---- and ends here
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    seb = timed[-1]
    check(rc == 0, f"{tag}: train returned {rc}")
    checked = audit.check(1)
    check(checked["batches"] == SEBULBA_CLI
          and checked["rollouts"] == SEBULBA_CLI
          and checked.get("replicas", 0) == (
              0 if learners == 1 else learners * checked["publishes"]),
          f"{tag}: the audit saw {checked}")
    rows = _metric_rows(out)
    keys = {r["key"] for r in rows}
    need = {"queue_depth", "actor_idle_s", "learner_idle_s", "loss",
            "return_mean", "test_return_mean"}
    check(need <= keys, f"{tag}: rows lack {sorted(need - keys)}")
    for r in rows:
        v = r["value"]
        check(all(np.isfinite(v if isinstance(v, list) else [v])),
              f"{tag}: non-finite {r}")
    n_train = sum(1 for r in rows if r["key"] == "loss")
    check(seb.seat_launches == [step] * learners and launches == {
        k: SEBULBA_CLI * learners * step[k] + seb.warm_launches[k]
        for k in step},
        f"{tag}: CLI launches {launches} for {SEBULBA_CLI} steps of "
        f"{seb.seat_launches} a placement (warm-up {seb.warm_launches})")
    models = _one_dir(os.path.join(out, "models", "*"))
    saved = ckpt.find_checkpoint(models)
    check(saved is not None and ckpt.verify_checkpoint(saved[0]),
          f"{tag}: no verified checkpoint")
    topo = ckpt.read_meta(saved[0])["topology"]
    check(topo.get("loop") == "sebulba" and topo.get("sebulba") == {
        "actor_devices": 3, "learner_devices": learners},
        f"{tag}: checkpoint stamp {topo}")
    run_dir = _one_dir(os.path.join(out, "qmix*"))
    events = obs_report.load_events(run_dir)
    util = obs_report.sebulba_utilization(
        events, obs_report.phase_summary(events))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_r = obs_report.report_main(run_dir)
    check(rc_r == 0 and "sebulba utilization" in buf.getvalue(),
          f"{tag}: obs report printed no sebulba table")
    spans = [e for e in events if e.get("event") == "span"]
    learn = sorted(float(e["t0"]) for e in spans
                   if e.get("phase") == "learner.dispatch")
    gaps_ms = [1e3 * (b - a) for a, b in zip(learn, learn[1:])]
    rates = [r["value"] for r in rows if r["key"] == "env_steps_per_sec"]
    busy = (smi_samples.share(learn[1], learn[-1])
            if len(learn) > 2 else None)
    roll_dev = [max(e0.elapsed_time(e1) for e0, e1 in shards)
                for shards in seb.events["rollout"]]
    learn_dev = ([max(e0.elapsed_time(e1) for e0, e1 in seats)
                  for seats in seb.events["learner_set"]]
                 if learners > 1 else
                 [e0.elapsed_time(e1) for e0, e1 in seb.events["learner"]])
    seb.timing = False
    idle = {k: [r["value"] for r in rows if r["key"] == k][-1]
            for k in ("actor_idle_s", "learner_idle_s", "queue_depth")}
    steady = sorted(gaps_ms)[len(gaps_ms) // 2] if gaps_ms else None
    seb_rate = spr / (steady / 1e3) if steady else None
    print(f"{tag}: python -m t2omca_tpu_torch train --config "
          f"{SEBULBA_CONFIG} --share-cards {' '.join(SEBULBA_OVERRIDES)} "
          f"{' '.join(over)} t_max={SEBULBA_CLI * spr - 1} "
          f"test_interval={SEBULBA_TEST_INTERVAL} "
          f"save_model_interval={SEBULBA_CLI * spr} log_interval={spr} "
          f"({seb.describe()}): {n_train} train steps, launches "
          f"{launches} ({seb.seat_launches} a placement a step), "
          f"{len(rows)} rows, last queue_depth {idle['queue_depth']:g}, "
          f"actor_idle_s {idle['actor_idle_s']:g}, learner_idle_s "
          f"{idle['learner_idle_s']:g}; checkpoint at {saved[1]} verified, "
          f"stamp {topo['sebulba']}; audit {checked}; whole call "
          f"{wall:.1f} s ({smi})", flush=True)
    print(f"{tag}: learner steps start every "
          f"{', '.join(f'{x:.0f}' for x in gaps_ms)} ms (device ms, "
          f"overlapped: rollouts, the slowest shard "
          f"{', '.join(f'{x:.0f}' for x in roll_dev)}; learner steps, the "
          f"slowest placement {', '.join(f'{x:.0f}' for x in learn_dev)}); "
          f"env_steps_per_sec rows {', '.join(f'{x:.0f}' for x in rates)}; "
          f"env-steps/s (median learner-step period) {seb_rate or 0:.0f}; "
          f"obs report utilization actor {util['actor']['util_pct']}% "
          f"learner {util['learner']['util_pct']}%; nvidia-smi busy "
          f"{100 * (busy or 0):.1f}% between the 2nd and last learner step; "
          f"peak {peak:.2f} GiB; captures s "
          + ", ".join(f"{k} {v:.2f}" for k, v in seb.capture_s.items())
          + f" ({smi})", flush=True)
    print(buf.getvalue().rstrip(), flush=True)
    return {"launches": launches, "seat_launches": seb.seat_launches,
            "rollout_device_ms": roll_dev, "learner_device_ms": learn_dev,
            "learner_gaps_ms": gaps_ms, "rates": rates,
            "env_steps_per_s": seb_rate, "util": util, "busy_share": busy,
            "peak_gib": peak, "capture_s": dict(seb.capture_s),
            "audit": checked, "cli_s": wall}


def _sebulba_blocked_step(torch, att, smi: str, path: str,
                          t: int = SEBULBA_SET_T,
                          detail: bool = False) -> dict:
    """``[sebulba]``'s learner-set step at episode length ``t``: lockstep
    at 3 actor and ``SEBULBA_LEARNERS`` learner placements (streams of
    the card), one
    rollout into the ring, then one learner step of the set (each
    placement's captured segments, the collectives between them) against
    the step the placements should take, computed at world 1 on one
    stream from the same state and key over the same row blocks without
    the learner's dp code (``_blocked_step_probe``): bit for bit, or the
    largest difference against ``[dp]``'s bounds; each placement's
    launches exact (a dp rank's count); the values finite; each
    placement's capture seconds; the leaves that differ. ``detail``
    adds the probe's ``block_grads`` and the params' ``leaf_sizes``
    (name, numel) in the learner's leaf order."""
    import dataclasses
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import (SebulbaConfig, load_config,
                                         sanity_check)
    from t2omca_tpu_torch.parallel import sebulba as seb_mod
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.train.superstep import clone_state
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    n = SEBULBA_LEARNERS
    cut = SEBULBA_OVERRIDES + (f"env_args.episode_limit={t}",)
    spr = load_config(path, cut).batch_size_run * t
    # [sebulba]'s quiet cadences, and lockstep at n learner placements
    cfg = load_config(path, cut + (
        f"test_interval={10 ** 9}", "save_model=false",
        f"t_max={SEBULBA_LOCKSTEP * spr - 1}", f"log_interval={spr}",
        "sebulba.queue_slots=1", "sebulba.staleness=0",
        f"sebulba.learner_devices={n}"))
    step = loop_launches(cfg)
    exp = Experiment.build(cfg)
    seb = seb_mod.make_sebulba(exp, share_cards=True)
    try:
        seb.init_states(cfg.seed)
        seb.init_queue()
        capture_s = seb.capture()
        seb.adopt(seb.publish())
        tms, _ = seb.actor_step()
        seb.queue_put(0, tms)
        seb.queue_get(0)
        seb.sync_learner()
        ts0 = clone_state(seb.join())
        pri0 = seb.ls.buffer.priorities.cpu().clone()
        key = prng.split(prng.PRNGKey(cfg.seed + 7, exp.device))[0]
        ref = Experiment.build(sanity_check(dataclasses.replace(
            cfg, sebulba=SebulbaConfig())))
        train_iter = ref.programs()[2]
        beta = torch.full((), ref.buffer.per_beta(spr), device=ref.device)
        seen, restore = _blocked_step_probe(torch, n, detail)
        try:
            train_iter(ts0, key, spr, beta=beta)
            torch.cuda.synchronize()
        finally:
            restore()
        del ts0, ref, train_iter
        att.reset_launches()
        t0 = time.perf_counter()
        info = seb.learner_step(key, spr)
        seb.sync_learner()
        step_ms = 1e3 * (time.perf_counter() - t0)
        launches = dict(att.LAUNCHES)
        ls = seb.ls.learner
        got = {k: v.detach().cpu() for k, v in flatten_state(
            {"params": ls.params, "opt_state": ls.opt_state})[0].items()}
        want = seen["learner"]
        check(set(got) == set(want), "[sebulba] the learner set's state "
                                     "has other leaves than the probe's")
        exact = [k for k in want if torch.equal(got[k], want[k])]
        cat = lambda src, keys: torch.cat([src[k].float().flatten()
                                           for k in keys])
        pkeys = [k for k in want if k.startswith("params.")]
        diffs = (cat(got, pkeys) - cat(want, pkeys)).abs()
        off = float((diffs > 1e-5).float().mean())
        mu = [k for k in want if k.startswith("opt_state.mu.")]
        mu_ref = cat(want, mu)
        rel_mu = float((cat(got, mu) - mu_ref).norm()
                       / mu_ref.norm().clamp(min=1e-30))
        loss, norm = float(info["loss"]), float(info["grad_norm"])
        rel, rel_norm = _rel(loss, seen["loss"]), _rel(norm,
                                                       seen["grad_norm"])
        pri_want = pri0.clone()
        pri_want[seen["idx"]] = seen["pa"]
        pri = seb.ls.buffer.priorities.cpu()
        pr_rel = float(((pri - pri_want).abs()
                        / pri_want.abs().clamp(min=1e-30)).max())
        finite = all(bool(torch.isfinite(v).all()) for v in info.values()
                     if v.is_floating_point())
        seats = seb.seat_launches
        print(f"[sebulba] T={t}: a learner set of {n} ({seb.describe()}), one step "
              f"from the state after one rollout, against the blocked step "
              f"at world 1 (the same {n} row blocks of the sampled batch, "
              f"the gradients summed in placement order): "
              f"{'bit for bit' if len(exact) == len(want) else 'not bit for bit'}"
              f" ({len(exact)} of {len(want)} leaves equal); loss {loss:.8g} "
              f"rel {rel:.2e} (limit {DP_LOSS_RTOL:.0e}); pre-clip grad norm "
              f"{norm:.8g} rel {rel_norm:.2e}, Adam's first moment rel "
              f"{rel_mu:.2e} (limit {DP_STEP_RTOL:.0e} each); params max "
              f"|diff| {float(diffs.max()):.3e}, {100 * off:.3f}% above 1e-5; "
              f"priorities max rel {pr_rel:.2e}; launches a placement "
              f"{seats}; graphs a placement's train stage "
              f"{[getattr(x.train_graph, 'count', 0) for x in seb.seats]}, "
              f"nodes "
              f"{[getattr(x.train_graph, 'nodes', 0) for x in seb.seats]};"
              f" the step "
              f"{step_ms:.0f} ms; captures s "
              + ", ".join(f"{k} {v:.2f}" for k, v in capture_s.items())
              + f" ({smi})", flush=True)
        check(finite, f"[sebulba] the learner set's info: {info}")
        check(seats == [step] * n and launches == {
            k: n * step[k] for k in step},
            f"[sebulba] the learner set's launches {launches} "
            f"({seats} a placement, want {step} each)")
        check(rel <= DP_LOSS_RTOL, f"[sebulba] loss rel {rel:.2e}")
        check(rel_norm <= DP_STEP_RTOL and rel_mu <= DP_STEP_RTOL
              and pr_rel <= DP_STEP_RTOL,
              f"[sebulba] grad norm rel {rel_norm:.2e}, first moment rel "
              f"{rel_mu:.2e}, priorities rel {pr_rel:.2e}")
        check(off <= 0.01 and float(diffs.max()) <= 2 * cfg.lr,
              f"[sebulba] params: {100 * off:.3f}% above 1e-5, max "
              f"{float(diffs.max()):.3e}")
        out = {"bit_for_bit": len(exact) == len(want),
               "leaves_equal": len(exact), "leaves": len(want),
               "differ": [k for k in want if k not in set(exact)],
               "loss_rel": rel, "grad_norm_rel": rel_norm,
               "grad_norm": norm, "probe_grad_norm": seen["grad_norm"],
               "mu_rel": rel_mu, "params_max_diff": float(diffs.max()),
               "priorities_rel": pr_rel, "seat_launches": seats,
               "segments": [getattr(x.train_graph, "count", 0)
                            for x in seb.seats],
               "step_ms": step_ms, "capture_s": capture_s}
        if out["differ"]:
            print(f"[sebulba] the learner set's leaves that differ from the "
                  f"blocked step: {', '.join(out['differ'][:6])}"
                  f"{' ...' if len(out['differ']) > 6 else ''}", flush=True)
        if detail:
            out.update(block_grads=seen["block_grads"], leaf_sizes=[
                (f"{m}.{k}", p.numel()) for m, sub in ls.params.items()
                for k, p in sub.items()])
        return out
    finally:
        seb.close()


def phase_sebulba(torch, att, smi: str, path: str = SEBULBA_CONFIG,
                  one_card: bool = True) -> dict:
    """``configs/config3_sebulba.yaml`` at its widths (96 lanes, 64 AGVs,
    emb 256, bf16, ring 2048, batch 32; T cut to 30, the learner-set
    step's to ``SEBULBA_SET_T``) with
    kernels.attention=pallas, its 3 + 1 split as CUDA streams on the one
    card (``--share-cards``):

    1. lockstep (queue_slots=1, staleness=0) for ``SEBULBA_LOCKSTEP``
       iterations against the classic loop (``run_sequential``'s, with the
       test cadence's greedy rollout at the first iteration in both) from
       the same seed: every leaf of the final ``TrainState`` bit for bit;
       the classic iterations' stage times and ``superstep_program(1)``
       dispatches' (the same graphs, one after another);
    2. without ``--share-cards`` the CLI refuses the split on one card;
    3. the shipped queue (2 slots, staleness 1) through ``python -m
       t2omca_tpu_torch train --share-cards`` for ``SEBULBA_CLI``
       iterations, the test cadence at the first only: the
       queue_depth / actor_idle_s / learner_idle_s rows, a stamped and
       verified checkpoint, env-steps/s, ``obs report``'s utilization,
       nvidia-smi's busy share, the peak, each graph's capture seconds,
       each learner step's exact attention launches, and the race checks
       (``parallel/sebulba.Audit``: every batch's ring rows = its
       emission, every rollout's params within the staleness bound and
       equal to their publish);
    4. the 3 shards against one 96-lane rollout from the same state;
    5. a learner set of ``SEBULBA_LEARNERS`` (3 actor + 2 learner
       streams): one step of the set against the blocked step
       (``_sebulba_blocked_step``), then step 3's CLI leg at 2 learner
       placements, its env-steps/s and utilization against step 3's.

    ``path`` (a rehearsal's smaller config) skips the shipped-widths
    check; ``one_card=False`` skips step 2."""
    import contextlib
    import dataclasses
    import gc
    import io
    import shutil
    import tempfile
    import numpy as np
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import (SebulbaConfig, load_config,
                                         sanity_check)
    from t2omca_tpu_torch.obs import report as obs_report
    from t2omca_tpu_torch.parallel import sebulba as seb_mod
    from t2omca_tpu_torch.run import Experiment, run
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    from t2omca_tpu_torch.utils.logging import Logger
    root = os.path.dirname(os.path.abspath(__file__))
    shipped = path == SEBULBA_CONFIG
    path = os.path.join(root, path)
    cfg = load_config(path, SEBULBA_OVERRIDES)
    sb = cfg.sebulba
    check(not shipped or cfg.batch_size_run == 96 and cfg.env_args.agv_num == 64
          and cfg.model.emb == 256 and cfg.model.dtype == "bfloat16"
          and cfg.replay.buffer_size == 2048 and cfg.batch_size == 32
          and (sb.actor_devices, sb.learner_devices, sb.queue_slots,
               sb.staleness) == (3, 1, 2, 1),
          f"[sebulba] {SEBULBA_CONFIG} is not as shipped")
    spr = cfg.batch_size_run * cfg.env_args.episode_limit
    step = loop_launches(cfg)
    built = []
    make = seb_mod.make_sebulba

    def recording(*a, **kw):
        built.append(make(*a, **kw))
        return built[-1]
    seb_mod.make_sebulba = recording
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_sebulba_", dir=root)
    result = {}
    try:
        # 1. lockstep against the classic loop (the driver's, so the test
        # cadence's first-iteration rollout is in both), and the same
        # iterations as superstep_program(1)'s captured graphs
        # a log cadence every iteration (the stage times, the rows)
        quiet = (f"test_interval={10 ** 9}", "save_model=false",
                 f"t_max={SEBULBA_LOCKSTEP * spr - 1}",
                 f"log_interval={spr}")
        classic_dir = os.path.join(tmp, "classic")
        classic_cfg = sanity_check(dataclasses.replace(
            load_config(path, SEBULBA_OVERRIDES + quiet + (
                "profile_stages=true",
                f"local_results_path={classic_dir}")),
            sebulba=SebulbaConfig()))
        ts = run(classic_cfg, Logger())
        want, want_host = ckpt.flatten_state(ts)
        want = {k: v.detach().cpu() for k, v in want.items()}
        del ts
        stage = {}
        for r in _metric_rows(classic_dir):
            if r["key"] in ("time_rollout_ms", "time_train_ms"):
                stage.setdefault(r["t"], {})[r["key"]] = r["value"]
        classic_ms = [sum(v.values()) for _, v in sorted(stage.items())]
        exp = Experiment.build(classic_cfg)
        ts = exp.init_state(classic_cfg.seed)
        sup = exp.superstep_program(1)
        mirror = {"key": prng.PRNGKey(classic_cfg.seed + 1, exp.device),
                  "t_env": 0, "episode": 0, "filled": 0}
        # the first dispatch captures (or, in a process that has not run
        # a superstep, warms up and the second captures): the last replays
        sup_ms, sup_dev = [], []
        for i in range(3):
            sup.timing = i == 2
            t0 = time.perf_counter()
            ts, _, _, _ = fused_dispatch(torch, sup, ts, mirror)
            torch.cuda.synchronize()
            sup_ms.append(1e3 * (time.perf_counter() - t0))
            sup_dev += [(e0.elapsed_time(e1), e1.elapsed_time(e2))
                        for e0, e1, e2 in sup.events]
        sup.timing = False
        sup.close()
        del sup, ts, exp
        gc.collect()
        torch.cuda.empty_cache()
        lock_cfg = load_config(path, SEBULBA_OVERRIDES + quiet + (
            "sebulba.queue_slots=1", "sebulba.staleness=0",
            f"sebulba.actor_devices={SEBULBA_LOCKSTEP_ACTORS}",
            f"local_results_path={os.path.join(tmp, 'lockstep')}"))
        att.reset_launches()
        got_ts = run(lock_cfg, Logger(), share_cards=True)
        lock_launches = dict(att.LAUNCHES)
        seb = built[-1]
        got, got_host = ckpt.flatten_state(got_ts)
        bad = [k for k in want if k not in got
               or not torch.equal(got[k].detach().cpu(), want[k])]
        check(set(got) == set(want) and not bad and got_host == want_host,
              f"[sebulba] lockstep ({seb.describe()}) differs "
              f"from the classic loop after {SEBULBA_LOCKSTEP} iterations: "
              f"{bad[:8]} of {len(want)} leaves; host {got_host} against "
              f"{want_host}")
        check(seb.learner_launches == step,
              f"[sebulba] a learner step's replay launches "
              f"{seb.learner_launches}, not {step}")
        check(lock_launches == {k: SEBULBA_LOCKSTEP * step[k]
                                + seb.warm_launches[k] for k in step},
              f"[sebulba] lockstep launches {lock_launches} (warm-up "
              f"{seb.warm_launches})")
        print(f"[sebulba] lockstep (queue_slots=1, staleness=0, "
              f"{seb.describe()}): {SEBULBA_LOCKSTEP} iterations bit for bit "
              f"equal to the classic loop ({len(want)} leaves: learner, Adam, "
              f"ring, priorities, runner, episode); classic iterations ms "
              f"{', '.join(f'{x:.0f}' for x in classic_ms)}; "
              f"superstep_program(1) dispatches ms "
              f"{', '.join(f'{x:.0f}' for x in sup_ms)} (device rollout + "
              f"train ms "
              + ", ".join(f"{x:.0f} + {y:.0f}" for x, y in sup_dev)
              + f"); a learner step "
              f"launches {seb.learner_launches}", flush=True)
        del got_ts, got, want, seb
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()
        # 2. one card without --share-cards: refused, naming the count
        refused = None if one_card else "needs 3+1=4 devices, have 1 " \
            "--share-cards"
        try:
            if one_card:
                cli.main(["train", "--config", path, *SEBULBA_OVERRIDES,
                          f"local_results_path="
                          f"{os.path.join(tmp, 'refused')}"])
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "needs 3+1=4 devices, have 1"
              in refused and "--share-cards" in refused,
              f"[sebulba] one card without --share-cards: {refused}")
        # 3. the shipped queue through the CLI, overlapped, audited
        cli_one = _sebulba_cli(torch, att, smi, path, tmp, spr, step,
                               recording, 1)
        seb = built[-1]
        # 4. the 3 shards against one 96-lane rollout from the same state
        # and params (the shards' graphs against the eager rollout)
        from t2omca_tpu_torch.parallel.sebulba import tm_leaves
        from t2omca_tpu_torch.train.superstep import clone_state
        rs = clone_state(seb.join().runner)
        eps = seb.exp.runner.epsilons(rs.t_env).to(seb.exp.device)
        _, one, _ = seb.exp.runner.run_raw(seb.shards[0].params, rs,
                                           eps=eps)
        tms, _ = seb.actor_step()
        seb.queue_put(0, tms)
        torch.cuda.synchronize()
        three = seb.queue.slots[0]
        first_obs = all(torch.equal(a[0], b[0]) for a, b in zip(
            tm_leaves(one)[:4], tm_leaves(three)[:4]))
        flips = (one.actions != three.actions).float()
        first_flip = (int(flips.amax(dim=(1, 2)).nonzero()[0])
                      if flips.any() else None)
        shards = {"first_obs_equal": first_obs,
                  "actions_differ": float(flips.mean()),
                  "first_step_differing": first_flip,
                  "reward_max_abs": float((one.reward - three.reward)
                                          .abs().max())}
        check(first_obs, "[sebulba] the 3 shards' first observations "
                         "differ from one rollout's (a lane mix-up)")
        print(f"[sebulba] 3 shards of 32 lanes against one rollout of 96 "
              f"from the same state and params: t=0 observations equal; "
              f"actions differ in {100 * shards['actions_differ']:.3f}% "
              f"(first at step {first_flip}), rewards up to "
              f"{shards['reward_max_abs']:.3g} apart", flush=True)
        del one, three, tms, rs, seb
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()
        classic_rate = spr / (np.median(classic_ms) / 1e3)
        sup_rate = spr / (sup_ms[-1] / 1e3)
        print(f"[sebulba] 1 learner: env-steps/s {cli_one['env_steps_per_s'] or 0:.0f} "
              f"against run_classic {classic_rate:.0f} and "
              f"superstep_program(1) {sup_rate:.0f} ({smi})", flush=True)
        # 5. a learner set of SEBULBA_LEARNERS placements: 3 actor + 2
        # learner streams on the card; one step of the set against the
        # blocked step, then the CLI leg as step 3's
        blocked = _sebulba_blocked_step(torch, att, smi, path)
        gc.collect()
        torch.cuda.empty_cache()
        cli_set = _sebulba_cli(torch, att, smi, path, tmp, spr, step,
                               recording, SEBULBA_LEARNERS)
        ratio = ((cli_set["env_steps_per_s"] or 0)
                 / max(cli_one["env_steps_per_s"] or 0, 1e-9))
        print(f"[sebulba] {SEBULBA_LEARNERS} learner placements against 1 "
              f"({smi}): env-steps/s {cli_set['env_steps_per_s'] or 0:.0f} "
              f"against {cli_one['env_steps_per_s'] or 0:.0f} ({ratio:.3f}x); "
              f"utilization actor {cli_set['util']['actor']['util_pct']}% "
              f"against {cli_one['util']['actor']['util_pct']}%, learner "
              f"{cli_set['util']['learner']['util_pct']}% against "
              f"{cli_one['util']['learner']['util_pct']}%; learner step "
              f"device ms (median) "
              f"{np.median(cli_set['learner_device_ms']):.0f} against "
              f"{np.median(cli_one['learner_device_ms']):.0f}; nvidia-smi "
              f"busy {100 * (cli_set['busy_share'] or 0):.1f}% against "
              f"{100 * (cli_one['busy_share'] or 0):.1f}%", flush=True)
        result.update({
            "shards": shards,
            "launches": {k: lock_launches[k] + cli_one["launches"][k]
                         + cli_set["launches"][k] for k in step},
            "classic_ms": classic_ms, "superstep1_ms": sup_ms,
            "superstep1_device_ms": sup_dev,
            "classic_env_steps_per_s": classic_rate,
            "superstep1_env_steps_per_s": sup_rate,
            "one_learner": cli_one, "learner_set": cli_set,
            "blocked": blocked, "set_ratio": ratio})
    finally:
        seb_mod.make_sebulba = make
        seb_mod.AUDIT = None
        built.clear()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return result


# ============================================== population over devices

#: [pop-dp]'s CLI run: config 7 over this many ranks, two whole members a
#: rank, for [population]'s CLI's two dispatches at VARIANT_T (its t_max:
#: PER's beta anneals over it): the first is held against [population]'s
#: one-process checkpoint, the second (a replay: the ranks warm their
#: stages before the run) is timed
POP_DP_RANKS = 2
POP_DP_DISPATCHES = 2
#: its PBT variant: one member a rank, so every copy crosses ranks
POP_DP_PBT_RANKS = 4
#: [pop-sebulba]: config 7's members over 2 actor streams, 1 learner, for
#: this many lockstep iterations against the classic population loop
POP_SEBULBA = ("sebulba.actor_devices=2", "sebulba.learner_devices=1",
               "sebulba.queue_slots=1", "sebulba.staleness=0")
POP_SEBULBA_ITERATIONS = 4
#: [pop-reshape]: the population sizes [population]'s P = 4 checkpoint
#: is restored under (a ranked shrink, then a grow)
POP_RESHAPE = (2, 6)


def _pop_cli_args(cfg7: str, per: int) -> list:
    """[population]'s CLI arguments at VARIANT_T, without its pulse port:
    what its checkpoints came from (``profile_stages`` syncs after each
    dispatch, so its ``time_superstep_ms`` row is the device's)."""
    return ["train", "--config", cfg7, *POPULATION_OVERRIDES,
            f"env_args.episode_limit={VARIANT_T}", f"log_interval={per}",
            f"runner_log_interval={per}", f"t_max={2 * per - 1}",
            f"test_interval={2 * per}", f"save_model_interval={per}",
            "profile_stages=true"]


def _state_file(dirname: str):
    import torch
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    return torch.load(os.path.join(dirname, ckpt.STATE_FILE),
                      weights_only=True)


def pop_dp_rank_main(argv) -> int:
    """``python -m chip_smoke --pop-dp-rank OUT <the CLI's arguments>``:
    one rank of [pop-dp]'s CLI runs, started with the launcher's
    variables (``_start_ranks``). Without PBT it first runs one fused
    iteration of the config eagerly on a scratch state (the process's
    warm-up of the stages, so the run's first dispatch captures and its
    second replays). Once ``OUT/go`` exists it runs the port's CLI and
    writes ``OUT/rank<r>.json`` (the rank's members, its kernel launches,
    wall seconds and peak). With ``population.pbt.enabled=true`` a
    ``driver.iteration`` hook at the top of the second dispatch (after the
    first's save and PBT) writes the rank's members to
    ``OUT/members<r>.pt`` and stops the run there."""
    import torch
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.kernels import build
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.train.superstep import SuperstepProgram
    from t2omca_tpu_torch.utils import resilience
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    build.build()
    build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, cli_argv = argv[0], argv[1:]
    rank = int(os.environ["RANK"])
    pbt = "population.pbt.enabled=true" in cli_argv
    if not pbt:
        cfg = load_config(cli_argv[cli_argv.index("--config") + 1],
                          tuple(a for a in cli_argv if "=" in a
                                and not a.startswith("--")))
        dev = torch.device("cuda", 0 if "--share-cards" in cli_argv
                           else int(os.environ["LOCAL_RANK"]))
        exp = Experiment.build(cfg, dev)
        warm = SuperstepProgram(exp, 1, member=0)
        warm._dispatch(exp.init_state(cfg.seed),
                       torch.zeros((1, 2), dtype=torch.int64, device=dev),
                       0, [True])
        warm.close()
        del warm, exp
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    end = time.monotonic() + 900
    while not os.path.exists(os.path.join(out, "go")):
        if time.monotonic() > end:
            return 1
        time.sleep(0.05)
    seen = {}

    def at_dispatch(t_env, state, guard, **_):
        seen.setdefault("members", list(state.members))
        if pbt and t_env and "dumped" not in seen:
            seen["dumped"] = True
            torch.save({m: {k: v.detach().cpu()
                            for k, v in flatten_state(st)[0].items()}
                        for m, st in zip(state.members, state.ts)},
                       os.path.join(out, f"members{rank}.pt"))
            guard.request("smoke")

    resilience.register_fault("driver.iteration", at_dispatch)
    att.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(cli_argv)
    seen.update(rank=rank, launches=dict(att.LAUNCHES),
                wall_s=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(seen, f)
    return rc


def phase_pop_dp(torch, att, smi: str, population: dict) -> dict:
    """Config 7 (4 members, the lr grid, the scenario salt, K = 4, f32,
    kernels.attention=pallas) over data-parallel ranks, at VARIANT_T,
    through ``python -m t2omca_tpu_torch train`` (the ranks as the
    launcher starts them; on one card they share it over gloo with
    ``--share-cards``, with more cards NCCL, a card a rank):

    1. ``dp_devices=2``, two whole members a rank, [population]'s CLI's
       two dispatches: the checkpoint after each (rank 0 gathers every
       member) bit for bit [population]'s one-process CLI checkpoint at
       that step (every member's tensors, the spec, the host values, the
       driver keys, the member ranking); each rank's launches
       POP_DP_DISPATCHES x 2 members x K x a train replay; experiments/s
       of the last dispatch against [population]'s CLI's last;
    2. its PBT variant at ``dp_devices=4`` (a member a rank: every copy
       crosses ranks), released once the dp ranks have exited, so the
       timed dispatch shares the card with its own two ranks alone; one
       dispatch, the save, PBT: the members after PBT,
       gathered from the ranks, bit for bit ``population.pbt_step`` in
       this process on that checkpoint with the ranking it stamps."""
    import shutil
    import tempfile
    from t2omca_tpu_torch import population as pop
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    root = os.path.dirname(os.path.abspath(__file__))
    cfg7 = os.path.join(root, POPULATION_CONFIG)
    cut_t = f"env_args.episode_limit={VARIANT_T}"
    cfg = load_config(cfg7, POPULATION_OVERRIDES + (cut_t,))
    p, k, b = cfg.population.size, cfg.superstep, cfg.batch_size_run
    per = k * b * VARIANT_T
    check(per == population["cli_per"], f"[pop-dp] a dispatch is {per} "
          f"env steps, [population]'s CLI {population['cli_per']}")
    step = loop_launches(cfg)
    refs = {at: (_state_file(d), ckpt.read_meta(d))
            for at, d in population["cli_checkpoints"].items()}
    ref = refs[per][0]
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_popdp_", dir=root)
    try:
        runs = {}
        for name, world, extra in (
                ("dp", POP_DP_RANKS, []),
                ("pbt", POP_DP_PBT_RANKS,
                 ["population.pbt.enabled=true",
                  "resilience.emergency_checkpoint=false"])):
            out = os.path.join(tmp, name)
            os.makedirs(out)
            share = world > torch.cuda.device_count()
            argv = (["--pop-dp-rank", out]
                    + _pop_cli_args(cfg7, per)
                    + [f"dp_devices={world}",
                       f"local_results_path={os.path.join(out, 'res')}",
                       *extra] + (["--share-cards"] if share else []))
            runs[name] = {"out": out, "world": world, "share": share,
                          "procs": _start_ranks(argv, world)}
        # one set on the card at a time: the PBT ranks wait (idle, before
        # their first dispatch) until the dp ranks, whose dispatch is
        # timed, have exited
        codes, wall = {}, {}
        try:
            for n, r in runs.items():
                t0 = time.time()
                open(os.path.join(r["out"], "go"), "w").close()
                codes[n] = _wait_ranks(r["procs"], 600)
                wall[n] = time.time() - t0
        finally:
            for r in runs.values():
                _wait_ranks([q for q in r["procs"] if q.poll() is None], 0)
        for n, r in runs.items():
            check(codes[n] == [0] * r["world"],
                  f"[pop-dp] the {n} ranks exited {codes[n]}")
            r["ranks"] = []
            for i in range(r["world"]):
                with open(os.path.join(r["out"], f"rank{i}.json")) as f:
                    r["ranks"].append(json.load(f))
        # 1. two members a rank against the one-process population
        dp = runs["dp"]
        res = os.path.join(dp["out"], "res")
        models = _one_dir(os.path.join(res, "models", "*"))
        steps = sorted(int(x) for x in os.listdir(models) if x.isdigit())
        check(steps == sorted(refs), f"[pop-dp] checkpoints at {steps}, "
                                     f"[population]'s at {sorted(refs)}")
        for at, (want, want_meta) in sorted(refs.items()):
            got = _state_file(os.path.join(models, str(at)))
            meta = ckpt.read_meta(os.path.join(models, str(at)))
            bad = [n for n in want if n not in got
                   or not torch.equal(got[n], want[n])]
            topo = meta["topology"]
            check(set(got) == set(want) and not bad
                  and meta["host"] == want_meta["host"]
                  and meta["driver"] == want_meta["driver"]
                  and topo.get("member_ranking")
                  == want_meta["topology"].get("member_ranking"),
                  f"[pop-dp] the 2-rank checkpoint at {at} differs from "
                  f"[population]'s one-process one: {bad[:5]} of "
                  f"{len(want)} tensors; ranking "
                  f"{topo.get('member_ranking')} against "
                  f"{want_meta['topology'].get('member_ranking')}")
            check((topo["population"], topo["process_count"],
                   topo["mesh_shape"]) == (p, POP_DP_RANKS,
                                           [POP_DP_RANKS]),
                  f"[pop-dp] stamp {topo}")
        per_rank = p // POP_DP_RANKS
        want = {n: POP_DP_DISPATCHES * per_rank * k * v
                for n, v in step.items()}
        check(all(r["launches"] == want for r in dp["ranks"]),
              f"[pop-dp] launches by rank {[r['launches'] for r in dp['ranks']]}"
              f", want {want}")
        disp = [r["value"] for r in _metric_rows(res)
                if r["key"] == "time_superstep_ms"]
        check(len(disp) == POP_DP_DISPATCHES, f"[pop-dp] rank 0's "
                                              f"dispatch rows {disp}")
        one_ms = population["cli_superstep_ms"][-1]
        eps_dp, eps_one = p * k / (disp[-1] / 1e3), p * k / (one_ms / 1e3)
        print(f"[pop-dp] python -m t2omca_tpu_torch train --config "
              f"{POPULATION_CONFIG} {' '.join(POPULATION_OVERRIDES)} {cut_t} "
              f"dp_devices={POP_DP_RANKS}"
              + (" --share-cards" if dp["share"] else "")
              + f": {POP_DP_RANKS} ranks over "
              f"{'gloo on one card' if dp['share'] else 'NCCL'}, members "
              f"{[r['members'] for r in dp['ranks']]}"
              f"; the checkpoints at {sorted(refs)} (rank 0's gather) bit "
              f"for bit [population]'s one-process ones ({len(ref)} "
              f"tensors, host values, driver keys, ranking "
              f"{topo.get('member_ranking')}); launches a rank "
              f"{dp['ranks'][0]['launches']}; dispatch ms "
              f"{', '.join(f'{x:.0f}' for x in disp)} (rank 0, synced: "
              f"capture, replay): "
              f"experiments_per_sec {eps_dp:.3f} against [population]'s "
              f"CLI {eps_one:.3f} ({one_ms:.0f} ms); peak by rank "
              + ", ".join(f"{r['peak_gib']:.2f}" for r in dp["ranks"])
              + f" GiB | {smi}", flush=True)
        # 2. PBT across ranks against pbt_step in one process
        pb = runs["pbt"]
        res = os.path.join(pb["out"], "res")
        saved = ckpt.find_checkpoint(_one_dir(os.path.join(res, "models",
                                                           "*")))
        check(saved is not None and saved[1] == per,
              f"[pop-dp] PBT run checkpoint {saved}")
        pre = _state_file(saved[0])
        check(set(pre) == set(ref) and all(torch.equal(pre[n], ref[n])
                                           for n in ref),
              "[pop-dp] the 4-rank checkpoint before PBT differs from "
              "[population]'s")
        ranking = ckpt.read_meta(saved[0])["topology"].get("member_ranking")
        check(ranking is not None and sorted(ranking) == list(range(p)),
              f"[pop-dp] PBT checkpoint ranking {ranking}")
        cfg_pbt = load_config(cfg7, POPULATION_OVERRIDES + (
            cut_t, "population.pbt.enabled=true"))
        exp = Experiment.build(cfg_pbt)
        state = ckpt.load_checkpoint(saved[0], pop.PopState(
            *pop.init_population(exp, cfg_pbt)))
        perf = [float(p - ranking.index(m)) for m in range(p)]
        ts, spec, info = pop.pbt_step(cfg_pbt, state.ts, state.spec, perf,
                                      per)
        check(info is not None, "[pop-dp] one-process PBT made no copy")
        gathered = {}
        for i in range(POP_DP_PBT_RANKS):
            gathered.update(torch.load(os.path.join(pb["out"],
                                                    f"members{i}.pt"),
                                       weights_only=True))
        bad = [(m, n) for m in range(p)
               for n, v in ckpt.flatten_state(ts[m])[0].items()
               if not torch.equal(v.cpu(), gathered[m][n])]
        check(sorted(gathered) == list(range(p)) and not bad,
              f"[pop-dp] members after PBT across {POP_DP_PBT_RANKS} ranks "
              f"differ from one-process PBT: {bad[:5]}")
        copies = [r["value"] for r in _metric_rows(res)
                  if r["key"] == "pbt_copies"]
        check(copies == [len(info["copied"])],
              f"[pop-dp] pbt_copies rows {copies}, one-process "
              f"{info['copied']}")
        print(f"[pop-dp] PBT (population.pbt.enabled=true, dp_devices="
              f"{POP_DP_PBT_RANKS}, a member a rank): ranking {ranking}, "
              f"copies {info['copied']} (each across ranks), pbt_copies "
              f"{copies[0]:g}; every member after PBT bit for bit "
              f"pbt_step in one process on the same checkpoint and ranking; "
              f"the dp run {wall['dp']:.1f} s, then the PBT run "
              f"{wall['pbt']:.1f} s", flush=True)
        del exp, state, ts, gathered, pre
        return {"launches": {n: sum(r["launches"][n] for x in runs.values()
                                    for r in x["ranks"]) for n in step},
                "dispatch_ms": disp, "experiments_per_sec": eps_dp,
                "experiments_per_sec_one": eps_one, "wall_s": wall,
                "pbt_copied": info["copied"], "ranking": ranking,
                "peak_gib_by_rank": [r["peak_gib"] for r in dp["ranks"]]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_pop_sebulba(torch, att, smi: str, population: dict) -> dict:
    """Config 7's population under Sebulba in lockstep (the only
    composition JAX allows): 2 actor streams and 1 learner stream on the
    card (``--share-cards``), two whole members an actor stream, at
    VARIANT_T and ``superstep: 1`` (JAX refuses a superstep under
    Sebulba), through ``run``, against the classic population loop
    (``run_sequential``'s population program at K = 1, so the test
    cadence's greedy rollouts come after the first iteration in both)
    over the same POP_SEBULBA_ITERATIONS iterations from the same seed:
    every member's state (params, target, Adam, ring, priorities, runner,
    the episode counter) and the spec bit for bit (both run each member's
    unsplit 32-lane graphs); the race checks (``Audit``, each member's
    own); exact launches; env-steps/s against the classic loop's and each
    side's utilization."""
    import gc
    import shutil
    import tempfile
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.obs import report as obs_report
    from t2omca_tpu_torch.parallel import sebulba as seb_mod
    from t2omca_tpu_torch.run import run
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    from t2omca_tpu_torch.utils.logging import Logger
    root = os.path.dirname(os.path.abspath(__file__))
    cfg7 = os.path.join(root, POPULATION_CONFIG)
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_popseb_", dir=root)
    n_it = POP_SEBULBA_ITERATIONS
    base = load_config(cfg7, POPULATION_OVERRIDES)
    spr = base.batch_size_run * VARIANT_T
    common = POPULATION_OVERRIDES + (
        f"env_args.episode_limit={VARIANT_T}", "superstep=1",
        f"t_max={n_it * spr - 1}", f"log_interval={spr}",
        f"test_interval={SEBULBA_TEST_INTERVAL}", "save_model=false",
        "profile_stages=true")
    classic_dir, seb_dir = (os.path.join(tmp, "classic"),
                            os.path.join(tmp, "sebulba"))
    classic_cfg = load_config(cfg7, common + (
        f"local_results_path={classic_dir}",))
    cfg = load_config(cfg7, common + POP_SEBULBA + (
        f"local_results_path={seb_dir}",))
    p = cfg.population.size
    step = loop_launches(cfg)
    built = []
    make = seb_mod.make_sebulba

    def timing(*a, **kw):
        built.append(make(*a, **kw))
        built[-1].timing = True
        return built[-1]
    try:
        t0 = time.time()
        want = run(classic_cfg, Logger())
        torch.cuda.synchronize()
        classic_s = time.time() - t0
        want = {f"ts.{m}.{k}": v.detach().cpu() for m, st in
                enumerate(want.ts) for k, v in
                ckpt.flatten_state(st)[0].items()}
        classic_ms = [r["value"] for r in _metric_rows(classic_dir)
                      if r["key"] == "time_superstep_ms"]
        seb_mod.make_sebulba = timing
        audit = seb_mod.AUDIT = seb_mod.Audit()
        att.reset_launches()             # ---- the driver path starts here
        t0 = time.time()
        ps = run(cfg, Logger(), share_cards=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(att.LAUNCHES)    # ---- and ends here
        seb_mod.AUDIT = None
        seb = built[-1]
        checked = audit.check(0)
        check(checked["batches"] == p * n_it
              and checked["rollouts"] == p * n_it,
              f"[pop-sebulba] the audit saw {checked}")
        check(seb.placement_of == [m // (p // 2) for m in range(p)],
              f"[pop-sebulba] members on placements {seb.placement_of}")
        got = {f"ts.{m}.{k}": v.detach().cpu() for m, st in
               enumerate(ps.ts) for k, v in
               ckpt.flatten_state(st)[0].items()}
        bad = [n for n in want if n not in got
               or not torch.equal(got[n], want[n])]
        check(set(got) == set(want) and not bad,
              f"[pop-sebulba] lockstep differs from the classic population "
              f"loop after {n_it} iterations: {bad[:6]} of {len(want)}")
        check(seb.learner_launches == {x: p * v for x, v in step.items()}
              and launches == {x: n_it * p * v + sum(
                  m.warm_launches[x] for m in seb.members)
                  for x, v in step.items()},
              f"[pop-sebulba] launches {launches}, a learner step of every "
              f"member {seb.learner_launches}, want {n_it} x {p} x {step}")
        events = obs_report.load_events(_one_dir(os.path.join(seb_dir,
                                                              "qmix*")))
        util = obs_report.sebulba_utilization(
            events, obs_report.phase_summary(events))
        spans = [e for e in events if e.get("event") == "span"]
        learn = sorted(float(e["t0"]) for e in spans
                       if e.get("phase") == "learner.dispatch")
        gaps_ms = [1e3 * (b_ - a_) for a_, b_ in zip(learn, learn[1:])]
        ev = seb.events
        roll_dev = [max(e0.elapsed_time(e1) for e0, e1 in shards)
                    for shards in ev["rollout"]]
        learn_dev = [e0.elapsed_time(e1) for e0, e1 in ev["learner"]]
        steady = sorted(gaps_ms)[len(gaps_ms) // 2] if gaps_ms else None
        rate = p * spr / (steady / 1e3) if steady else None
        classic_rate = p * spr / (sorted(classic_ms[1:] or classic_ms)[
            len(classic_ms[1:] or classic_ms) // 2] / 1e3)
        print(f"[pop-sebulba] config 7 (P={p}, T={VARIANT_T}, superstep=1) "
              f"under Sebulba in lockstep ({seb.describe()}): {n_it} "
              f"iterations bit for bit the classic population loop's "
              f"({len(want)} tensors: every member's learner, Adam, ring, "
              f"priorities, runner, episode); audit {checked}; launches "
              f"{launches}; learner steps (all {p} members) start every "
              f"{', '.join(f'{x:.0f}' for x in gaps_ms)} ms: env-steps/s "
              f"{rate or 0:.0f} against the classic population loop's "
              f"{classic_rate:.0f} (its synced dispatches "
              f"{', '.join(f'{x:.0f}' for x in classic_ms)} ms); device ms "
              f"a member's rollout (the slower stream's) "
              f"{', '.join(f'{x:.1f}' for x in roll_dev[:p])}, a member's "
              f"learner step {', '.join(f'{x:.1f}' for x in learn_dev[:p])}"
              f"; obs report utilization actor {util['actor']['util_pct']}% "
              f"learner {util['learner']['util_pct']}%; run {wall:.1f} s "
              f"(captures {sum(seb.capture_s.values()):.1f} s), classic "
              f"{classic_s:.1f} s | {smi}", flush=True)
        del ps, want, got
        return {"launches": launches, "gaps_ms": gaps_ms,
                "env_steps_per_s": rate,
                "classic_env_steps_per_s": classic_rate,
                "classic_ms": classic_ms, "rollout_device_ms": roll_dev,
                "learner_device_ms": learn_dev, "util": util,
                "audit": checked, "wall_s": wall,
                "capture_s": sum(seb.capture_s.values())}
    finally:
        seb_mod.make_sebulba = make
        seb_mod.AUDIT = None
        built.clear()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_pop_reshape(torch, att, smi: str, population: dict) -> dict:
    """[population]'s P = 4 CLI checkpoint restored on the card under
    another P (``utils/elastic.resume_state``): as P = 2, the two best
    members of its stamped ranking, every tensor equal to the saved
    member's and the spec rows with them, then one K = 4 dispatch through
    the program it captures (finite, exact launches); as P = 6, members 4
    and 5 copies of 0 and 1 with their rollout keys re-salted (checked at
    restore: a dispatch would capture six members). Every value finite,
    every member's rollout key distinct."""
    import dataclasses
    import gc
    from t2omca_tpu_torch import population as pop
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import load_config, sanity_check
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    from t2omca_tpu_torch.utils import elastic
    root = os.path.dirname(os.path.abspath(__file__))
    dirname = population["cli_checkpoints"][population["cli_per"]]
    saved = _state_file(dirname)
    meta = ckpt.read_meta(dirname)
    ranking = meta["topology"].get("member_ranking")
    check(ranking is not None and sorted(ranking) == [0, 1, 2, 3],
          f"[pop-reshape] the checkpoint's ranking {ranking}")
    base = load_config(os.path.join(root, POPULATION_CONFIG),
                       POPULATION_OVERRIDES + (
                           f"env_args.episode_limit={VARIANT_T}",))
    k, per = base.superstep, population["cli_per"]
    out = {}
    for p_dst in POP_RESHAPE:
        cfg = sanity_check(base.replace(population=dataclasses.replace(
            base.population, size=p_dst, lr=())))
        exp = Experiment.build(cfg)
        t0 = time.perf_counter()
        got = elastic.resume_state(dirname, pop.PopState(
            *pop.init_population(exp, cfg)), verify=True,
            topology={"loop": "classic"})
        restore_s = time.perf_counter() - t0
        src = (ranking[:p_dst] if p_dst < 4
               else [m % 4 for m in range(p_dst)])
        bad, keys = [], set()
        for j, m in enumerate(src):
            for name, v in ckpt.flatten_state(got.ts[j])[0].items():
                want = saved[f"ts.{m}.{name}"]
                if name == "runner.key" and j >= 4:
                    want = prng.fold_in(want, j)
                if not torch.equal(v.cpu(), want.cpu()):
                    bad.append((j, name))
                if v.is_floating_point() and not bool(
                        torch.isfinite(v).all()):
                    bad.append((j, name, "non-finite"))
            keys.add(tuple(got.ts[j].runner.key.tolist()))
        check(not bad and len(keys) == p_dst
              and got.spec.member.tolist() == src
              and torch.equal(got.spec.lr_scale,
                              saved["spec.lr_scale"][src]),
              f"[pop-reshape] P=4 -> {p_dst}: {bad[:6]}, {len(keys)} "
              f"distinct keys, spec members {got.spec.member.tolist()}")
        line = (f"P=4 -> {p_dst} ({'ranked shrink' if p_dst < 4 else 'grow'}"
                f", members {src}) restored in {restore_s:.2f} s")
        if p_dst < 4:
            prog = exp.population_superstep_program(k)
            lead = got.ts[0]
            mirror = {"keys": pop.member_keys(cfg, "cuda"), "t_env": per,
                      "episode": int(lead.episode),
                      "filled": int(lead.buffer.episodes_in_buffer)}
            keys_, gated, t_env0 = pop_rows(torch, prog, mirror)
            att.reset_launches()
            t0 = time.perf_counter()
            pts, stats, infos = prog(got.ts, keys_, t_env0, gated, got.spec)
            torch.cuda.synchronize()
            disp_s = time.perf_counter() - t0
            launches = dict(att.LAUNCHES)
            want = {n: p_dst * sum(gated) * v
                    for n, v in loop_launches(cfg).items()}
            finite = all(bool(torch.isfinite(v).all())
                         for st in pts for v in ckpt.flatten_state(st)[0]
                         .values() if v.is_floating_point())
            check(launches == want and finite
                  and bool(infos["all_finite"].all())
                  and all(set(m.graphs) == {"rollout", "train"}
                          for m in prog.members),
                  f"[pop-reshape] the shrunk population's dispatch: "
                  f"launches {launches} (want {want}), finite {finite}")
            out["launches"] = launches
            line += (f"; one K={k} dispatch captured and run in "
                     f"{disp_s:.1f} s, finite, launches {launches}")
            prog.close()
            del prog, pts, stats, infos
        out[p_dst] = restore_s
        print(f"[pop-reshape] {line}; every tensor the saved member's (the "
              f"copies' keys re-salted), spec rows with them, every key "
              f"distinct | {smi}", flush=True)
        del got, exp
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    # CUPTI stays attached after a torch.profiler session unless Kineto
    # tears it down: every later launch then pays its callbacks (a graph
    # launch ~60 ms of host time instead of ~2, an eager config 6
    # iteration ~25% more; scripts/torch_graph_launch_cupti.py). The
    # phases after [profile] measure without that; [report]'s subprocess
    # runs with the environment a user has, without this setting
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {count}", flush=True)

    phases = {}
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    print(f"[build] {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    hmma = phase_build_report(lib, build)

    def lap(name):
        nonlocal t0
        phases[name] = time.perf_counter() - t0
        print(f"[time] {name} {phases[name]:.1f} s (total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)
        t0 = time.perf_counter()

    lap("build")
    errs, times = phase_kernels(torch, att)
    lap("kernels")
    launches, fes, requests = phase_serve(torch, att)
    lap("serve")
    # before the first torch.profiler session: CUPTI stays attached after
    # one, and each replay of a captured graph then costs ~60 ms of host
    # time instead of ~3, which serializes the members' launches
    population = phase_population(torch, att, smi)
    lap("population")
    for dt in ("float32", "bfloat16"):
        phase_profile(torch, fes[dt], requests, dt)
    del fes
    torch.cuda.empty_cache()
    lap("profile")
    errs_bwd, times_bwd = phase_kernels_bwd(torch, att)
    lap("kernels-bwd")
    train, buffer, ring, cfg, info = phase_train(torch, att)
    lap("train")
    phase_profile_train(torch, buffer, ring, cfg, info)
    lap("profile-train")
    del buffer, ring
    torch.cuda.empty_cache()
    entity = phase_entity(torch)
    lap("entity")
    loop, loop_exp, loop_ts = phase_loop(torch, att)
    lap("loop")
    sight = phase_sight(torch, att, loop_exp, loop_ts)
    lap("sight")
    remat = phase_remat(torch, att, loop_exp, loop_ts,
                        train.pop("cross_batch"))
    lap("remat")
    superstep = phase_superstep(torch, att, loop_exp, loop_ts, smi)
    lap("superstep")
    del loop_exp, loop_ts
    torch.cuda.empty_cache()
    rbg = phase_rbg(torch, att, smi)
    lap("rbg")
    dense = phase_loop_dense(torch, att)
    lap("loop-dense")
    noisy = phase_loop_noisy(torch, att)
    lap("loop-noisy")
    dropout = phase_dropout(torch, att, smi)
    lap("dropout")
    families = phase_families(torch, att, smi)
    lap("families")
    host_replay = phase_host_replay(torch, att, smi)
    lap("host-replay")
    driver = phase_driver(torch, att, loop, after=lambda models, first:
                          phase_artifact(torch, att, models, then=lambda arts:
                                         phase_fleet(
                                             torch, att, arts["pallas"],
                                             ARTIFACT_VARIANTS["pallas"],
                                             first, "profile" in phases)))
    lap("driver")
    artifact = driver.pop("after")
    fleet = artifact.pop("then")
    phases["driver"] -= driver["after_s"]
    phases["artifact"] = driver["after_s"] - fleet["seconds"]
    phases["fleet"] = fleet["seconds"]
    scenarios = phase_scenarios(torch, att, smi)
    lap("scenarios")
    report = phase_report(torch, smi)
    lap("report")
    dp = phase_dp(torch, att, smi)
    lap("dp")
    dps = phase_dp_superstep(torch, att, smi)
    lap("dp-superstep")
    sebulba = phase_sebulba(torch, att, smi)
    lap("sebulba")
    pop_dp = phase_pop_dp(torch, att, smi, population)
    lap("pop-dp")
    pop_sebulba = phase_pop_sebulba(torch, att, smi, population)
    lap("pop-sebulba")
    pop_reshape = phase_pop_reshape(torch, att, smi, population)
    lap("pop-reshape")
    sp = phase_sp(torch, smi)
    lap("sp")
    want6 = loop_launches(scenarios["cfg"])
    check(scenarios["want_step"] == want6,
          f"[population] counted by loop_launches ({want6}), but the CPU "
          f"path launches {scenarios['want_step']} a config 6 train "
          f"iteration")
    loops = {"loop": loop, "sight": sight, "remat": remat,
             "superstep": superstep, "loop_dense": dense,
             "loop_noisy": noisy, "dropout": dropout,
             "families": families, "host_replay": host_replay,
             "driver": {"launches": {
                 k: driver["launches"][k] + driver["launches_resume"][k]
                 for k in driver["launches"]}},
             "artifact": artifact, "fleet": fleet, "scenarios": scenarios,
             "population": population, "dp": dp,
             "dp_superstep": {"launches": dps["launches"]},
             "sebulba": {"launches": sebulba["launches"]},
             "pop_dp": pop_dp, "pop_sebulba": pop_sebulba,
             "pop_reshape": pop_reshape,
             "rbg": {"launches": {k: rbg["launches"][k]
                                  + rbg["drop_launches"][k]
                                  for k in rbg["launches"]}}}

    def fwd_times(key):
        ms, plain, lib_ms, bound, by = times[key]
        return {"ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                "bound_ms": bound, "bound_by": by}

    def learner_times(name):
        return [times_bwd[key] for key in times_bwd if key[0] == name]

    def f32_times(name):
        """The f32 body's times at the learner shapes, beside bf16's in
        ``learner_shapes``: {tag: {ms, plain_ms, bound_ms, ...}}."""
        return {key[1]: times_bwd[key] for key in times_bwd
                if key[0] == name and key[2] == "float32"}

    def config5_times(name):
        """The rows at config 5's shapes ([dp]'s path: the mixer, k is v;
        the agent's query slice off it under the default stack)."""
        return {f"config5_{tag}": {dt: times_bwd[(name, key, dt)]
                                   for dt in ("float32", "bfloat16")}
                for tag, key in (("agent", "agent5"),
                                 ("mixer", "mixer5_k_is_v"))}

    csrc = "t2omca_tpu_torch/kernels/csrc/"
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": csrc + "flash_fwd_dmma.cu",
        "source_bf16": csrc + "flash_fwd_tc.cu",
        "entry": csrc + "flash_fwd.cu",
        "replaces": "t2omca_tpu/kernels/attention.py:115 (pallas_call :392)",
        "launches": (launches["flash_fwd"] + train["launches"]["flash_fwd"]
                     + sum(r["launches"]["flash_fwd"]
                           for r in loops.values())),
        "launches_by_path": {"serve": launches["flash_fwd"],
                             "train": train["launches"]["flash_fwd"],
                             **{k: r["launches"]["flash_fwd"]
                                for k, r in loops.items()}},
        "max_abs_err": errs[("serve", "float32")],
        **fwd_times(("serve", "float32")),
        "shape": [4096, 4, 65, 65, 64], "dtype": "float32",
        "serve_bfloat16": dict(fwd_times(("serve", "bfloat16")),
                               max_abs_err=errs[("serve", "bfloat16")]),
        "serve_strided_bfloat16": fwd_times(("serve_strided", "bfloat16")),
        "serve_strided_float32": fwd_times(("serve_strided", "float32")),
        "float32": f32_times("flash_fwd"),
        "config6_mixer_float32": times_bwd[("flash_fwd", "mixer6_k_is_v",
                                            "float32")],
        **config5_times("flash_fwd"),
        "learner_shapes": learner_times("flash_fwd"),
    }]
    sources = {
        "flash_fwd_res": ("flash_fwd_tc.cu", "flash_fwd_dmma.cu",
                          ":115 (pallas_call :383)"),
        "flash_bwd_dq": ("flash_bwd_dq_tc.cu", "flash_bwd_dq_tc.cu",
                         ":210 (pallas_call :437)"),
        "flash_bwd_dkv": ("flash_bwd_tc.cu", "flash_bwd_dkv_3xtf32.cu",
                          ":253 (pallas_call :464)")}
    for name, (src, src32, line) in sources.items():
        head = times_bwd[(name, "agent", "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": csrc + src, "source_f32": csrc + src32,
            "replaces": f"t2omca_tpu/kernels/attention.py{line}",
            "launches": (train["launches"][name]
                         + sum(r["launches"][name] for r in loops.values())),
            "launches_by_path": {"serve": 0,
                                 "train": train["launches"][name],
                                 **{k: r["launches"][name]
                                    for k, r in loops.items()}},
            "max_abs_err": errs_bwd[("agent", "bfloat16")][name],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": "bfloat16",
            "max_abs_err_f32": errs_bwd[("agent", "float32")][name],
            "float32": f32_times(name),
            "config6_mixer_float32": times_bwd[(name, "mixer6_k_is_v",
                                                "float32")],
            **config5_times(name),
            "learner_shapes": learner_times(name),
        })
    mask = dropout["mask_kernel"]
    kernels.append({
        "name": "dropout_mask", "route": "cuda",
        "source": csrc + "dropout_mask.cu",
        "replaces": "t2omca_tpu/models/transformer.py:162 (flax "
                    "nn.Dropout's bernoulli draw, XLA ops: no pallas_call)",
        "launches": dropout["mask_launches"] + dps["mask_launches"],
        "launches_by_path": {"dropout": dropout["mask_launches"],
                             "dp_superstep": dps["mask_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in mask.values()),
        **{k: mask["agent"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "shape")},
        "dtype": "bool", "shapes": mask,
        "row_map": dropout["row_map"],
    })
    philox = rbg["mask_kernel"]
    kernels.append({
        "name": "dropout_mask_philox", "route": "cuda",
        "source": csrc + "dropout_mask.cu",
        "replaces": "t2omca_tpu/models/transformer.py:162 (flax "
                    "nn.Dropout's bernoulli draw under prng_impl rbg / "
                    "unsafe_rbg: XLA's rng_bit_generator, no pallas_call)",
        "launches": rbg["mask_launches"],
        "launches_by_path": {"rbg_dropout": rbg["mask_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in philox.values()),
        **{k: philox["agent"][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "shape")},
        "dtype": "bool", "shapes": philox,
    })
    tc_of = {"flash_fwd": ("flash_fwd_tc_kernel", "flash_fwd_dmma_kernel"),
             "flash_fwd_res": ("flash_fwd_tc_kernel",
                               "flash_fwd_dmma_kernel"),
             "flash_bwd_dkv": ("flash_bwd_dkv_tc_kernel",
                               "flash_bwd_dkv_3xtf32_kernel"),
             "flash_bwd_dq": ("flash_bwd_dq_tc_kernel",
                              "flash_bwd_dq_3xtf32_kernel")}
    for k in kernels:
        k["mma_in_sass"] = {n: c for n, c in hmma.items()
                             if n.startswith(tc_of.get(k["name"], ()))}
    print(f"[summary] trainer step p50: bf16 {train['p50_bf16_ms']:.1f} ms, "
          f"f32 {train['p50_f32_ms']:.1f} ms (T="
          f"{train['f32_episode_limit']})", flush=True)
    print(f"[summary] loop (default stack, {LOOP_LANES} lanes, ring "
          f"{LOOP_RING}, T={LOOP_T}): rollout p50 "
          f"{loop['rollout_p50_ms']:.1f} ms "
          f"({loop['env_steps_per_s']:.0f} env-steps/s), trainer step p50 "
          f"{loop['train_p50_ms']:.1f} ms, iteration p50 "
          f"{loop['iteration_p50_ms']:.1f} ms, peak {loop['peak_gib']:.2f} "
          f"GiB, {loop['rollout_launches']} launches a rollout, device busy "
          f"{100 * loop['rollout_busy_share']:.1f}% of a rollout; "
          f"loop-dense ({DENSE_LANES} lanes): rollout p50 "
          f"{dense['rollout_p50_ms']:.1f} ms ({dense['env_steps_per_s']:.0f} "
          f"env-steps/s), trainer step p50 {dense['train_p50_ms']:.1f} ms; "
          f"acting forward at {LOOP_LANES} lanes: entity tables "
          f"{entity['entity_ms']:.3f} ms, query slice {entity['qslice_ms']:.3f}"
          f" ms", flush=True)
    print(f"[summary] superstep (config 3, K={SUPERSTEP_K}, captured CUDA "
          f"graphs): bit-identical to {SUPERSTEP_K} eager iterations; "
          f"capture rollout {superstep['capture_s']['rollout'][0]:.2f} + "
          f"{superstep['capture_s']['rollout'][1]:.2f} s, train "
          f"{superstep['capture_s']['train'][0]:.2f} + "
          f"{superstep['capture_s']['train'][1]:.2f} s (capture + "
          f"instantiate); a dispatch of replays {superstep['host_ms']:.0f} "
          f"ms host, {superstep['wall_ms']:.0f} ms to the device's end "
          f"(eager: {superstep['eager_s'] * 1e3:.0f} ms for {SUPERSTEP_K} "
          f"run_classic iterations); device busy "
          f"{100 * superstep['busy_share']:.1f}% of a profiled iteration; "
          f"peak {superstep['peak_gib']:.2f} GiB allocated, "
          f"{superstep['reserved_gib']:.2f} GiB reserved", flush=True)
    print(f"[summary] driver (config 3 via python -m t2omca_tpu_torch, one "
          f"fused K=4 dispatch): startup {driver['startup_s']:.2f} s, "
          f"dispatch "
          f"host {driver['dispatch_host_ms']:.0f} ms, iterations "
          f"{', '.join(f'{x:.0f}' for x in driver['iterations_ms'])} ms, "
          f"test rollout {driver['test_ms']:.0f} ms, checkpoint "
          f"{driver['save_bytes'] / 1e9:.3f} GB (copy "
          f"{driver['save_copy_s']:.2f} s, write {driver['save_write_s']:.2f}"
          f" s, hash {driver['save_hash_s']:.2f} s; restore hash "
          f"{driver['restore_hash_s']:.2f} s, load "
          f"{driver['restore_load_s']:.2f} s), evaluate "
          f"{driver['eval_episode_ms']:.0f} ms an episode, SIGTERM to exit "
          f"{driver['sigterm_to_exit_s']:.2f} s", flush=True)
    art = {key: v for key, v in artifact.items() if key != "launches"}
    print("[summary] artifact (config 3 from [driver]'s checkpoint, "
          "loaded on the card): " + "; ".join(
              f"{tag} {dt}: export {v['export_s']:.2f} s, "
              f"{v['bytes'] / 1e6:.2f} MB, load {v['load_s']:.2f} s, warm "
              f"p50 n=64 {v['warm_ms'][64]:.2f} ms"
              for (tag, dt), v in art.items()), flush=True)
    ch = fleet["chaos"]
    print(f"[summary] fleet (2 engines over [artifact]'s dense pallas "
          f"artifact, f32): select p50 ms "
          + ", ".join(f"n={n}: {v:.2f}" for n, v in fleet["p50_ms"].items())
          + f"; refresh {fleet['refresh_s']:.2f} s; chaos "
          f"{ch['requests']} requests, {ch.get('ok', 0)} ok, "
          f"{ch.get('shed', 0)} shed, {ch['unresolved']} unresolved, p99 "
          f"{ch['p99_ms']:.2f} ms (under burst {ch['burst_p99_ms']:.2f}), "
          f"recoveries {ch['recoveries_s']} s", flush=True)
    print(f"[summary] report (config 6 at T=20 through the CLI, "
          f"obs.program_trace):"
          f" " + ", ".join(f"{n} {v['device_ms']:.1f} ms"
                           for n, v in sorted(report["device_times"].items()))
          + f"; dispatch host ms before / after the window "
          f"{report['dispatch_ms'][1]:.0f} / {report['dispatch_ms'][3]:.0f}",
          flush=True)
    print(f"[summary] scenarios (config 6, K=4, f32, pallas): capture "
          f"rollout {scenarios['capture_s']['rollout'][0]:.2f} + "
          f"{scenarios['capture_s']['rollout'][1]:.2f} s, train "
          f"{scenarios['capture_s']['train'][0]:.2f} + "
          f"{scenarios['capture_s']['train'][1]:.2f} s; a dispatch of "
          f"replays {scenarios['host_ms']:.0f} ms host (eager: "
          f"{scenarios['eager_s'] * 1e3:.0f} ms for 4 run_classic "
          f"iterations); the driver's two dispatches "
          f"{', '.join(f'{x:.0f}' for x in scenarios['driver_dispatch_ms'])}"
          f" ms host", flush=True)
    print(f"[summary] population (config 7, P=4, K=4, f32, pallas): a "
          f"dispatch of replays with the members overlapped "
          f"{population['host_ms']:.0f} ms host, "
          f"{min(population['overlap_s']) * 1e3:.0f} ms to the device's end"
          f" against {min(population['serial_s']) * 1e3:.0f} ms serial: "
          f"experiments_per_sec {population['experiments_per_sec']:.3f}, "
          f"serialized_experiments_per_sec "
          f"{population['serialized_experiments_per_sec']:.3f}, "
          f"population_speedup {population['population_speedup']:.3f}; "
          f"the driver's two dispatches "
          f"{', '.join(f'{x:.0f}' for x in population['driver_dispatch_ms'])}"
          f" ms host; peak {population['peak_gib']:.2f} GiB", flush=True)
    dense_rows = "; ".join(
        f"{key[0]} {key[1]} {key[2]} {v['ms']:.3f} ms (bound "
        f"{v['bound_ms']:.3f}, sdpa {v['library_ms']:.3f})"
        for key, v in times_bwd.items() if key[1] in DENSE_SHAPES)
    print(f"[summary] kernels-dense (D = 64, the dense modules' shapes): "
          f"{dense_rows}", flush=True)
    print(f"[summary] dropout (config 3, dropout {DROPOUT}, remat, "
          f"{DROPOUT_LANES} lanes, T={DROPOUT_T}): rollout+insert p50 "
          f"{dropout['rollout_p50_ms']:.1f} ms, trainer step p50 "
          f"{dropout['train_p50_ms']:.1f} ms, peak {dropout['peak_gib']:.2f} "
          f"GiB; at the agent's shape the mask kernel "
          f"{dropout['mask_kernel']['agent']['ms']:.3f} ms (plain "
          f"{dropout['mask_kernel']['agent']['plain_ms']:.2f} ms), one "
          f"dropout {dropout['mask_ms']['agent']:.3f} ms, "
          f"{dropout['mask_launches']} mask launches; host-replay ({HOST_LANES} "
          f"lanes, ring {HOST_RING} f32 in host RAM): iteration p50 "
          f"{host_replay['iteration_p50_ms']:.1f} ms against loop-dense's "
          f"{dense['iteration_p50_ms']:.1f} ms, a sample "
          f"{host_replay['sample_ms']:.1f} ms, RSS "
          f"{host_replay['rss_gib']:.2f} GiB", flush=True)
    print(f"[summary] dp (config 5's widths, {DP_LANES} lanes, ring "
          f"{DP_RING}, batch {DP_BATCH}, {DP_RANKS} ranks over "
          f"{dp['backend']}"
          + (" on one card" if dp["shared_card"] else "") + "): a warm "
          f"dispatch {dp['dispatch_ms']:.0f} ms against "
          f"{dp['dispatch_ms_one']:.0f} ms at 1 rank; "
          f"env-steps/s {dp['env_steps_per_s']:.0f} against "
          f"{dp['env_steps_per_s_one']:.0f}; all-reduce a step "
          f"{dp['allreduce_ms']['grad']:.2f} + "
          f"{dp['allreduce_ms']['batch']:.2f} ms; peak by rank "
          f"{', '.join(f'{x:.2f}' for x in dp['peak_gib_by_rank'])} GiB; "
          f"against their step computed at 1 rank: loss rel "
          f"{dp['loss_rel']:.1e}, grad norm rel {dp['grad_norm_rel']:.1e}, "
          f"first moment rel {dp['mu_rel']:.1e}, params "
          f"{100 * dp['params_off']:.2f}% off; CLI {dp['cli_s']:.1f} "
          f"s, resume {dp['resume_s']:.1f} s", flush=True)
    print(f"[summary] dp-superstep (config 3 as shipped, K=4, sight, T="
          f"{DPS_T}, {DPS_RANKS} ranks over {dps['backend']}"
          + (" on one card" if dps["shared_card"] else "") + "): a warm "
          f"dispatch {dps['dispatch_ms']:.0f} ms against the classic dp "
          f"loop's {dps['classic_ms']:.0f} ms for its 4 iterations; "
          f"env-steps/s {dps['env_steps_per_s']:.0f} against "
          f"{dps['classic_env_steps_per_s']:.0f}; segments "
          f"{dps['segments']}, nodes {dps['nodes']}; peak by rank "
          f"{', '.join(f'{x:.2f}' for x in dps['peak_gib_by_rank'])} GiB; "
          f"bit for bit against the classic dp loop ({dps['leaves']} "
          f"tensors, {dps['sight_rows']} sight rows)", flush=True)
    for n, leg in ((1, sebulba["one_learner"]),
                   (SEBULBA_LEARNERS, sebulba["learner_set"])):
        print(f"[summary] sebulba (config3_sebulba, 3 actor + {n} learner "
              f"streams on one card, queue 2, staleness 1): env-steps/s "
              f"{leg['env_steps_per_s'] or 0:.0f} against run_classic "
              f"{sebulba['classic_env_steps_per_s']:.0f} and "
              f"superstep_program(1) "
              f"{sebulba['superstep1_env_steps_per_s']:.0f}; utilization "
              f"actor {leg['util']['actor']['util_pct']}% learner "
              f"{leg['util']['learner']['util_pct']}%; busy "
              f"{100 * (leg['busy_share'] or 0):.1f}%; peak "
              f"{leg['peak_gib']:.2f} GiB", flush=True)
    blk = sebulba["blocked"]
    print(f"[summary] sebulba learner set of {SEBULBA_LEARNERS}: one step "
          f"{'bit for bit' if blk['bit_for_bit'] else 'not bit for bit'} "
          f"against the blocked step ({blk['leaves_equal']} of "
          f"{blk['leaves']} leaves; loss rel {blk['loss_rel']:.2e}, grad "
          f"norm rel {blk['grad_norm_rel']:.2e}, params max |diff| "
          f"{blk['params_max_diff']:.3e}); {sebulba['set_ratio']:.3f}x the "
          f"one-learner env-steps/s", flush=True)
    print(f"[summary] population over devices (config 7, T={VARIANT_T}): "
          f"dp_devices={POP_DP_RANKS} experiments_per_sec "
          f"{pop_dp['experiments_per_sec']:.3f} against one process's "
          f"{pop_dp['experiments_per_sec_one']:.3f}; under Sebulba in "
          f"lockstep env-steps/s {pop_sebulba['env_steps_per_s'] or 0:.0f} "
          f"against the classic population loop's "
          f"{pop_sebulba['classic_env_steps_per_s']:.0f}, utilization actor "
          f"{pop_sebulba['util']['actor']['util_pct']}% learner "
          f"{pop_sebulba['util']['learner']['util_pct']}%; P=4 restored as "
          + " / ".join(f"{n} in {pop_reshape[n]:.2f} s" for n in POP_RESHAPE),
          flush=True)
    print(f"[summary] rbg (config 3, {LOOP_LANES} lanes, T={LOOP_T}): "
          f"rollout p50 {rbg['rollout_p50_ms']['rbg']:.1f} ms under rbg "
          f"against {rbg['rollout_p50_ms']['threefry']:.1f} ms under "
          f"threefry; the Philox mask kernel at the agent shape "
          f"{philox['agent']['ms']:.3f} ms "
          f"({philox['agent']['ms'] / philox['agent']['bound_ms']:.2f}x "
          f"its bound, "
          f"threefry's {philox['agent']['threefry_ms']:.3f} ms), "
          f"{rbg['mask_launches']} launches in the dropout leg", flush=True)
    print(f"[summary] sp (config 5's mixer, 515 tokens, {SP_ROWS} rows): "
          + "; ".join(f"{dt} a forward " + ", ".join(
              f"n={n} {ms:.2f} ms" for n, ms in sp["ms"][dt].items())
              for dt in sp["ms"]), flush=True)
    print(f"[summary] total {time.perf_counter() - t_start:.1f} s; by phase: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in phases.items()),
          flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-cli-rank"]:
        sys.exit(dp_cli_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--pop-dp-rank"]:
        sys.exit(pop_dp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--dp-superstep-rank"]:
        sys.exit(dp_superstep_rank_main(sys.argv[2:]))
    sys.exit(main())
