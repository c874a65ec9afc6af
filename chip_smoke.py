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
             shapes and the odd / masked / causal / all-masked cases,
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
5. profile   device time of one max-bucket dispatch by kernel, f32 and
             bf16 (torch.profiler), after the launch counts are read
6. kernels-bwd  K1 + residuals, K2 and K3 against their plain versions
             at the learner agent (2048, 1, 4, 65, 256) and mixer
             (32, 1, 268, 131, 256) shapes in f32 and bf16, the dense
             learner's heads, odd shapes, masks, causal, the all-masked
             row, and the bf16 and f32 edges of phase 3; times of each
             kernel at the two learner shapes in both dtypes (and with k
             is v) beside its
             bound, its plain version and its SDPA yardstick (forward for
             K1 and K1 + residuals; backward alone for K2 and K3, as the
             device time of its kernels in a profiler trace; never on the
             path), and the fwd+bwd totals
7. train     the trainer step (sample -> train -> priority feedback,
             train/program.py) at the north-star widths, bf16,
             kernels.attention=pallas, dense replay; 5 steps with exact
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
9. loop      config 3's own loop, uncut: three iterations of the classic
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
             config3_tpu_northstar.yaml uncut (1024 lanes, ring 2048,
             K = 4, spans and memwatch on) with kernels.attention=pallas,
             obs.sight.enabled=false and obs.pulse_port=0: one dispatch
             to t_env 614400 with launches 4 x [loop]'s, the metric keys,
             a verified checkpoint and no staging leftover; the same call
             resumed from it to 1228800 (every restored tensor, the ring
             cursor and the driver key equal to the checkpoint's before
             the first new dispatch, launches as before); a SIGTERM'd
             training subprocess (4 lanes, ring 256, K = 1) exits 0 with an
             emergency checkpoint, the resume hint and a flight recorder
             with the memwatch peak; evaluate with benchmark.csv from a
             full-state restore and from the model-only fallback. Prints
             startup, the dispatch's and each iteration's time beside
             [loop]'s, the test rollout, the checkpoint's bytes and its
             save, hash and restore times, an evaluate episode and
             SIGTERM to exit. Runs under a temporary directory in the
             checkout that it deletes.
11. summary  the kernels JSON line, the card line, the result line

Run from the repository root: ``python3 chip_smoke.py``. The last line
is ``{"ok": true, "device": {...}}``; it is printed only when every
phase passed.
"""

from __future__ import annotations

import dataclasses
import json
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
              "float64": 67e12}
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
#: replay ring of the trainer step, cut from config 3's 2048 episodes:
#: 64 episodes of 151 steps (bf16 storage, ~0.75 GB) are enough to
#: sample batches of 32
RING = 64
TRAIN_STEPS = 5


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
    kernel and copy in a torch.profiler trace, by self device time."""
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
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
    check(all(any(k in n and hmma[n] + dmma[n] > 0 for n in hmma)
              for k in TC_KERNELS),
          "a tensor-core kernel is missing from the library")
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
    ] + BF16_EDGES + F32_EDGES
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
        if name in ("agent", "mixer"):
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
        # the one tensor once
        for kv_same in (False, True):
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
              batch_size: int = 32, episode_limit: int = 150):
    from t2omca_tpu_torch.config import from_dict
    d = json.loads(json.dumps(NORTH_STAR))
    d["batch_size"] = batch_size
    d["env_args"]["episode_limit"] = episode_limit
    d["model"].update(dtype=dtype, use_qslice=use_qslice)
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
        ts = TrainState(learner=ls, buffer=ring, episode=RING)
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
    times32 = run(cfg32, 3, keys, buf32, ring32)[2]
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    p50_32 = statistics.median(times32)
    print(f"[train] f32 3 trainer steps at T={t32}"
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
    return result, buffer, ring, cfg, info


#: the f32 cross-check's operating point: the zero-init mixer gate
#: (model.mixer_zero_init) opened to this value. At the reference init
#: the mixer's q_tot at emb 256 is O(1e3), the loss O(1e7) and the
#: pre-clip gradient norm O(1e7), where two f32 lowerings of the same
#: function differ by ~1e-4 in grad_norm from rounding alone (PERF.md).
CROSS_GATE = 1e-3


def cross_check_step(torch, info, attention, use_qslice, batch, w):
    """One f32 train step at batch 2 → (loss, grad_norm, clipped
    gradients, params after the step)."""
    from t2omca_tpu_torch.learners.qmix_learner import (
        clip_by_global_norm, global_norm)
    cfg = train_cfg("float32", attention, use_qslice, batch_size=2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, mixer_zero_init=True))
    lrn = build_learner(cfg, info)
    ls = lrn.init_state(torch.Generator().manual_seed(SEED))
    for tree in (ls.params, ls.target_params):
        tree["mixer"]["out_gate"].fill_(CROSS_GATE)
    params = {m: {k: v.detach().requires_grad_() for k, v in sub.items()}
              for m, sub in ls.params.items()}
    loss, _ = lrn._loss(params, ls.target_params, batch, w)
    leaves = [(m, k) for m in params for k in params[m]]
    grads = torch.autograd.grad(loss, [params[m][k] for m, k in leaves],
                                allow_unused=True)
    tree = {m: {} for m in params}
    for (m, k), g in zip(leaves, grads):
        tree[m][k] = torch.zeros_like(params[m][k]) if g is None else g
    clipped = clip_by_global_norm(tree, global_norm(tree),
                                  cfg.grad_norm_clip)
    ls2, inf = lrn.train(ls, batch, w, 1000, RING)
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
        torch.Generator().manual_seed(SEED)), buffer=ring, episode=RING)
    train_iter = build_train_iter(buffer, learner, cfg)
    k1, k2 = prng.split(prng.PRNGKey(SEED + 13, "cuda")).unbind(0)
    ts, _ = train_iter(ts, k1, 1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
DENSE_LANES = 128                   # [loop-dense]: 1024 -> 128
DENSE_RING = 256                    # [loop-dense]: 2048 -> 256
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


def run_loop(torch, att, exp, ts, tag: str, iterations: int):
    """``iterations`` classic iterations (rollout → insert → gated train)
    through ``run.run_classic``, each with its exact kernel launches and
    its checks → (ts', records, launch totals, result dict)."""
    import numpy as np
    from t2omca_tpu_torch.run import run_classic
    cfg = exp.cfg
    b, t = cfg.batch_size_run, cfg.env_args.episode_limit
    want = loop_launches(cfg)
    totals = dict.fromkeys(want, 0)
    cursor, records, iter_s = None, [], []
    for i in range(iterations):
        # what the insert alone would leave: the new slots at the stamp
        stamp = ts.buffer.max_priority ** cfg.replay.per_alpha
        inserted = ts.buffer.priorities.clone()
        inserted[(ts.buffer.insert_pos + torch.arange(b, device="cuda"))
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
    check(cursor.t_env == iterations * b * t,
          f"{tag}: t_env {cursor.t_env} != {iterations * b * t}")
    check(cursor.episode == ts.episode == iterations * b,
          f"{tag}: episode {cursor.episode} != {iterations * b}")
    st = ts.buffer.storage
    n = ts.buffer.episodes_in_buffer
    check(n == min(iterations * b, cfg.replay.buffer_size),
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
              "env_steps_per_s": b * t / (p50_roll / 1e3)}
    return ts, records, result


def check_stored_obs(torch, ts, env, tag: str) -> str:
    """The ring's obs: compact leaves finite with MEC ids in [0, n_mec)
    (config 3 pads no agent), or finite dense obs."""
    from t2omca_tpu_torch.components.episode_buffer import CompactEntityObs
    n = ts.buffer.episodes_in_buffer
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
    2048, three classic iterations through ``run.run_classic``."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.run import Experiment
    cfg = loop_cfg()
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
    del exp, ts
    torch.cuda.empty_cache()
    return result


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
                             LOOP_ITERATIONS)
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


#: [driver]: config 3 through the CLI, as a user runs it, with the three
#: overrides it needs on the port (the flash kernels on, the learning-
#: health probes and the live plane left to a later slice); the SIGTERM
#: and the full-state evaluate steps run a cut copy (4 lanes, a ring of
#: 256, and for SIGTERM K = 1), so as not to pay another full-width
#: startup
DRIVER_CONFIG = "configs/config3_tpu_northstar.yaml"
DRIVER_OVERRIDES = ("kernels.attention=pallas", "obs.sight.enabled=false",
                    "obs.pulse_port=0")
SIGTERM_LANES = 4                   # batch_size_run 1024 -> 4
SIGTERM_RING = 256                  # replay.buffer_size 2048 -> 256
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


def _timed_iterations(torch, run_mod):
    """Wrap ``run.run_classic`` so a K-iteration dispatch runs as K calls
    of one iteration each (the same work: ``run_classic`` chains its
    iterations exactly so) with a CUDA event after each: the device
    timeline between the events is each iteration's time, with no added
    synchronize. → (events list, restore function)."""
    original = run_mod.run_classic
    events = []

    def timed(exp, ts, n, cursor=None, sync=False):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks, recs = [start], []
        for _ in range(n):
            ts, cursor, (rec,) = original(exp, ts, 1, cursor, sync)
            recs.append(rec)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        events.append(marks)
        return ts, cursor, recs

    run_mod.run_classic = timed
    return events, lambda: setattr(run_mod, "run_classic", original)


def phase_driver(torch, att, loop: dict) -> dict:
    """The training driver through ``python -m t2omca_tpu_torch``'s
    ``main``: config 3 uncut (one K = 4 dispatch, the test, save and log
    cadences), an exact resume, a SIGTERM'd subprocess and evaluate."""
    import gc
    import glob
    import shutil
    import signal
    import tempfile
    import numpy as np
    from t2omca_tpu_torch import __main__ as cli
    from t2omca_tpu_torch import run as run_mod
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.runners.episode_runner import EpisodeRunner
    from t2omca_tpu_torch.utils import checkpoint as ckpt
    from t2omca_tpu_torch.utils import resilience
    root = os.path.dirname(os.path.abspath(__file__))
    cfg3 = os.path.join(root, DRIVER_CONFIG)
    cfg = load_config(cfg3, DRIVER_OVERRIDES)
    k = cfg.superstep
    per = k * cfg.batch_size_run * cfg.env_args.episode_limit
    check(k > 1 and cfg.t_max < per, f"[driver] {DRIVER_CONFIG} does not "
          f"train exactly one K={k} dispatch (t_max {cfg.t_max})")
    want = {name: k * v for name, v in loop_launches(cfg).items()}
    timeout = max(120.0, round(4 * k * loop["iteration_p50_ms"] / 1e3))
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_driver_", dir=root)
    base = ["--config", cfg3, *DRIVER_OVERRIDES]
    result = {}
    logs = _LogLines()
    try:
        # ---- 1. train: config 3 uncut, one dispatch of K = 4 ----------
        out1 = os.path.join(tmp, "train")
        events, unwrap = _timed_iterations(torch, run_mod)
        att.reset_launches()             # ---- the driver path starts here
        t_start = time.time()
        try:
            rc = cli.main(["train", *base,
                           f"resilience.dispatch_timeout={timeout}",
                           f"local_results_path={out1}"])
        finally:
            unwrap()
        torch.cuda.synchronize()
        train_wall = time.time() - t_start
        launches = dict(att.LAUNCHES)    # ---- and ends here
        check(rc == 0, f"[driver] train returned {rc}")
        check(len(events) == 1, f"[driver] {len(events)} dispatches, "
                                f"expected one")
        check(launches == want, f"[driver] launches {launches} != {want}")
        iters_ms = [a.elapsed_time(b) for a, b in zip(events[0],
                                                      events[0][1:])]
        rows = _metric_rows(out1)
        keys = {r["key"] for r in rows}
        missing = [k for k in DRIVER_KEYS if k not in keys]
        check(not missing, f"[driver] metrics.jsonl lacks {missing}")
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
              f"{disp['wall_ms']:.0f} ms; iterations (device timeline) "
              f"{', '.join(f'{x:.0f}' for x in iters_ms)} ms against "
              f"[loop]'s iteration p50 {loop['iteration_p50_ms']:.0f} ms "
              f"(driver overhead {sum(iters_ms) / k - loop['iteration_p50_ms']:+.0f}"
              f" ms an iteration); test rollout "
              f"{test_ms[0] if test_ms else float('nan'):.0f} ms; whole "
              f"call {train_wall:.1f} s", flush=True)
        print(f"[driver] checkpoint: {save['save_bytes'] / 1e9:.3f} GB, "
              f"device->host {save['save_copy_s']:.2f} s, write+fsync "
              f"{save['save_write_s']:.2f} s "
              f"({save['save_bytes'] / 1e9 / save['save_write_s']:.2f} GB/s),"
              f" hash {save['save_hash_s']:.2f} s", flush=True)
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
        shutil.rmtree(model_dir, ignore_errors=True)   # free the disk early
        resumed_models = _one_dir(os.path.join(out2, "models", "*"))

        # ---- 3. SIGTERM: a subprocess, after its first dispatch logged -
        out3 = os.path.join(tmp, "sigterm")
        cut = [f"batch_size_run={SIGTERM_LANES}",
               f"replay.buffer_size={SIGTERM_RING}"]
        # K = 1 here: a SIGTERM waits for the dispatch in flight, and one
        # iteration bounds that wait (and runs the K = 1 dispatches)
        proc = subprocess.Popen(
            [sys.executable, "-m", "t2omca_tpu_torch", "train", *base, *cut,
             "superstep=1", "t_max=100000000",
             "save_model_interval=100000000",
             f"log_interval={SIGTERM_LANES * cfg.env_args.episode_limit}",
             f"test_nepisode={SIGTERM_LANES}", f"local_results_path={out3}"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        lines = []
        try:
            deadline = time.time() + 300
            for line in proc.stdout:     # the second log cadence's line
                lines.append(line)
                if ("Recent stats" in line and "env_steps_per_sec" in line
                        or time.time() > deadline):
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
              f"{cfg.replay.buffer_size} -> {SIGTERM_RING}, superstep {k} -> "
              f"1, log_interval -> one dispatch) "
              f"SIGTERM'd after its first dispatch logged: exit 0 in "
              f"{sig_s:.2f} s, emergency checkpoint at t_env "
              f"{sig_found[1]} verified, resume hint logged, "
              f"flight_recorder.json with memwatch (peak "
              f"{max(hw, default=0) / 2 ** 30:.2f} GiB)", flush=True)
        result["sigterm_to_exit_s"] = sig_s

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
              f"episode (p50, B=1, T=150)", flush=True)
        result["eval_episode_ms"] = per_ep * 1e3
    finally:
        logs.close()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return result


def main() -> int:
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
        t0 = time.perf_counter()

    lap("build")
    errs, times = phase_kernels(torch, att)
    lap("kernels")
    launches, fes, requests = phase_serve(torch, att)
    lap("serve")
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
    loop = phase_loop(torch, att)
    lap("loop")
    dense = phase_loop_dense(torch, att)
    lap("loop-dense")
    noisy = phase_loop_noisy(torch, att)
    lap("loop-noisy")
    driver = phase_driver(torch, att, loop)
    lap("driver")
    loops = {"loop": loop, "loop_dense": dense, "loop_noisy": noisy,
             "driver": {"launches": {
                 k: driver["launches"][k] + driver["launches_resume"][k]
                 for k in driver["launches"]}}}

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
            "learner_shapes": learner_times(name),
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
                             if n.startswith(tc_of[k["name"]])}
    print(f"[summary] trainer step p50: bf16 {train['p50_bf16_ms']:.1f} ms, "
          f"f32 {train['p50_f32_ms']:.1f} ms (T="
          f"{train['f32_episode_limit']})", flush=True)
    print(f"[summary] loop (default stack, {LOOP_LANES} lanes, ring "
          f"{LOOP_RING}, T=150): rollout p50 {loop['rollout_p50_ms']:.1f} ms "
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
    print(f"[summary] driver (config 3 via python -m t2omca_tpu_torch, one "
          f"K=4 dispatch): startup {driver['startup_s']:.2f} s, dispatch "
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
    sys.exit(main())
