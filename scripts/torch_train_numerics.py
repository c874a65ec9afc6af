#!/usr/bin/env python3
"""Numerics and memory of the PyTorch port's trainer step on one NVIDIA GPU.

Three measurements at the north-star widths (``chip_smoke.NORTH_STAR``),
printed one per line; the numbers behind ``PERF.md``'s findings on the
f32 pallas-vs-xla cross-check and on peak memory:

1. drift: the online agent unroll in f32 under ``kernels.attention``
   pallas and xla from the same params and batch (batch 2, T = 150): the
   max |Δq| and |Δh| at a few time steps, and how many double-Q argmaxes
   differ;
2. sweep: one f32 train step per lowering over T ∈ {10, 30, 50, 150}
   and three operating points (the reference init; the zero-init mixer
   gate opened to 1e-3 and 1e-2): loss and grad_norm relative
   differences and the largest parameter difference after the step;
3. memory: bytes kept for the backward per online agent step and per
   online mixer step at bf16, batch 32.

Run from the repository root on the card: ``python3
scripts/torch_train_numerics.py``. It checks nothing and exits 0 when
every measurement ran.
"""

from __future__ import annotations

import dataclasses
import os
import sys


def batch_for(torch, cs, info, t: int, b: int, g):
    from t2omca_tpu_torch.components.episode_buffer import \
        PrioritizedReplayBuffer
    cap = max(8, b)
    buf = PrioritizedReplayBuffer(
        capacity=cap, episode_limit=t, n_agents=info["n_agents"],
        n_actions=info["n_actions"], obs_dim=info["obs_shape"],
        state_dim=info["state_shape"], store_dtype="bfloat16")
    ring = buf.insert_episode_batch(
        buf.init(), cs.make_episodes(torch, info, cap, t, g, torch.bfloat16))
    u = (torch.arange(b, device="cuda") + 0.5) / b
    batch, _, w = buf.sample(ring, b, 1000, u=u)
    return batch, w


def learner_at(torch, cs, info, attention, t, gate, dtype="float32",
               batch_size=2):
    cfg = cs.train_cfg(dtype, attention, True, batch_size=batch_size,
                       episode_limit=t)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, mixer_zero_init=gate is not None))
    lrn = cs.build_learner(cfg, info)
    ls = lrn.init_state(torch.Generator().manual_seed(cs.SEED))
    if gate is not None:
        for tree in (ls.params, ls.target_params):
            tree["mixer"]["out_gate"].fill_(gate)
    return lrn, ls


def drift(torch, cs, info, g):
    batch, _ = batch_for(torch, cs, info, 150, 2, g)
    obs = batch.obs.transpose(0, 1).float()
    avail = batch.avail_actions.transpose(0, 1)
    out = {}
    with torch.no_grad():
        for attention in ("pallas", "xla"):
            lrn, ls = learner_at(torch, cs, info, attention, 150, None)
            out[attention] = lrn._unroll_agent(ls.params["agent"], obs)
    (qp, hp), (qx, hx) = out["pallas"], out["xla"]
    for t in (0, 10, 50, 100, 150):
        print(f"[drift] t={t}: max|dq| {(qp[t] - qx[t]).abs().max():.3e} "
              f"max|dh| {(hp[t] - hx[t]).abs().max():.3e}", flush=True)
    best = [torch.where(avail, q, float("-inf")).argmax(-1)
            for q in (qp, qx)]
    print(f"[drift] double-Q argmax mismatches: "
          f"{int((best[0] != best[1]).sum())} of {best[0].numel()}",
          flush=True)


def sweep(torch, cs, info, g):
    for t in (10, 30, 50, 150):
        batch, w = batch_for(torch, cs, info, t, 2, g)
        for gate in (None, 1e-3, 1e-2):
            res = {}
            for attention in ("pallas", "xla"):
                lrn, ls = learner_at(torch, cs, info, attention, t, gate)
                ls2, inf = lrn.train(ls, batch, w, 1000, 8)
                res[attention] = (float(inf["loss"]),
                                  float(inf["grad_norm"]), ls2.params)
            (lp, gp, pp), (lx, gx, px) = res["pallas"], res["xla"]
            dparam = max((pp[m][k] - px[m][k]).abs().max().item()
                         for m in pp for k in pp[m])
            print(f"[sweep] T={t} gate={gate}: loss {lx:.4g} rel "
                  f"{abs(lp - lx) / abs(lx):.2e}, grad_norm {gx:.3e} rel "
                  f"{abs(gp - gx) / gx:.2e}, max|dparam| {dparam:.2e}",
                  flush=True)


def memory(torch, cs, info, g):
    batch, _ = batch_for(torch, cs, info, 150, 32, g)
    lrn, ls = learner_at(torch, cs, info, "pallas", 150, None, "bfloat16",
                         32)
    params = {m: {k: v.detach().requires_grad_() for k, v in sub.items()}
              for m, sub in ls.params.items()}
    obs = batch.obs.transpose(0, 1).float()
    state = batch.state.transpose(0, 1).float()
    steps = 10
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    kept = lrn._unroll_agent(params["agent"], obs[:steps + 1], n_grad=steps)
    torch.cuda.synchronize()
    agent = (torch.cuda.memory_allocated() - m0) / steps / 2 ** 20
    del kept
    chosen = torch.zeros(steps, 32, info["n_agents"], device="cuda",
                         requires_grad=True)
    hid = torch.zeros(steps, 32, info["n_agents"], lrn.mixer.emb,
                      device="cuda", requires_grad=True)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    kept = lrn._unroll_mixer(params["mixer"], chosen, hid, state[:steps],
                             obs[:steps])
    torch.cuda.synchronize()
    mixer = (torch.cuda.memory_allocated() - m0) / steps / 2 ** 20
    print(f"[memory] bf16 batch 32: {agent:.1f} MiB per online agent step "
          f"and {mixer:.1f} MiB per online mixer step kept for the "
          f"backward", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_train_numerics: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from t2omca_tpu_torch.envs.registry import make_env
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    info = make_env(cs.train_cfg("float32").env_args).get_env_info()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    drift(torch, cs, info, g)
    sweep(torch, cs, info, g)
    memory(torch, cs, info, g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
