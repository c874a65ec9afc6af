#!/usr/bin/env python3
"""How far the learner's f32 pallas-vs-xla check (``chip_smoke.py``
``[train]``) moves when only the attention changes: the same f32 trainer
step at batch 2 (north-star widths, T = 150, the mixer gate opened to
1e-3, as ``cross_check_step`` runs it), with the flash-attention kernels
replaced by variants, each held against the ``xla`` path by the check's
own metrics (loss, grad_norm, the worst clipped gradient relative to its
tensor's max; the limit is 1e-3):

* ``kernels``: the port's kernels as they are;
* ``exact``: every kernel output computed in f64 by the plain versions
  and rounded once to f32;
* ``exact_out``: only K1's output exact (m, l and the gradients from the
  kernels), and ``exact_res`` / ``exact_dq`` / ``exact_dkv``: only those;
* ``noise_0.25ulp`` / ``noise_1ulp``: the exact forward output plus
  seeded Gaussian noise of that many ulps before the rounding;
* ``f32_order``: the forward output of the plain f32 version summed in
  another order (head dims and keys permuted alike).

Run from the repository root on one NVIDIA GPU:

    python3 scripts/torch_f32_xcheck.py [--paths dense qslice]

Prints one line per variant and path.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

SEED = 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", nargs="+", default=["dense", "qslice"],
                    choices=["dense", "qslice"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_f32_xcheck: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from t2omca_tpu_torch.components.episode_buffer import \
        PrioritizedReplayBuffer
    from t2omca_tpu_torch.envs.registry import make_env
    from t2omca_tpu_torch.kernels import attention as att
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    cfg = cs.train_cfg("bfloat16")
    info = make_env(cfg.env_args).get_env_info()
    t = cfg.env_args.episode_limit
    buffer = PrioritizedReplayBuffer(
        capacity=cs.RING, episode_limit=t, n_agents=info["n_agents"],
        n_actions=info["n_actions"], obs_dim=info["obs_shape"],
        state_dim=info["state_shape"], store_dtype="bfloat16",
        alpha=cfg.replay.per_alpha, beta0=cfg.replay.per_beta,
        t_max=cfg.t_max)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    ring = buffer.insert_episode_batch(
        buffer.init(), cs.make_episodes(torch, info, cs.RING, t, g,
                                        torch.bfloat16))
    batch, _, w = buffer.sample(
        ring, None, 2, 1000, u=torch.tensor([0.25, 0.75], device="cuda"))

    k_fwd, k_res, k_bwd = att._launch, att._launch_res, att._launch_bwd
    noise_gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def exact_fwd(q, k, v, bias, causal):
        return att.flash_attention_fwd_reference(
            q.double(), k.double(), v.double(), bias, causal)

    def ulp(x):
        return torch.pow(2.0, torch.floor(torch.log2(
            x.abs().clamp(min=1e-30))) - 23)

    def noisy(units):
        def out(q, k, v, bias, causal):
            o = exact_fwd(q, k, v, bias, causal)[0]
            n = torch.randn(o.shape, device=o.device, dtype=o.dtype,
                            generator=noise_gen)
            return (o + units * n * ulp(o)).float()
        return out

    def f32_order(q, k, v, bias, causal):
        pd = torch.randperm(q.shape[-1], device=q.device,
                            generator=noise_gen)
        pk = torch.randperm(k.shape[2], device=q.device, generator=noise_gen)
        if causal:   # a permuted key order would move the causal mask
            return att.flash_attention_reference(q, k, v, bias, causal)
        b = None if bias is None else torch.broadcast_to(
            bias, q.shape[:3] + (k.shape[2],))[..., pk]
        return att.flash_attention_reference(
            q[..., pd], k[..., pd][:, :, pk], v[:, :, pk], b, False)

    def variant(out=None, res=False, dq=False, dkv=False):
        """Kernel launchers with some outputs replaced: ``out`` computes
        K1's output, ``res`` takes m and l exact, ``dq`` / ``dkv`` the
        gradients."""
        def launch(q, k, v, bias, causal):
            if out is None:
                return k_fwd(q, k, v, bias, causal)
            return out(q, k, v, bias, causal)

        def launch_res(q, k, v, bias, causal):
            o, m, l = k_res(q, k, v, bias, causal)
            if out is not None:
                o = out(q, k, v, bias, causal)
            if res:
                _, m, l = (x.float() for x in exact_fwd(q, k, v, bias,
                                                        causal))
            return o, m, l

        def launch_bwd(q, k, v, bias, causal, o, m, l, do):
            dq_, dk_, dv_ = k_bwd(q, k, v, bias, causal, o, m, l, do)
            if dq or dkv:
                ex = att.flash_attention_bwd_reference(
                    q.double(), k.double(), v.double(), bias, causal,
                    o.double(), m.double(), l.double(), do.double())
                if dq:
                    dq_ = ex[0].float()
                if dkv:
                    dk_, dv_ = ex[1].float(), ex[2].float()
            return dq_, dk_, dv_
        return launch, launch_res, launch_bwd

    def exact_out(q, k, v, bias, causal):
        return exact_fwd(q, k, v, bias, causal)[0].float()

    variants = {
        "kernels": (k_fwd, k_res, k_bwd),
        "exact": variant(exact_out, True, True, True),
        "exact_out": variant(exact_out),
        "exact_res": variant(res=True),
        "exact_dq": variant(dq=True),
        "exact_dkv": variant(dkv=True),
        "noise_0.25ulp": variant(noisy(0.25)),
        "noise_1ulp": variant(noisy(1.0)),
        "f32_order": variant(f32_order),
    }

    def summary(a, b):
        (lp, gp, cp, _), (lx, gx, cx, _) = a, b
        worst, where = 0.0, None
        for m in cx:
            for k in cx[m]:
                mx = cx[m][k].abs().max().item()
                if mx > 0:
                    rel = (cp[m][k] - cx[m][k]).abs().max().item() / mx
                    if rel > worst:
                        worst, where = rel, f"{m}.{k}"
        return (f"loss rel {abs(lp - lx) / abs(lx):.2e}, grad_norm rel "
                f"{abs(gp - gx) / abs(gx):.2e}, worst clipped gradient "
                f"{worst:.2e} of its max ({where}; limit 1e-3)")

    for path in args.paths:
        use_qslice = path == "qslice"
        xla = cs.cross_check_step(torch, info, "xla", use_qslice, batch, w)
        for name, fns in variants.items():
            att._launch, att._launch_res, att._launch_bwd = fns
            try:
                out = cs.cross_check_step(torch, info, "pallas", use_qslice,
                                          batch, w)
            finally:
                att._launch, att._launch_res, att._launch_bwd = (
                    k_fwd, k_res, k_bwd)
            print(f"[xcheck] {path} {name} vs xla: {summary(out, xla)}",
                  flush=True)
            del out
        del xla
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
