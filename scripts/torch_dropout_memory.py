"""Peak device memory and time of one dropout trainer step at config 3's
widths on the card: the dense agent and mixer (dropout 0.1 makes the
query-slice reductions ineligible), bf16, pallas, batch 32, with
``model.remat`` off at short episodes (its saved activations grow with
T) and on at T = 150.

    python scripts/torch_dropout_memory.py [--short 10,20] [--remat-t 150]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--short", default="10,20")
    ap.add_argument("--remat-t", type=int, default=150)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.kernels import build
    from t2omca_tpu_torch.learners import QMixLearner
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    build.build()
    build.load()
    print(cs.smi_line(), flush=True)
    runs = [(int(t), False) for t in args.short.split(",")]
    runs.append((args.remat_t, True))
    for t, remat in runs:
        cfg = cs.train_cfg("bfloat16", "pallas", use_qslice=False,
                           episode_limit=t, remat=remat, dropout=0.1)
        from t2omca_tpu_torch.envs.registry import make_env
        info = make_env(cfg.env_args, device="cuda").get_env_info()
        lrn = QMixLearner.build(cfg, BasicMAC.build(cfg, info), info)
        ls = lrn.init_state(torch.Generator().manual_seed(cs.SEED))
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
        batch = cs.make_episodes(torch, info, 32, t, g, torch.bfloat16)
        w = torch.ones(32, device="cuda")
        times = []
        for i in range(2):
            key = prng.PRNGKey(cs.SEED + i, "cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            ls, info_ = lrn.train(ls, batch, w, 1000, 64, key)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f"[dropout-memory] T={t} remat={remat}: a trainer step "
              f"{times[-1]:.0f} ms (first {times[0]:.0f}), peak above the "
              f"held state {peak:.2f} GiB, loss {float(info_['loss']):.4g}",
              flush=True)
        del lrn, ls, batch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
