"""Time one plain dropout mask draw (``prng.bernoulli``: threefry2x32 in
plain torch ops, the dropout-mask kernel's plain version) and one dropout
application (``models.transformer.dropout``, whose mask is the kernel's on
the card) at the shapes config 3's dense paths give it: the learner's agent unroll (B·64 sequences of
65 tokens x emb 256), the mixer (B of 131 tokens), and a rollout of L
lanes (L·64 sequences).

    python scripts/torch_dropout_mask_cost.py [--batch 32] [--lanes 128]
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def cuda_ms(fn, iters=5, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=128)
    args = ap.parse_args()
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.flax_rng import Scope
    from t2omca_tpu_torch.models.transformer import dropout
    key = prng.PRNGKey(0, "cuda")
    shapes = {"agent": (args.batch * 64, 65, 256),
              "mixer": (args.batch, 131, 256),
              "rollout": (args.lanes * 64, 65, 256)}
    for name, shape in shapes.items():
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
        n = x.numel()
        mask_ms = cuda_ms(lambda: prng.bernoulli(key, 0.9, shape))
        drop_ms = cuda_ms(lambda: dropout(x, 0.1, Scope(key)))
        torch.cuda.reset_peak_memory_stats()
        dropout(x, 0.1, Scope(key))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[mask-cost] {name} {shape} ({n / 1e6:.1f} M elements): "
              f"bernoulli {mask_ms:.2f} ms, dropout {drop_ms:.2f} ms "
              f"({drop_ms / n * 1e9:.2f} ns an element), peak "
              f"{peak:.2f} GiB", flush=True)
        del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
