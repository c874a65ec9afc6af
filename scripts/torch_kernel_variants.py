#!/usr/bin/env python3
"""Time variants of the f32 K1 and K3 sources side by side on one card.

Each variant is a copy of ``t2omca_tpu_torch/kernels/csrc/<source>``
with some lines replaced (a register cap, the warps that split D, the
ring depth). ``nvcc`` builds every copy at once into its own shared
library with the plain C entry point (``t2o_flash_fwd_f32`` or
``t2o_flash_bwd_dkv_f32``), called through ``ctypes`` on the same
seeded inputs. For each variant: ptxas registers and spill bytes at
D = 256 and D = 64, the largest error against the plain version, and
CUDA-event times at the serve (K1 only), agent and mixer shapes, with
k and v apart and as one tensor. The build goes to ``--out`` (default
``scratch_chip/var``, gitignored). Run from the repository root on one
NVIDIA GPU:

    python3 scripts/torch_kernel_variants.py [--only NAME ...]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

CSRC = os.path.join("t2omca_tpu_torch", "kernels", "csrc")
K1, K3 = "flash_fwd_dmma.cu", "flash_bwd_dkv_3xtf32.cu"
#: name -> (source, [(text, replacement), ...])
VARIANTS = {
    "k1": (K1, []),
    "k1_uncapped": (K1, [("kThreads,\n                                  "
                          "DP <= 64 ? 2 : 3)", "kThreads, 1)")]),
    "k1_uncapped_d256": (K1, [("DP <= 64 ? 2 : 3)", "2)")]),
    "k1_8warps": (K1, [("kSplit = DP >= 128 ? DP / 64 : 1;",
                        "kSplit = DP >= 128 ? DP / 32 : 1;"),
                       ("DP <= 64 ? 2 : 3)", "2)")]),
    "k1_2rowtiles": (K1, [("DP <= 64 ? 8 : DP == 128 ? 2 : 1",
                           "DP <= 64 ? 8 : 2"), ("DP <= 64 ? 2 : 3)", "2)")]),
    "k3": (K3, []),
    "k3_uncapped": (K3, [("kSplit * 32, 3)", "kSplit * 32, 2)")]),
    "k3_8warps": (K3, [("kSplit = DP >= 64 ? DP / 64 : 1;",
                        "kSplit = DP >= 256 ? DP / 32 : DP >= 64 ? DP / 64 "
                        ": 1;"), ("kSplit * 32, 3)", "kSplit * 32, 2)")]),
    "k3_3stages": (K3, [("kStages = 2;", "kStages = 3;")]),
}
SHAPES = {"serve": (4096, 4, 65, 65, 64), "agent": (2048, 1, 4, 65, 256),
          "mixer": (32, 1, 268, 131, 256)}


def build_all(names, out):
    sys.path.insert(0, os.getcwd())
    from t2omca_tpu_torch.kernels import build
    nvcc = build._nvcc()
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in names:
        src, subs = VARIANTS[name]
        text = open(os.path.join(CSRC, src)).read()
        for a, b in subs:
            if a not in text:
                raise RuntimeError(f"{name}: {a!r} not in {src}")
            text = text.replace(a, b)
        path = os.path.join(out, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", f"-I{CSRC}", path, "-o",
             os.path.join(out, f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: build failed\n{err[-3000:]}")
        usage, fn = [], None
        for ln in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", ln)
            spill = m.group(1) if m else None
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn and re.search(r"Li(256|64)E(Lb0E)?E", fn):
                d = re.search(r"Li(\d+)E", fn).group(1)
                usage.append(f"D {d}: {m.group(1)} registers")
            if spill and spill != "0" and fn:
                usage.append(f"spills {spill} bytes in {fn}")
        print(f"[variants] {name}: {'; '.join(usage)}", flush=True)
        libs[name] = ctypes.CDLL(os.path.abspath(
            os.path.join(out, f"lib{name}.so")))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS))
    ap.add_argument("--out", default=os.path.join("scratch_chip", "var"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_all(args.only or list(VARIANTS), args.out)
    sys.path.insert(0, os.getcwd())
    from t2omca_tpu_torch.kernels import attention as att
    torch.backends.cuda.matmul.allow_tf32 = False
    P = ctypes.c_void_p

    def ptr(t):
        return P(None if t is None else t.data_ptr())

    def strides(*ts):
        s = [x for t in ts for x in (t.stride() if t is not None
                                     else (0, 0, 0, 0))]
        return (ctypes.c_int64 * len(s))(*s)

    def cuda_ms(fn, iters=30, warmup=3):
        for _ in range(warmup):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    stream = P(torch.cuda.current_stream().cuda_stream)
    for sname, (b, h, tq, tk, d) in SHAPES.items():
        for kv in (False, True):
            if sname == "serve" and kv:
                continue
            q, k = (torch.randn(b, h, t, d, device=dev, generator=g)
                    * d ** -0.25 for t in (tq, tk))
            v = k if kv else torch.randn(b, h, tk, d, device=dev,
                                         generator=g)
            do = torch.randn(b, h, tq, d, device=dev, generator=g)
            o_r, m_r, l_r = att.flash_attention_fwd_reference(q, k, v)
            _, dk_r, dv_r = att.flash_attention_bwd_reference(
                q, k, v, None, False, o_r, m_r, l_r, do)
            delta = (do * o_r).sum(-1)
            tag = f"{sname}{' k_is_v' if kv else ''}"
            for name, lib in libs.items():
                if name.startswith("k1"):
                    o = torch.empty_like(q)
                    m, l = torch.empty(q.shape[:3], device=dev), \
                        torch.empty(q.shape[:3], device=dev)
                    st = strides(q, k, v, None, o)

                    def k1(res):
                        return lib.t2o_flash_fwd_f32(
                            ptr(q), ptr(k), ptr(v), ptr(None), ptr(o),
                            ptr(m if res else None), ptr(l if res else None),
                            b, h, tq, tk, d, st, 0, stream)
                    rc = k1(True)
                    torch.cuda.synchronize()
                    err = (o - o_r).abs().max().item()
                    print(f"[variants] {name} {tag}: rc {rc}, max|o - "
                          f"plain| {err:.2e}; K1 "
                          f"{cuda_ms(lambda: k1(False)):.4f} ms, K1 + res "
                          f"{cuda_ms(lambda: k1(True)):.4f} ms", flush=True)
                elif sname != "serve":
                    dk, dv = torch.empty_like(k), torch.empty_like(v)
                    st = strides(q, k, v, do, None, q, dk, dv)

                    def k3():
                        return lib.t2o_flash_bwd_dkv_f32(
                            ptr(q), ptr(k), ptr(v), ptr(None), ptr(do),
                            ptr(m_r), ptr(l_r), ptr(delta), ptr(dk),
                            ptr(dv), b, h, tq, tk, d, st, 0, stream)
                    rc = k3()
                    torch.cuda.synchronize()
                    err = max((dk - dk_r).abs().max().item(),
                              (dv - dv_r).abs().max().item())
                    print(f"[variants] {name} {tag}: rc {rc}, max|dk, dv - "
                          f"plain| {err:.2e}; K3 {cuda_ms(k3):.4f} ms",
                          flush=True)
            del q, k, v, do
    return 0


if __name__ == "__main__":
    sys.exit(main())
