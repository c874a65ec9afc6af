#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[fleet]`` and ``[report]`` phases alone, on the
card, without the rest of the smoke:

    python3 scripts/torch_fleet_report_phases.py

Builds the kernels, runs the card-only fleet, thread and artifact tests
of ``tests/test_torch_cuda.py``, exports a serving artifact of config 3
(``configs/config3_tpu_northstar.yaml`` with ``model.use_qslice=false
kernels.attention=pallas``: 64 AGVs, emb 256, depth 2) from an
agent-only checkpoint of seeded random params, writes a second such
checkpoint (another seed) as the refresh target, and calls
``phase_fleet`` and ``phase_report``. Prints each phase's lines and
seconds. About three minutes with the build; needs one NVIDIA GPU.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.envs.registry import make_env
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.kernels import build
    from t2omca_tpu_torch.serve import __main__ as serve_cli
    from t2omca_tpu_torch.utils.checkpoint import save_checkpoint
    t0 = time.time()
    build.build()
    build.load()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "cuda",
                        "--noconftest", "tests/test_torch_cuda.py", "-k",
                        "fleet or threads or serve_artifact"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    print(f"cuda tests rc {r.returncode}: {r.stdout[-500:]}", flush=True)
    root = tempfile.mkdtemp(dir=ROOT, prefix=".fleet_report_")
    try:
        cfg3 = os.path.join(ROOT, cs.DRIVER_CONFIG)
        over = cs.ARTIFACT_VARIANTS["pallas"]
        cfg = load_config(cfg3, over)
        info = make_env(cfg.env_args).get_env_info()
        for name, seed, t in (("resumed", 0, 1228800), ("first", 1, 614400)):
            mac = BasicMAC.build(cfg, info, "cpu")
            sd = mac.init_params(torch.Generator().manual_seed(seed))
            save_checkpoint(os.path.join(root, name), t,
                            {"learner": {"params": {"agent": sd}}})
        art = os.path.join(root, "art")
        cs.check(serve_cli.main(["export", os.path.join(root, "resumed"),
                                 "--config", cfg3, "--out", art,
                                 *over]) == 0, "export")
        t0 = time.time()
        cs.phase_fleet(torch, att, art, over, os.path.join(root, "first"),
                       False)
        print(f"[fleet] {time.time() - t0:.1f} s", flush=True)
        t0 = time.time()
        cs.phase_report(torch, cs.smi_line())
        print(f"[report] {time.time() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0 if r.returncode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
