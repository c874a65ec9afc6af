"""CLI: ``python -m t2omca_tpu_torch <train|evaluate|benchmark> [--config f]
[key=value ...]`` (the port of ``python -m t2omca_tpu``).

Subcommands instead of sacred command-line magic, ``key=value`` /
``section.key=value`` overrides instead of ``with config.yaml``.
Examples::

    python -m t2omca_tpu_torch train --config configs/config3_tpu_northstar.yaml \\
        kernels.attention=pallas obs.sight.enabled=false obs.pulse_port=0
    python -m t2omca_tpu_torch evaluate checkpoint_path=results/models/<token>
    python -m t2omca_tpu_torch benchmark checkpoint_path=... test_nepisode=32

The run goes on the CUDA card and raises when there is none: the CLI
has no CPU fallback. ``--device cpu`` asks for the CPU by name (as
``run.run(cfg, device="cpu")`` does in process). Multi-host
initialization is not ported (``dp_devices`` raises, ``ROADMAP.md`` item
12).
"""

from __future__ import annotations

import argparse
import sys

from .config import load_config
from .run import run
from .utils.logging import Logger


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="t2omca_tpu_torch")
    parser.add_argument("command",
                        choices=["train", "evaluate", "benchmark"])
    parser.add_argument("--config", default=None,
                        help="YAML/JSON config file")
    parser.add_argument("--device", default=None,
                        help="device to run on (default: cuda)")
    parser.add_argument("overrides", nargs="*",
                        help="key=value config overrides")
    # intermixed: the overrides may follow --config (plain parse_args
    # takes the empty override list before it and rejects the rest)
    args = parser.parse_intermixed_args(argv)

    cfg = load_config(args.config, tuple(args.overrides))
    if args.command in ("evaluate", "benchmark"):
        cfg = cfg.replace(evaluate=True)
    if args.command == "benchmark":
        cfg = cfg.replace(benchmark_mode=True)
    run(cfg, Logger(), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
