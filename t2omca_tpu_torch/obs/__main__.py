"""``python -m t2omca_tpu_torch.obs`` — the port's telemetry CLI.

Subcommands:

``learning <run_dir>``
    The learning-health report (``obs/sight.learning_main``): per-module
    gradient norms, PER health, attention entropies, value histograms,
    detector verdicts and learning curves from the run's
    ``metrics.jsonl`` (tolerant reader — a killed run's torn tail is
    skipped with a warning). Answers "is this run learning?" after the
    fact, with no device.

``report <run_dir>`` and ``timeline``
    The per-program roofline report and the perf-trajectory table of the
    JAX package are not ported yet (``ROADMAP.md`` item 13b): both
    raise.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m t2omca_tpu_torch.obs",
        description="run telemetry tools of the PyTorch port")
    sub = parser.add_subparsers(dest="cmd", required=True)
    ln = sub.add_parser(
        "learning", help="learning-health report for a recorded run")
    ln.add_argument("run_dir",
                    help="results directory of a run (holds "
                         "metrics.jsonl; obs.sight.enabled adds the "
                         "learning-dynamics keys)")
    for name in ("report", "timeline"):
        sub.add_parser(name, help="not ported yet (ROADMAP.md item 13b)",
                       add_help=False).add_argument("args", nargs="*")
    args = parser.parse_args(argv)
    if args.cmd == "learning":
        from .sight import learning_main
        return learning_main(args.run_dir)
    raise NotImplementedError(
        f"`obs {args.cmd}` is not ported yet (ROADMAP.md Queue A item 13b)")


if __name__ == "__main__":
    sys.exit(main())
