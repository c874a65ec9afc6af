"""``python -m t2omca_tpu_torch.obs`` — the port's telemetry CLI (port of
``python -m t2omca_tpu.obs``).

Subcommands:

``report <run_dir> [--programs-json F] [--peak-gflops G --peak-gbps B]``
    The per-program table of a run recorded with ``obs.enabled``
    (``obs/report.py``): its spans, its ``device_times.json`` (written
    under ``obs.program_trace``), the scenario slices and the learning
    section, joined against the budgets of a given programs file. Exit
    0 = report printed, 2 = usage error. A torn final JSONL line is
    skipped with a warning; a run directory holding only
    ``flight_recorder.json`` reports from the flight tail.

``timeline [BENCH_r*.json ...] [--runs <run_dir> ...] [--json]``
    The perf-trajectory table over BENCH records and recorded runs'
    ``metrics.jsonl`` (``obs/timeline.py``).

``learning <run_dir>``
    The learning-health report (``obs/learning.py``): per-module
    gradient norms, PER health, attention entropies, value histograms,
    detector verdicts and learning curves from the run's
    ``metrics.jsonl``.

None of them imports torch: the post-mortem host may have no device
stack at all.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m t2omca_tpu_torch.obs",
        description="run telemetry tools of the PyTorch port")
    sub = parser.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser(
        "report", help="per-program report for a recorded run")
    rep.add_argument("run_dir",
                     help="results directory of a run recorded with "
                          "obs.enabled=true (holds spans.jsonl)")
    rep.add_argument("--programs-json", default=None,
                     help="program budgets to join against (the schema of "
                          "t2omca_tpu/analysis/programs.json; default: "
                          "none, the budget columns read '-')")
    rep.add_argument("--peak-gflops", type=float, default=None,
                     help="chip peak GFLOP/s — adds the roofline bound "
                          "and achieved fraction per program")
    rep.add_argument("--peak-gbps", type=float, default=None,
                     help="chip peak memory bandwidth in GB/s (used "
                          "with --peak-gflops)")
    tl = sub.add_parser(
        "timeline", help="perf-trajectory table over BENCH_r*.json "
                         "records and run dirs")
    tl.add_argument("paths", nargs="*",
                    help="BENCH record files (default: BENCH_r*.json "
                         "in the current directory)")
    tl.add_argument("--runs", nargs="*", default=[], metavar="RUN_DIR",
                    help="recorded run directories whose metrics.jsonl "
                         "joins the table (newest env-steps/s)")
    tl.add_argument("--json", action="store_true",
                    help="machine-readable rows instead of the table")
    ln = sub.add_parser(
        "learning", help="learning-health report for a recorded run")
    ln.add_argument("run_dir",
                    help="results directory of a run (holds "
                         "metrics.jsonl; obs.sight.enabled adds the "
                         "learning-dynamics keys)")
    args = parser.parse_args(argv)
    if args.cmd == "learning":
        from .learning import learning_main
        return learning_main(args.run_dir)
    if args.cmd == "report":
        from .report import report_main
        return report_main(args.run_dir, args.programs_json,
                           args.peak_gflops, args.peak_gbps)
    from .timeline import timeline_main
    return timeline_main(args.paths, args.runs, as_json=args.json)


if __name__ == "__main__":
    sys.exit(main())
