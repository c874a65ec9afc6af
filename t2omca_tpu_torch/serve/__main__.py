"""``python -m t2omca_tpu_torch.serve`` — the serving CLI (port of
``python -m t2omca_tpu.serve``).

Subcommands::

    # export a port training checkpoint as a serving artifact
    python -m t2omca_tpu_torch.serve export results/models/<token> \\
        --config configs/serve_smoke.yaml --out /path/to/artifact \\
        [--buckets 1,2,4,8] [--dtypes float32,bfloat16] [--load-step N] \\
        [--device cpu] [key=value overrides ...]

    # inspect an artifact
    python -m t2omca_tpu_torch.serve info /path/to/artifact

    # hot-refresh dry run: would a live fleet accept this checkpoint?
    # (the fold and check ServeFleet.refresh runs before any engine is
    # touched; a live fleet arms the real thing through its
    # <artifact>/FLEET_REFRESH trigger file)
    python -m t2omca_tpu_torch.serve refresh /path/to/artifact <ckpt_dir> \
        [--dtype float32] [--device cpu]

Exit codes: 0 done (export written, refresh compatible), 2 usage error
(a bad config, a missing or mismatched checkpoint, an unreadable
artifact, a refused refresh). The export config must be the training
run's config: the exporter rebuilds the MAC from it and checks the
checkpoint's shapes against it. The export and the refresh check fold on
``cuda`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

COMMANDS = ("export", "info", "refresh")


def _parse_int_list(s: str):
    try:
        return [int(x) for x in s.split(",") if x.strip()]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected a comma-separated int list, got {s!r}")


def _export_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m t2omca_tpu_torch.serve export",
        description="export a checkpoint as a serving artifact")
    p.add_argument("ckpt_dir", help="checkpoint directory (the training "
                                    "run's results/models/<token>)")
    p.add_argument("--config", default=None,
                   help="the TRAINING config (YAML/JSON)")
    p.add_argument("--out", default=None,
                   help="artifact output dir (default: <ckpt_dir>/serve)")
    p.add_argument("--buckets", type=_parse_int_list, default=None,
                   metavar="1,2,4,...",
                   help="batch buckets (default: powers of 2 up to 64)")
    p.add_argument("--dtypes", default="float32,bfloat16",
                   help="param variants to write (comma-separated)")
    p.add_argument("--load-step", type=int, default=0,
                   help="checkpoint step to export (0 = newest)")
    p.add_argument("--device", default=None,
                   help="device of the fold (default: cuda)")
    p.add_argument("overrides", nargs="*", help="key=value config overrides")
    return p


def _info(artifact_dir: str) -> int:
    meta_path = os.path.join(artifact_dir, "meta.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        print(f"serve: error: unreadable artifact meta {meta_path}: {e}",
              file=sys.stderr)
        return 2
    ck = meta.get("checkpoint", {})
    print(f"format v{meta.get('format')} ({meta.get('framework')}) — "
          f"checkpoint {ck.get('dir')} @ t_env={ck.get('t_env')}")
    print(f"model: {meta.get('n_agents')} agents x {meta.get('n_actions')} "
          f"actions, obs {meta.get('obs_dim')}, emb {meta.get('emb')}, "
          f"folded={meta.get('folded')}")
    print(f"buckets: {meta.get('buckets')}")
    for dt, p in sorted(meta.get("params", {}).items()):
        print(f"params[{dt}]: {p.get('bytes')} bytes "
              f"sha256={str(p.get('sha256'))[:12]}…")
    prov = meta.get("provenance", {})
    print(f"provenance: git={str(prov.get('git_commit'))[:12]} "
          f"torch={prov.get('torch')} cuda={prov.get('cuda')} "
          f"device={prov.get('device')}")
    return 0


def _export(argv) -> int:
    parser = _export_parser()
    # intermixed: the overrides may follow --config
    args = parser.parse_intermixed_args(argv)
    bad = [a for a in args.overrides if "=" not in a]
    if bad:
        parser.error(f"unrecognized arguments: {' '.join(bad)}")
    from ..config import load_config
    try:
        cfg = load_config(args.config, tuple(args.overrides))
    except (OSError, KeyError, ValueError) as e:
        print(f"serve: error: bad config: {e}", file=sys.stderr)
        return 2
    from .export import DEFAULT_BUCKETS, PARAM_DTYPES, export_artifact
    out = args.out or os.path.join(args.ckpt_dir, "serve")
    try:
        meta = export_artifact(
            cfg, args.ckpt_dir, out,
            buckets=args.buckets or DEFAULT_BUCKETS,
            dtypes=tuple(d for d in args.dtypes.split(",") if d)
            or PARAM_DTYPES,
            load_step=args.load_step, device=args.device)
    except (FileNotFoundError, ValueError) as e:
        print(f"serve: error: {e}", file=sys.stderr)
        return 2
    ck = meta["checkpoint"]
    print(f"serve: artifact written to {out} (checkpoint t_env="
          f"{ck['t_env']}, buckets {meta['buckets']}, variants "
          f"{sorted(meta['params'])})")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="python -m t2omca_tpu_torch.serve",
        description="policy-serving artifacts of the PyTorch port")
    parser.add_argument("command", choices=COMMANDS)
    args = parser.parse_args(argv[:1])
    rest = argv[1:]
    if args.command == "export":
        return _export(rest)
    if args.command == "info":
        info = argparse.ArgumentParser(
            prog="python -m t2omca_tpu_torch.serve info")
        info.add_argument("artifact_dir")
        return _info(info.parse_args(rest).artifact_dir)
    ref = argparse.ArgumentParser(
        prog="python -m t2omca_tpu_torch.serve refresh",
        description="hot-refresh dry run: fold a checkpoint and check it "
                    "against an artifact")
    ref.add_argument("artifact_dir")
    ref.add_argument("ckpt_dir",
                     help="checkpoint directory holding the new params")
    ref.add_argument("--dtype", choices=("float32", "bfloat16"),
                     default="float32",
                     help="the serving param variant to check")
    ref.add_argument("--device", default=None,
                     help="device of the fold (default: cuda)")
    return _refresh(ref.parse_args(rest))


def _refresh(args) -> int:
    if not os.path.isfile(os.path.join(args.artifact_dir, "meta.json")):
        print(f"serve: error: {args.artifact_dir} is not a serve artifact "
              f"(no meta.json)", file=sys.stderr)
        return 2
    from .fleet import check_refresh
    out = check_refresh(args.artifact_dir, args.ckpt_dir, dtype=args.dtype,
                        device=args.device)
    if out["status"] != "compatible":
        print(f"serve: refresh REFUSED: {out.get('reason')}",
              file=sys.stderr)
        return 2
    print(f"serve: refresh compatible (checkpoint t_env="
          f"{out.get('t_env')}, {out.get('leaves_checked')} param leaves "
          f"checked against the artifact's {args.dtype} variant)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
