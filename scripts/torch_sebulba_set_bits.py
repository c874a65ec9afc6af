#!/usr/bin/env python3
"""Where a Sebulba learner set's step leaves the blocked step's bits:
``chip_smoke.py``'s ``[sebulba]`` learner-set leg alone, at several
episode lengths, each twice, on the card.

    python3 scripts/torch_sebulba_set_bits.py [T ...]   (default 30 50)

For each ``T`` (``env_args.episode_limit`` of
``configs/config3_sebulba.yaml``: 3 actor and 2 learner streams of the
card) it runs ``chip_smoke._sebulba_blocked_step`` twice, each a new
set from the same seed, and prints:

* the leaves of the set's new params and optimizer state that differ
  from the blocked step (the probe: the same row blocks through the
  loss one after another at world 1, eagerly, the gradients summed in
  placement order), and whether the two runs' differing leaves and
  values are the same (a race would move them between runs);
* each placement's gradient as it enters the set's sum (the flat
  buffer ``QMixLearner._reduce`` hands to ``PlacementComm.sum``)
  against the probe's gradient of the same block: equal bit for bit,
  or the first leaf and how many elements differ;
* the set's summed gradient against the probe's blocks summed;
* the pre-clip global norm (``QMixLearner``'s ``global_norm``) of that
  summed gradient recomputed here over views of one flat buffer (as the
  set's learner reads it) and over a separate tensor for each leaf (as
  the probe holds it), eagerly and in a captured graph, beside the
  set's and the probe's norms.

Needs one NVIDIA GPU; about four minutes with the build.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _where(torch, a, b, sizes) -> str:
    """The first leaf where flat ``a`` and ``b`` differ and the count of
    elements that do, or ``equal``."""
    bad = (a != b).nonzero().flatten()
    if bad.numel() == 0:
        return "equal"
    first, at = int(bad[0]), 0
    for name, n in sizes:
        if first < at + n:
            break
        at += n
    per = {}
    at = 0
    for nm, n in sizes:
        k = int(((bad >= at) & (bad < at + n)).sum())
        if k:
            per[nm] = k
        at += n
    rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
    return (f"{bad.numel()} elements differ in {len(per)} leaves (first "
            f"{name}; max rel {rel:.2e}; by leaf "
            + ", ".join(f"{k} {v}" for k, v in list(per.items())[:6])
            + (" ..." if len(per) > 6 else "") + ")")


def _norms(torch, flat, sizes) -> dict:
    """``global_norm`` of the flat gradient ``flat`` (the leaves of
    ``sizes`` in order) over views of it and over a copy of each leaf,
    eagerly and replayed from a captured graph → {how: float}."""
    from t2omca_tpu_torch.learners.qmix_learner import global_norm

    def tree(leaves):
        out = {}
        for (name, _), x in zip(sizes, leaves):
            m, k = name.split(".", 1)
            out.setdefault(m, {})[k] = x
        return out
    views, at = [], 0
    for _, n in sizes:
        views.append(flat[at:at + n])
        at += n
    copies = [v.clone() for v in views]
    out = {}
    for how, leaves in (("views", views), ("copies", copies)):
        out[f"{how} eager"] = float(global_norm(tree(leaves)))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            global_norm(tree(leaves))              # warm-up off the graph
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            norm = global_norm(tree(leaves))
        g.replay()
        torch.cuda.synchronize()
        out[f"{how} graphed"] = float(norm)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.kernels import build
    from t2omca_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    build.build()
    build.load()
    smi = cs.smi_line()
    print(f"build {time.time() - t0:.1f} s | {smi}", flush=True)
    ts = [int(a) for a in sys.argv[1:]] or [30, 50]
    path = os.path.join(ROOT, cs.SEBULBA_CONFIG)
    stash = {}
    reduce0 = mesh.PlacementGroup._reduce

    def reduce(self):
        # each sum's parts, cloned on each part's stream before the sum,
        # and the sum after, the last of each length kept (the step's
        # flat gradient is the one as long as the params)
        parts = self._parts
        if parts[0][0] == "sum":
            pre = []
            for kind, src, dst, root, stream in parts:
                with torch.cuda.stream(stream):
                    pre.append(src.clone())
            out, s0 = parts[0][2], parts[0][4]
        reduce0(self)
        if parts[0][0] == "sum":
            with torch.cuda.stream(s0):
                stash[out.numel()] = (pre, out.clone())

    mesh.PlacementGroup._reduce = reduce
    failed = False
    for t in ts:
        runs = []
        for rep in range(2):
            stash.clear()
            t1 = time.time()
            try:
                res = cs._sebulba_blocked_step(torch, att, smi, path, t,
                                               detail=True)
            except RuntimeError as e:
                print(f"T={t} run {rep}: {e}", flush=True)
                failed = True
                continue
            runs.append(res)
            sizes = res["leaf_sizes"]
            blocks = res["block_grads"]
            print(f"T={t} run {rep} ({time.time() - t1:.0f} s): "
                  f"{res['leaves_equal']} of {res['leaves']} leaves equal; "
                  f"grad norm rel {res['grad_norm_rel']:.3e}; differ: "
                  f"{res['differ'][:8]}", flush=True)
            total = sum(n for _, n in sizes)
            if total not in stash:
                print(f"T={t} run {rep}: no sum of {total} elements seen "
                      f"(sums of {sorted(stash)})", flush=True)
                failed = True
                continue
            torch.cuda.synchronize()
            pre, summed = stash.pop(total)
            stash.clear()
            res["pre"] = [p.cpu() for p in pre]
            for r, (got, want) in enumerate(zip(res["pre"], blocks)):
                print(f"T={t} run {rep}: placement {r}'s gradient against "
                      f"the probe's block {r}: "
                      f"{_where(torch, got, want, sizes)}", flush=True)
            norms = _norms(torch, summed, sizes)
            print(f"T={t} run {rep}: pre-clip norms: the set's "
                  f"{res['grad_norm']!r}, the probe's "
                  f"{res['probe_grad_norm']!r}; recomputed from the summed "
                  f"gradient "
                  + ", ".join(f"{k} {v!r}" for k, v in norms.items()),
                  flush=True)
            print(f"T={t} run {rep}: the set's summed gradient against the "
                  f"probe's blocks summed: "
                  f"{_where(torch, summed.cpu(), blocks[0] + blocks[1], sizes)}",
                  flush=True)
        if len(runs) == 2:
            a, b = runs
            same = {
                "differing leaves": a["differ"] == b["differ"],
                "probe blocks": all(torch.equal(x, y) for x, y in zip(
                    a["block_grads"], b["block_grads"])),
                "placements' gradients": all(torch.equal(x, y) for x, y in
                                             zip(a.get("pre", [None]), b.get("pre", [])))}
            print(f"T={t}: the two runs' "
                  + "; ".join(f"{k} {'the same' if v else 'NOT the same'}"
                              for k, v in same.items()), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
