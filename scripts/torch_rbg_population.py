#!/usr/bin/env python3
"""Config 7 under ``prng_impl: rbg`` on the card: a population's members
seated on member 0's keys (``prng.seat``) inside their captured graphs.

    python3 scripts/torch_rbg_population.py

Builds the kernels; runs config 7 (``chip_smoke.py``'s ``[population]``
cuts: 4 members, 32 lanes, T = 20, K = 4, f32, pallas) under rbg: one
dispatch that warms the members up, then one of captured graphs, whose
first rollout of each member is held bit for bit against an eager
``run_raw`` from a copy of the same state with the member's seat of
member 0's runner key (``lead``) and member 0's salt; after it every
member's carried runner key is its own chain (4 threefry splits) and
every member's ``lead`` has advanced with member 0's. Needs one NVIDIA
GPU; about a minute with the build.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import dataclasses
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from t2omca_tpu_torch import population as pop
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import load_config
    from t2omca_tpu_torch.kernels import build
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.train.superstep import clone_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    build.build()
    build.load()
    print(f"build {time.time() - t0:.1f} s | {cs.smi_line()}", flush=True)
    cfg = load_config(os.path.join(ROOT, cs.POPULATION_CONFIG),
                      cs.POPULATION_OVERRIDES + (
                          f"env_args.episode_limit={cs.POPULATION_T}",
                          "prng_impl=rbg"))
    exp = Experiment.build(cfg)
    pts, spec = pop.init_population(exp, cfg)
    prog = exp.population_superstep_program(cfg.superstep)
    cs.check(prog.seated, "the population is not seated under rbg")
    mirror = {"keys": pop.member_keys(cfg, "cuda"), "t_env": 0,
              "episode": 0, "filled": 0}
    keys, gated, t_env0 = cs.pop_rows(torch, prog, mirror)
    pts, _, _ = prog(pts, keys, t_env0, gated, spec)      # warm-up
    torch.cuda.synchronize()
    # the eager reference of the next dispatch's first rollouts
    start = [clone_state(t) for t in pts]
    salt = spec.scalars(0)[3] if cfg.population.scenario_salt else None
    ref = []
    for m, t in enumerate(start):
        eps = exp.runner.epsilons(t.runner.t_env, spec.scalars(m)[1])
        _, _, stats = exp.runner.run_raw(
            t.learner.params["agent"], t.runner, eps=eps.cuda(),
            member=salt, gather=False,
            lead=prng.seat(start[0].runner.key, m))
        ref.append(stats)
    own = [t.runner.key.clone() for t in start]
    for _ in range(prog.k):
        own = [prng.split(k, 3, "rbg")[0] for k in own]
    keys, gated, t_env0 = cs.pop_rows(torch, prog, mirror)
    t0 = time.perf_counter()
    pts, stats, _ = prog(pts, keys, t_env0, gated, spec)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    cs.check(set(prog.members[0].graphs) == {"rollout", "train"},
             "the dispatch did not replay captured graphs")
    for m in range(len(pts)):
        for f in dataclasses.fields(stats):
            cs.check(torch.equal(getattr(stats, f.name)[m, 0].cpu(),
                                 torch.as_tensor(getattr(ref[m],
                                                         f.name)).cpu()),
                     f"member {m}: {f.name} of the captured first rollout "
                     f"differs from the eager seated one")
        cs.check(torch.equal(pts[m].runner.key, own[m]),
                 f"member {m}: the carried runner key is not its own chain")
        cs.check(torch.equal(prog.members[m].lead[:4], pts[0].runner.key)
                 and int(prog.members[m].lead[4]) == m,
                 f"member {m}: lead did not follow member 0's key")
    fam = stats.scenario[:, 0]
    print(f"[rbg-population] config 7 (P={len(pts)}, {cfg.batch_size_run} "
          f"lanes, T={cfg.env_args.episode_limit}, K={prog.k}) under rbg: "
          f"a dispatch of captured graphs in {ms:.0f} ms; each member's "
          f"first rollout = the eager seated run_raw bit for bit "
          f"({len(dataclasses.fields(stats))} stats), the carried keys "
          f"their own chains, every lead member 0's key; member 0/1 "
          f"scenario families differ in "
          f"{int((fam[0] != fam[1]).sum())} of {fam.shape[-1]} lanes",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
