"""Learning-dynamics telemetry and RL-health detectors (port of
``t2omca_tpu/obs/sight.py``).

* **in-graph diagnostics** — what the train step adds to its info when
  ``obs.sight.enabled``: per-module gradient and update norms (the agent
  transformer, the rest of the agent, the mixer), fixed-bin masked
  histograms of the TD error, the chosen Qs and the targets, the PER
  importance weights' effective sample size and the priority
  distribution's entropy, per-layer attention entropy of one probe
  timestep through the folded query-slice blocks, and target-network
  drift. Every probe runs on detached tensors under ``torch.no_grad()``
  on the device, so training with the gate on is bit-identical to
  training with it off, and the values ride the driver's one log-cadence
  fetch of the train info.
* :class:`SightMonitor` — host-side windowed detectors over the fetched
  stream: loss plateau, Q-value divergence, PER priority collapse,
  attention collapse, per-module gradient starvation. Each registers a
  pulse ``/healthz`` check (``sight-<detector>``), marks the flight
  recorder on a trip, and folds its verdict into the driver's flight and
  stall extras.
* **learning CLI** — ``python -m t2omca_tpu_torch.obs learning
  <run_dir>``: the learning-health table, detector verdicts and
  per-scenario-slice learning curves from the run's ``metrics.jsonl``
  (tolerant reader: a killed run's torn last line is skipped). It lives
  in ``obs/learning.py``, which imports no torch; ``learning_main`` is
  imported back here.

Where the port differs from the JAX module: the module groups come from
the torch parameter names (``transformer.*`` of the agent is flax's
``agent["transformer"]`` subtree, ``convert.py``'s name map); the
norms reduce each group with one multi-tensor kernel
(``torch._foreach_norm``) instead of a per-leaf sum of squares, equal to
rounding; the histogram index is written in XLA's form (the chain of
constant factors folded into one float32 factor, ``xla_float.fold``).
A population (``make_monitor(population=P)``) gets
:class:`PopulationSightMonitor`: one ``SightMonitor`` a member over the
same fetch, each reading its member's row of the ``(P,)``-leading
leaves.

The host half and the CLI compute with numpy and the standard library
(they touch no device).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..xla_float import fold
# the learning CLI lives in a module of its own that imports no torch
# (the post-mortem readers' rule); its entry stays importable from here
from .learning import learning_main  # noqa: F401

#: tiny epsilon for entropy/ratio denominators (f32-safe)
_EPS = 1e-12

#: detector names — the ``/healthz`` check ids are ``sight-<name>``,
#: the logged alert keys ``sight_alert_<name>``
DETECTORS = ("loss_plateau", "q_divergence", "priority_collapse",
             "attention_collapse", "grad_starvation")


def module_group_names(cfg) -> Tuple[str, ...]:
    """Per-config grouping of the params for the per-module norm
    breakdown: the agent transformer stack, everything else in the
    agent (feature embedding + q head = ``embed``), and the mixer.
    Derived from the CONFIG, not the tree, so ``train_info_zeros`` can
    mirror the emitted keys (VDN is parameterless — no mixer group)."""
    names = []
    if cfg.agent == "transformer":
        names.append("agent_tf")
    names.append("embed")
    if cfg.mixer != "vdn":
        names.append("mixer")
    return tuple(names)


def module_groups(cfg, tree) -> Dict[str, list]:
    """Split a ``{"agent": {name: tensor}, "mixer": {name: tensor}}``
    tree (params, gradients or optimizer updates) into the
    ``module_group_names`` leaf lists, each in name order. ``agent_tf``
    is every agent leaf under ``transformer.`` (flax's
    ``agent["transformer"]`` subtree)."""
    agent = tree["agent"]
    groups: Dict[str, list] = {}
    names = sorted(agent)
    if cfg.agent == "transformer":
        groups["agent_tf"] = [agent[k] for k in names
                              if k.startswith("transformer.")]
        names = [k for k in names if not k.startswith("transformer.")]
    groups["embed"] = [agent[k] for k in names]
    if cfg.mixer != "vdn":
        groups["mixer"] = [tree["mixer"][k] for k in sorted(tree["mixer"])]
    return groups


def _global_norm(leaves) -> torch.Tensor:
    """f32 global L2 norm over a leaf list (``optax.global_norm`` of the
    f32-lifted leaves): each leaf's norm in one multi-tensor launch,
    then the norm of those."""
    norms = torch._foreach_norm([x.float() for x in leaves])
    return torch.linalg.vector_norm(torch.stack(norms))


def masked_histogram(x: torch.Tensor, mask: torch.Tensor, lo: float,
                     hi: float, bins: int) -> torch.Tensor:
    """Fixed-bin masked histogram as one scatter-add (``index_add_``):
    ``x`` and ``mask`` broadcast-compatible, result a ``(bins,)`` f32
    FRACTION vector (sums to 1 over the masked mass; outliers clip into
    the edge bins). The bin index is ``(x - lo) · bins / (hi - lo)``
    with the constant factors folded as XLA folds them, so a value on a
    bin edge lands where JAX puts it; a NaN lands in bin 0 and ±inf in
    the edge bins, as XLA's saturating float-to-int conversion does."""
    x = x.float()
    m = torch.broadcast_to(mask.float(), x.shape)
    pos = (x - lo) * fold(1.0, hi - lo, bins)
    idx = torch.clamp(torch.nan_to_num(pos, nan=0.0), 0, bins - 1).long()
    counts = torch.zeros(bins, device=x.device).index_add_(
        0, idx.reshape(-1), m.reshape(-1))
    return counts / torch.clamp(counts.sum(), min=1.0)


def learner_train_info(cfg, grads, updates, params, target_params,
                       weights: torch.Tensor) -> dict:
    """The train step's tail block (``QMixLearner.train``): per-module
    norms of the pre-clip gradients and of the optimizer's updates (as
    ``optimizer_update`` returns them, not a difference of params), the
    importance weights' effective sample size (fraction of the batch),
    and the target drift (relative param distance to the target copy:
    the params after the guard select, the target before the sync)."""
    info = {}
    with torch.no_grad():
        for name, leaves in module_groups(cfg, grads).items():
            info[f"sight_grad_norm_{name}"] = _global_norm(leaves)
        for name, leaves in module_groups(cfg, updates).items():
            info[f"sight_update_norm_{name}"] = _global_norm(leaves)
        w = weights.float()
        s1, s2 = w.sum(), (w * w).sum()
        info["sight_per_ess"] = (s1 * s1) / (w.shape[0]
                                             * torch.clamp(s2, min=_EPS))
        p = [v for sub in params.values() for v in sub.values()]
        t = [target_params[m][k] for m, sub in params.items() for k in sub]
        diff = torch._foreach_sub([x.float() for x in p],
                                  [x.float() for x in t])
        info["sight_target_drift"] = (
            _global_norm(diff)
            / torch.clamp(_global_norm(t), min=_EPS))
    return info


def loss_sight_info(sight_cfg, td, chosen, targets, mask) -> dict:
    """The loss body's block (``QMixLearner._loss``): fixed-bin masked
    histograms of the TD error, the chosen (taken) Qs and the bootstrap
    targets. The caller passes detached tensors."""
    b, q = float(sight_cfg.td_range), float(sight_cfg.q_range)
    n = int(sight_cfg.bins)
    with torch.no_grad():
        return {
            "sight_td_hist": masked_histogram(td, mask, -b, b, n),
            "sight_q_taken_hist": masked_histogram(
                chosen, mask[..., None], -q, q, n),
            "sight_target_hist": masked_histogram(targets, mask, -q, q, n),
        }


def attention_entropies(folded_tf: dict, k0: torch.Tensor,
                        x0: torch.Tensor, *, emb: int, heads: int,
                        depth: int, dtype) -> torch.Tensor:
    """Per-layer mean attention entropy of ``x0``'s query rows against
    the pinned layer-0 keys ``k0`` — the ``transformer_rows`` math
    (``ops/query_slice.py``) with the softmax distribution kept to
    reduce its entropy (so it launches no flash kernel). Returns
    ``(depth,)`` f32 entropies NORMALIZED by ``log(n_keys)`` (1 =
    uniform attention, 0 = every head a delta). Products take ``dtype``
    operands with f32 accumulation, as JAX's ``preferred_element_type``
    ones; the query projection stays f32."""
    from ..ops.query_slice import _block_tail, _mm32
    s, r, _ = x0.shape
    t_k = k0.shape[1]
    ents = []
    with torch.no_grad():
        for i in range(depth):
            bp = folded_tf["blocks"][i]
            qp = _mm32(x0.reshape(s * r, emb), bp["wqk"], dtype)
            qp = qp.reshape(s, r * heads, emb)
            logits = torch.bmm(qp, k0.float().transpose(1, 2))
            p = torch.softmax(logits, dim=-1)                # (S, R·H, T)
            ent = -(p * torch.log(p + _EPS)).sum(dim=-1).mean()
            ents.append(ent / math.log(max(t_k, 2)))
            # advance the query rows through the block tail so layer
            # i+1 measures the attention it actually computes
            ctx = torch.bmm(p.to(dtype).float(), k0.float())
            ctx = ctx.to(dtype).reshape(s * r, heads * emb)
            attended = _mm32(ctx, bp["wvu"], dtype) + bp["u_bias"].float()
            x0 = _block_tail(bp, attended, x0.reshape(s * r, emb),
                             dtype).reshape(s, r, emb)
    return torch.stack(ents).float()


def agent_attention_entropy(learner, agent_params, obs_t0, compact_t0
                            ) -> torch.Tensor:
    """Agent-side probe: episode-start hidden + the first timestep's
    entity tokens through the folded blocks. ``obs_t0 (B, A, O)`` for
    dense storage, or ``compact_t0 = (rows, same_mec, mean, std)`` for
    compact entity storage (the tokens are rebuilt per
    ``agent_forward_qslice_entity``'s factoring: a one-timestep
    ``(B, A, A+1, E)`` materialization)."""
    from ..ops.query_slice import _mm32, fold_agent_params
    a = learner.mac.agent
    dt = a.dtype
    with torch.no_grad():
        f = fold_agent_params({k: v.detach() for k, v in
                               agent_params.items()},
                              emb=a.emb, heads=a.heads, depth=a.depth,
                              standard_heads=a.standard_heads, dtype=dt)
        we = f["fe"]["weight"].t().to(dt)                 # (in, E)
        be = f["fe"]["bias"].float()
        if compact_t0 is not None:
            rows, same_mec, mean, std = [x.detach() for x in compact_t0]
            b, n_ag, _ = rows.shape
            denom = std.float() + 1e-8
            rows9 = torch.cat([rows.float(),
                               rows.new_zeros(b, n_ag, 1,
                                              dtype=torch.float32)], dim=-1)
            e_vis = _mm32(((rows9 - mean) / denom).to(dt), we, dt) + be
            e_hid = _mm32(((-mean) / denom).to(dt), we, dt) + be
            self_corr = we[8].float() / denom[..., 8:9]  # (B, A, E)
            # observer i's entity token j: visible ? e_vis[j] : e_hid[j],
            # plus the is-self correction on the diagonal (j == i)
            vis = same_mec[:, :, :, None]                 # (B, A_i, A_j, 1)
            ent_tok = torch.where(vis, e_vis[:, None], e_hid[:, None])
            eye = torch.eye(n_ag, device=rows.device)[None, :, :, None]
            ent_tok = ent_tok + eye * self_corr[:, None]
            h0 = learner.mac.init_hidden(b).float()       # (B, A, E)
            k0 = torch.cat([h0[:, :, None, :], ent_tok], dim=2)
            k0 = k0.reshape(b * n_ag, n_ag + 1, a.emb).to(dt)
        else:
            obs_t0 = obs_t0.detach()
            b, n_ag, _ = obs_t0.shape
            s = b * n_ag
            x = obs_t0.reshape(s, a.n_entities, a.feat_dim).to(dt)
            embs = (_mm32(x, we, dt) + be).to(dt)
            h0 = learner.mac.init_hidden(b).reshape(s, a.emb).to(dt)
            k0 = torch.cat([h0[:, None, :], embs], dim=1)
        x0 = k0[:, :1, :]                                 # the hidden row
        return attention_entropies(f["tf"], k0, x0, emb=a.emb,
                                   heads=a.heads, depth=a.depth, dtype=dt)


def mixer_attention_entropy(learner, mixer_params, state_t0, obs_t0,
                            hid_t0) -> torch.Tensor:
    """Mixer-side probe: the t=0 mixer token sequence — state-entity
    embeddings ++ post-step-0 agent hiddens ++ the initial hyper tokens
    — with the consumed (last ``A+3``) rows as queries, exactly the rows
    ``mixer_forward_qslice`` carries."""
    from ..ops.query_slice import _mm32, fold_mixer_params
    mx = learner.mixer
    dt = mx.dtype
    with torch.no_grad():
        f = fold_mixer_params({k: v.detach() for k, v in
                               mixer_params.items()},
                              emb=mx.emb, heads=mx.heads, depth=mx.depth,
                              standard_heads=mx.standard_heads, dtype=dt)
        b = hid_t0.shape[0]
        if mx.state_entity_mode:
            inputs = state_t0.reshape(b, mx.n_entities, mx.feat_dim)
        else:                   # Q12: all agents' obs entities
            inputs = obs_t0.reshape(b, mx.n_agents * mx.n_entities,
                                    mx.feat_dim)
        inputs = inputs.detach().to(dt)
        fe = f["fe"]
        embs = (_mm32(inputs, fe["weight"].t(), dt)
                + fe["bias"].float()).to(dt)
        k0 = torch.cat([embs, hid_t0.detach().to(dt),
                        mx.initial_hyper(b, device=hid_t0.device).to(dt)],
                       dim=1)
        r = mx.n_agents + 3
        return attention_entropies(f["tf"], k0, k0[:, -r:, :], emb=mx.emb,
                                   heads=mx.heads, depth=mx.depth, dtype=dt)


def buffer_sight_info(priorities: torch.Tensor,
                      episodes_in_buffer: torch.Tensor) -> dict:
    """PER priority-distribution health from the ring's stored (already
    ``p^alpha``) priority vector: Shannon entropy of the sampling
    distribution over the valid slots, normalized by ``log(n)`` —
    collapse (a handful of episodes soaking all sampling mass) reads as
    norm → 0. One masked reduce over the ``(capacity,)`` vector on the
    device; ``episodes_in_buffer`` is the ring's device fill count (an
    int works too), and ``log(n)`` is taken in float64 and rounded once,
    the value ``math.log`` gives, with no host read."""
    with torch.no_grad():
        pri = priorities.float()
        n = torch.as_tensor(episodes_in_buffer, device=pri.device)
        valid = torch.arange(pri.shape[0], device=pri.device) < n
        p = torch.where(valid, pri, 0.0)
        probs = p / torch.clamp(p.sum(), min=_EPS)
        ent = -(probs * torch.log(probs + _EPS)).sum()
        norm = ent / torch.log(torch.clamp(n, min=2).double()).float()
    return {"sight_priority_entropy": ent,
            "sight_priority_entropy_norm": norm}


def maybe_buffer_info(cfg, info: dict, buf) -> dict:
    """Merge the PER-health read into a train-info dict when the gate and
    prioritized replay apply. ``cfg`` is the full TrainConfig; ``buf``
    the post-update ``BufferState``."""
    if not (cfg.obs.sight.enabled and cfg.replay.prioritized):
        return info
    return dict(info, **buffer_sight_info(buf.priorities,
                                          buf.episodes_in_buffer))


def buffer_sight_info_host(pri: np.ndarray, count: int) -> dict:
    """Host-replay twin of :func:`buffer_sight_info` over a numpy
    priority mirror — pure host math."""
    p = np.asarray(pri[:max(count, 0)], np.float64)
    z = max(float(p.sum()), _EPS)
    probs = p / z
    ent = float(-(probs * np.log(probs + _EPS)).sum()) if count else 0.0
    norm = ent / np.log(max(count, 2))
    return {"sight_priority_entropy": np.float32(ent),
            "sight_priority_entropy_norm": np.float32(norm)}


def train_info_extras_zeros(cfg, device=None) -> dict:
    """Zeros for every key the learner's sight blocks emit, with their
    shapes and dtypes (``QMixLearner.train_info_zeros``). The key set is
    a function of the config (``module_group_names`` + the family
    gates), never of runtime values."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=device)
    sg = cfg.obs.sight
    info = {}
    for name in module_group_names(cfg):
        info[f"sight_grad_norm_{name}"] = z()
        info[f"sight_update_norm_{name}"] = z()
    info["sight_per_ess"] = z()
    info["sight_target_drift"] = z()
    for k in ("sight_td_hist", "sight_q_taken_hist", "sight_target_hist"):
        info[k] = z(sg.bins)
    if cfg.agent == "transformer":
        info["sight_attn_entropy_agent"] = z(cfg.model.depth)
    if cfg.mixer == "transformer":
        info["sight_attn_entropy_mixer"] = z(cfg.model.mixer_depth)
    return info


# --------------------------------------------------------------------------
# host side: the detector monitor
# --------------------------------------------------------------------------


class SightMonitor:
    """Windowed RL-health detectors over the fetched train-info stream.

    The driver calls :meth:`observe` once per log cadence with the
    (host-fetched) last train info; the monitor logs every ``sight_*``
    stat to the metric stream (full fidelity — the Logger degrades
    vectors to a summary only on the console), evaluates the detectors,
    and on a trip logs ``sight_alert_<name>``, marks the flight
    recorder, and returns the newly tripped names so the driver can
    persist the flight ring. ``/healthz`` checks registered via
    :meth:`wire_pulse` read the CURRENT verdicts — the endpoint flips
    503 naming the detector the moment one trips."""

    def __init__(self, sight_cfg, logger=None, rec=None,
                 member: Optional[int] = None):
        self.cfg = sight_cfg
        self.logger = logger
        self.rec = rec
        #: population member index: set by the population's monitor
        #: when P > 1 — logged stat keys gain a
        #: ``pop<i>_`` prefix and /healthz checks register as
        #: ``sight-pop<i>-<detector>``; None (solo runs, and the P=1
        #: population for metric-stream parity) keeps today's names
        self.member = member
        self._prefix = f"pop{member}_" if member is not None else ""
        self._window: deque = deque(maxlen=int(sight_cfg.window))
        self.status: Dict[str, dict] = {
            name: {"ok": True, "detail": "no data", "t_env": 0}
            for name in DETECTORS}
        self.trips_total = 0

    # -- ingestion -------------------------------------------------------

    @staticmethod
    def _scalarize(info: dict) -> dict:
        out = {}
        for k, v in info.items():
            a = np.asarray(v)
            out[k] = a if a.ndim else float(a)
        return out

    def observe(self, info: dict, t_env: int) -> List[str]:
        """One log-cadence observation → newly tripped detector names."""
        vals = self._scalarize(info)
        if self.logger is not None:
            for k in sorted(vals):
                if k.startswith("sight_"):
                    self.logger.log_stat(self._prefix + k, vals[k], t_env)
        self._window.append(vals)
        newly: List[str] = []
        for name, (ok, detail) in self._evaluate().items():
            prev = self.status[name]["ok"]
            self.status[name] = {"ok": ok, "detail": detail,
                                 "t_env": int(t_env)}
            if ok != prev and self.logger is not None:
                self.logger.log_stat(f"{self._prefix}sight_alert_{name}",
                                     0.0 if ok else 1.0, t_env)
            if prev and not ok:
                self.trips_total += 1
                newly.append(name if self.member is None
                             else f"pop{self.member}:{name}")
                if self.rec is not None:
                    mark_kw = ({} if self.member is None
                               else {"member": self.member})
                    self.rec.mark("sight", detector=name, t_env=t_env,
                                  detail=detail[:200], **mark_kw)
        return newly

    # -- detectors -------------------------------------------------------

    def _latest(self, key: str):
        for vals in reversed(self._window):
            if key in vals:
                return vals[key]
        return None

    def _series(self, key: str) -> List[float]:
        return [v[key] for v in self._window if key in v]

    def _evaluate(self) -> Dict[str, Tuple[bool, str]]:
        cfg = self.cfg
        out: Dict[str, Tuple[bool, str]] = {}

        # loss plateau: relative spread over a FULL window below the
        # threshold (informational-grade: a converged run plateaus too —
        # the detail carries the level so the reader can tell)
        losses = self._series("loss")
        if len(losses) >= self._window.maxlen:
            m = float(np.mean(np.abs(losses)))
            spread = float(np.max(losses) - np.min(losses))
            flat = spread <= cfg.plateau_rel * max(m, _EPS)
            out["loss_plateau"] = (
                not flat,
                f"spread={spread:.3g} over {len(losses)} cadences at "
                f"mean |loss|={m:.3g}"
                + (" — flat" if flat else ""))
        else:
            out["loss_plateau"] = (True, f"warming up "
                                         f"({len(losses)}/"
                                         f"{self._window.maxlen})")

        # Q divergence: NaN-free blow-up of the value scale
        qt, tg = self._latest("q_taken_mean"), self._latest("target_mean")
        worst = max(abs(qt or 0.0), abs(tg or 0.0))
        out["q_divergence"] = (
            worst <= cfg.q_div,
            f"|q_taken_mean|={abs(qt) if qt is not None else 0:.3g} "
            f"|target_mean|={abs(tg) if tg is not None else 0:.3g} "
            f"(threshold {cfg.q_div:g})")

        # PER priority collapse: sampling entropy or importance-weight
        # effective sample size through the floor
        pen = self._latest("sight_priority_entropy_norm")
        ess = self._latest("sight_per_ess")
        if pen is None and ess is None:
            out["priority_collapse"] = (True, "no PER telemetry")
        else:
            bad = []
            if pen is not None and pen < cfg.priority_entropy_min:
                bad.append(f"priority entropy {pen:.3g} < "
                           f"{cfg.priority_entropy_min:g} of log(n)")
            if ess is not None and ess < cfg.ess_min:
                bad.append(f"importance-weight ESS {ess:.3g} < "
                           f"{cfg.ess_min:g} of batch")
            out["priority_collapse"] = (
                not bad,
                "; ".join(bad) or f"entropy_norm="
                                  f"{pen if pen is not None else -1:.3g} "
                                  f"ess={ess if ess is not None else -1:.3g}")

        # attention collapse: any layer's normalized entropy at the floor
        layers: List[Tuple[str, int, float]] = []
        for side in ("agent", "mixer"):
            v = self._latest(f"sight_attn_entropy_{side}")
            if v is not None:
                for i, e in enumerate(np.asarray(v).reshape(-1)):
                    layers.append((side, i, float(e)))
        if not layers:
            out["attention_collapse"] = (True, "no attention telemetry")
        else:
            side, i, e = min(layers, key=lambda x: x[2])
            out["attention_collapse"] = (
                e >= cfg.attn_entropy_min,
                f"min layer entropy {e:.3g} ({side} layer {i}; "
                f"threshold {cfg.attn_entropy_min:g} of log(keys))")

        # per-module gradient starvation: one module's share of the
        # total gradient norm at the floor for a FULL window
        shares_hist: List[Dict[str, float]] = []
        for vals in self._window:
            norms = {k[len("sight_grad_norm_"):]: v
                     for k, v in vals.items()
                     if k.startswith("sight_grad_norm_")}
            total = sum(norms.values())
            if norms and total > 0:
                shares_hist.append({m: n / total for m, n in norms.items()})
            elif norms:
                # complete gradient death (total norm exactly 0) is
                # strictly WORSE than one starved module — count every
                # module at share 0 so a dead window trips instead of
                # reading as "warming up" forever
                shares_hist.append({m: 0.0 for m in norms})
        if len(shares_hist) < self._window.maxlen:
            out["grad_starvation"] = (
                True, f"warming up ({len(shares_hist)}/"
                      f"{self._window.maxlen})")
        else:
            starved = None
            for mod in shares_hist[-1]:
                ss = [s.get(mod, 1.0) for s in shares_hist]
                if all(s < cfg.grad_starvation for s in ss):
                    starved = (mod, max(ss))
                    break
            out["grad_starvation"] = (
                starved is None,
                (f"module {starved[0]!r} grad share <= {starved[1]:.3g} "
                 f"for {len(shares_hist)} cadences (threshold "
                 f"{cfg.grad_starvation:g})") if starved
                else "all modules receiving gradient")
        return out

    # -- surfaces --------------------------------------------------------

    def report(self) -> dict:
        """The stall-diagnosis / flight-recorder extra: current
        verdicts + trip count (host-cached — safe on wedged-backend
        paths, nothing here touches a device)."""
        return {"detectors": {k: dict(v) for k, v in self.status.items()},
                "trips_total": self.trips_total}

    def wire_pulse(self, hub) -> None:
        """Register one ``/healthz`` check per detector: the endpoint
        names the tripped check (``sight-<detector>``, or
        ``sight-pop<i>-<detector>`` for a population member) so a
        supervisor needs no JSON spelunking to know WHY the run
        degraded."""
        tag = f"pop{self.member}-" if self.member is not None else ""
        for name in DETECTORS:
            hub.health(
                f"sight-{tag}{name}",
                lambda name=name: (self.status[name]["ok"],
                                   self.status[name]["detail"]))


class PopulationSightMonitor:
    """One :class:`SightMonitor` a population member over the same
    log-cadence fetch: the fetched train-info leaves carry a leading
    ``(P,)`` member axis, and each member's row feeds its own windowed
    detectors (host-side numpy indexing, no device traffic).

    At P > 1 a member's stats log as ``pop<i>_sight_*``, its ``/healthz``
    checks register as ``sight-pop<i>-<detector>`` and its trips report as
    ``pop<i>:<detector>``; at P = 1 the one member keeps the solo names,
    so a one-member population logs the solo run's stream."""

    def __init__(self, sight_cfg, population: int, logger=None, rec=None):
        self.population = int(population)
        self.members = [
            SightMonitor(sight_cfg, logger=logger, rec=rec,
                         member=(m if self.population > 1 else None))
            for m in range(self.population)]

    def observe(self, info: dict, t_env: int) -> List[str]:
        newly: List[str] = []
        for m, mon in enumerate(self.members):
            sliced = {}
            for k, v in info.items():
                a = np.asarray(v)
                sliced[k] = a[m] if a.ndim else a
            newly.extend(mon.observe(sliced, t_env))
        return newly

    def report(self) -> dict:
        return {"population": self.population,
                "members": [mon.report() for mon in self.members]}

    def wire_pulse(self, hub) -> None:
        for mon in self.members:
            mon.wire_pulse(hub)


def make_monitor(obs_cfg, logger=None, rec=None, population: int = 0
                 ) -> Optional[object]:
    """Driver constructor: None unless ``obs.sight.enabled`` (the off
    state — the driver's loop stays one ``if sight_mon is not None`` away
    from unchanged). ``population=P`` returns the per-member
    :class:`PopulationSightMonitor` over the ``(P,)``-leading fetched
    leaves."""
    sg = getattr(obs_cfg, "sight", None)
    if sg is None or not getattr(sg, "enabled", False):
        return None
    if population:
        return PopulationSightMonitor(sg, population, logger=logger,
                                      rec=rec)
    return SightMonitor(sg, logger=logger, rec=rec)
