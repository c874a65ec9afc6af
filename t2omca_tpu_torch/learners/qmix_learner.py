"""QMIX TD learner (port of ``t2omca_tpu/learners/qmix_learner.py``).

Per-agent Qs from the transformer agent, chosen-action Qs mixed by the
transformer mixer into ``q_tot``, target networks with double-Q targets,
an importance-weighted MSE (or 2×-scaled Huber) on the TD error, and
``info["td_errors_abs"]`` fed back as PER priorities (Q9).

The JAX ``lax.scan`` over episode time becomes a Python loop carrying
the agent hidden token and the mixer's 3 hyper tokens. The online
unrolls run under autograd; with ``kernels.attention: pallas`` every
attention call in them goes through the flash kernels' autograd
Function (K1 + residuals forward, K2 and K3 backward on the card). The
target unrolls run under ``torch.no_grad()``, as JAX prunes their
backward, so they launch K1 alone.

Parameters are plain dicts of f32 tensors (``{"agent": ..., "mixer":
...}``, the flax names); the modules are built on the ``meta`` device
and run through ``functional_call``. The optimizer is functional too
(``clip_by_global_norm`` then ``adam`` or ``rmsprop`` with optax's
formulas), so the non-finite guard selects old or new params AND
optimizer state elementwise on the device, with no host sync.

Compact entity storage (``CompactEntityObs`` episodes) unrolls the agent
through the entity-table forward, rebuilding the same-MEC mask from the
stored int8 MEC index; that unroll launches no flash kernel, and the
mixer reads the state alone. A noisy q-head (``action_selector:
noisy-new``) trains with noise from ``k_learn``: ``k_ag, k_tag, k_mx,
k_tmx = split(key, 4)``, one key a step from ``split(k_ag, T + 1)`` (and
``k_tag``), as in JAX; the learner draws every step's q-head weights
before its unroll, the same numbers the JAX scan draws step by step.

``model.remat`` runs every unroll step that needs a gradient through
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` around each scan
body): the backward recomputes the step's forward instead of keeping its
activations, with the same values and gradients. Under ``pallas`` each
online mixer step then launches K1 + residuals twice (forward and
recompute). ``obs.sight`` adds the learning-health probes
(``obs/sight.py``) to the info: histograms and attention entropies in
``_loss``, per-module norms, ESS and target drift after the guard
select in ``train``, all on detached tensors under ``torch.no_grad()``,
so the update is bit-identical with the gate on or off.

A scenario distribution that can pad (``envs/graftworld.
distribution_can_pad``) turns on the mixer padding mask, a static gate as
in JAX: the trailing agents that never had a non-idle action available
enter the mixer with zero Qs, hidden tokens and obs rows.

A population member's ``spec`` (``population.py``) scales the update
after Adam by its ``lr_scale``, ``u * lr_scale``, as JAX scales optax's
update tree; the ``lr`` baked into the functional Adam stays the config's
(``(-lr·x)·s`` and ``-(lr·s)·x`` differ in the last bit). ``lr_scale`` is
a device scalar of the member's program, so PBT can change it under
capture.

Dropout (``model.dropout`` > 0) makes both query-slice reductions
ineligible: the agent and the mixer unroll their dense modules, and
every step draws its masks from its own key, ``split(k_ag, T + 1)[t]``
for the agent (split again into ``k_noise, k_drop`` by the MAC's
``forward``) and ``split(k_mx, T)[t]`` for the mixer (its ``"dropout"``
stream), the target unrolls likewise from ``k_tag`` and ``k_tmx``. A
noisy dense agent (``use_qslice: false``) draws its q-head noise the
same way; with ``dropout`` 0 the mixer keys are dropped and the mixer
stays on its deterministic path, as in JAX. Under ``model.remat`` a
step's recompute takes the step's key again, so it draws the same
masks.

Under data parallelism (``comm``, a ``parallel.mesh.RankComm``) the
learner computes its rank's block of the batch's rows, and every value
that JAX's GSPMD reduces over the sharded batch is reduced by hand: the
loss's denominator (the mask sum, an exact f32 integer) is summed over
the ranks before the first unroll, so that no collective falls between
a forward and its backward (a segmented capture splits its graphs there,
``train/superstep.py``); after the backward the logged values'
numerators are summed, the TD errors of all rows are gathered, and the
gradients of the rank's share of the loss are summed in one all-reduce
before the global norm. From there (norm, finite flag, clip, Adam, the
guard select, the target sync) every rank computes the same update from
the same bits. The probes log the global batch's values too: the
histograms' counts, the importance weights' sums and the entropies (a
mean over equal blocks of rows: the ranks' means summed over the rank
count) ride the logged values' all-reduce. Dropout draws the rank's
block of rows of the masks over the global batch (``flax_rng.Rows``).

The mixer family comes from ``MIXER_REGISTRY``: the transformer mixer,
``qmix_ff`` (standard QMIX over the flat state) and ``vdn`` (a sum, no
parameters); the agent family from the MAC's (``transformer``, ``rnn``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .. import prng
from ..components.episode_buffer import CompactEntityObs, EpisodeBatch
from ..config import TrainConfig
from ..controllers.basic_mac import (BasicMAC, Params, init_module_params,
                                     torch_dtype)
from ..device import DeviceLike, resolve_device
from ..flax_rng import Rows
from ..models.ff_mixer import QMixFFMixer, VDNMixer
from ..models.mixer import TransformerMixer
from ..models.noisy import noisy_weights
from ..obs import sight
from ..ops.query_slice import agent_qslice_eligible

Tree = Dict[str, Params]

#: mixer families, as the JAX learner's registry; each takes the
#: transformer mixer's call
MIXER_REGISTRY = {"transformer": TransformerMixer, "qmix_ff": QMixFFMixer,
                  "vdn": VDNMixer}


# --------------------------------------------------------------- optimizer

def global_norm(tree: Tree) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm over every leaf."""
    return torch.sqrt(sum((g.float() ** 2).sum() for sub in tree.values()
                          for g in sub.values()))


def _tree_map(fn, *trees: Tree) -> Tree:
    return {m: {k: fn(*(t[m][k] for t in trees)) for k in trees[0][m]}
            for m in trees[0]}


def clip_by_global_norm(grads: Tree, norm: torch.Tensor,
                        max_norm: float) -> Tree:
    """``optax.clip_by_global_norm``: ``g`` when ``norm < max_norm``,
    else ``g / norm · max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    trigger = norm < max_norm
    return _tree_map(lambda g: torch.where(trigger, g, g / norm * max_norm),
                     grads)


def optimizer_init(cfg: TrainConfig, params: Tree) -> dict:
    zeros = lambda: _tree_map(torch.zeros_like, params)
    if cfg.optimizer == "rmsprop":
        return {"nu": zeros()}
    device = next(iter(next(iter(params.values())).values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": zeros(), "nu": zeros()}


def optimizer_update(cfg: TrainConfig, grads: Tree, state: dict
                     ) -> Tuple[Tree, dict]:
    """The update after clipping → (updates, state'). ``adam`` is
    ``optax.adam(lr, eps=optim_eps)`` (b1 0.9, b2 0.999, bias-corrected,
    eps outside the sqrt); ``rmsprop`` is ``optax.rmsprop(lr,
    decay=optim_alpha, eps=optim_eps)`` (eps INSIDE the rsqrt, no bias
    correction)."""
    lr = cfg.lr
    if cfg.optimizer == "rmsprop":
        d = cfg.optim_alpha
        nu = _tree_map(lambda g, n: (1 - d) * g ** 2 + d * n, grads,
                       state["nu"])
        upd = _tree_map(lambda g, n: -lr * (torch.rsqrt(n + cfg.optim_eps)
                                            * g), grads, nu)
        return upd, {"nu": nu}
    b1, b2 = 0.9, 0.999
    mu = _tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
    nu = _tree_map(lambda g, n: (1 - b2) * g ** 2 + b2 * n, grads,
                   state["nu"])
    count = state["count"] + 1
    c1 = 1 - b1 ** count.float()
    c2 = 1 - b2 ** count.float()
    upd = _tree_map(lambda m, n: -lr * ((m / c1)
                                        / (torch.sqrt(n / c2)
                                           + cfg.optim_eps)), mu, nu)
    return upd, {"count": count, "mu": mu, "nu": nu}


def _select(cond: torch.Tensor, new, old):
    """Elementwise ``where(cond, new, old)`` over matching trees."""
    if isinstance(new, dict):
        return {k: _select(cond, new[k], old[k]) for k in new}
    return torch.where(cond, new, old)


# ------------------------------------------------------------------ learner

@dataclasses.dataclass
class LearnerState:
    params: Tree                    # {"agent": ..., "mixer": ...}
    target_params: Tree
    opt_state: dict
    train_steps: torch.Tensor       # () int32
    last_target_update: torch.Tensor  # () int32: episode of the last sync


@dataclasses.dataclass(frozen=True)
class QMixLearner:
    mac: BasicMAC
    mixer: object                   # any MIXER_REGISTRY family
    cfg: TrainConfig
    obs_dim: int
    state_dim: int
    device: torch.device
    comm: object = None             # parallel.mesh.RankComm under dp

    @classmethod
    def build(cls, cfg: TrainConfig, mac: BasicMAC, env_info: dict,
              device: DeviceLike = None) -> "QMixLearner":
        """Runs on ``cuda`` unless ``device`` says otherwise (raises when
        no card is present and none was named)."""
        device = resolve_device(device)
        n_entities = cfg.model.n_entities_state or env_info["n_entities"]
        state_entity_mode = "state_entity_feats" in env_info
        if state_entity_mode:
            feat = env_info["state_entity_feats"]
        else:
            # Q12 fallback: the mixer tokenizes all agents' obs entities
            feat = env_info["obs_entity_feats"]
            n_entities = env_info["n_entities"]
        # the feed-forward QMIX mixer sizes its hypernets from the flat
        # state (flax infers it at init)
        extra = ({"state_dim": env_info["state_shape"]}
                 if cfg.mixer == "qmix_ff" else {})
        mixer = MIXER_REGISTRY[cfg.mixer](
            n_agents=env_info["n_agents"], n_entities=n_entities,
            feat_dim=feat, emb=cfg.model.mixer_emb,
            heads=cfg.model.mixer_heads, depth=cfg.model.mixer_depth,
            ff_hidden_mult=cfg.model.ff_hidden_mult,
            dropout=cfg.model.dropout,
            qmix_pos_func=cfg.model.qmix_pos_func,
            qmix_pos_func_beta=cfg.model.qmix_pos_func_beta,
            state_entity_mode=state_entity_mode,
            standard_heads=cfg.model.standard_heads,
            dtype=torch_dtype(cfg.model.dtype),
            attn_impl=cfg.kernels.attention,
            zero_init_gate=cfg.model.mixer_zero_init, device="meta", **extra)
        return cls(mac=mac, mixer=mixer, cfg=cfg,
                   obs_dim=env_info["obs_shape"],
                   state_dim=env_info["state_shape"], device=device)

    # ------------------------------------------------------------ state

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Tree] = None) -> LearnerState:
        """Fresh state: ``params`` as given (copied to the learner's
        device), else drawn from ``generator`` (agent, then mixer)."""
        if params is None:
            params = {
                "agent": init_module_params(self.mac.agent, generator,
                                            self.device,
                                            self.mac.use_orthogonal),
                "mixer": init_module_params(self.mixer, generator,
                                            self.device,
                                            self.cfg.model.use_orthogonal)}
        params = _tree_map(lambda p: p.detach().to(self.device,
                                                   torch.float32).clone(),
                           params)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return LearnerState(
            params=params,
            target_params=_tree_map(torch.clone, params),
            opt_state=optimizer_init(self.cfg, params),
            train_steps=zero.clone(), last_target_update=zero.clone())

    def train_info_zeros(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The info dict of a skipped train step: ``train``'s keys,
        shapes and dtypes, ``all_finite`` True (with ``obs.sight`` on,
        its keys too)."""
        z = torch.zeros((), device=self.device)
        out = {"loss": z, "td_error_abs": z.clone(),
               "q_taken_mean": z.clone(), "target_mean": z.clone(),
               "grad_norm": z.clone(),
               "td_errors_abs": torch.zeros(batch_size, device=self.device),
               "all_finite": torch.ones((), dtype=torch.bool,
                                        device=self.device)}
        if self.cfg.obs.sight.enabled:
            out.update(sight.train_info_extras_zeros(self.cfg, self.device))
        return out

    # ---------------------------------------------------------- unrolls

    @property
    def _agent_qslice(self) -> bool:
        return agent_qslice_eligible(self.cfg)

    @property
    def _mixer_qslice(self) -> bool:
        from ..ops.query_slice import mixer_qslice_eligible
        return mixer_qslice_eligible(self.cfg)

    @property
    def _mask_padded(self) -> bool:
        """Static gate of the mixer padding mask: True only when the
        config's scenario distribution can draw ``n_active < n_agents``.
        A config that cannot pad runs none of the mask's ops."""
        from ..envs.graftworld import distribution_can_pad
        from ..envs.registry import make_scenario_distribution
        return distribution_can_pad(
            make_scenario_distribution(self.cfg.env_args),
            self.mac.n_agents)

    def _step(self, fn, *args):
        """One unroll step: under ``model.remat`` and autograd, through
        ``torch.utils.checkpoint`` (the backward recomputes the step; a
        step draws only from the explicit key among its arguments, so no
        RNG state is stashed)."""
        if self.cfg.model.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    @property
    def needs_rngs(self) -> bool:
        """Training draws noise: a noisy q-head's sigma params get their
        gradient only through noise drawn in the loss unroll."""
        return (self.cfg.action_selector == "noisy-new"
                or self.cfg.model.dropout > 0.0)

    def _unroll_agent(self, agent_params: Params,
                      obs_tm: Optional[torch.Tensor],
                      key: Optional[torch.Tensor] = None,
                      compact_tm=None, n_grad: Optional[int] = None,
                      drop_rows: Optional[Rows] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs_tm ``(T1, B, A, O)`` → (q ``(T1, B, A, n_actions)``,
        hiddens ``(T1, B, A, emb)``), carrying the hidden token. With
        ``compact_tm`` (time-major ``(rows, same_mec, mean, std)``) the
        entity-table forward runs instead and ``obs_tm`` may be None.
        ``key`` gives step ``t`` the key ``split(key, T1)[t]``: on the
        query-slice and entity paths (a noisy q-head) every step's noisy
        weights are drawn before the loop; the dense forward draws its
        noise and dropout masks inside the step from that key.
        Steps from ``n_grad`` on run without autograd: the online
        unroll's bootstrap step feeds only the detached double-Q argmax,
        and JAX prunes its backward the same way (torch would otherwise
        run it with zero cotangents). Under ``model.remat`` each step
        with a gradient runs through ``_step``'s checkpoint."""
        if self._agent_qslice:
            from ..ops.query_slice import fold_agent_params
            a = self.mac.agent
            # fold once, outside the loop (differentiable)
            agent_params = fold_agent_params(
                agent_params, emb=a.emb, heads=a.heads, depth=a.depth,
                standard_heads=a.standard_heads, dtype=a.dtype)
            if compact_tm is not None:
                fwd = self.mac.forward_entity
            else:
                fwd = lambda p, o, h: self.mac.forward_qslice(
                    p, o, h, attn_impl=self.cfg.kernels.attention)
        elif key is not None:
            fwd = lambda p, o, h, k: self.mac.forward(p, o, h, key=k,
                                                      deterministic=False,
                                                      rows=drop_rows)
        else:
            fwd = self.mac.forward
        impl = self.cfg.prng_impl
        xs = (list(zip(*compact_tm)) if compact_tm is not None
              else list(obs_tm))
        step_params = [agent_params] * len(xs)
        step_keys = [()] * len(xs)
        if key is not None and not self._agent_qslice:
            step_keys = [(k,) for k in prng.split(key, len(xs), impl)]
        elif key is not None:
            qb = agent_params["qb"]
            w, b = noisy_weights(qb["weight_mu"], qb["weight_sigma"],
                                 qb["bias_mu"], qb["bias_sigma"],
                                 prng.split(key, len(xs), impl), impl)
            step_params = [dict(agent_params, qb={"weight": w[t],
                                                  "bias": b[t]})
                           for t in range(len(xs))]
        h = self.mac.init_hidden(len(xs[0][0]) if compact_tm is not None
                                 else obs_tm.shape[1])
        grad = torch.is_grad_enabled()
        qs, hs = [], []
        for t, x_t in enumerate(xs):
            with torch.set_grad_enabled(grad and (n_grad is None
                                                  or t < n_grad)):
                q, h = self._step(fwd, step_params[t], x_t, h,
                                  *step_keys[t])
            qs.append(q)
            hs.append(h)
        return torch.stack(qs), torch.stack(hs)

    def _unroll_mixer(self, mixer_params: Params, q_tm: torch.Tensor,
                      hid_tm: torch.Tensor, state_tm: torch.Tensor,
                      obs_tm: Optional[torch.Tensor],
                      key: Optional[torch.Tensor] = None,
                      drop_rows: Optional[Rows] = None) -> torch.Tensor:
        """q_tm ``(T, B, A)`` → ``q_tot (T, B)``, carrying the 3 hyper
        tokens across time. ``obs_tm`` is None under compact storage
        (the mixer reads the state alone). ``key`` (dropout) gives step
        ``t`` the ``"dropout"`` stream ``split(key, T)[t]``, of the rows
        ``drop_rows`` alone where given (a data-parallel rank's). Under
        ``model.remat`` and autograd each step runs through ``_step``'s
        checkpoint."""
        if key is not None:
            def mix(p, *xs):
                *xs, k = xs
                rngs = {"dropout": k, "impl": self.cfg.prng_impl}
                if drop_rows is not None:
                    rngs["rows"] = drop_rows
                return functional_call(self.mixer, p, tuple(xs),
                                       {"rngs": rngs}, strict=True)
        elif self._mixer_qslice:
            from ..ops.query_slice import make_mixer_qslice
            fold, mix = make_mixer_qslice(self.mixer)
            mixer_params = fold(mixer_params)
        else:
            mix = lambda p, *xs: functional_call(self.mixer, p, xs,
                                                 strict=True)
        hyper = self.mixer.initial_hyper(q_tm.shape[1], device=self.device)
        if obs_tm is None:
            obs_tm = [None] * len(q_tm)
        step_keys = ([()] * len(q_tm) if key is None else
                     [(k,) for k in prng.split(key, len(q_tm),
                                               self.cfg.prng_impl)])
        q_tots = []
        for qv, h, s, o, k in zip(q_tm, hid_tm, state_tm, obs_tm,
                                  step_keys):
            q_tot, hyper = self._step(mix, mixer_params, qv[:, None, :], h,
                                      hyper, s, o, *k)
            q_tots.append(q_tot[:, 0, 0])
        return torch.stack(q_tots)

    # ------------------------------------------------------------- loss

    def _loss(self, params: Tree, target_params: Tree, batch: EpisodeBatch,
              weights: torch.Tensor, key: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        tm = lambda x: x.transpose(0, 1)
        # obs/state may be stored bf16: the loss math lifts them to f32.
        # Compact storage unrolls through the entity tables, with the
        # same-MEC mask rebuilt from the stored MEC index (padded agents'
        # unique sentinels keep them visible to themselves alone)
        if isinstance(batch.obs, CompactEntityObs):
            co = batch.obs
            mec = tm(co.mec_index)
            compact_tm = (tm(co.rows).float(),
                          mec.unsqueeze(-1) == mec.unsqueeze(-2),
                          tm(co.mean), tm(co.std))
            obs = None
        else:
            compact_tm = None
            obs = tm(batch.obs).float()
        state = tm(batch.state).float()
        avail = tm(batch.avail_actions)                    # (T+1, B, A, n)
        actions = tm(batch.actions).long()                 # (T, B, A)
        reward = tm(batch.reward).float()                  # (T, B)
        term = tm(batch.terminated).float()
        mask = tm(batch.filled).float()
        denom = mask.sum()
        if self.comm is not None:
            # the global batch's mask, before any forward (module
            # docstring): a sum of 0/1 values, exact in f32 below 2**24
            denom = self.comm.sum(denom)
        denom = torch.clamp(denom, min=1.0)
        # a data-parallel rank's block of rows of the dropout masks
        rows = None
        if self.comm is not None and cfg.model.dropout > 0.0:
            b = mask.shape[1]
            rows = Rows(torch.arange(self.comm.rank * b,
                                     (self.comm.rank + 1) * b,
                                     device=mask.device), b * self.comm.world)

        # the mixer keys seed its dropout; a noisy-only config drops them
        # and its mixer stays on the deterministic path, as in JAX
        k_ag = k_tag = k_mx = k_tmx = None
        if key is not None:
            k_ag, k_tag, k_mx, k_tmx = prng.split(
                key, 4, cfg.prng_impl).unbind(0)
            if cfg.model.dropout == 0.0:
                k_mx = k_tmx = None
        qs, hs = self._unroll_agent(params["agent"], obs, k_ag, compact_tm,
                                    n_grad=avail.shape[0] - 1,
                                    drop_rows=rows)
        with torch.no_grad():
            target_qs, target_hs = self._unroll_agent(
                target_params["agent"], obs, k_tag, compact_tm,
                drop_rows=rows)

        # the mixer padding mask: padded agents can never take a non-idle
        # action and hold the trailing agent slots (EnvParams.agent_mask
        # is arange < n_active), so the trailing block of agents that
        # never had a non-idle action available, the bootstrap step
        # included, marks them from the stored avail alone (dense and
        # compact storage). Their chosen and target Qs, hidden tokens and
        # obs rows enter the mixer multiplied by 0; active agents by 1,
        # which leaves a full-fleet batch bit-identical
        if self._mask_padded:
            saw_job = avail[..., 1:].any(dim=-1).any(dim=0)      # (B, A)
            act_m = saw_job.int().flip(-1).cummax(-1).values.flip(-1) > 0

            def padmask(x):
                m = act_m.to(x.dtype)
                return x * (m[None] if x.ndim == 3 else m[None, ..., None])

            hs, target_hs = padmask(hs), padmask(target_hs)
            if obs is not None:
                obs = padmask(obs)
        else:
            padmask = lambda x: x  # noqa: E731

        chosen = padmask(qs[:-1].gather(-1, actions[..., None])[..., 0])
        # illegal actions are suppressed in the targets; over all T+1
        # steps so the target mixer unrolls from t=0 like the online one
        with torch.no_grad():
            if cfg.double_q:
                best = torch.where(avail, qs, float("-inf")).argmax(-1)
                target_max = target_qs.gather(-1, best[..., None])[..., 0]
            else:
                target_max = torch.where(avail, target_qs,
                                         float("-inf")).amax(-1)
            target_max = padmask(target_max)
            target_q_tot = self._unroll_mixer(
                target_params["mixer"], target_max, target_hs, state,
                obs, k_tmx, drop_rows=rows)[1:]
        q_tot = self._unroll_mixer(params["mixer"], chosen, hs[:-1],
                                   state[:-1],
                                   None if obs is None else obs[:-1], k_mx,
                                   drop_rows=rows)

        if cfg.reward_unit != 1.0:
            reward = reward / cfg.reward_unit
        targets = reward + cfg.gamma * (1.0 - term) * target_q_tot
        td = (q_tot - targets.detach()) * mask
        if cfg.td_loss == "huber":
            # 2x-scaled Huber, branch selection by where (exact at any
            # delta; see the JAX learner)
            d = cfg.huber_delta
            abs_td = td.abs()
            elem = torch.where(abs_td <= d, td ** 2, 2.0 * d * abs_td - d * d)
        else:
            elem = td ** 2
        loss = (weights[None, :] * elem).sum() / denom
        ep_mask = torch.clamp(mask.sum(dim=0), min=1.0)
        with torch.no_grad():
            info = {
                "loss": loss.detach(),
                "td_error_abs": td.abs().sum() / denom,
                "q_taken_mean": (chosen.mean(dim=-1) * mask).sum() / denom,
                "target_mean": (targets * mask).sum() / denom,
                "td_errors_abs": td.abs().sum(dim=0) / ep_mask,    # (B,)
            }
        if cfg.obs.sight.enabled:
            # the learning-health probes on detached tensors: value-scale
            # histograms and one-timestep attention entropies
            # (under dp the histograms' counts: the global batch's are
            # their sum over the ranks, ``_reduce``)
            info.update(sight.loss_sight_info(
                cfg.obs.sight, td.detach(), chosen.detach(),
                targets.detach(), mask, normalize=self.comm is None))
            if cfg.agent == "transformer":
                info["sight_attn_entropy_agent"] = \
                    sight.agent_attention_entropy(
                        self, params["agent"],
                        None if obs is None else obs[0],
                        None if compact_tm is None
                        else tuple(x[0] for x in compact_tm))
            if cfg.mixer == "transformer":
                info["sight_attn_entropy_mixer"] = \
                    sight.mixer_attention_entropy(
                        self, params["mixer"], state[0],
                        None if obs is None else obs[0], hs[0].detach())
        return loss, info

    # ------------------------------------------------------------ train

    def train(self, ls: LearnerState, batch: EpisodeBatch,
              weights: torch.Tensor, t_env, episode,
              key: Optional[torch.Tensor] = None, spec=None
              ) -> Tuple[LearnerState, Dict[str, torch.Tensor]]:
        """One importance-weighted QMIX update; hard target sync every
        ``target_update_interval`` episodes. ``key`` (``k_learn``) seeds
        the noisy q-head and is required when it is on (ignored
        otherwise) and the dropout masks. ``info["grad_norm"]`` is the pre-clip norm; when the
        loss or the gradients are not finite (``info["all_finite"]``
        False) params and optimizer state pass through unchanged, and
        ``train_steps`` still counts the call. ``spec``: a population
        member's knobs, of which the learner reads ``lr_scale`` (a () f32
        tensor, or a float) to scale the update (module docstring)."""
        del t_env
        if self.needs_rngs and key is None:
            raise ValueError("QMixLearner.train needs a PRNG key when "
                             "action_selector is noisy-new or dropout > 0 "
                             "(noise and masks are drawn in the loss "
                             "unroll)")
        if not self.needs_rngs:
            key = None
        cfg = self.cfg
        params = _tree_map(lambda p: p.detach().requires_grad_(), ls.params)
        weights = weights.to(self.device).float()
        loss, info = self._loss(params, ls.target_params, batch, weights,
                                key)
        inject_at = cfg.resilience.inject_nan_at_step
        if inject_at >= 0:            # fault injection (off: not traced)
            trip = ls.train_steps == inject_at
            loss = loss * torch.where(trip, float("nan"), 1.0)
            info["loss"] = loss.detach()
        leaves = [p for sub in params.values() for p in sub.values()]
        grads_flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads_flat = [_or_zeros(g, p) for g, p in zip(grads_flat, leaves)]
        if self.comm is not None:
            if cfg.obs.sight.enabled:
                info["sight_per_weight_sums"] = sight.weight_sums_of(weights)
            info, grads_flat = self._reduce(info, grads_flat)
        it = iter(grads_flat)
        grads = _tree_map(lambda p: next(it), params)
        norm = global_norm(grads)
        info["grad_norm"] = norm
        all_finite = torch.isfinite(info["loss"]) & torch.isfinite(norm)
        info["all_finite"] = all_finite

        clipped = clip_by_global_norm(grads, norm, cfg.grad_norm_clip)
        updates, opt_state = optimizer_update(cfg, clipped, ls.opt_state)
        if spec is not None:
            scale = torch.as_tensor(spec.lr_scale, device=self.device)
            updates = _tree_map(lambda u: u * scale.to(u.dtype), updates)
        new_params = _tree_map(lambda p, u: p.detach() + u, params, updates)
        # the guard: a tripped step is a no-op on params AND optimizer
        # state (a NaN gradient would poison Adam's moments for good)
        new_params = _select(all_finite, new_params, ls.params)
        opt_state = _select(all_finite, opt_state, ls.opt_state)
        if cfg.obs.sight.enabled:
            # after the guard select: a tripped step reports the drift of
            # the params it kept; the target before this step's sync
            sums = info.pop("sight_per_weight_sums", None)
            info.update(sight.learner_train_info(
                cfg, grads, updates, new_params, ls.target_params,
                weights, weight_sums=None if sums is None else
                (sums, weights.shape[0] * self.comm.world)))

        episode = torch.as_tensor(episode, dtype=torch.int32,
                                  device=self.device)
        sync = (episode - ls.last_target_update) \
            >= cfg.target_update_interval
        target_params = _select(sync, new_params, ls.target_params)
        return LearnerState(
            params=new_params, target_params=target_params,
            opt_state=opt_state, train_steps=ls.train_steps + 1,
            last_target_update=torch.where(sync, episode,
                                           ls.last_target_update),
        ), info


    #: the info values summed over the ranks under dp (each rank's is its
    #: rows' numerator over the global denominator), and with them the
    #: probes' histogram counts, entropies and importance-weight sums
    _SUMMED = ("loss", "td_error_abs", "q_taken_mean", "target_mean")
    _ENTROPIES = ("sight_attn_entropy_agent", "sight_attn_entropy_mixer")
    _SIGHT_SUMMED = sight.HISTOGRAMS + _ENTROPIES + ("sight_per_weight_sums",)

    def _reduce(self, info, grads):
        """Under dp: the logged values (and the probes' parts) summed and
        the TD errors gathered over the ranks, and the gradients of the
        rank's share of the loss summed in one flat all-reduce (module
        docstring)."""
        comm = self.comm
        names = self._SUMMED + tuple(k for k in self._SIGHT_SUMMED
                                     if k in info)
        vals = comm.sum(torch.cat([info[k].reshape(-1) for k in names]))
        info, at = dict(info), 0
        for k in names:
            n = info[k].numel()
            info[k] = vals[at:at + n].view_as(info[k])
            at += n
        for k in sight.HISTOGRAMS:
            if k in info:
                info[k] = sight.histogram_fraction(info[k])
        for k in self._ENTROPIES:
            if k in info:
                # the mean over the ranks' equal blocks of rows
                info[k] = info[k] / comm.world
        info["td_errors_abs"] = comm.gather_rows(info["td_errors_abs"])
        flat = comm.sum(torch.cat([g.reshape(-1) for g in grads]))
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return info, out


def _or_zeros(g: Optional[torch.Tensor], p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if g is None else g


LEARNER_REGISTRY = {"qmix_learner": QMixLearner}
