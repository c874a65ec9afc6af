"""Multi-agent controller (port of ``t2omca_tpu/controllers/basic_mac.py``).

The MAC is a frozen descriptor (agent module + selector + device); the
parameters are passed explicitly as a state dict keyed by the agent's
parameter names, as the JAX MAC passes its param tree. The agent modules
themselves are built on the ``meta`` device and hold no weights: every
forward runs ``torch.func.functional_call`` over the given params, so
one MAC serves any number of param sets (f32 and bf16 variants, folded
and raw).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from .. import prng
from ..components.action_selectors import (SELECTOR_REGISTRY,
                                           EpsilonGreedySelector,
                                           exploration_draws)
from ..components.schedules import DecayThenFlatSchedule
from ..config import TrainConfig
from ..device import DeviceLike, resolve_device
from ..models.agent import TransformerAgent
from ..models.noisy import NoisyLinear
from ..models.rnn_agent import RNNAgent

#: agent families, as the JAX MAC's registry
AGENT_REGISTRY = {"transformer": TransformerAgent, "rnn": RNNAgent}

Params = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; valid: "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class BasicMAC:
    agent: TransformerAgent
    selector: object            # EpsilonGreedySelector | NoisySelector
    n_agents: int
    n_actions: int
    emb: int
    device: torch.device
    use_qslice: bool = False    # exact token-0-only forward (ops/query_slice)
    # acting through the entity tables (ops/query_slice,
    # agent_forward_qslice_entity) when the runner hands ``compact`` in
    use_entity_tables: bool = False
    use_orthogonal: bool = False
    # acting-path compute dtype (model.act_dtype); None = the agent's
    act_dtype: Optional[torch.dtype] = None
    act_agent: Optional[TransformerAgent] = None
    #: the run's ``prng_impl``: the keys' ``split``/``fold_in``
    prng_impl: str = "threefry"

    @classmethod
    def build(cls, cfg: TrainConfig, env_info: dict,
              device: DeviceLike = None) -> "BasicMAC":
        """Runs on ``cuda`` unless ``device`` says otherwise (raises when
        no card is present and none was named)."""
        device = resolve_device(device)
        n_agents = env_info["n_agents"]
        n_entities = cfg.model.n_entities_obs or env_info["n_entities"]
        feat = env_info.get("obs_entity_feats")
        if feat is None or cfg.agent == "rnn":
            # flat-obs mode and flat-input agents: the whole obs vector
            # is one entity token
            n_entities, feat = 1, env_info["obs_shape"]
        dtype = torch_dtype(cfg.model.dtype)
        kw = dict(n_agents=n_agents, n_entities=n_entities, feat_dim=feat,
                  emb=cfg.model.emb, heads=cfg.model.heads,
                  depth=cfg.model.depth, n_actions=env_info["n_actions"],
                  ff_hidden_mult=cfg.model.ff_hidden_mult,
                  dropout=cfg.model.dropout,
                  noisy=cfg.action_selector == "noisy-new",
                  standard_heads=cfg.model.standard_heads,
                  attn_impl=cfg.kernels.attention, device="meta")
        family = AGENT_REGISTRY[cfg.agent]
        agent = family(dtype=dtype, **kw)
        act_dtype = torch_dtype(cfg.model.act_dtype or cfg.model.dtype)
        act_agent = (family(dtype=act_dtype, **kw)
                     if act_dtype != dtype else None)
        schedule = DecayThenFlatSchedule(
            cfg.epsilon_start, cfg.epsilon_finish, cfg.epsilon_anneal_time)
        selector = SELECTOR_REGISTRY[cfg.action_selector](schedule)
        from ..ops.query_slice import (agent_qslice_eligible,
                                       entity_tables_eligible)
        return cls(agent=agent, selector=selector, n_agents=n_agents,
                   n_actions=env_info["n_actions"], emb=cfg.model.emb,
                   device=device, use_qslice=agent_qslice_eligible(cfg),
                   use_entity_tables=entity_tables_eligible(cfg),
                   use_orthogonal=cfg.model.use_orthogonal,
                   act_dtype=act_dtype, act_agent=act_agent,
                   prng_impl=cfg.prng_impl)

    # ------------------------------------------------------------------ state

    def init_params(self, generator: torch.Generator) -> Params:
        """Fresh f32 agent params from a CPU ``torch.Generator`` (see
        ``init_module_params``), on the MAC's device."""
        return init_module_params(self.agent, generator, self.device,
                                  self.use_orthogonal)

    def init_hidden(self, batch_size: int) -> torch.Tensor:
        """Zeros ``(batch, n_agents, emb)`` on the MAC's device."""
        return self.agent.initial_hidden(batch_size, device=self.device)

    # ---------------------------------------------------------------- forward

    @property
    def dtype(self) -> torch.dtype:
        return self.agent.dtype

    @property
    def _acting_dtype(self) -> torch.dtype:
        return self.act_dtype if self.act_dtype is not None else self.dtype

    @property
    def stochastic(self) -> bool:
        """Whether a training-mode dense forward draws: a noisy q-head or
        dropout in the transformer blocks."""
        return self.agent.noisy or self.agent.dropout > 0.0

    def forward(self, params: Params, obs: torch.Tensor,
                hidden: torch.Tensor, key: Optional[torch.Tensor] = None,
                deterministic: bool = True, acting: bool = False,
                rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense forward: obs ``(B, A, obs_dim)`` → (q ``(B, A,
        n_actions)``, hidden'). With ``key`` and ``deterministic`` False,
        ``k_noise, k_drop = split(key)`` seed the noisy q-head and the
        dropout masks (flax's ``rngs``), as the JAX MAC does; ``rows`` (a
        data-parallel rank's ``flax_rng.Rows`` of the global batch) draws
        the rank's rows of the masks. ``acting=True`` runs the act_dtype
        module."""
        module = (self.act_agent if acting and self.act_agent is not None
                  else self.agent)
        rngs = None
        if key is not None and not deterministic:
            k_noise, k_drop = prng.split(key, 2, self.prng_impl).unbind(-2)
            rngs = {"noise": k_noise, "dropout": k_drop,
                    "impl": self.prng_impl}
            if rows is not None:
                rngs["rows"] = rows
        return functional_call(module, params, (obs, hidden),
                               {"rngs": rngs}, strict=True)

    def _noise_key(self, key: Optional[torch.Tensor],
                   deterministic: bool) -> Optional[torch.Tensor]:
        """The q-head's noise key on the query-slice and entity paths:
        only a noisy agent outside deterministic mode draws noise (the
        dense module's eval-mode mu path otherwise)."""
        if key is None or deterministic or not self.agent.noisy:
            return None
        return key

    def forward_qslice(self, params, obs: torch.Tensor,
                       hidden: torch.Tensor,
                       key: Optional[torch.Tensor] = None,
                       deterministic: bool = True, acting: bool = False,
                       attn_impl: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token-0-only forward over the same params (raw or folded).
        ``key`` seeds a noisy q-head when ``deterministic`` is False.
        ``attn_impl=None`` keeps the plain attention path, as the JAX
        MAC does for acting and serving."""
        from ..ops.query_slice import agent_forward_qslice
        a = self.agent
        return agent_forward_qslice(
            params, obs, hidden, n_entities=a.n_entities,
            feat_dim=a.feat_dim, emb=a.emb, heads=a.heads, depth=a.depth,
            n_actions=a.n_actions, standard_heads=a.standard_heads,
            dtype=self._acting_dtype if acting else a.dtype,
            noise_key=self._noise_key(key, deterministic),
            attn_impl=attn_impl or "xla", prng_impl=self.prng_impl)

    def forward_entity(self, params, compact, hidden: torch.Tensor,
                       key: Optional[torch.Tensor] = None,
                       deterministic: bool = True, acting: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Entity-table forward: ``compact`` is the env's ``(rows,
        same_mec, mean, std)`` over the lanes. It launches no flash
        kernel (plain tensor code, as in JAX)."""
        from ..ops.query_slice import agent_forward_qslice_entity
        rows, same_mec, mean, std = compact
        a = self.agent
        return agent_forward_qslice_entity(
            params, rows, same_mec, mean, std, hidden, emb=a.emb,
            heads=a.heads, depth=a.depth, n_actions=a.n_actions,
            standard_heads=a.standard_heads,
            dtype=self._acting_dtype if acting else a.dtype,
            noise_key=self._noise_key(key, deterministic),
            prng_impl=self.prng_impl)

    def prepare_acting_params(self, params: Params, dtype=None):
        """Fold the query-slice products once (qslice MACs), and pre-cast
        float leaves when the acting dtype differs from the train dtype.
        ``dtype`` overrides the fold dtype (serving passes the train
        dtype)."""
        ad = torch_dtype(dtype) if dtype is not None else self._acting_dtype
        if not self.use_qslice:
            return self._cast_acting(params, ad)
        from ..ops.query_slice import fold_agent_params
        a = self.agent
        folded = fold_agent_params(params, emb=a.emb, heads=a.heads,
                                   depth=a.depth,
                                   standard_heads=a.standard_heads,
                                   dtype=ad)
        return self._cast_acting(folded, ad)

    def _cast_acting(self, tree, ad: torch.dtype):
        """Cast f32 leaves to the acting dtype, only in the mixed mode
        (acting dtype != train dtype)."""
        if ad == self.dtype:
            return tree
        return map_float_leaves(tree, lambda x: x.to(ad)
                                if x.dtype == torch.float32 else x)

    def select_actions(self, params, obs: Optional[torch.Tensor],
                       avail: torch.Tensor, hidden: torch.Tensor,
                       key: torch.Tensor, t_env=0, test_mode: bool = False,
                       draws=None, compact=None, eps=None, rows=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """→ (actions ``(B, A)`` int32, hidden', epsilon). ``key (2,)``
        splits ``k_noise, k_sel`` as the JAX MAC does: a noisy q-head
        draws from ``k_noise`` outside test mode, the selector from
        ``k_sel``, or takes ``draws`` (``exploration_draws``, drawn ahead
        for a whole rollout). ``compact`` (the env's compact obs) takes
        the entity-table forward when the MAC was built eligible; ``obs``
        may then be None. ``eps`` (a () device tensor) replaces the
        epsilon of ``t_env`` (the selector's ``select``). Outside test
        mode the dense forward draws its noise and dropout masks from
        ``k_noise`` (a dropout config drops in its rollouts too, as in
        JAX); test mode and serving stay deterministic. ``rows``: a
        data-parallel rank's lanes of the global masks (``forward``)."""
        needs_noise = self.stochastic and not test_mode
        k_noise, k_sel = (prng.split(key, 2, self.prng_impl).unbind(0)
                          if needs_noise or draws is None else (None, None))
        if self.use_entity_tables and compact is not None:
            q, hidden = self.forward_entity(params, compact, hidden,
                                            key=k_noise,
                                            deterministic=test_mode,
                                            acting=True)
        elif self.use_qslice:
            q, hidden = self.forward_qslice(params, obs, hidden,
                                            key=k_noise,
                                            deterministic=test_mode,
                                            acting=True)
        else:
            q, hidden = self.forward(params, obs, hidden, key=k_noise,
                                     deterministic=test_mode, acting=True,
                                     rows=rows)
        actions, eps = self.selector.select(k_sel, q, avail, t_env,
                                            test_mode=test_mode,
                                            draws=draws, eps=eps,
                                            impl=self.prng_impl)
        return actions.to(torch.int32), hidden, eps

    def exploration_draws(self, key: torch.Tensor, batch: int, rows=None):
        """The selector's draws for keys ``key (..., width)`` (one a
        step) and ``batch`` env lanes: ``k_noise, k_sel = split(key)``,
        then ``exploration_draws(k_sel, (batch, A, n_actions))``, of the
        lanes ``rows`` alone where given; ``None`` for selectors that draw
        nothing."""
        if not isinstance(self.selector, EpsilonGreedySelector):
            return None
        k_sel = prng.split(key, 2, self.prng_impl,
                           scan=key.dim() - 1).unbind(-2)[1]
        return exploration_draws(k_sel, (batch, self.n_agents,
                                         self.n_actions), rows,
                                 self.prng_impl)


def init_module_params(module: nn.Module, generator: torch.Generator,
                       device: torch.device,
                       use_orthogonal: bool = False) -> Params:
    """Fresh f32 params for every parameter of ``module`` (the agent, or
    the learner's mixer), drawn on the CPU from ``generator`` so that a
    seed gives the same weights on every device, then moved to
    ``device``. flax's initializers: lecun-normal (or orthogonal)
    kernels, zero biases, unit LayerNorm scales, the NoisyNet
    uniform/constant pair, the mixer's zero ``out_gate``, and flax's
    orthogonal recurrent kernels of the GRU cell (``recurrent``
    layers)."""
    out: Params = {}
    for mname, mod in module.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(mod, NoisyLinear):
            bound = mod.in_features ** -0.5
            shape = (mod.out_features, mod.in_features)
            uni = lambda s: (torch.rand(s, generator=generator)
                             * 2 * bound - bound)
            out[pre + "weight_mu"] = uni(shape)
            out[pre + "weight_sigma"] = torch.full(shape, mod.sigma0 * bound)
            out[pre + "bias_mu"] = uni((mod.out_features,))
            out[pre + "bias_sigma"] = torch.full((mod.out_features,),
                                                 mod.sigma0 * bound)
        elif isinstance(mod, nn.LayerNorm):
            out[pre + "weight"] = torch.ones(mod.normalized_shape)
            out[pre + "bias"] = torch.zeros(mod.normalized_shape)
        elif isinstance(mod, nn.Linear):
            w = torch.empty(mod.out_features, mod.in_features)
            if getattr(mod, "recurrent", False):
                nn.init.orthogonal_(w, 1.0, generator=generator)
            elif use_orthogonal:
                nn.init.orthogonal_(w, math.sqrt(2.0), generator=generator)
            else:
                # flax lecun_normal: truncated normal, variance 1/fan_in
                std = (1.0 / mod.in_features) ** 0.5 / .87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            out[pre + "weight"] = w
            if mod.bias is not None:
                out[pre + "bias"] = torch.zeros(mod.out_features)
        for pname, param in mod.named_parameters(recurse=False):
            if pre + pname not in out:       # the mixer's zero-init gate
                out[pre + pname] = torch.zeros(param.shape)
    return {k: v.to(device) for k, v in out.items()}


def map_float_leaves(tree, fn):
    """Apply ``fn`` to every floating tensor leaf of a nested dict/list
    param tree (other leaves pass through)."""
    if isinstance(tree, dict):
        return {k: map_float_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_float_leaves(v, fn) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


MAC_REGISTRY = {"basic_mac": BasicMAC}
