"""Transformer QMIX mixer (port of ``t2omca_tpu/models/mixer.py``).

The QMIX hypernetwork weights are read off positional output tokens of a
transformer run over [state-entity embeddings ++ agent hidden states ++
3 recurrent hyper tokens] (quirk Q11: the order is load-bearing):

    w1 = tokens[-3-n_agents:-3]   (one per agent)
    b1 = tokens[-3]
    w2 = tokens[-2]
    b2 = relu(hyper_b2(tokens[-1]))

Monotonicity in the per-agent Qs comes from ``pos_func`` on w1/w2, then
``q_tot = elu(q·w1 + b1)·w2 + b2``, optionally times the zero-init
``out_gate``. The mixer returns its last 3 output tokens, which the
learner carries across timesteps. Quirk Q12: without
``state_entity_mode`` the mixer tokenizes all agents' observation
entities instead of the state entities. Parameter names mirror the flax
tree (``convert.mixer_state_from_flax``). ``rngs`` (``{"dropout": k}``,
flax's ``apply`` argument) draws the blocks' dropout under
``transformer``; None is deterministic.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .agent import scope
from .transformer import Transformer, dense


def qmix_pos_func(x: torch.Tensor, kind: str, beta: float = 1.0
                  ) -> torch.Tensor:
    """Monotonicity transform for the QMIX mixing weights. ``softplus``
    is ``jax.nn.softplus(βx)/β`` = ``logaddexp(βx, 0)/β`` everywhere
    (``F.softplus`` switches to the identity above its threshold)."""
    if kind == "softplus":
        bx = beta * x
        return torch.logaddexp(bx, torch.zeros_like(bx)) / beta
    if kind == "quadratic":
        return 0.5 * x ** 2
    if kind == "abs":
        return torch.abs(x)
    return x


class TransformerMixer(nn.Module):
    def __init__(self, n_agents: int, n_entities: int, feat_dim: int,
                 emb: int, heads: int, depth: int, ff_hidden_mult: int = 4,
                 dropout: float = 0.0,
                 qmix_pos_func: str = "abs", qmix_pos_func_beta: float = 1.0,
                 state_entity_mode: bool = True,
                 standard_heads: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
                 zero_init_gate: bool = False, device=None):
        super().__init__()
        self.n_agents, self.n_entities, self.feat_dim = (n_agents,
                                                         n_entities,
                                                         feat_dim)
        self.emb, self.heads, self.depth = emb, heads, depth
        self.qmix_pos_func, self.qmix_pos_func_beta = (qmix_pos_func,
                                                       qmix_pos_func_beta)
        self.state_entity_mode = state_entity_mode
        self.standard_heads, self.dtype = standard_heads, dtype
        self.attn_impl = attn_impl
        self.zero_init_gate = zero_init_gate
        self.feat_embedding = nn.Linear(feat_dim, emb, device=device)
        self.transformer = Transformer(
            emb, heads, depth, ff_hidden_mult=ff_hidden_mult,
            dropout=dropout, standard_heads=standard_heads, dtype=dtype,
            attn_impl=attn_impl, device=device)
        self.hyper_b2 = nn.Linear(emb, 1, device=device)
        if zero_init_gate:
            self.out_gate = nn.Parameter(torch.zeros(1, device=device))

    def pos_func(self, x: torch.Tensor) -> torch.Tensor:
        return qmix_pos_func(x, self.qmix_pos_func, self.qmix_pos_func_beta)

    def forward(self, qvals: torch.Tensor, hidden_states: torch.Tensor,
                hyper_weights: torch.Tensor, states: torch.Tensor,
                obs: torch.Tensor,
                rngs: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """qvals ``(b, 1, n_agents)``; hidden_states ``(b, n_agents,
        emb)``; hyper_weights ``(b, 3, emb)`` → ``(q_tot (b, 1, 1), hyper
        (b, 3, emb))``, both f32."""
        b = qvals.shape[0]
        if self.state_entity_mode:
            inputs = states.reshape(b, self.n_entities, self.feat_dim)
        else:                               # Q12: all agents' obs entities
            inputs = obs.reshape(b, self.n_agents * self.n_entities,
                                 self.feat_dim)
        embs = dense(self.feat_embedding, inputs, self.dtype)
        tokens = torch.cat([embs, hidden_states.to(embs.dtype),
                            hyper_weights.to(embs.dtype)], dim=1)
        out = self.transformer(tokens, tokens,
                               rng=scope(rngs, "dropout", "transformer")
                               ).float()
        w1 = out[:, -3 - self.n_agents:-3, :]
        b1 = out[:, -3, :].reshape(b, 1, self.emb)
        w2 = out[:, -2, :].reshape(b, self.emb, 1)
        b2 = torch.relu(dense(self.hyper_b2, out[:, -1, :],
                              torch.float32)).reshape(b, 1, 1)
        w1 = self.pos_func(w1)
        w2 = self.pos_func(w2)
        hidden = F.elu(torch.matmul(qvals.float(), w1) + b1)
        y = torch.matmul(hidden, w2) + b2
        if self.zero_init_gate:
            y = y * self.out_gate
        return y, out[:, -3:, :]

    def initial_hyper(self, batch_size: int, device=None) -> torch.Tensor:
        """Zeros ``(batch, 3, emb)``: the 3 hyper tokens the forward
        consumes."""
        return torch.zeros(batch_size, 3, self.emb, device=device)
