"""Transformer Q-agent (port of ``t2omca_tpu/models/agent.py``).

Entity-tokenized observations are embedded, the recurrent hidden state
is prepended as token 0, the stack self-attends (q = k = tokens), token
0 becomes the new hidden state and is projected to per-action Q-values.
Inputs ``(batch, n_agents, obs)`` fold to ``(batch*n_agents, n_entities,
feat)`` so all agents share one set of weights. The q-head and the
carried hidden state are f32 whatever the compute dtype.

``rngs`` is the dict flax's ``apply`` takes (``{"noise": k, "dropout":
k}``, each a ``(2,)`` key): dropout in the blocks draws under
``transformer``, a noisy q-head under ``q_basic``. None is flax's
``deterministic=True``. A data-parallel rank adds ``"rows"``, its
``flax_rng.Rows`` of the global batch, which the dropout masks draw.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..flax_rng import Scope
from .noisy import NoisyLinear
from .transformer import Transformer, dense


class TransformerAgent(nn.Module):
    def __init__(self, n_agents: int, n_entities: int, feat_dim: int,
                 emb: int, heads: int, depth: int, n_actions: int,
                 ff_hidden_mult: int = 4, dropout: float = 0.0,
                 noisy: bool = False, standard_heads: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
                 device=None):
        super().__init__()
        self.n_agents, self.n_entities, self.feat_dim = (n_agents,
                                                         n_entities,
                                                         feat_dim)
        self.emb, self.heads, self.depth = emb, heads, depth
        self.n_actions, self.noisy = n_actions, noisy
        self.standard_heads, self.dtype = standard_heads, dtype
        self.dropout = dropout
        self.feat_embedding = nn.Linear(feat_dim, emb, device=device)
        self.transformer = Transformer(
            emb, heads, depth, ff_hidden_mult=ff_hidden_mult,
            dropout=dropout, standard_heads=standard_heads, dtype=dtype,
            attn_impl=attn_impl, device=device)
        if noisy:
            self.q_basic = NoisyLinear(emb, n_actions, device=device)
        else:
            self.q_basic = nn.Linear(emb, n_actions, device=device)

    def forward(self, inputs: torch.Tensor, hidden_state: torch.Tensor,
                rngs: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (q ``(b, a, n_actions)`` f32, hidden' ``(b, a, emb)`` f32)."""
        b, a, _ = inputs.shape
        x = inputs.reshape(b * a, self.n_entities, self.feat_dim)
        h = hidden_state.reshape(b * a, 1, self.emb).to(self.dtype)
        embs = dense(self.feat_embedding, x, self.dtype)
        tokens = torch.cat([h, embs], dim=1)        # hidden token at 0
        out = self.transformer(tokens, tokens,
                               rng=scope(rngs, "dropout", "transformer"))
        h_new = out[:, 0:1, :].float()
        if self.noisy:
            q = self.q_basic(h_new, scope(rngs, "noise", "q_basic"))
        else:
            q = dense(self.q_basic, h_new, torch.float32)
        return (q.float().reshape(b, a, self.n_actions),
                h_new.reshape(b, a, self.emb))

    def initial_hidden(self, batch_size: int, device=None) -> torch.Tensor:
        return torch.zeros(batch_size, self.n_agents, self.emb,
                           device=device)


def scope(rngs: Optional[Dict[str, torch.Tensor]], stream: str,
          name: str) -> Optional[Scope]:
    """The scope ``name`` of ``rngs[stream]`` below a module's root (with
    the rank's ``rngs["rows"]`` and the run's ``rngs["impl"]`` where
    given), or None (deterministic)."""
    if rngs is None:
        return None
    return Scope(rngs[stream], rows=rngs.get("rows"),
                 impl=rngs.get("impl")).child(name)
