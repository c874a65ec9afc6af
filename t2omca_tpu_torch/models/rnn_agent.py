"""GRU recurrent Q-agent (port of ``t2omca_tpu/models/rnn_agent.py``).

``obs → fc1 + relu → GRU cell → q-head``, with the transformer agent's
interface: agents fold into the batch, the hidden state is carried
explicitly, and the MAC hands the flat obs in as one token. The cell is
flax's ``GRUCell`` as plain tensor ops on its own parameters (its gate
layout is not ``torch.nn.GRUCell``'s):

    r = σ(ir(x) + hr(h)),  z = σ(iz(x) + hz(h))
    n = tanh(in(x) + r · hn(h)),  h' = (1 - z) · n + z · h

``ir``/``iz``/``in`` carry biases, ``hr``/``hz`` none, ``hn`` one inside
``r · (·)``. ``fc1`` and the cell compute in ``dtype`` (flax ``Dense``
casts input and weights); the q-head and the carried state are f32. A
noisy q-head draws from ``rngs["noise"]`` under ``q_basic``, as the
transformer agent's does; the agent has no dropout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .agent import scope
from .noisy import NoisyLinear
from .transformer import dense


class GRUCell(nn.Module):
    """flax ``linen.GRUCell``'s parameters and arithmetic. ``hr``, ``hz``
    and ``hn`` take flax's orthogonal recurrent initializer
    (``recurrent``)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_features, features,
                                            device=device))
        for name in ("hr", "hz", "hn"):
            layer = nn.Linear(features, features, bias=name == "hn",
                              device=device)
            layer.recurrent = True
            self.add_module(name, layer)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        lin = lambda name, v: dense(getattr(self, name), v, self.dtype)
        r = torch.sigmoid(lin("ir", x) + lin("hr", h))
        z = torch.sigmoid(lin("iz", x) + lin("hz", h))
        n = torch.tanh(lin("in", x) + r * lin("hn", h))
        return (1.0 - z) * n + z * h.to(n.dtype)


class RNNAgent(nn.Module):
    def __init__(self, n_agents: int, n_entities: int, feat_dim: int,
                 emb: int, heads: int = 1, depth: int = 1,
                 n_actions: int = 3, ff_hidden_mult: int = 4,
                 dropout: float = 0.0, noisy: bool = False,
                 standard_heads: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
                 device=None):
        super().__init__()
        del heads, depth, ff_hidden_mult, dropout, attn_impl  # interface
        self.dropout = 0.0                  # the GRU agent has none
        self.n_agents, self.n_entities, self.feat_dim = (n_agents,
                                                         n_entities,
                                                         feat_dim)
        self.emb, self.n_actions, self.noisy = emb, n_actions, noisy
        self.standard_heads, self.dtype = standard_heads, dtype
        self.fc1 = nn.Linear(feat_dim, emb, device=device)
        self.rnn = GRUCell(emb, emb, dtype=dtype, device=device)
        if noisy:
            self.q_basic = NoisyLinear(emb, n_actions, device=device)
        else:
            self.q_basic = nn.Linear(emb, n_actions, device=device)

    def forward(self, inputs: torch.Tensor, hidden_state: torch.Tensor,
                rngs: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (q ``(b, a, n_actions)`` f32, hidden' ``(b, a, emb)`` f32)."""
        b, a, obs_dim = inputs.shape
        x = inputs.reshape(b * a, obs_dim).to(self.dtype)
        h = hidden_state.reshape(b * a, self.emb).to(self.dtype)
        x = torch.relu(dense(self.fc1, x, self.dtype))
        h_new = self.rnn(h, x).float()
        if self.noisy:
            q = self.q_basic(h_new, scope(rngs, "noise", "q_basic"))
        else:
            q = dense(self.q_basic, h_new, torch.float32)
        return (q.float().reshape(b, a, self.n_actions),
                h_new.reshape(b, a, self.emb))

    def initial_hidden(self, batch_size: int, device=None) -> torch.Tensor:
        return torch.zeros(batch_size, self.n_agents, self.emb,
                           device=device)
