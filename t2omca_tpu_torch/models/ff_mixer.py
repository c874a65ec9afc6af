"""Feed-forward QMIX and VDN mixers (port of
``t2omca_tpu/models/ff_mixer.py``).

Both take ``TransformerMixer``'s call, ``(qvals, hidden_states,
hyper_weights, states, obs) → (q_tot, hyper')``, so the learner's unroll
is the same for every family; neither is recurrent, and each hands the
dummy ``(b, 3, emb)`` hyper carry back unchanged.

``QMixFFMixer`` is standard QMIX: the flat state goes through the
``state_norm`` LayerNorm (the env's state is unnormalized), then one MLP
each (``<name>_h`` + relu, then ``<name>``, in ``dtype``, read back in
f32) gives ``w1`` ``(n_agents, emb)``, ``b1``, ``w2`` and ``b2``:
``q_tot = elu(q·pos(w1) + b1)·pos(w2) + b2``, with ``b2`` unclamped
(unlike the transformer mixer's relu) and the optional zero-init
``out_gate``. ``VDNMixer`` sums the agents' Qs and has no parameters.
Neither runs attention, so neither launches a flash kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .mixer import qmix_pos_func
from .transformer import LN_EPS, LayerNorm, dense


class FastVarianceLayerNorm(LayerNorm):
    """flax ``LayerNorm`` as it computes: f32 statistics with the fast
    variance ``mean(x²) - mean(x)²`` (clamped at 0), then ``(x - mean)
    · (rsqrt(var + eps) · scale) + bias``. The state's raw features are
    O(1e4), where that form and a two-pass variance part ways."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.weight.float()
        return ((x32 - mean) * mul + self.bias.float()).to(
            self.compute_dtype)


class QMixFFMixer(nn.Module):
    def __init__(self, n_agents: int, n_entities: int = 0,
                 feat_dim: int = 0, emb: int = 32, heads: int = 1,
                 depth: int = 1, ff_hidden_mult: int = 4,
                 dropout: float = 0.0, qmix_pos_func: str = "abs",
                 qmix_pos_func_beta: float = 1.0,
                 state_entity_mode: bool = True,
                 standard_heads: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
                 zero_init_gate: bool = False, hypernet_layers: int = 2,
                 hypernet_emb: int = 64, state_dim: int = 0, device=None):
        super().__init__()
        del heads, depth, ff_hidden_mult, dropout, attn_impl  # interface
        self.n_agents, self.emb, self.dtype = n_agents, emb, dtype
        self.qmix_pos_func, self.qmix_pos_func_beta = (qmix_pos_func,
                                                       qmix_pos_func_beta)
        self.state_entity_mode, self.standard_heads = (state_entity_mode,
                                                       standard_heads)
        self.hypernet_layers = hypernet_layers
        self.zero_init_gate = zero_init_gate
        self.state_norm = FastVarianceLayerNorm(state_dim, dtype,
                                                device=device)
        for name, out in (("hyper_w1", n_agents * emb), ("hyper_b1", emb),
                          ("hyper_w2", emb), ("hyper_b2", 1)):
            width = state_dim
            if hypernet_layers >= 2:
                self.add_module(f"{name}_h", nn.Linear(
                    state_dim, hypernet_emb, device=device))
                width = hypernet_emb
            self.add_module(name, nn.Linear(width, out, device=device))
        if zero_init_gate:
            self.out_gate = nn.Parameter(torch.zeros(1, device=device))

    def pos_func(self, x: torch.Tensor) -> torch.Tensor:
        return qmix_pos_func(x, self.qmix_pos_func, self.qmix_pos_func_beta)

    def _hyper(self, name: str, s: torch.Tensor) -> torch.Tensor:
        x = s
        if self.hypernet_layers >= 2:
            x = torch.relu(dense(getattr(self, f"{name}_h"), x, self.dtype))
        return dense(getattr(self, name), x, self.dtype).float()

    def forward(self, qvals: torch.Tensor, hidden_states: torch.Tensor,
                hyper_weights: torch.Tensor, states: torch.Tensor,
                obs: Optional[torch.Tensor],
                rngs: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        del hidden_states, obs, rngs
        b = qvals.shape[0]
        s = self.state_norm(states.reshape(b, -1).to(self.dtype))
        w1 = self.pos_func(self._hyper("hyper_w1", s)).reshape(
            b, self.n_agents, self.emb)
        b1 = self._hyper("hyper_b1", s).reshape(b, 1, self.emb)
        w2 = self.pos_func(self._hyper("hyper_w2", s)).reshape(
            b, self.emb, 1)
        b2 = self._hyper("hyper_b2", s).reshape(b, 1, 1)
        hidden = F.elu(torch.matmul(qvals.float(), w1) + b1)
        y = torch.matmul(hidden, w2) + b2
        if self.zero_init_gate:
            y = y * self.out_gate
        return y, hyper_weights

    def initial_hyper(self, batch_size: int, device=None) -> torch.Tensor:
        """The dummy recurrent carry, zeros ``(batch, 3, emb)``."""
        return torch.zeros(batch_size, 3, self.emb, device=device)


class VDNMixer(nn.Module):
    """``q_tot = Σ_a q_a``."""

    def __init__(self, n_agents: int, emb: int = 32, device=None, **_):
        super().__init__()
        self.n_agents, self.emb = n_agents, emb

    def forward(self, qvals: torch.Tensor, hidden_states: torch.Tensor,
                hyper_weights: torch.Tensor, states: torch.Tensor,
                obs: Optional[torch.Tensor],
                rngs: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        del hidden_states, states, obs, rngs
        return qvals.float().sum(dim=-1, keepdim=True), hyper_weights

    def initial_hyper(self, batch_size: int, device=None) -> torch.Tensor:
        return torch.zeros(batch_size, 3, self.emb, device=device)
