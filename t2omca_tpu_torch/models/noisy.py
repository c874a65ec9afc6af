"""Factorized-Gaussian NoisyNet linear layer (port of
``t2omca_tpu/models/noisy.py``).

``w = mu_w + sigma_w * (f(eps_out) ⊗ f(eps_in))``, ``b = mu_b + sigma_b *
f(eps_out)`` with ``f(x) = sign(x)·sqrt(|x|)``. ``noisy_weights`` makes
one draw of that affine from an explicit threefry key, as the JAX
function does for the query-slice and entity-table q-heads
(``ops/query_slice._q_head``), bit for bit in the key chain. The dense
module below draws its training noise from its ``"noise"`` scope
(``flax_rng.Scope``), the key flax's ``make_rng("noise")`` gives the
JAX module; without one it runs the mu path (flax's
``deterministic=True``). Weights are stored torch-style, ``(out, in)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from typing import Optional

from .. import prng
from ..flax_rng import Scope
from ..xla_float import fma, sqrt


def _scaled_noise(key: torch.Tensor, n: int) -> torch.Tensor:
    """``f(x) = sign(x)·sqrt(|x|)`` of ``n`` standard normals from each
    key of ``key (..., width)`` → ``(..., n)``."""
    x = prng.normal(key, (n,), scan=key.dim() - 1)
    return torch.sign(x) * sqrt(torch.abs(x))


def noisy_weights(w_mu: torch.Tensor, w_sigma: torch.Tensor,
                  b_mu, b_sigma, key: torch.Tensor, impl=None):
    """One factored-Gaussian draw of the noisy affine: ``k_in, k_out =
    split(key)``, ``eps_in`` over the ``in`` features and ``eps_out`` over
    the ``out`` features. ``w (out, in)``; keys ``(..., width)`` give a
    draw for each key (a scan over steps in JAX, not a vmap), ``(..., out,
    in)`` (``impl``: the run's ``prng_impl``). ``b_mu=None`` for bias-less layers.
    XLA contracts ``sigma · outer + mu`` into one FMA; so does this."""
    k_in, k_out = prng.split(key, 2, impl, key.dim() - 1).unbind(-2)
    eps_in = _scaled_noise(k_in, w_mu.shape[-1])
    eps_out = _scaled_noise(k_out, w_mu.shape[-2])
    outer = eps_out.unsqueeze(-1) * eps_in.unsqueeze(-2)
    w = fma(w_sigma, outer, w_mu)
    b = None if b_mu is None else fma(b_sigma, eps_out, b_mu)
    return w, b


class NoisyLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 sigma0: float = 0.5, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.sigma0 = sigma0
        shape = (out_features, in_features)
        self.weight_mu = nn.Parameter(torch.empty(shape, device=device))
        self.weight_sigma = nn.Parameter(torch.empty(shape, device=device))
        self.bias_mu = nn.Parameter(torch.empty(out_features, device=device))
        self.bias_sigma = nn.Parameter(torch.empty(out_features,
                                                   device=device))

    def forward(self, x: torch.Tensor, rng: Optional[Scope] = None
                ) -> torch.Tensor:
        """``rng``: the layer's ``"noise"`` scope; None runs the mu
        path."""
        if rng is None:
            w, b = self.weight_mu, self.bias_mu
        else:
            w, b = noisy_weights(self.weight_mu, self.weight_sigma,
                                 self.bias_mu, self.bias_sigma,
                                 rng.make_rng(), rng.impl)
        return F.linear(x, w.to(x.dtype), b.to(x.dtype))
