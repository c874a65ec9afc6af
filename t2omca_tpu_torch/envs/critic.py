"""CRITIC multi-criteria weighting (port of ``t2omca_tpu/envs/critic.py``).

Criteria Importance Through Intercriteria Correlation (Diakoulaki 1995):
``weight_j ∝ std_j · Σ_k (1 − r_jk)`` over min-max normalized criteria,
scores = normalized matrix · weights. Degenerate columns (zero range or
zero std) are handled with epsilons instead of producing NaN.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def critic(matrix: torch.Tensor) -> torch.Tensor:
    """``(..., n_agents, n_criteria)`` → scores ``(..., n_agents)``."""
    x = matrix.float()
    lo = x.amin(dim=-2, keepdim=True)
    hi = x.amax(dim=-2, keepdim=True)
    xn = (x - lo) / torch.clamp(hi - lo, min=_EPS)

    n = xn.shape[-2]
    xc = xn - xn.mean(dim=-2, keepdim=True)
    std = torch.sqrt((xc * xc).mean(dim=-2))             # population std
    cov = (xc.transpose(-1, -2) @ xc) / n
    denom = torch.clamp(std.unsqueeze(-1) * std.unsqueeze(-2), min=_EPS)
    corr = cov / denom

    info = std * (1.0 - corr).sum(dim=-1)                 # C_j
    weights = info / torch.clamp(info.sum(dim=-1, keepdim=True), min=_EPS)
    return (xn * weights.unsqueeze(-2)).sum(dim=-1)
