"""Batch transforms (port of ``t2omca_tpu/components/transforms.py``)."""

from __future__ import annotations

import torch


def one_hot(actions: torch.Tensor, n_actions: int) -> torch.Tensor:
    """Integer indices → one-hot float32 rows; an index outside ``[0,
    n_actions)`` gives a zero row, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(n_actions, device=actions.device)
    return (actions.unsqueeze(-1) == classes).float()
