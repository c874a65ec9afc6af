"""Carry weights from flax param trees (agent, mixer, the learner's pair)
to the port's state dicts.

Input: the JAX package's agent variables as nested dicts of numpy arrays
(``{"params": {"feat_embedding": {"kernel", "bias"}, "transformer":
{"block_i": {"attention": {"toqueries", "tokeys", "tovalues",
"unifyheads"}, "norm1", "norm2", "ff1", "ff2"}}, "q_basic": ...}}``),
e.g. ``jax.tree.map(np.asarray, variables)``. Output: ``{dotted torch
name: tensor}`` for ``TransformerAgent`` (or any of its submodules,
whose flax subtree converts the same way).

Leaf mapping: flax ``Dense.kernel`` is ``(in, out)`` and becomes the
``(out, in)`` ``weight``; LayerNorm ``scale`` becomes ``weight``; the
noisy head's ``w_mu``/``w_sigma`` (``(in, out)``) and ``b_mu``/
``b_sigma`` become ``weight_mu``/``weight_sigma``/``bias_mu``/
``bias_sigma``; ``bias`` stays ``bias``. The mixer's zero-init gate
``out_gate`` (a top-level ``(1,)`` leaf) keeps its name.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device

#: flax leaf name → (torch leaf name, transpose?)
_LEAVES = {
    "kernel": ("weight", True),
    "scale": ("weight", False),
    "bias": ("bias", False),
    "w_mu": ("weight_mu", True),
    "w_sigma": ("weight_sigma", True),
    "b_mu": ("bias_mu", False),
    "b_sigma": ("bias_sigma", False),
}


def agent_state_from_flax(variables: Mapping, device: DeviceLike = None,
                          dtype: torch.dtype = torch.float32
                          ) -> Dict[str, torch.Tensor]:
    """flax variables → torch state dict on ``device`` (``cuda`` unless
    named otherwise)."""
    return _state_from_flax(variables, resolve_device(device), dtype, ())


def mixer_state_from_flax(variables: Mapping, device: DeviceLike = None,
                          dtype: torch.dtype = torch.float32
                          ) -> Dict[str, torch.Tensor]:
    """flax ``TransformerMixer`` variables → ``TransformerMixer`` state
    dict on ``device`` (``cuda`` unless named otherwise)."""
    return _state_from_flax(variables, resolve_device(device), dtype,
                            ("out_gate",))


def learner_params_from_flax(params: Mapping, device: DeviceLike = None
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX learner's ``{"agent": ..., "mixer": ...}`` param pair →
    the port learner's pair of f32 state dicts."""
    device = resolve_device(device)
    return {"agent": agent_state_from_flax(params["agent"], device),
            "mixer": mixer_state_from_flax(params["mixer"], device)}


def _state_from_flax(variables: Mapping, device: torch.device,
                     dtype: torch.dtype, named_leaves: tuple
                     ) -> Dict[str, torch.Tensor]:
    tree = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{path}{key}.")
                continue
            if key in named_leaves and not path:
                name, transpose = key, False
            elif key in _LEAVES:
                name, transpose = _LEAVES[key]
            else:
                raise KeyError(f"unknown flax leaf {path}{key}")
            arr = np.asarray(val, dtype=np.float32)
            if transpose:
                arr = arr.T
            out[path + name] = torch.tensor(arr, dtype=dtype,
                                            device=device)

    walk(tree, "")
    return out
