"""Carry weights from flax param trees (agent, mixer, the learner's pair)
to the port's state dicts, and the JAX package's carried states (keys,
env and runner states, replay buffers) to the port's dataclasses; a JAX
population's ``(P,)``-stacked learner and runner states split into the
port's P member states (``member_states_from_jax``).

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
``out_gate`` (a top-level ``(1,)`` leaf) keeps its name. The other
families convert the same way: the GRU agent's ``fc1``, ``rnn.{ir, iz,
in, hr, hz, hn}`` and ``q_basic``; the feed-forward QMIX mixer's
``state_norm``, ``hyper_{w1,b1,w2,b2}`` and their ``*_h`` layers; VDN
has no leaves.
"""

from __future__ import annotations

import dataclasses
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


def tensor_from_jax(x, device: DeviceLike = None) -> torch.Tensor:
    """One JAX array (or its numpy copy) → tensor: uint32 (PRNG keys)
    becomes int64 holding the same values, bfloat16 stays bfloat16."""
    arr = np.asarray(x)
    dev = resolve_device(device)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.astype(np.int64)).to(dev)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def state_from_jax(cls, obj, device: DeviceLike = None):
    """A JAX ``struct.dataclass`` state (``EnvState``, ``EnvParams``,
    ``RunnerState``, ``BufferState``, ...) → the port dataclass ``cls``
    with the same field names. Nested states convert recursively; the
    runner's ``t_env`` (a host mirror in the port) becomes a Python int,
    the ring cursor and fill stay 0-d int32 tensors as in JAX; static
    fields (a ``gamma``) pass through."""
    from .components.episode_buffer import CompactEntityObs, EpisodeBatch
    from .envs.mec_offload import EnvParams, EnvState
    from .envs.normalization import NormState, RewardScaleState
    nested = {"norm": NormState, "env_states": EnvState,
              "rscale": RewardScaleState, "env_params": EnvParams,
              "storage": EpisodeBatch}
    host_ints = ("t_env",)
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if f.name in nested:
            kw[f.name] = state_from_jax(nested[f.name], v, dev)
        elif hasattr(v, "mec_index") and hasattr(v, "rows"):
            kw[f.name] = state_from_jax(CompactEntityObs, v, dev)
        elif f.name in host_ints:
            kw[f.name] = int(np.asarray(v))
        elif isinstance(v, (int, float)):
            kw[f.name] = v
        else:
            kw[f.name] = tensor_from_jax(v, dev)
    return cls(**kw)


def learner_state_from_jax(ls, device: DeviceLike = None):
    """The JAX learner's ``LearnerState`` (params, target params, optax
    state of ``clip_by_global_norm`` → adam or rmsprop, counters) → the
    port's, so a port train step can start from a JAX one."""
    from .learners.qmix_learner import LearnerState
    dev = resolve_device(device)
    tree = lambda t: learner_params_from_flax(t, dev)
    stats = [s for s in _walk(ls.opt_state) if hasattr(s, "nu")]
    if len(stats) != 1:
        raise ValueError("expected one optax adam or rmsprop state")
    (st,) = stats
    opt = {"nu": tree(st.nu)}
    if hasattr(st, "mu"):
        opt.update(count=tensor_from_jax(st.count, dev), mu=tree(st.mu))
    return LearnerState(
        params=tree(ls.params), target_params=tree(ls.target_params),
        opt_state=opt, train_steps=tensor_from_jax(ls.train_steps, dev),
        last_target_update=tensor_from_jax(ls.last_target_update, dev))


def unstack_member(tree, m: int):
    """Member ``m`` of a ``(P,)``-stacked JAX tree (a population's state:
    dataclasses, named tuples, tuples, lists, dicts of arrays): every array
    leaf indexed at ``m``, every other leaf (a static ``gamma``) as it
    is."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: unstack_member(getattr(tree, f.name), m)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(unstack_member(x, m) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(unstack_member(x, m) for x in tree)
    if isinstance(tree, dict):
        return {k: unstack_member(v, m) for k, v in tree.items()}
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return np.asarray(tree)[m]
    return tree


def member_states_from_jax(learner, runner, device: DeviceLike = None):
    """A JAX population's ``(P,)``-stacked ``LearnerState`` and
    ``RunnerState`` → the port's P ``(LearnerState, RunnerState)`` pairs,
    member by member (``population.init_population`` builds the port's
    members one at a time; this starts them from JAX's)."""
    from .runners.parallel_runner import RunnerState
    p = int(np.asarray(learner.train_steps).shape[0])
    return [(learner_state_from_jax(unstack_member(learner, m), device),
             state_from_jax(RunnerState, unstack_member(runner, m), device))
            for m in range(p)]


def _walk(node):
    """The optax state objects nested in tuples (chain states)."""
    if isinstance(node, tuple) and not hasattr(node, "_fields"):
        for child in node:
            yield from _walk(child)
    else:
        yield node
