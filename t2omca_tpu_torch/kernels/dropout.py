"""Dropout's keep mask: the CUDA kernel and its plain version.

flax's ``nn.Dropout(rate)`` keeps an element where
``jax.random.bernoulli(make_rng("dropout"), 1 - rate, x.shape)`` is
true, and ``make_rng`` is ``fold_in(key, fold)`` of the stream's key and
a uint32 the scope's path gives (``flax_rng.Scope.fold_data``;
``models/transformer.py`` ``dropout`` applies the mask). The plain
version is ``prng.bernoulli(prng.fold_in(key, fold), ...)``: the
threefry hash as ~160 elementwise torch ops, each a pass over the whole
mask in device memory, after a fold of as many launches on the 2-element
key. The kernel ``dropout_mask`` (``csrc/dropout_mask.cu``, CUDA C++ for
``sm_90a``, built at first use by ``build.py``) folds and draws in one
pass with every round in registers. It replaces no Pallas kernel (JAX draws
the mask with XLA ops); it exists because the plain draw took most of a
dropout trainer step on the card (PERF.md).

``keep_mask`` launches the kernel on a CUDA key and runs the plain
version on a CPU key; a build or launch failure raises. The key is read
from device memory, so the launch captures into a CUDA graph and a replay
draws from whatever key the graph's static input holds.
"""

from __future__ import annotations

import threading
from typing import Sequence

import torch

from .. import prng

#: launches since the last ``reset_launches()``; ``keep_mask`` adds one
#: exactly where it launches the kernel
LAUNCHES = {"dropout_mask": 0}
_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str = "dropout_mask", n: int = 1) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += n


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES["dropout_mask"] = 0


def keep_mask_reference(key: torch.Tensor, fold: int, keep: float,
                        shape: Sequence[int]) -> torch.Tensor:
    """The plain version: ``jax.random.bernoulli(fold_in(key, fold), keep,
    shape)``."""
    return prng.bernoulli(prng.fold_in(key, fold), keep, tuple(shape))


def keep_mask(key: torch.Tensor, fold: int, keep: float,
              shape: Sequence[int]) -> torch.Tensor:
    """``bernoulli(fold_in(key, fold), keep, shape)`` for one ``(2,)``
    key and a uint32 ``fold`` → bool ``shape`` on the key's device."""
    if key.device.type != "cuda":
        return keep_mask_reference(key, fold, keep, shape)
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"keep_mask: the key must be an int64 (2,) "
                         f"tensor, got {key.dtype} {tuple(key.shape)}")
    if key.device.index != torch.cuda.current_device():
        raise ValueError(f"keep_mask: the key is on {key.device} but the "
                         f"current CUDA device is "
                         f"{torch.cuda.current_device()}")
    from .build import load
    out = torch.empty(tuple(shape), dtype=torch.bool, device=key.device)
    stream = torch.cuda.current_stream(key.device).cuda_stream
    load().dropout_mask(key.contiguous(), int(fold), float(keep), stream,
                        out)
    count_launch()
    return out
