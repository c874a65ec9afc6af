"""Dropout's keep mask: the CUDA kernel and its plain version.

flax's ``nn.Dropout(rate)`` keeps an element where
``jax.random.bernoulli(make_rng("dropout"), 1 - rate, x.shape)`` is
true, and ``make_rng`` is ``fold_in(key, fold)`` of the stream's key and
a uint32 the scope's path gives (``flax_rng.Scope.fold_data``;
``models/transformer.py`` ``dropout`` applies the mask), under the run's
PRNG impl (``prng``). The plain version is ``prng.bernoulli(
prng.fold_in(key, fold, impl), ...)``: under threefry the hash as ~160
elementwise torch ops, each a pass over the whole mask in device memory,
after a fold of as many launches on the 2-element key; under ``rbg`` /
``unsafe_rbg`` (4-word keys) XLA's CPU Philox4x32-10 stream as ~120
such ops. The kernel ``dropout_mask`` (``csrc/dropout_mask.cu``, CUDA C++
for ``sm_90a``, built at first use by ``build.py``) folds and draws in one
pass with every round in registers: threefry's hash for a 2-word key, or
its Philox path for a 4-word key (the fold under ``rbg`` is threefry on
each half; under ``unsafe_rbg`` an xor with 4 words that depend on
``fold`` alone, computed here on the host). It replaces no Pallas kernel
(JAX draws the mask with XLA ops); it exists because the plain draw took
most of a dropout trainer step on the card (PERF.md).

``keep_mask`` launches the kernel on a CUDA key and runs the plain
version on a CPU key; a build or launch failure raises. The key is read
from device memory, so the launch captures into a CUDA graph and a replay
draws from whatever key the graph's static input holds.

``rows`` (a data-parallel rank's rows of a mask over the global batch,
``flax_rng.Rows``) is a 1-D int64 tensor of row numbers of ``shape``'s
first axis: the mask is those rows of the whole draw, bit for bit. The
kernel reads the map from device memory too (so the launch still
captures); without it the draw and the kernel are the ones before the
map existed.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

import torch

from .. import prng

#: launches since the last ``reset_launches()``; ``keep_mask`` adds one
#: exactly where it launches the kernel (``dropout_mask_philox``: its
#: Philox path, for 4-word keys)
LAUNCHES = {"dropout_mask": 0, "dropout_mask_philox": 0}
_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str = "dropout_mask", n: int = 1) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += n


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def keep_mask_reference(key: torch.Tensor, fold: int, keep: float,
                        shape: Sequence[int],
                        rows: Optional[torch.Tensor] = None,
                        impl: Optional[str] = None) -> torch.Tensor:
    """The plain version: ``jax.random.bernoulli(fold_in(key, fold), keep,
    shape)`` under ``impl`` (None: threefry), or its ``rows`` alone."""
    return prng.bernoulli(prng.fold_in(key, fold, impl), keep, tuple(shape),
                          rows=rows)


def keep_mask(key: torch.Tensor, fold: int, keep: float,
              shape: Sequence[int], rows: Optional[torch.Tensor] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """``bernoulli(fold_in(key, fold), keep, shape)`` for one ``(2,)`` or
    ``(4,)`` key (``impl``: the run's ``prng_impl``, which a 4-word key
    requires; None: threefry) and a uint32 ``fold`` → bool ``shape`` on the key's device;
    with ``rows`` (1-D int64 on that device), the ``(len(rows),) +
    shape[1:]`` rows of it (the module docstring)."""
    if key.device.type != "cuda":
        return keep_mask_reference(key, fold, keep, shape, rows, impl)
    if key.dim() != 1 or key.dtype != torch.int64:
        raise ValueError(f"keep_mask: the key must be an int64 (2,) or "
                         f"(4,) tensor (or a member's (5,)), got "
                         f"{key.dtype} {tuple(key.shape)}")
    impl = prng.impl_of(key, impl)
    shape = tuple(shape)
    if key.shape[0] == 5:
        # a population member's key (prng.seat): its rows of member 0's
        # draw over the members, through the row map
        own = (torch.arange(shape[0], device=key.device) if rows is None
               else rows)
        rows = key[4] * shape[0] + own
        key = key[:4]
    if key.device.index != torch.cuda.current_device():
        raise ValueError(f"keep_mask: the key is on {key.device} but the "
                         f"current CUDA device is "
                         f"{torch.cuda.current_device()}")
    if math.prod(shape) >= 2 ** 32:
        raise ValueError(f"keep_mask: a draw of {shape} has 2**32 or more "
                         f"elements (the counters are 32 bits)")
    row_elems = math.prod(shape[1:])
    if rows is not None:
        if (rows.dim() != 1 or rows.dtype != torch.int64
                or rows.device != key.device):
            raise ValueError(f"keep_mask: rows must be a 1-D int64 tensor "
                             f"on {key.device}, got {rows.dtype} "
                             f"{tuple(rows.shape)} on {rows.device}")
        rows = rows.contiguous()
        shape = (rows.shape[0],) + shape[1:]
    from .build import load
    out = torch.empty(shape, dtype=torch.bool, device=key.device)
    stream = torch.cuda.current_stream(key.device).cuda_stream
    if impl == "threefry":
        load().dropout_mask(key.contiguous(), int(fold), float(keep),
                            stream, out, rows, row_elems)
        count_launch()
        return out
    # rbg folds with threefry on each half; unsafe_rbg xors the key with
    # words of `fold` alone
    xor = (list(prng.unsafe_fold_mask(fold)) if impl == "unsafe_rbg"
           else [])
    load().dropout_mask_philox(key.contiguous(), int(fold), xor,
                               float(keep), stream, out, rows, row_elems)
    count_launch("dropout_mask_philox")
    return out
