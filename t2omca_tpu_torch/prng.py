"""JAX's threefry2x32 random API, bit for bit, in plain torch ops.

The JAX package draws every random number on its training path from
``jax.random`` with the ``threefry2x32`` implementation and
``jax_threefry_partitionable=True`` (the default on jax 0.9; the repo's
``run.py`` pins the impl). This module reproduces that API on torch
tensors so that a rollout of the port can be held against the JAX
package draw for draw:

* ``PRNGKey(seed)`` is ``threefry_seed``: the key ``(seed >> 32, seed &
  0xFFFFFFFF)``;
* ``split(key, n)`` is the partitionable ("fold-like") split: subkey
  ``i`` is the threefry hash of the counter pair ``(0, i)``, so
  ``split(key, n)[i] == fold_in(key, i)``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)``;
* ``random_bits(key, shape)`` (32-bit) is ``bits1 ^ bits2`` of the hash
  of ``(hi, lo)`` of a 64-bit iota over ``shape`` (``hi`` is 0 below
  2**32 elements);
* ``uniform``, ``bernoulli``, ``randint`` (the two-draw modular form),
  ``gumbel`` and ``normal`` are the float32 / int32 samplers of
  ``jax/_src/random.py`` built on those bits.

Keys are ``(..., 2)`` int64 tensors whose entries hold uint32 values
(torch's ``uint32`` supports few operations); the hash's rounds run on
int32 tensors with the same bits (``threefry2x32``). Leading key dimensions are batch lanes: a
draw of ``shape`` from keys ``(B, 2)`` returns ``(B, *shape)`` with the
same counters in every lane, which is what ``jax.vmap`` of the draw over
``B`` keys gives.

Floating point: ``uniform(minval, maxval)`` computes ``floats * (maxval
- minval) + minval`` as one fused multiply-add, because XLA's CPU
backend contracts it into an FMA; here the product and sum run in
float64, exact for the spans used on the path, then round once to
float32. ``gumbel`` and ``normal`` go through ``log`` / ``erfinv``,
whose float32 results may differ from XLA's in the last bits.

Threefry is XLA code in JAX (not a Pallas kernel), so it stays plain
torch ops here: about 160 elementwise launches per hash on a CUDA
tensor.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .xla_float import f32, fma

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: float32 facts used by the samplers (``jnp.finfo(float32)``)
_NMANT = 23
_TINY = float(np.finfo(np.float32).tiny)
_ONE_BITS = 0x3F800000                     # float32 1.0

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def PRNGKey(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` → ``(2,)`` key on ``device`` (``cuda``
    unless named otherwise). Seeds are int32, as JAX takes them without
    64-bit mode."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} is outside int32")
    return torch.tensor([0, seed & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _i32(x):
    """uint32 values (int64 tensor or Python int) as the int32 with the
    same bits."""
    if isinstance(x, torch.Tensor):
        return (x - ((x & 0x80000000) << 1)).to(torch.int32)
    x = int(x) & MASK
    return x - (1 << 32) if x & 0x80000000 else x


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1, x2
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1,
    x2)`` under the key ``(k1, k2)``: int64 tensors (or Python ints for
    the counters) holding uint32 values, broadcast against each other;
    the result as int64 uint32 values. Mirrors
    ``_threefry2x32_lowering``. The rounds run on int32 tensors holding
    the same bits: half the bytes of int64 a pass and no mask after each
    add. This requires torch's int32 ``add`` and left shift to wrap
    modulo 2**32 (two's complement, as torch's CPU and CUDA kernels do;
    ``tests/test_torch_prng.py`` and the card's CUDA = CPU check hold it
    bit for bit); a rotation's right shift is masked to its low bits,
    because int32 right shifts are arithmetic."""
    k1, k2 = _i32(k1), _i32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _i32(_PARITY))
    y0, y1 = torch.broadcast_tensors(ks[0] + _i32(x1), ks[1] + _i32(x2))
    y0, y1 = y0.clone(), y1.clone()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0.add_(y1)
            low = (y1 >> (32 - r)).bitwise_and_((1 << r) - 1)
            y1 = (y1 << r).bitwise_or_(low).bitwise_xor_(y0)
        y0.add_(ks[(i + 1) % 3])
        y1.add_(ks[(i + 2) % 3]).add_(i + 1)
    return y0.to(torch.int64) & MASK, y1.to(torch.int64) & MASK


def _hash_counters(key: torch.Tensor, lo, shape: Tuple[int, ...]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash of the counters ``(0, lo)`` (``lo`` of ``shape``, or a Python
    int for ``shape == ()``) under each key of ``key (..., 2)``: → two
    ``(..., *shape)`` tensors."""
    view = key.shape[:-1] + (1,) * len(shape)
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    return threefry2x32(k1, k2, 0, lo)


def _iota(shape: Tuple[int, ...], device) -> torch.Tensor:
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("draws of 2**32 or more elements")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` → ``(..., num, 2)``; unpack with
    ``.unbind(-2)``."""
    b1, b2 = _hash_counters(key, _iota((num,), key.device), (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a Python int ``data``."""
    b1, b2 = _hash_counters(key, int(data) & MASK, ())
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32-bit ``random_bits``: ``(..., *shape)`` int64 in [0, 2**32)."""
    shape = _shape(shape)
    lo = _iota(shape, key.device) if shape else 0
    b1, b2 = _hash_counters(key, lo, shape)
    return b1.bitwise_xor_(b2)


def _unit_floats(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 in [0, 1): random mantissa bits under exponent 0, minus
    one (``_uniform``'s bit trick)."""
    bits = random_bits(key, shape)
    bits = (bits >> (32 - _NMANT)).bitwise_or_(_ONE_BITS)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over [minval, maxval) (Python
    floats, taken as float32)."""
    floats = _unit_floats(key, shape)
    lo = f32(minval)
    span = f32(np.float32(maxval) - np.float32(minval))
    if (lo, span) != (0.0, 1.0):
        floats = fma(floats, span, lo)
    return torch.clamp(floats, min=lo)


def bernoulli(key: torch.Tensor, p, shape: Shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` for a
    float32 ``p`` (tensor broadcastable to the result, or a float)."""
    return uniform(key, shape) < p


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` to int32 for int32 bounds: two 32-bit draws
    combined modulo the span (``_randint``)."""
    k1, k2 = split(key).unbind(-2)
    hi_bits = random_bits(k1, shape)
    lo_bits = random_bits(k2, shape)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span           # uint32 product
    off = ((hi_bits % span) * mult & MASK) + lo_bits % span
    off = (off & MASK) % span
    return (off + minval).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` for ``u``
    uniform in [tiny, 1)."""
    u = uniform(key, shape, _TINY, 1.0)
    return -torch.log(-torch.log(u))


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) · erfinv(u)`` for ``u`` uniform
    in (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.erfinv(u) * f32(np.sqrt(2))


def cumsum_f32(p) -> Tuple[float, ...]:
    """``jnp.cumsum`` of a float32 vector as XLA computes it (a reduce
    window: each prefix summed left to right from zero, every add rounded
    to float32) → the prefix sums as Python floats."""
    acc, out = np.float32(0.0), []
    for x in np.asarray(p, np.float32).reshape(-1):
        acc = np.float32(acc + x)
        out.append(float(acc))
    return tuple(out)


def choice(key: torch.Tensor, n: int, p) -> torch.Tensor:
    """``jax.random.choice(key, n, shape=(), replace=True, p=p)`` for keys
    ``(..., 2)`` → int32 indices ``(...)``. ``p`` is a host vector of
    ``n`` probabilities, taken as float32: ``cum = cumsum(p)``, ``r =
    cum[-1] · (1 − u)`` for ``u`` uniform in [0, 1), and the index is the
    left-side ``searchsorted(cum, r)``, the count of prefix sums below
    ``r``. The prefix sums stay on the host, so the draw makes no host
    sync and allocates nothing that depends on the data."""
    cum = cumsum_f32(p)
    if len(cum) != n:
        raise ValueError(f"p must have {n} entries, got {len(cum)}")
    r = (1.0 - uniform(key, ())) * cum[-1]
    return sum((r > c).to(torch.int32) for c in cum)
