"""The keys flax's ``make_rng`` gives a module, derived on torch tensors.

The JAX package draws dropout masks and the dense NoisyNet head's noise
through flax's named RNG streams: ``module.apply(..., rngs={"dropout":
k})`` hands the root scope a key, every child scope appends its name to
the key's static suffix, and ``make_rng(name)`` appends the scope's call
counter (1 for a module's first call) and folds the suffix into the key
(flax 0.12's ``LazyRng`` and ``_fold_in_static``):

* the SHA-1 of the suffix, strings as their UTF-8 bytes and ints as
  their big-endian bytes (``int.to_bytes((bit_length + 7) // 8)``),
  with no separator byte (``flax_fix_rng_separator`` is False by
  default);
* the digest's first 4 bytes, big-endian, folded in with
  ``jax.random.fold_in``.

Compact modules take automatic names (``Dropout_0``, ``Dropout_1`` in
each ``block_<i>``); the rest are explicit (``transformer``,
``block_<i>``, ``q_basic``). The suffix is static, so the derived key is
one threefry hash of the root key, whatever the depth of the path.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple, Union

import torch

from . import prng

Foldable = Union[str, int]


def suffix_hash(data: Tuple[Foldable, ...]) -> int:
    """The uint32 flax folds in for the static ``data``."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return int.from_bytes(m.digest()[:4], "big")


@dataclasses.dataclass(frozen=True)
class Scope:
    """One named stream seen from a module: the root key handed to
    ``apply`` and the path of scope names below it."""

    key: torch.Tensor
    path: Tuple[str, ...] = ()

    def child(self, name: str) -> "Scope":
        return Scope(self.key, self.path + (name,))

    def make_rng(self, count: int = 1) -> torch.Tensor:
        """The key of the scope's ``count``-th ``make_rng`` call."""
        return prng.fold_in(self.key, self.fold_data(count))

    def fold_data(self, count: int = 1) -> int:
        """The uint32 that ``make_rng(count)`` folds into ``key`` (the
        dropout-mask kernel folds it on the card)."""
        return suffix_hash(self.path + (count,))
