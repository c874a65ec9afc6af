"""The keys flax's ``make_rng`` gives a module, derived on torch tensors.

The JAX package draws dropout masks and the dense NoisyNet head's noise
through flax's named RNG streams: ``module.apply(..., rngs={"dropout":
k})`` hands the root scope a key, every child scope appends its name to
the key's static suffix, and ``make_rng(name)`` appends the scope's call
counter (1 for a module's first call) and folds the suffix into the key
(flax 0.12's ``LazyRng`` and ``_fold_in_static``), under the run's
PRNG impl (``prng``: ``unsafe_rbg``'s ``fold_in`` is its own, the scope
carries the impl):

* the SHA-1 of the suffix, strings as their UTF-8 bytes and ints as
  their big-endian bytes (``int.to_bytes((bit_length + 7) // 8)``),
  with no separator byte (``flax_fix_rng_separator`` is False by
  default);
* the digest's first 4 bytes, big-endian, folded in with
  ``jax.random.fold_in``.

Compact modules take automatic names (``Dropout_0``, ``Dropout_1`` in
each ``block_<i>``); the rest are explicit (``transformer``,
``block_<i>``, ``q_basic``). The suffix is static, so the derived key is
one ``fold_in`` of the root key, whatever the depth of the path.

Under data parallelism a rank computes some rows of a batch whose
dropout masks are drawn over the global batch: a scope then carries the
rank's ``Rows`` (each local batch row's global row), and a mask draws
those rows of the global draw (``models/transformer.py`` ``dropout``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple, Union

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


@dataclasses.dataclass(frozen=True, eq=False)
class Rows:
    """A data-parallel rank's rows of the global batch: ``index`` (a 1-D
    int64 tensor on the device) holds the global row of each of the
    rank's rows, ``total`` is the global batch."""

    index: torch.Tensor
    total: int

    def of(self, n: int) -> Tuple[torch.Tensor, int]:
        """The map for a leading axis of ``n`` rows that holds each batch
        row's ``n / len(index)`` rows together (the agent's ``(B·A)``
        rows): → (each local row's global row, the global row count)."""
        b = self.index.shape[0]
        per = n // b
        if per * b != n:
            raise ValueError(f"{n} rows do not hold {b} batch rows evenly")
        if per == 1:
            return self.index, self.total
        idx = self.index[:, None] * per + torch.arange(
            per, dtype=torch.int64, device=self.index.device)
        return idx.reshape(-1), self.total * per


@dataclasses.dataclass(frozen=True)
class Scope:
    """One named stream seen from a module: the root key handed to
    ``apply`` and the path of scope names below it; ``rows``: a
    data-parallel rank's rows of the batch (the module docstring);
    ``impl``: the run's ``prng_impl`` (None: threefry)."""

    key: torch.Tensor
    path: Tuple[str, ...] = ()
    rows: Optional[Rows] = None
    impl: Optional[str] = None

    def child(self, name: str) -> "Scope":
        return dataclasses.replace(self, path=self.path + (name,))

    def make_rng(self, count: int = 1) -> torch.Tensor:
        """The key of the scope's ``count``-th ``make_rng`` call."""
        return prng.fold_in(self.key, self.fold_data(count), self.impl)

    def fold_data(self, count: int = 1) -> int:
        """The uint32 that ``make_rng(count)`` folds into ``key`` (the
        dropout-mask kernel folds it on the card)."""
        return suffix_hash(self.path + (count,))
