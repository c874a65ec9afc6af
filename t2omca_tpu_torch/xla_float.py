"""float32 arithmetic in the form XLA's CPU backend gives the JAX
package's expressions, so that values which decide a discrete outcome
(a rounding, a comparison, an exploration coin) match it bit for bit.

What XLA does, as found against the live JAX package
(``tests/test_torch_env.py``):

* a division by a compile-time constant becomes a multiply by its
  float32 reciprocal (``recip``), and a chain of constant factors folds
  into one factor;
* ``a * b + c`` is contracted into one fused multiply-add (``fma``):
  computed here in float64, where the product of two float32 is exact,
  and rounded once;
* ``sqrt`` is correctly rounded; torch's float32 CPU ``sqrt`` is not on
  every build, so ``sqrt`` goes through float64, which rounds back
  exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def f32(x: float) -> float:
    """A Python float rounded to float32, as JAX takes a constant."""
    return float(np.float32(x))


def recip(c: float) -> float:
    """float32 ``1 / c``: XLA's form of a division by the constant ``c``."""
    return float(np.float32(1.0) / np.float32(c))


def fold(c: float, divisor: float, m: float) -> float:
    """XLA's single float32 factor for ``c * x / divisor * m``."""
    return f32(np.float32(np.float32(c) * np.float32(recip(divisor)))
               * np.float32(m))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once; ``b`` and ``c`` are tensors or
    Python floats (rounded to float32 first, as JAX takes constants)."""
    b = b.double() if isinstance(b, torch.Tensor) else f32(b)
    c = c.double() if isinstance(c, torch.Tensor) else f32(c)
    return (a.double() * b + c).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()
