"""JAX's random API, bit for bit, in plain torch ops, for the three
``prng_impl`` values the config takes.

The JAX package draws every random number on its training path from
``jax.random`` under the impl its ``run.py`` pins for the process:
``threefry2x32`` (the default, with ``jax_threefry_partitionable=True``),
``rbg`` or ``unsafe_rbg``. This module reproduces that API on torch
tensors so that a rollout of the port can be held against the JAX
package draw for draw. The port carries no process-wide impl: a key's
width says threefry (2 words) or an RngBitGenerator impl (4 words), and
``split``/``fold_in``/``randint`` take ``impl``, which a 4-word key
requires (``None`` only for threefry: the width cannot tell ``rbg``
from ``unsafe_rbg``).

threefry2x32:

* ``PRNGKey(seed)`` is ``threefry_seed``: the key ``(seed >> 32, seed &
  0xFFFFFFFF)``;
* ``split(key, n)`` is the partitionable ("fold-like") split: subkey
  ``i`` is the threefry hash of the counter pair ``(0, i)``, so
  ``split(key, n)[i] == fold_in(key, i)``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)``;
* ``random_bits(key, shape)`` (32-bit) is ``bits1 ^ bits2`` of the hash
  of ``(hi, lo)`` of a 64-bit iota over ``shape`` (``hi`` is 0 below
  2**32 elements).

rbg and unsafe_rbg (keys of 4 words ``(k0, k1, k2, k3)``):

* ``PRNGKey(seed)`` is ``_rbg_seed``: the threefry key twice;
* ``random_bits`` is XLA's ``rng_bit_generator`` as its CPU backend
  computes it: Philox4x32-10 under the Philox key ``(k0, k1)``, on the
  128-bit little-endian counter of words ``(k2, k3, k0, k1)``, one block
  of 4 outputs a counter, the counter advancing by one a block (a 128-bit
  add), the outputs in row-major order. The TPU's hardware stream is
  another one: the port matches JAX on the CPU;
* under ``rbg``, ``split`` and ``fold_in`` are threefry's on each half
  ``(k0, k1)``, ``(k2, k3)``;
* under ``unsafe_rbg``, ``split(n)`` is every 10th row of a draw of
  ``(10·n, 4)`` and ``fold_in(d)`` is ``key ^`` the last row of a draw of
  ``(10, 4)`` from ``_rbg_seed(d)``.

Leading key dimensions: under threefry each key draws its own numbers,
so a draw of ``shape`` from keys ``(B, 2)`` returns ``(B, *shape)``, what
``jax.vmap`` of the draw over ``B`` keys gives. JAX batches
``rng_bit_generator`` otherwise: under ``vmap`` it draws ``(B, *shape)``
from the **first** key alone (``_rng_bit_generator_batching_rule``), and
nested maps count row-major over all of them. The port follows that rule
for 4-word keys: the leading dimensions are ``jax.vmap``'d, except the
first ``scan`` of them, which are independent draws (a ``lax.scan`` or a
loop over keys in JAX: a rollout's steps, drawn ahead here).

``uniform``, ``bernoulli``, ``randint`` (the two-draw modular form),
``gumbel``, ``normal`` and ``choice`` are the float32 / int32 samplers
of ``jax/_src/random.py``, built on the impl's bits.

Each element's bits depend on its own counter alone, so ``rows`` (an
index of the first axis of the mapped draw ``(*vmapped dims, *shape)``:
a slice, or a 1-D int64 tensor of row numbers on the key's device) draws
just those rows of a draw: the same numbers as the whole draw indexed
afterwards, without computing the rest (under Philox, element ``e`` is
word ``e % 4`` of block ``e // 4``). A data-parallel rank draws its env
lanes' rows of a draw over the batch axis this way, and its rows of a
dropout mask.

Keys are ``(..., 2)`` or ``(..., 4)`` int64 tensors whose entries hold
uint32 values (torch's ``uint32`` supports few operations); threefry's
rounds run on int32 tensors with the same bits (``threefry2x32``),
Philox's on int64, whose 32×32→64-bit products wrap modulo 2**64 as
torch's CPU and CUDA kernels compute them (the high word is taken
masked).

Floating point: ``uniform(minval, maxval)`` computes ``floats * (maxval
- minval) + minval`` as one fused multiply-add, because XLA's CPU
backend contracts it into an FMA; here the product and sum run in
float64, exact for the spans used on the path, then round once to
float32. ``gumbel`` and ``normal`` go through ``log`` / ``erfinv``,
whose float32 results may differ from XLA's in the last bits.

Both generators are XLA code in JAX (not Pallas kernels), so they stay
plain torch ops here: about 160 elementwise launches per threefry hash
and about 120 per Philox draw on a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .xla_float import f32, fma

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: Philox4x32-10's multipliers and Weyl constants
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
#: the config's ``prng_impl`` values and their key widths
IMPLS = {"threefry": 2, "rbg": 4, "unsafe_rbg": 4}
#: float32 facts used by the samplers (``jnp.finfo(float32)``)
_NMANT = 23
_TINY = float(np.finfo(np.float32).tiny)
_ONE_BITS = 0x3F800000                     # float32 1.0

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def impl_of(key: torch.Tensor, impl: Optional[str]) -> str:
    """The impl of ``key``: ``impl`` checked against the key's width;
    ``None`` only for a 2-word (threefry) key, because the width cannot
    tell ``rbg`` from ``unsafe_rbg``. A member's key (``seat``) has an
    rbg impl's width and one word more."""
    width = key.shape[-1]
    if impl is None:
        if width != 2:
            raise ValueError(f"a {width}-word key needs its impl named "
                             f"(rbg or unsafe_rbg)")
        impl = "threefry"
    elif IMPLS.get(impl) != width and not (IMPLS.get(impl) == 4
                                           and width == 5):
        raise ValueError(f"a {impl} key has {IMPLS.get(impl)} words, "
                         f"got one of {width}")
    return impl


def seat(key: torch.Tensor, member) -> torch.Tensor:
    """Member ``member``'s key for its draws under a population's
    ``jax.vmap`` (an RngBitGenerator impl): ``key`` is member 0's 4-word
    key and the fifth word the member's index. JAX's batching rule draws
    every member's numbers from member 0's key, member m taking rows m of
    the ``(P, ...)`` draw; so ``split`` and ``fold_in`` of a member's key
    follow member 0's chain and keep the index, and a draw from it is the
    member's rows of member 0's draw."""
    m = torch.as_tensor(member, dtype=torch.int64, device=key.device)
    return torch.cat([key[..., :4], m.expand(key.shape[:-1] + (1,))],
                     dim=-1)


def _seated(key: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` (keys derived from ``key``'s first 4 words) with ``key``'s
    member word appended."""
    m = key[..., 4:]
    m = m.reshape(m.shape[:-1] + (1,) * (out.dim() - key.dim()) + (1,))
    return torch.cat([out, m.expand(out.shape[:-1] + (1,))], dim=-1)


def _seed_words(seed: int) -> Tuple[int, int]:
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} is outside int32")
    return 0, seed & MASK


def PRNGKey(seed: int, device: DeviceLike = None,
            impl: str = "threefry") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` under ``impl`` → a ``(2,)`` or
    ``(4,)`` key on ``device`` (``cuda`` unless named otherwise). Seeds are
    int32, as JAX takes them without 64-bit mode."""
    if impl not in IMPLS:
        raise ValueError(f"prng_impl must be one of {tuple(IMPLS)}, "
                         f"got {impl!r}")
    words = _seed_words(seed) * (IMPLS[impl] // 2)
    return torch.tensor(words, dtype=torch.int64,
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


def philox4x32(key: Sequence, ctr: Sequence) -> List[torch.Tensor]:
    """Philox4x32-10 of the counter words ``ctr`` (4, low word first)
    under the key ``(k0, k1)``: int64 tensors (or Python ints) holding
    uint32 values, broadcast against each other → the 4 output words as
    int64 uint32 values. The 32×32-bit products run in int64 and wrap
    modulo 2**64; their high word is the arithmetic shift masked to 32
    bits."""
    k0, k1 = key
    c0, c1, c2, c3 = ctr
    for _ in range(10):
        p0 = c0 * _PHILOX_M[0]
        p1 = c2 * _PHILOX_M[1]
        c0, c1, c2, c3 = ((p1 >> 32) & MASK ^ c1 ^ k0, p1 & MASK,
                          (p0 >> 32) & MASK ^ c3 ^ k1, p0 & MASK)
        k0 = (k0 + _PHILOX_W[0]) & MASK
        k1 = (k1 + _PHILOX_W[1]) & MASK
    return [c0, c1, c2, c3]


def _philox_blocks(key: torch.Tensor, blocks: torch.Tensor
                   ) -> List[torch.Tensor]:
    """The 4 words of Philox blocks ``blocks`` (int64 block numbers whose
    leading dimensions are the keys', ``(*key lead, ...)``) of
    ``rng_bit_generator``'s stream under each key of ``key (..., 4)``: block ``i`` hashes the
    key's counter plus ``i`` (a 128-bit add, the carry into the high
    words)."""
    k = [key[..., j] for j in range(4)]
    view = k[0].shape + (1,) * (blocks.dim() - k[0].dim())
    k = [w.reshape(view) for w in k]
    s = k[2] + (blocks & MASK)
    c0 = s & MASK
    s = k[3] + (blocks >> 32) + (s >> 32)
    c1 = s & MASK
    s = k[0] + (s >> 32)
    c2 = s & MASK
    c3 = (k[1] + (s >> 32)) & MASK
    return philox4x32((k[0], k[1]), (c0, c1, c2, c3))


def _philox_bits(key: torch.Tensor, shape: Tuple[int, ...], rows,
                 scan: int) -> torch.Tensor:
    """``rng_bit_generator``'s 32-bit draw of ``shape`` under the vmap
    rule (the module docstring): keys ``(*S, *V, 4)`` with ``S`` the first
    ``scan`` dimensions → ``(*S, *V, *shape)``, each of the ``S`` draws
    from the first key of its ``V`` block, counted row-major over ``(*V,
    *shape)``; ``rows`` indexes that mapped shape's first axis. A member's
    key (``seat``: a fifth word m) draws elements ``m·N`` on of its
    ``N``-element draw, its rows of the members' draw."""
    lead = tuple(key.shape[:-1])
    if scan > len(lead):
        raise ValueError(f"scan={scan} of a key with {len(lead)} leading "
                         f"dimensions")
    mapped = lead[scan:] + shape
    k = key[(slice(None),) * scan + (0,) * (len(lead) - scan)]
    s = k.shape[:-1]
    n = math.prod(mapped)
    if n >= 2 ** 32:
        raise NotImplementedError("draws of 2**32 or more elements")
    offset = k[..., 4] * n if k.shape[-1] == 5 else None    # (*S,)
    if rows is None and (offset is None or n % 4 == 0):
        nb = -(-n // 4)
        blocks = torch.arange(nb, dtype=torch.int64, device=key.device)
        blocks = (blocks.expand(s + (nb,)) if offset is None
                  else blocks + (offset // 4)[..., None])
        w = _philox_blocks(k, blocks)
        flat = torch.stack(w, dim=-1).reshape(s + (4 * nb,))
        return flat[..., :n].reshape(s + mapped)
    if rows is None:
        rows = slice(None)
    if not mapped:
        mapped, inner = (1,), ()
    else:
        inner = mapped[1:]
    if isinstance(rows, torch.Tensor):
        r = rows.to(torch.int64)
    else:
        r = torch.arange(mapped[0], dtype=torch.int64,
                         device=key.device)[rows]
    e = (r.reshape((-1,) + (1,) * len(inner)) * math.prod(inner)
         + _iota(inner, key.device))
    e = e.expand(s + e.shape)
    if offset is not None:
        e = e + offset.reshape(s + (1,) * (e.dim() - len(s)))
    w = _philox_blocks(k, e >> 2)
    word = e & 3
    out = torch.where(word == 0, w[0], w[1])
    out = torch.where(word == 2, w[2], out)
    out = torch.where(word == 3, w[3], out)
    return out if shape or lead[scan:] else out.reshape(s)


def _philox_rows(key: torch.Tensor, n: int, scan: int = 0
                 ) -> torch.Tensor:
    """A draw of ``(n, 4)`` under the vmap rule → ``(..., n, 4)``."""
    return _philox_bits(key, (n, 4), None, scan)


def _rbg_seed_words(data: int) -> Tuple[int, int, int, int]:
    return (0, int(data) & MASK) * 2


def unsafe_fold_mask(data: int) -> Tuple[int, ...]:
    """The 4 words ``unsafe_rbg``'s ``fold_in(key, data)`` xors into the
    key: the last row of a ``(10, 4)`` draw from ``_rbg_seed(data)``,
    computed on the host."""
    k = _rbg_seed_words(data)
    # block 9's counter: k2 is 0, so adding 9 carries nothing
    out = philox4x32((k[0], k[1]), (k[2] + 9, k[3], k[0], k[1]))
    return tuple(int(w) for w in out)


def split(key: torch.Tensor, num: int = 2, impl: Optional[str] = None,
          scan: int = 0) -> torch.Tensor:
    """``jax.random.split`` → ``(..., num, width)``; unpack with
    ``.unbind(-2)``. ``scan``: under ``unsafe_rbg``, the leading key
    dimensions that are not ``vmap``'d (the module docstring)."""
    impl = impl_of(key, impl)
    if key.shape[-1] == 5:
        # a member's key: member 0's chain, the index kept
        return _seated(key, split(key[..., :4], num, impl, scan))
    if impl == "unsafe_rbg":
        return _philox_rows(key, 10 * num, scan)[..., ::10, :]
    if impl == "rbg":
        return torch.cat([split(key[..., :2], num),
                          split(key[..., 2:], num)], dim=-1)
    b1, b2 = _hash_counters(key, _iota((num,), key.device), (num,))
    return torch.stack([b1, b2], dim=-1)


def member_split(key: torch.Tensor, lead: torch.Tensor, num: int = 2,
                 impl: Optional[str] = None) -> torch.Tensor:
    """The ``num`` subkeys a population member's own ``key`` splits into
    under the members' ``jax.vmap`` (``lead``: the member's ``seat`` of
    member 0's key at the same point): under ``rbg`` its own threefry
    split; under ``unsafe_rbg`` a split is a draw, its rows of member 0's
    ``(10·num, 4)`` draw, every 10th."""
    impl = impl_of(lead, impl)
    if impl == "unsafe_rbg":
        return random_bits(lead, (10 * num, 4))[..., ::10, :]
    return split(key, num, impl)


def fold_in(key: torch.Tensor, data: int, impl: Optional[str] = None
            ) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a Python int ``data``."""
    impl = impl_of(key, impl)
    if key.shape[-1] == 5:
        return _seated(key, fold_in(key[..., :4], data, impl))
    if impl == "unsafe_rbg":
        m = unsafe_fold_mask(data)
        return torch.stack([key[..., j] ^ m[j] for j in range(4)], dim=-1)
    if impl == "rbg":
        return torch.cat([fold_in(key[..., :2], data),
                          fold_in(key[..., 2:], data)], dim=-1)
    b1, b2 = _hash_counters(key, int(data) & MASK, ())
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape, rows=None, scan: int = 0
                ) -> torch.Tensor:
    """32-bit ``random_bits``: ``(..., *shape)`` int64 in [0, 2**32);
    with ``rows``, only those rows (the module docstring); ``scan``: the
    leading key dimensions of a 4-word key that are not ``vmap``'d."""
    shape = _shape(shape)
    if key.shape[-1] in (4, 5):
        return _philox_bits(key, shape, rows, scan)
    impl_of(key, None)
    if rows is not None and key.dim() - 1 > scan:
        # rows of the first vmapped key axis: those keys' draws
        key = key[(slice(None),) * scan + (rows,)]
        rows = None
    if isinstance(rows, torch.Tensor):
        # row r's counters are r·inner + its element's: no whole iota
        if math.prod(shape) >= 2 ** 32:
            raise NotImplementedError("draws of 2**32 or more elements")
        inner = shape[1:]
        r = rows.to(torch.int64).reshape((-1,) + (1,) * len(inner))
        lo = r * math.prod(inner) + _iota(inner, key.device)
        shape = tuple(lo.shape)
    else:
        lo = _iota(shape, key.device) if shape else 0
        if rows is not None:
            lo = lo[rows]
            shape = tuple(lo.shape)
    b1, b2 = _hash_counters(key, lo, shape)
    return b1.bitwise_xor_(b2)


def _unit_floats(key: torch.Tensor, shape: Shape, rows=None,
                 scan: int = 0) -> torch.Tensor:
    """float32 in [0, 1): random mantissa bits under exponent 0, minus
    one (``_uniform``'s bit trick)."""
    bits = random_bits(key, shape, rows, scan)
    bits = (bits >> (32 - _NMANT)).bitwise_or_(_ONE_BITS)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0, rows=None, scan: int = 0
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over [minval, maxval) (Python
    floats, taken as float32); ``rows``, ``scan``: see the module
    docstring."""
    floats = _unit_floats(key, shape, rows, scan)
    lo = f32(minval)
    span = f32(np.float32(maxval) - np.float32(minval))
    if (lo, span) != (0.0, 1.0):
        floats = fma(floats, span, lo)
    return torch.clamp(floats, min=lo)


def bernoulli(key: torch.Tensor, p, shape: Shape, rows=None,
              scan: int = 0) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` for a
    float32 ``p`` (tensor broadcastable to the result, or a float);
    ``rows``, ``scan``: see the module docstring."""
    return uniform(key, shape, rows=rows, scan=scan) < p


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            impl: Optional[str] = None, rows=None, scan: int = 0
            ) -> torch.Tensor:
    """``jax.random.randint`` to int32 for int32 bounds: two 32-bit draws
    combined modulo the span (``_randint``); ``impl`` as ``split``'s,
    ``rows`` and ``scan`` as ``random_bits``'."""
    k1, k2 = split(key, impl=impl, scan=scan).unbind(-2)
    hi_bits = random_bits(k1, shape, rows, scan)
    lo_bits = random_bits(k2, shape, rows, scan)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span           # uint32 product
    off = ((hi_bits % span) * mult & MASK) + lo_bits % span
    off = (off & MASK) % span
    return (off + minval).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Shape, rows=None, scan: int = 0
           ) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` for ``u``
    uniform in [tiny, 1)."""
    u = uniform(key, shape, _TINY, 1.0, rows, scan)
    return -torch.log(-torch.log(u))


def normal(key: torch.Tensor, shape: Shape, scan: int = 0
           ) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) · erfinv(u)`` for ``u`` uniform
    in (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, scan=scan)
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


def choice(key: torch.Tensor, n: int, p, rows=None) -> torch.Tensor:
    """``jax.random.choice(key, n, shape=(), replace=True, p=p)`` for keys
    ``(..., width)`` → int32 indices ``(...)``. ``p`` is a host vector of
    ``n`` probabilities, taken as float32: ``cum = cumsum(p)``, ``r =
    cum[-1] · (1 − u)`` for ``u`` uniform in [0, 1), and the index is the
    left-side ``searchsorted(cum, r)``, the count of prefix sums below
    ``r``. The prefix sums stay on the host, so the draw makes no host
    sync and allocates nothing that depends on the data. ``rows``: as
    ``random_bits``'."""
    cum = cumsum_f32(p)
    if len(cum) != n:
        raise ValueError(f"p must have {n} entries, got {len(cum)}")
    r = (1.0 - uniform(key, (), rows=rows)) * cum[-1]
    return sum((r > c).to(torch.int32) for c in cum)
