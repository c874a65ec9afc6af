"""Transformer core (port of ``t2omca_tpu/models/transformer.py``).

The reference transformer with its three behavioural quirks, kept
exactly:

* **Q1 — full-emb heads.** K/Q/V project ``emb → emb*heads`` (every head
  has the full emb width) unless ``standard_heads`` picks ``emb//heads``;
  queries AND keys are each scaled by ``head_dim**-0.25``.
* **Q2 — post-LN residuals** adding the query input:
  ``x = norm1(attended + q); x = norm2(ff(x) + x)``.
* **Keys pinned to layer 0**: every block attends its evolving queries
  against the original key tokens.

Numerics follow flax: a layer with compute ``dtype`` casts its input and
weights to it (a bf16 product accumulates in f32 and rounds once);
LayerNorm takes f32 statistics with flax's eps of 1e-6 and returns the
compute dtype. Parameter names mirror the flax tree (``convert.py``
carries weights across).

Dropout (``dropout`` > 0) follows each sub-layer's LayerNorm, as flax's
``nn.Dropout`` in the JAX blocks: the forward takes the owning module's
``"dropout"`` stream (a ``flax_rng.Scope``; None is flax's
``deterministic=True``), and ``Dropout_0``/``Dropout_1`` of
``block_<i>`` each draw ``bernoulli(make_rng("dropout"), 1 - rate,
x.shape)`` and keep ``x / (1 - rate)`` (``dropout``; on the card the
mask is one launch of the ``dropout_mask`` kernel,
``kernels/dropout.py``). A data-parallel rank's scope carries its rows of
the global batch (``flax_rng.Rows``), and its masks are those rows of the
masks over the global shape, as a GSPMD shard draws them. Every mask
comes from an explicit threefry key, so a recompute under
``torch.utils.checkpoint`` and a CUDA-graph replay draw the same masks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..flax_rng import Scope
from ..kernels.attention import NEG_MASK_VALUE, flash_attention
from ..kernels.dropout import keep_mask
from ..xla_float import recip

LN_EPS = 1e-6   # flax nn.LayerNorm default (torch's is 1e-5)

__all__ = ["NEG_MASK_VALUE", "LN_EPS", "LayerNorm", "MultiHeadAttention",
           "TransformerBlock", "Transformer", "dense", "dropout"]


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, weight and bias in ``dtype``."""
    b = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


def dropout(x: torch.Tensor, rate: float, scope: Optional[Scope]
            ) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` at the scope's first ``make_rng``:
    ``select(bernoulli(key, 1 - rate, x.shape), x / (1 - rate), 0)``.
    The division takes the form jitted XLA gives it on the CPU: an f32
    ``x`` multiplies by the f32 reciprocal; a bf16 ``x`` divides by the
    bf16-rounded constant in f32 and rounds once (the constant is a
    Python float: no host-to-device copy, so the draw captures)."""
    if rate == 0.0 or scope is None:
        return x
    keep = 1.0 - rate
    shape, rows = tuple(x.shape), None
    if scope.rows is not None:
        # a data-parallel rank's rows of the mask over the global batch
        rows, total = scope.rows.of(shape[0])
        shape = (total,) + shape[1:]
    mask = keep_mask(scope.key, scope.fold_data(), keep, shape, rows,
                     scope.impl)
    if x.dtype == torch.float32:
        kept = x * recip(keep)
    else:
        kb = float(torch.tensor(keep, dtype=x.dtype))
        kept = (x.float() / kb).to(x.dtype)
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm: f32 statistics, eps 1e-6, result in ``dtype``."""

    def __init__(self, emb: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(emb, eps=LN_EPS, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with the reference's head geometry (Q1).
    ``attn_impl``: ``"xla"`` = the plain einsum path; ``"pallas"`` = the
    fused flash kernel (``kernels/attention.py``)."""

    def __init__(self, emb: int, heads: int = 8, causal: bool = False,
                 standard_heads: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
                 device=None):
        super().__init__()
        if attn_impl not in ("xla", "pallas"):
            raise ValueError(f"attn_impl must be xla/pallas, got "
                             f"{attn_impl!r}")
        if standard_heads and emb % heads:
            raise ValueError(f"standard_heads needs emb % heads == 0, got "
                             f"emb={emb}, heads={heads}")
        self.emb, self.heads, self.causal = emb, heads, causal
        self.head_dim = emb // heads if standard_heads else emb
        self.dtype, self.attn_impl = dtype, attn_impl
        hd = heads * self.head_dim
        self.tokeys = nn.Linear(emb, hd, bias=False, device=device)
        self.toqueries = nn.Linear(emb, hd, bias=False, device=device)
        self.tovalues = nn.Linear(emb, hd, bias=False, device=device)
        self.unifyheads = nn.Linear(hd, emb, device=device)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t_q, _ = q.shape
        t_k = k.shape[1]
        h, d, dt = self.heads, self.head_dim, self.dtype
        keys = dense(self.tokeys, k, dt).view(b, t_k, h, d)
        queries = dense(self.toqueries, q, dt).view(b, t_q, h, d)
        values = dense(self.tovalues, k, dt).view(b, t_k, h, d)
        scale = d ** -0.25
        queries = queries * scale
        keys = keys * scale

        if mask is not None:
            # (b, t_q, t_k) broadcasts over heads; (b, h|1, t_q, t_k) as is
            if mask.ndim == 3:
                mask = mask[:, None]
            if mask.ndim != 4:
                raise ValueError(f"mask must be 3-D or 4-D, got "
                                 f"{tuple(mask.shape)}")

        if self.attn_impl == "pallas":
            out = flash_attention(queries.transpose(1, 2),
                                  keys.transpose(1, 2),
                                  values.transpose(1, 2),
                                  mask=mask, causal=self.causal)
            out = out.transpose(1, 2).reshape(b, t_q, h * d)
            return dense(self.unifyheads, out, dt)

        logits = torch.einsum("bqhd,bkhd->bhqk", queries, keys)
        if self.causal:
            tri = torch.ones(t_q, t_k, dtype=torch.bool,
                             device=q.device).triu(1)
            logits = logits.masked_fill(tri, float("-inf"))
        if mask is not None:
            logits = logits.masked_fill(mask == 0, NEG_MASK_VALUE)
        # f32 parity mode softmaxes in f32; bf16 mode stays in bf16
        if dt == torch.float32:
            attn = torch.softmax(logits.float(), dim=-1)
        else:
            attn = torch.softmax(logits, dim=-1)
        attn = attn.to(values.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, values)
        return dense(self.unifyheads, out.reshape(b, t_q, h * d), dt)


class TransformerBlock(nn.Module):
    """Post-LN transformer block (Q2), dropout after each LayerNorm."""

    def __init__(self, emb: int, heads: int, causal: bool = False,
                 ff_hidden_mult: int = 4, dropout: float = 0.0,
                 standard_heads: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
                 device=None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.attention = MultiHeadAttention(
            emb, heads, causal=causal, standard_heads=standard_heads,
            dtype=dtype, attn_impl=attn_impl, device=device)
        self.norm1 = LayerNorm(emb, dtype, device=device)
        self.ff1 = nn.Linear(emb, ff_hidden_mult * emb, device=device)
        self.ff2 = nn.Linear(ff_hidden_mult * emb, emb, device=device)
        self.norm2 = LayerNorm(emb, dtype, device=device)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[Scope] = None) -> torch.Tensor:
        """``rng``: the block's ``"dropout"`` scope (None: deterministic)."""
        sub = (lambda name: None) if rng is None else rng.child
        attended = self.attention(q, k, mask)
        x = self.norm1(attended + q)
        x = dropout(x, self.dropout, sub("Dropout_0"))
        ff = torch.relu(dense(self.ff1, x, self.dtype))
        ff = dense(self.ff2, ff, self.dtype)
        return dropout(self.norm2(ff + x), self.dropout, sub("Dropout_1"))


class Transformer(nn.Module):
    """``depth`` non-causal blocks (``block_0`` …); keys stay the layer-0
    input across blocks."""

    def __init__(self, emb: int, heads: int, depth: int,
                 ff_hidden_mult: int = 4, dropout: float = 0.0,
                 standard_heads: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
                 device=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerBlock(
                emb, heads, ff_hidden_mult=ff_hidden_mult, dropout=dropout,
                standard_heads=standard_heads, dtype=dtype,
                attn_impl=attn_impl, device=device))

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[Scope] = None) -> torch.Tensor:
        """``rng``: this stack's ``"dropout"`` scope (None:
        deterministic); block ``i`` draws under ``block_<i>``."""
        x = q
        for i in range(self.depth):
            name = f"block_{i}"
            x = getattr(self, name)(x, k, mask,
                                    None if rng is None else rng.child(name))
        return x
