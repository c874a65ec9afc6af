"""Fused flash attention, forward and backward: the CUDA kernels and their
plain versions.

Port of ``t2omca_tpu/kernels/attention.py``. The function is
``softmax(QKᵀ [masked]) V`` on ``(B, H, T, D)`` with the TPU kernels'
semantics, which every version here keeps exactly:

* f32 accumulation and softmax statistics at every input dtype; the
  output is cast to q's dtype, each gradient to its input's;
* the mask is a REPLACEMENT: where the mask is 0 the logit is
  overwritten with ``NEG_MASK_VALUE`` (−1e9), never biased, so an
  all-masked row degrades to the uniform mean of the real values;
* causal positions (``col > row``) take the same finite −1e9;
* key-tail padding (−1e30 on the TPU) never enters a row.

Four kernels, all CUDA C++ for ``sm_90a`` built at first use by
``build.py`` (a build or launch failure raises):

* K1 ``flash_fwd``: the forward;
* K1 + residuals ``flash_fwd_res``: the forward that also writes each
  row's final running max ``m`` and denominator ``l`` (f32 ``(B, H,
  Tq)``, kept separate: an all-masked row has ``m = −1e9``, which would
  swallow ``log l`` in a fused logsumexp);
* K2 ``flash_bwd_dq`` and K3 ``flash_bwd_dkv``: the gradients,
  recomputing P from ``(q, k, m, l)``.

Every body runs its products on Hopper's tensor cores, because at every
main-path shape the function is bound by bytes but f32 products on the
CUDA cores cost as much as the whole byte time. The bf16 bodies of K1
(both launches, ``csrc/flash_fwd_tc.cu``), K3 (``csrc/flash_bwd_tc.cu``)
and K2 (``csrc/flash_bwd_dq_tc.cu``) use ``mma.sync`` with bf16 operands
and f32 accumulation. Their one new rounding, stated here once: they
round P (K1, K3) and dS (K2, K3) to bf16 before the products with V, K,
dO and Q, where the plain versions below keep f32 P and dS; the
statistics ``m``, ``l`` and every accumulator stay f32, and the card's
tolerances are unchanged (``chip_smoke.py``, ``tests/test_torch_cuda.py``;
``tests/test_torch_attention_bf16_rounding.py`` holds a plain model of
that rounding against JAX on the CPU). The f32 bodies of K3
(``csrc/flash_bwd_dkv_3xtf32.cu``) and K2 (``csrc/flash_bwd_dq_tc.cu``)
run as 3×TF32: each f32 operand is split into two tf32 terms and each
product sums three tf32 products in f32, within the f32 tolerances. The
f32 K1 (``csrc/flash_fwd_dmma.cu``, both launches) runs on the FP64
tensor cores: exact products, f64 sums and an f64 softmax, so its output
is the exact one rounded once to f32 (PERF.md, section 6, says why the
forward needs that and 3×TF32 does not give it).
``tests/test_torch_attention_tf32_model.py`` holds plain models of both
arithmetics against JAX on the CPU. The C entry points
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) validate the arguments
and pick the body by dtype.

``flash_attention`` dispatches on autograd and the device and on nothing
else. Under grad mode with an input that requires grad it goes through
``FlashAttentionFunction`` (the TPU path's ``_build`` custom VJP), whose
forward and backward launch K1 + residuals, K2 and K3 on CUDA tensors
and run the plain versions on CPU tensors. Otherwise CUDA tensors launch
K1 and CPU tensors run ``flash_attention_reference``.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

#: the module's masked_fill value (models/transformer.py re-exports it)
NEG_MASK_VALUE = -1e9

#: launches of each kernel since the last ``reset_launches()``; a wrapper
#: adds one exactly where it launches its kernel, through
#: ``count_launch``, whose lock keeps the counts exact when several
#: threads launch at once (the serving fleet's engines)
LAUNCHES = {"flash_fwd": 0, "flash_fwd_res": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str, n: int = 1) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += n


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation type of the plain versions: f32, or f64 for f64
    inputs (``gradcheck``; the kernels take f32 and bf16 only)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _logits(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor],
            causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (the replaced logits, the ``replaced`` plane: positions whose
    logit the forward overwrote, broadcastable to the logits)."""
    acc = _acc_dtype(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    replaced = torch.zeros((), dtype=torch.bool, device=q.device)
    if bias is not None:
        bias = bias.to(acc)
        bmask = bias != 0.0
        s = torch.where(bmask, bias, s)
        replaced = replaced | bmask
    if causal:
        t_q, t_k = q.shape[2], k.shape[2]
        tri = torch.ones(t_q, t_k, dtype=torch.bool,
                         device=q.device).triu(1)
        s = s.masked_fill(tri, NEG_MASK_VALUE)
        replaced = replaced | tri
    return s, replaced


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              causal: bool = False) -> torch.Tensor:
    """K1's function in plain PyTorch, all in f32: ``bias`` is the float
    plane ``flash_attention`` builds (0 = keep the logit, nonzero =
    replace it), broadcastable to ``(B, H, Tq, Tk)``."""
    s, _ = _logits(q, k, bias, causal)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(s.dtype)).to(q.dtype)


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  bias: Optional[torch.Tensor] = None,
                                  causal: bool = False
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """K1 + residuals in plain PyTorch → ``(o, m, l)``: ``m`` is the row
    max of the replaced logits and ``l`` the row sum of ``exp(s − m)``,
    both f32 ``(B, H, Tq)``. An all-masked row has ``m = −1e9`` and
    ``l = Tk``."""
    s, _ = _logits(q, k, bias, causal)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    o = torch.matmul(e, v.to(s.dtype)) / l[..., None]
    return o.to(q.dtype), m, l


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  bias: Optional[torch.Tensor],
                                  causal: bool, o: torch.Tensor,
                                  m: torch.Tensor, l: torch.Tensor,
                                  do: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """K2 and K3 in plain PyTorch → ``(dq, dk, dv)`` in the input dtypes:
    ``Δ = rowsum(dO∘O)`` from ``o`` as stored, ``P = exp(S − m)/l``,
    ``dS = P∘(dP − Δ)`` zeroed where the forward replaced the logit,
    ``dQ = dS K``, ``dK = dSᵀ Q`` and ``dV = Pᵀ dO`` with the full P."""
    s, replaced = _logits(q, k, bias, causal)
    acc = s.dtype
    p = torch.exp(s - m.to(acc)[..., None]) / l.to(acc)[..., None]
    g = do.to(acc)
    delta = (g * o.to(acc)).sum(dim=-1)
    dp = torch.matmul(g, v.to(acc).transpose(-1, -2))
    ds = torch.where(replaced, torch.zeros((), dtype=acc, device=s.device),
                     p * (dp - delta[..., None]))
    dq = torch.matmul(ds, k.to(acc))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc))
    dv = torch.matmul(p.transpose(-1, -2), g)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_devices(q: torch.Tensor, *others: torch.Tensor) -> None:
    for t in others:
        if t.device != q.device:
            raise ValueError(f"flash_attention: a tensor is on {t.device}, "
                             f"q on {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: q is on {q.device} but the "
                         f"current CUDA device is "
                         f"{torch.cuda.current_device()}")


def _expand_bias(bias: Optional[torch.Tensor], q: torch.Tensor,
                 k: torch.Tensor) -> Optional[torch.Tensor]:
    if bias is None:
        return None
    b, h, t_q, _ = q.shape
    return bias.to(q.device).expand(b, h, t_q, k.shape[2])


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], causal: bool) -> torch.Tensor:
    """Launch K1 on q's current stream. Output memory follows q's layout
    (``empty_like``), so a ``(B, T, H, D)`` view in gives a ``(B, T, H,
    D)``-contiguous result out."""
    from .build import load
    ops = load()
    _check_devices(q, k, v)
    bias = _expand_bias(bias, q, k)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ops.flash_fwd(q, k, v, bias, bool(causal), stream, out)
    count_launch("flash_fwd")
    return out


def _launch_res(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: Optional[torch.Tensor], causal: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 + residuals → ``(o, m, l)``."""
    from .build import load
    ops = load()
    _check_devices(q, k, v)
    bias = _expand_bias(bias, q, k)
    out = torch.empty_like(q)
    m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ops.flash_fwd_res(q, k, v, bias, bool(causal), stream, out, m, l)
    count_launch("flash_fwd_res")
    return out, m, l


def _launch_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor], causal: bool,
                   do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   delta: torch.Tensor) -> torch.Tensor:
    """Launch K2 → dq in q's layout. ``bias`` expanded, ``do`` in q's
    dtype, ``delta = rowsum(dO∘O)`` f32 ``(B, H, Tq)``."""
    from .build import load
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    load().flash_bwd_dq(q, k, v, bias, do, m, l, delta, bool(causal),
                        stream, dq)
    count_launch("flash_bwd_dq")
    return dq


def _launch_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], causal: bool,
                    do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                    delta: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 → (dk, dv) in k's and v's layouts (arguments as
    ``_launch_bwd_dq``)."""
    from .build import load
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    load().flash_bwd_dkv(q, k, v, bias, do, m, l, delta, bool(causal),
                         stream, dk, dv)
    count_launch("flash_bwd_dkv")
    return dk, dv


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: Optional[torch.Tensor], causal: bool, o: torch.Tensor,
                m: torch.Tensor, l: torch.Tensor, do: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``Δ = rowsum(dO∘O)`` as a torch reduction (the TPU path's
    ``backward`` does the same at ``attention.py:413``), then K2 and K3
    → ``(dq, dk, dv)``, each in its input's layout."""
    _check_devices(q, k, v, do)
    bias = _expand_bias(bias, q, k)
    do = do.to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = _launch_bwd_dq(q, k, v, bias, causal, do, m, l, delta)
    dk, dv = _launch_bwd_dkv(q, k, v, bias, causal, do, m, l, delta)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """The flash custom VJP (the TPU path's ``_build``,
    ``attention.py:482-500``). Forward saves ``q, k, v, bias, o, m, l``;
    backward returns ``dq, dk, dv`` in the input dtypes and no gradient
    for the bias plane (it encodes the mask). CUDA tensors launch K1 +
    residuals, then K2 and K3; CPU tensors run the plain versions. When
    ``k`` and ``v`` are one tensor, autograd sums the two gradients."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        if q.is_cuda:
            o, m, l = _launch_res(q, k, v, bias, causal)
        else:
            o, m, l = flash_attention_fwd_reference(q, k, v, bias, causal)
        ctx.save_for_backward(q, k, v, bias, o, m, l)
        ctx.causal = causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, bias, o, m, l = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = _launch_bwd(q, k, v, bias, ctx.causal, o, m, l, do)
        else:
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, bias, ctx.causal, o, m, l, do)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention on ``(B, H, T, D)``. Any Q1 query/key scaling is
    the caller's job. ``mask``: optional ``(B, 1|H, T_q, T_k)``; zero
    entries are suppressed (replacement semantics above). Differentiable
    through ``FlashAttentionFunction`` when grad mode is on and an input
    requires grad."""
    bias = None
    if mask is not None:
        if mask.ndim != 4:
            raise ValueError(f"mask must be (B, 1|H, T_q, T_k), got shape "
                             f"{tuple(mask.shape)}")
        bias = torch.where(mask == 0, NEG_MASK_VALUE, 0.0).to(torch.float32)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, bias, bool(causal))
    if q.is_cuda:
        return _launch(q, k, v, bias, causal)
    return flash_attention_reference(q, k, v, bias, causal)
