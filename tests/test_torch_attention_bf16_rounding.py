"""The operand rounding of the port's bf16 tensor-core kernels, held to
JAX's bf16 ``flash_attention`` and its gradients on the CPU.

The bf16 K1 (both launches), K2 and K3 kernels on Hopper feed the tensor
cores bf16 operands: K1 rounds the probabilities P to bf16 before P·V, K2
rounds dS to bf16 before dQ = dS·K, and K3 rounds P and dS to bf16 before
dV = Pᵀ·dO and dK = dSᵀ·Q, all with f32 accumulation; the plain versions
in ``kernels/attention.py`` keep f32 P and dS.
The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``), so this file carries a plain model of that rounding
(here, never in the package) and checks, before any chip time, that it
stays within the card's bf16 tolerances of the TPU kernels' bf16 forward
and gradients (run in interpret mode, as ``tests/test_kernels.py`` runs
them): output atol 2e-2; gradients rtol 0.05 / atol 0.02·max(scale, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.kernels.attention import flash_attention as jax_flash
from t2omca_tpu_torch.kernels import attention as port

OUT_ATOL = 2e-2
GRAD_RTOL, GRAD_ATOL = 0.05, 0.02


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def tensor_core_forward(q, k, v, bias, causal):
    """K1's bf16 rounding model → (o bf16, m, l): f32 logits and
    statistics, P = exp(S − m) rounded to bf16 before the product with V,
    l summed from the f32 P."""
    s, _ = port._logits(q, k, bias, causal)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    o = torch.matmul(_bf16(e), v.float()) / l[..., None]
    return o.to(torch.bfloat16), m, l


def tensor_core_backward(q, k, v, bias, causal, o, m, l, do):
    """K2's and K3's bf16 rounding model (dS rounded to bf16 before
    dQ = dS K, P and dS before dV = Pᵀ dO and dK = dSᵀ Q) → bf16 (dq, dk,
    dv)."""
    s, replaced = port._logits(q, k, bias, causal)
    p = torch.exp(s - m[..., None]) / l[..., None]
    g = do.float()
    delta = (g * o.float()).sum(dim=-1)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    ds = torch.where(replaced, torch.zeros(()), p * (dp - delta[..., None]))
    dq = torch.matmul(_bf16(ds), k.float())
    dk = torch.matmul(_bf16(ds).transpose(-1, -2), q.float())
    dv = torch.matmul(_bf16(p).transpose(-1, -2), g)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _assert_grad_close(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * scale)


@pytest.mark.parametrize("shape,mask,causal", [
    ((2, 4, 65, 65, 64), None, False),            # serve heads
    ((4, 1, 4, 65, 256), None, False),            # learner agent rows
    ((1, 1, 268, 131, 256), None, False),         # learner mixer rows
    ((2, 2, 40, 40, 8), "all_masked_row", True),  # D 8, causal, one dead row
], ids=["serve", "agent", "mixer", "all_masked_row"])
def test_bf16_rounding_model_within_card_tolerance_of_jax(shape, mask,
                                                          causal):
    b, h, tq, tk, d = shape
    rng = np.random.default_rng(21)
    q = rng.standard_normal((b, h, tq, d)) * d ** -0.25
    k = rng.standard_normal((b, h, tk, d)) * d ** -0.25
    v = rng.standard_normal((b, h, tk, d))
    do = rng.standard_normal((b, h, tq, d))
    # the bf16 inputs both sides see
    q, k, v, do = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v, do))
    keep = None
    if mask is not None:
        keep = rng.random((b, 1, tq, tk)) > 0.3
        keep[:, :, 3] = False

    jm = None if keep is None else jnp.asarray(keep)
    out_j, vjp = jax.vjp(
        lambda a, bb, c: jax_flash(a, bb, c, mask=jm, causal=causal),
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do, jnp.bfloat16))

    tq_, tk_, tv_, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                          for x in (q, k, v, do))
    bias = None if keep is None else torch.where(
        torch.from_numpy(keep), 0.0, port.NEG_MASK_VALUE)
    o, m, l = tensor_core_forward(tq_, tk_, tv_, bias, causal)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(out_j, np.float32), rtol=0.0,
                               atol=OUT_ATOL)
    # the statistics are the plain version's (m, l stay f32)
    _, m_r, l_r = port.flash_attention_fwd_reference(tq_, tk_, tv_, bias,
                                                     causal)
    torch.testing.assert_close(m, m_r, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(l, l_r, rtol=1e-5, atol=0.0)

    grads = tensor_core_backward(tq_, tk_, tv_, bias, causal, o, m, l, tdo)
    for got, want in zip(grads, grads_j):
        _assert_grad_close(got.float().numpy(), np.asarray(want, np.float32))
    if mask is not None:
        assert float(grads[0][:, :, 3].float().abs().max()) == 0.0
        assert float(grads[2].float().abs().max()) > 0.0
        assert (m[:, :, 3] == port.NEG_MASK_VALUE).all()
        assert (l[:, :, 3] == tk).all()


def test_rounding_model_is_not_the_plain_version():
    """The model rounds where the plain versions do not: its dV differs
    from the f32-P plain backward by bf16 rounding, and no more."""
    rng = np.random.default_rng(22)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((2, 1, 16, 24)).astype(np.float32)).to(
            torch.bfloat16) for _ in range(4))
    o, m, l = tensor_core_forward(q, k, v, None, False)
    _, _, dv = tensor_core_backward(q, k, v, None, False, o, m, l, do)
    _, _, dv_r = port.flash_attention_bwd_reference(q, k, v, None, False, o,
                                                    m, l, do)
    diff = (dv.float() - dv_r.float()).abs().max().item()
    assert 0.0 < diff <= GRAD_ATOL * max(dv_r.float().abs().max().item(), 1.0)


def test_rounding_model_rounds_ds_in_dq():
    """K2's side of the model rounds dS before dS·K: its dq differs from
    the plain backward's f32-dS dq by bf16 rounding of dS, and no more."""
    rng = np.random.default_rng(23)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((2, 1, 16, 24)).astype(np.float32)).to(
            torch.bfloat16) for _ in range(4))
    o, m, l = tensor_core_forward(q, k, v, None, False)
    dq, _, _ = tensor_core_backward(q, k, v, None, False, o, m, l, do)
    dq_r, _, _ = port.flash_attention_bwd_reference(q, k, v, None, False, o,
                                                    m, l, do)
    diff = (dq.float() - dq_r.float()).abs().max().item()
    assert 0.0 < diff <= GRAD_ATOL * max(dq_r.float().abs().max().item(), 1.0)
