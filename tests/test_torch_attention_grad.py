"""Port parity of the flash-attention gradient: the port's
``FlashAttentionFunction`` (reached through ``flash_attention`` when an
input requires grad) against ``jax.grad`` through the JAX package's
``flash_attention`` (the Pallas forward with residuals and the two
backward kernels, in interpret mode, as ``tests/test_kernels.py`` runs
them on the CPU).

On CPU tensors the Function runs the plain versions of K1 + residuals,
K2 and K3 — the functions the CUDA kernels are compared with on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``) — so these tests hold
those plain versions, and the Function's own glue (what it saves, Δ,
non-contiguous dO, ``k is v``), to the TPU kernels' gradients. Cases
mirror ``tests/test_kernels.py:127-208``. Tolerances: f32 rtol 1e-4 /
atol 1e-5 (reassociation of short f32 sums); bf16 rtol 0.05 / atol
0.02·max(scale, 1) against the f32 reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.kernels.attention import flash_attention as jax_flash
from t2omca_tpu_torch.kernels import attention as port

F32 = dict(rtol=1e-4, atol=1e-5)


def _grads_both(q, k, v, mask=None, causal=False, dtype=np.float32,
                **jax_kw):
    """Same numpy inputs through both, loss = Σ out² → (jax grads, port
    grads, port out) as f32 numpy."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jm = None if mask is None else jnp.asarray(mask)

    def loss(a, b, c):
        out = jax_flash(a, b, c, mask=jm, causal=causal, **jax_kw)
        return (out.astype(jnp.float32) ** 2).sum()

    gj = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    ts = [torch.tensor(x, dtype=tdt, requires_grad=True) for x in (q, k, v)]
    out = port.flash_attention(*ts, mask=None if mask is None
                               else torch.from_numpy(mask), causal=causal)
    assert out.grad_fn is not None
    (out.float() ** 2).sum().backward()
    for t in ts:
        assert t.grad.dtype == tdt
    return ([np.asarray(g, np.float32) for g in gj],
            [t.grad.float().numpy() for t in ts], out)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_grad_matches_jax_f32(causal, masked):
    rng = np.random.default_rng(5)
    q, k, v = (_rand(rng, (2, 2, 7, 8)) for _ in range(3))
    mask = (rng.random((2, 1, 7, 7)) > 0.3) if masked else None
    gj, gt, _ = _grads_both(q, k, v, mask, causal)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, **F32)


def test_grad_pad_tails_and_per_head_mask():
    rng = np.random.default_rng(6)
    q = _rand(rng, (2, 2, 5, 12))
    k = _rand(rng, (2, 2, 7, 12))
    v = _rand(rng, (2, 2, 7, 12))
    mask = rng.random((2, 2, 5, 7)) > 0.4
    gj, gt, _ = _grads_both(q, k, v, mask, block_q=4, block_k=4)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, **F32)


def test_grad_multi_k_block():
    """40 keys in 8-wide JAX blocks: several recomputed P tiles against
    one residual pair on the reference side."""
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, (1, 2, 40, 8)) for _ in range(3))
    gj, gt, _ = _grads_both(q, k, v, block_q=8, block_k=8)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, **F32)


def test_grad_all_masked_row():
    """The all-masked row: dq of that row is exactly 0 (every logit was
    replaced) and its uniform weights still carry cotangent into dv."""
    rng = np.random.default_rng(8)
    q, k, v = (_rand(rng, (1, 1, 4, 8)) for _ in range(3))
    mask = np.ones((1, 1, 4, 4), bool)
    mask[0, 0, 2] = False
    gj, gt, _ = _grads_both(q, k, v, mask)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, **F32)
    assert np.abs(gt[0][0, 0, 2]).max() == 0.0
    assert np.abs(gt[2]).max() > 0.0


def test_grad_bf16_against_f32_reference():
    rng = np.random.default_rng(9)
    q, k, v = (_rand(rng, (2, 2, 17, 8)) for _ in range(3))
    # the f32 reference sees the bf16-rounded inputs
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
               for x in (q, k, v))
    _, gt, _ = _grads_both(q, k, v, dtype="bf16")
    gj32, _, _ = _grads_both(q, k, v)
    for a, b in zip(gt, gj32):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0.05,
                                   atol=0.02 * max(scale, 1.0))


def _np_attention(q, k, v, mask, causal):
    """numpy formula of the forward and its residuals, in f64."""
    s = np.einsum("bhqd,bhkd->bhqk", q, k).astype(np.float64)
    replaced = np.zeros(s.shape, bool)
    if mask is not None:
        replaced |= np.broadcast_to(~mask, s.shape)
    if causal:
        replaced |= np.triu(np.ones(s.shape[-2:], bool), 1)
    s = np.where(replaced, port.NEG_MASK_VALUE, s)
    m = s.max(-1)
    e = np.exp(s - m[..., None])
    l = e.sum(-1)
    p = e / l[..., None]
    return p @ v, m, l, p, replaced


def test_residual_forward_and_bwd_reference_match_numpy_formula():
    rng = np.random.default_rng(11)
    q, k, v, g = (_rand(rng, (2, 2, 6, 5)) for _ in range(4))
    mask = rng.random((2, 1, 6, 6)) > 0.3
    mask[1, 0, 4] = False                         # an all-masked row
    o_np, m_np, l_np, p, replaced = _np_attention(q, k, v, mask, True)
    bias = torch.where(torch.from_numpy(mask), 0.0, port.NEG_MASK_VALUE)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, m, l = port.flash_attention_fwd_reference(tq, tk, tv, bias, True)
    assert m.dtype == l.dtype == torch.float32 and m.shape == (2, 2, 6)
    np.testing.assert_allclose(o.numpy(), o_np, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), m_np, rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), l_np, rtol=1e-5)
    assert m[1, :, 4].eq(port.NEG_MASK_VALUE).all()
    assert l[1, :, 4].eq(6.0).all()
    dq, dk, dv = port.flash_attention_bwd_reference(tq, tk, tv, bias, True,
                                                    o, m, l, tg)
    delta = (g * o_np).sum(-1)
    dp = np.einsum("bhqd,bhkd->bhqk", g, v)
    ds = np.where(replaced, 0.0, p * (dp - delta[..., None]))
    np.testing.assert_allclose(dq.numpy(), ds @ k, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dk.numpy(), ds.swapaxes(-1, -2) @ q,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), p.swapaxes(-1, -2) @ g,
                               rtol=1e-4, atol=1e-5)


def test_function_with_k_is_v_and_noncontiguous_do():
    """The qslice call passes one tensor as keys and values (autograd
    sums dk and dv), and dO arrives as a strided view."""
    rng = np.random.default_rng(12)
    q, kv = _rand(rng, (3, 1, 8, 16)), _rand(rng, (3, 1, 9, 16))
    w = _rand(rng, (3, 1, 16, 8))                  # dO, stored transposed

    def loss_j(a, b):
        out = jax_flash(a, b, b)
        return (out * jnp.asarray(w).transpose(0, 1, 3, 2)).sum()

    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(kv))
    tq = torch.tensor(q, requires_grad=True)
    tkv = torch.tensor(kv, requires_grad=True)
    out = port.flash_attention(tq, tkv, tkv)
    do = torch.from_numpy(w).transpose(2, 3)          # non-contiguous
    assert not do.is_contiguous()
    out.backward(do)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gj[0]), **F32)
    np.testing.assert_allclose(tkv.grad.numpy(), np.asarray(gj[1]), **F32)


def test_function_saves_residuals_and_gradcheck_f64():
    rng = np.random.default_rng(13)
    q, k, v = (torch.tensor(_rand(rng, (1, 2, 3, 4)), dtype=torch.float64,
                            requires_grad=True) for _ in range(3))
    mask = torch.from_numpy(rng.random((1, 1, 3, 3)) > 0.3)
    bias = torch.where(mask, 0.0, port.NEG_MASK_VALUE)
    out = port.FlashAttentionFunction.apply(q, k, v, bias, True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7 and saved[4] is not None
    o, m, l = port.flash_attention_fwd_reference(q.detach(), k.detach(),
                                                 v.detach(), bias, True)
    assert torch.equal(saved[5], m) and torch.equal(saved[6], l)
    assert torch.autograd.gradcheck(
        lambda a, b, c: port.flash_attention(a, b, c, mask=mask,
                                             causal=True),
        (q, k, v), eps=1e-6, atol=1e-6)


def test_no_grad_route_does_not_touch_the_function(monkeypatch):
    calls = []
    monkeypatch.setattr(port.FlashAttentionFunction, "apply",
                        lambda *a: calls.append(a))
    x = torch.zeros(1, 1, 2, 4, requires_grad=True)
    with torch.no_grad():
        out = port.flash_attention(x, x, x)
    assert calls == [] and out.grad_fn is None
    port.flash_attention(x.detach(), x.detach(), x.detach())
    assert calls == []
    port.flash_attention(x, x, x)
    assert len(calls) == 1
