"""The 3×TF32 arithmetic of the port's f32 K2 kernel, held to JAX's f32
flash-attention dq on the CPU.

On Hopper the f32 K2 (``csrc/flash_bwd_dq_tc.cu``) computes its three
products S = Q·Kᵀ, dP = dO·Vᵀ and dQ = dS·K on the tensor cores with tf32
operands: each f32 operand x is split into big = tf32(x) and small =
tf32(x − big), rounded to nearest with ties away from zero, and each
product sums small·big + big·small + big·big (small·small is dropped) in
f32. The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``), so this file carries a plain model of that
arithmetic (here, never in the package) and checks, before any chip
time, that it stays within the f32 tolerances the card holds the kernel
to (rtol 1e-4, atol 1e-5) of the TPU kernel's f32 dq (run in interpret
mode, as ``tests/test_kernels.py`` runs it). A second test shows that
single-pass TF32 misses those tolerances, so the check has teeth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.kernels.attention import flash_attention as jax_flash
from t2omca_tpu_torch.kernels import attention as port

RTOL, ATOL = 1e-4, 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32 (10 explicit mantissa bits) on the bits: add half
    of the 13 dropped bits' range, then clear them (ties away from zero,
    as ``cvt.rna.tf32.f32``)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def dq_model(q, k, v, bias, causal, o, m, l, do, mm):
    """K2 with its three products through ``mm`` → f32 dq."""
    _, replaced = port._logits(q, k, bias, causal)
    s = mm(q, k.transpose(-1, -2))
    if bias is not None:
        s = torch.where(bias != 0.0, bias, s)
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool).triu(1),
                          port.NEG_MASK_VALUE)
    p = torch.exp(s - m[..., None]) / l[..., None]
    delta = (do * o).sum(dim=-1)
    dp = mm(do, v.transpose(-1, -2))
    ds = torch.where(replaced, torch.zeros(()), p * (dp - delta[..., None]))
    return mm(ds, k)


def _case(shape, mask, causal, kv, seed):
    b, h, tq, tk, d = shape
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, tq, d)) * d ** -0.25).astype(np.float32)
    k = (rng.standard_normal((b, h, tk, d)) * d ** -0.25).astype(np.float32)
    v = k if kv else rng.standard_normal((b, h, tk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    keep = None
    if mask is not None:
        keep = rng.random((b, h if mask == "per_head" else 1, tq, tk)) > 0.3
        if mask == "all_masked_row":
            keep[:, :, 3] = False
    jm = None if keep is None else jnp.asarray(keep)
    _, vjp = jax.vjp(lambda a, bb, c: jax_flash(a, bb, c, mask=jm,
                                                 causal=causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    dq_jax = np.asarray(vjp(jnp.asarray(do))[0])
    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    bias = None if keep is None else torch.where(
        torch.from_numpy(keep), 0.0, port.NEG_MASK_VALUE)
    o, m, l = port.flash_attention_fwd_reference(tq_, tk_, tv_, bias, causal)
    return (tq_, tk_, tv_, bias, causal, o, m, l, tdo), dq_jax


CASES = {
    "agent": ((4, 1, 4, 65, 256), None, False, False),
    "agent_k_is_v": ((4, 1, 4, 65, 256), None, False, True),
    "mixer": ((1, 1, 268, 131, 256), None, False, False),
    "mixer_k_is_v": ((1, 1, 268, 131, 256), None, False, True),
    "causal_per_head_d12": ((2, 3, 33, 70, 12), "per_head", True, False),
    "all_masked_row": ((2, 2, 40, 40, 8), "all_masked_row", True, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_model_within_f32_tolerance_of_jax(name):
    shape, mask, causal, kv = CASES[name]
    args, dq_jax = _case(shape, mask, causal, kv, seed=31)
    dq = dq_model(*args, mm=mm_3xtf32).numpy()
    np.testing.assert_allclose(dq, dq_jax, rtol=RTOL, atol=ATOL)
    if mask == "all_masked_row":
        assert float(np.abs(dq[:, :, 3]).max()) == 0.0


def test_single_pass_tf32_misses_the_f32_tolerance():
    """One tf32 product (big·big alone) is ~2^-11 relative: at the agent
    shape its dq leaves the tolerance that 3×TF32 holds."""
    args, dq_jax = _case(*CASES["agent"], seed=31)
    dq = dq_model(*args, mm=mm_1xtf32).numpy()
    excess = np.abs(dq - dq_jax) / (ATOL + RTOL * np.abs(dq_jax))
    assert excess.max() > 2.0
    assert np.abs(dq_model(*args, mm=mm_3xtf32).numpy() - dq_jax).max() < \
        np.abs(dq - dq_jax).max() / 10


def test_tf32_rounding_on_the_bits():
    """Ties away from zero, carries into the exponent, 13 bits cleared."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 2.0 - 2.0 ** -23, 0.0,
                      3.1415927])
    got = tf32(x)
    assert got[0].item() == 1.0 + 2.0 ** -10
    assert got[1].item() == -(1.0 + 2.0 ** -10)
    assert got[2].item() == 1.0
    assert got[3].item() == 2.0
    assert got[4].item() == 0.0
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[5].item() - 3.1415927) <= 2.0 ** -11 * 3.1415927
