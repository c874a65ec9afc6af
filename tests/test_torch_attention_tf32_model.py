"""The arithmetic of the port's f32 kernels (K1 in both launches, K2 and
K3), held to JAX's f32 flash attention on the CPU.

On Hopper the f32 K2 (``csrc/flash_bwd_dq_tc.cu``) and K3
(``csrc/flash_bwd_dkv_3xtf32.cu``) compute their products (dP = dO·Vᵀ,
S = Q·Kᵀ and dQ = dS·K; dK = dSᵀ·Q and dV = Pᵀ·dO) on the tensor cores
as 3×TF32: each f32 operand x is split into big = tf32(x) and small =
tf32(x − big), rounded to nearest with ties away from zero, and each
product sums small·big + big·small + big·big (small·small is dropped) in
f32. The f32 K1 (``csrc/flash_fwd_dmma.cu``) runs S = Q·Kᵀ, the softmax
and O = P·V in f64 on the FP64 tensor cores and rounds once: its output
is the exact one, correctly rounded; K1 + residuals writes m as the f64
row max rounded once and l relative to it. The kernels run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``), so this file
carries plain models of that arithmetic (here, never in the package)
and checks, before any chip time, that they stay within the tolerances
the card holds the kernels to (K1's output: atol 1e-5; m, l and the
gradients: rtol 1e-4, atol 1e-5) of the TPU kernels' f32 results (run
in interpret mode, as ``tests/test_kernels.py`` runs them: the forward,
its residuals from the custom VJP's forward rule, and the VJP). A second
test shows that single-pass TF32 misses those tolerances, so the check
has teeth.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.kernels import attention as jax_att
from t2omca_tpu_torch.kernels import attention as port

RTOL, ATOL = 1e-4, 1e-5
#: K1's output against the plain version on the card (chip_smoke's TOL)
OUT_ATOL = 1e-5


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


def logits_model(q, k, bias, causal, mm):
    """S = Q·Kᵀ through ``mm`` with the replacement mask and causal fill →
    (S, replaced)."""
    _, replaced = port._logits(q, k, bias, causal)
    s = mm(q, k.transpose(-1, -2))
    if bias is not None:
        s = torch.where(bias != 0.0, bias, s)
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool).triu(1),
                          port.NEG_MASK_VALUE)
    return s, torch.broadcast_to(replaced, s.shape)


def mm_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The FP64 tensor cores' product: exact f64 products, f64 sums."""
    return a.double() @ b.double()


def fwd_model(q, k, v, bias, causal, mm):
    """K1 + residuals with S and P·V through ``mm`` and the softmax in
    ``mm``'s precision → f32 (o, m, l): o rounded once, m the row max
    rounded once, l relative to that f32 m."""
    s, _ = logits_model(q, k, bias, causal, mm)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    o = (mm(e, v) / l[..., None]).float()
    m32 = m.float()
    l32 = (l * torch.exp(m - m32.to(m.dtype))).float()
    return o, m32, l32


def dq_model(q, k, v, bias, causal, o, m, l, do, mm):
    """K2 with its three products through ``mm`` → f32 dq."""
    s, replaced = logits_model(q, k, bias, causal, mm)
    p = torch.exp(s - m[..., None]) / l[..., None]
    delta = (do * o).sum(dim=-1)
    dp = mm(do, v.transpose(-1, -2))
    ds = torch.where(replaced, torch.zeros(()), p * (dp - delta[..., None]))
    return mm(ds, k)


def dkv_model(q, k, v, bias, causal, o, m, l, do, mm):
    """K3 with its four products through ``mm`` → f32 (dk, dv)."""
    s, replaced = logits_model(q, k, bias, causal, mm)
    p = torch.exp(s - m[..., None]) / l[..., None]
    delta = (do * o).sum(dim=-1)
    dp = mm(do, v.transpose(-1, -2))
    ds = torch.where(replaced, torch.zeros(()), p * (dp - delta[..., None]))
    return mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), do)


CASES = {
    "agent": ((4, 1, 4, 65, 256), None, False, None),
    "agent_k_is_v": ((4, 1, 4, 65, 256), None, False, "kv"),
    "mixer": ((1, 1, 268, 131, 256), None, False, None),
    "mixer_k_is_v": ((1, 1, 268, 131, 256), None, False, "kv"),
    "causal_per_head_d12": ((2, 3, 33, 70, 12), "per_head", True, None),
    "all_masked_row": ((2, 2, 40, 40, 8), "all_masked_row", True, None),
    "negative_logits": ((4, 2, 20, 37, 64), None, False, "negative"),
}


@functools.lru_cache(maxsize=None)
def _case(name, seed=31):
    """The case's f32 inputs (torch) and JAX's f32 results in interpret
    mode: o, the residuals m and l, and dq, dk, dv."""
    (b, h, tq, tk, d), mask, causal, extra = CASES[name]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, tq, d)) * d ** -0.25).astype(np.float32)
    k = (rng.standard_normal((b, h, tk, d)) * d ** -0.25).astype(np.float32)
    if extra == "negative":
        q, k = np.abs(q), -np.abs(k)
    v = k if extra == "kv" else rng.standard_normal(
        (b, h, tk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    keep = None
    if mask is not None:
        keep = rng.random((b, h if mask == "per_head" else 1, tq, tk)) > 0.3
        if mask == "all_masked_row":
            keep[:, :, 3] = False
    jm = None if keep is None else jnp.asarray(keep)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o_jax, vjp = jax.vjp(lambda a, bb, c: jax_att.flash_attention(
        a, bb, c, mask=jm, causal=causal), jq, jk, jv)
    grads = [np.asarray(x) for x in vjp(jnp.asarray(do))]
    jbias = None if jm is None else jnp.where(
        jm == 0, jnp.float32(jax_att.NEG_MASK_VALUE), jnp.float32(0.0))
    fn = jax_att._build(causal, jax_att.DEFAULT_BLOCK_Q,
                        jax_att.DEFAULT_BLOCK_K, True, jbias is not None)
    _, res = fn.fwd(jq, jk, jv, jbias)
    m_jax, l_jax = (np.asarray(x).reshape(b, h, -1)[..., :tq]
                    for x in res[5:7])
    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    bias = None if keep is None else torch.where(
        torch.from_numpy(keep), 0.0, port.NEG_MASK_VALUE)
    want = dict(o=np.asarray(o_jax), m=m_jax, l=l_jax, dq=grads[0],
                dk=grads[1], dv=grads[2])
    return (tq_, tk_, tv_, bias, causal, tdo), want


def _bwd_args(name, mm_fwd):
    """Inputs of K2 and K3 with the residuals of the K1 model (the card's
    chain: K1 + residuals feeds the backward kernels)."""
    (q, k, v, bias, causal, do), want = _case(name)
    o, m, l = fwd_model(q, k, v, bias, causal, mm_fwd)
    return (q, k, v, bias, causal, o, m, l, do), want


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_model_within_f32_tolerance_of_jax(name):
    """K2's dq."""
    args, want = _bwd_args(name, mm_f64)
    dq = dq_model(*args, mm=mm_3xtf32).numpy()
    np.testing.assert_allclose(dq, want["dq"], rtol=RTOL, atol=ATOL)
    if CASES[name][1] == "all_masked_row":
        assert float(np.abs(dq[:, :, 3]).max()) == 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_k1_model_within_f32_tolerance_of_jax(name):
    """K1's output, and K1 + residuals' m and l."""
    (q, k, v, bias, causal, _), want = _case(name)
    o, m, l = fwd_model(q, k, v, bias, causal, mm_f64)
    np.testing.assert_allclose(o.numpy(), want["o"], rtol=0.0, atol=OUT_ATOL)
    np.testing.assert_allclose(m.numpy(), want["m"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), want["l"], rtol=RTOL, atol=ATOL)
    if CASES[name][1] == "all_masked_row":
        assert bool((m[:, :, 3] == port.NEG_MASK_VALUE).all())
        assert bool((l[:, :, 3] == k.shape[2]).all())
    if CASES[name][3] == "negative":
        assert bool((m < 0).all())


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_k3_model_within_f32_tolerance_of_jax(name):
    """K3's dk and dv."""
    args, want = _bwd_args(name, mm_f64)
    dk, dv = dkv_model(*args, mm=mm_3xtf32)
    np.testing.assert_allclose(dk.numpy(), want["dk"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dv.numpy(), want["dv"], rtol=RTOL, atol=ATOL)


def _excess(got, want, rtol, atol):
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


@pytest.mark.parametrize("kernel", ["K2", "K1", "K3"])
def test_single_pass_tf32_misses_the_f32_tolerance(kernel):
    """One tf32 product (big·big alone) is ~2^-11 relative: at the agent
    shape the kernel's result leaves the tolerance that the kernel's own
    arithmetic (f64 for K1, 3×TF32 for K2 and K3) holds, and its error is
    more than 10× that arithmetic's."""
    results = {}
    for tag, mm in (("1x", mm_1xtf32), ("3x", mm_3xtf32)):
        args, want = _bwd_args("agent", mm_f64 if tag == "3x" else mm)
        if kernel == "K1":
            got = {"o": args[5].numpy()}
        elif kernel == "K2":
            got = {"dq": dq_model(*args, mm=mm).numpy()}
        else:
            dk, dv = dkv_model(*args, mm=mm)
            got = {"dk": dk.numpy(), "dv": dv.numpy()}
        results[tag] = got
    rtol, atol = (0.0, OUT_ATOL) if kernel == "K1" else (RTOL, ATOL)
    for key, one in results["1x"].items():
        assert _excess(one, want[key], rtol, atol) > 2.0
        assert np.abs(results["3x"][key] - want[key]).max() < \
            np.abs(one - want[key]).max() / 10


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
