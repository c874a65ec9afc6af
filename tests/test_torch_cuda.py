"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is ``cuda``-marked and skips
without an NVIDIA GPU; the file imports no JAX, so it runs on the GPU
machine as is:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from t2omca_tpu_torch.kernels import attention as port

#: f32: reassociation scale of 64–256-term dots of unit-scale logits;
#: bf16: one rounding of the output (values of order 1)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=0.0, atol=2e-2)}


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import: every xdist worker
    must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "`python -m pytest -m cuda --noconftest tests/test_torch_cuda.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,causal,mask", [
    ((64, 4, 65, 65, 64), False, None),          # serve head geometry
    ((8, 1, 4, 65, 256), False, None),           # qslice rows, D = emb
    ((8, 2, 5, 7, 12), False, "broadcast"),      # odd shapes
    ((4, 3, 33, 200, 256), True, "per_head"),    # multi k-tile, D 256
    ((4, 2, 40, 40, 8), True, "all_masked_row"),
    ((8, 1, 4, 257, 256), False, None),          # config 5 agent rows
    ((2, 1, 1036, 515, 256), False, None),       # config 5 mixer rows
])
def test_flash_kernel_matches_plain(cuda_device, dtype, shape, causal, mask):
    b, h, tq, tk, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # Q1 scaling: q and k each carry head_dim**-0.25, as the module does
    q, k = (torch.randn(b, h, t, d, device=cuda_device, generator=g)
            * d ** -0.25 for t in (tq, tk))
    v = torch.randn(b, h, tk, d, device=cuda_device, generator=g)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    m = None
    if mask is not None:
        hm = h if mask == "per_head" else 1
        m = torch.rand(b, hm, tq, tk, device=cuda_device, generator=g) > 0.3
        if mask == "all_masked_row":
            m[:, :, 3] = False
    port.reset_launches()
    out = port.flash_attention(q, k, v, mask=m, causal=causal)
    torch.cuda.synchronize()
    assert port.LAUNCHES["flash_fwd"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    bias = None if m is None else torch.where(m, 0.0, port.NEG_MASK_VALUE)
    ref = port.flash_attention_reference(q, k, v, bias, causal)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    if mask == "all_masked_row":
        torch.testing.assert_close(out[:, :, 3].float(),
                                   v.float().mean(dim=2), **TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    """MultiHeadAttention hands over (B, T, H, D) projections transposed
    to (B, H, T, D): the kernel reads them in place, and writes its
    output in q's layout."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(16, 65, 4, 64, device=cuda_device, generator=g) * 0.35
    q = x.transpose(1, 2)
    out = port.flash_attention(q, q, q)
    assert out.stride() == q.stride()
    ref = port.flash_attention_reference(q, q, q)
    torch.testing.assert_close(out, ref, **TOL[torch.float32])


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 1, 4, 300, device=cuda_device)
    with pytest.raises(RuntimeError, match="head dim"):
        port.flash_attention(x, x, x)
    y = torch.zeros(1, 1, 4, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(RuntimeError, match="float32 or bfloat16"):
        port.flash_attention(y, y, y)


def _qkv(device, shape, dtype, seed, mask=None):
    b, h, tq, tk, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q, k = (torch.randn(b, h, t, d, device=device, generator=g)
            * d ** -0.25 for t in (tq, tk))
    v = torch.randn(b, h, tk, d, device=device, generator=g)
    do = torch.randn(b, h, tq, d, device=device, generator=g)
    m = None
    if mask is not None:
        hm = h if mask == "per_head" else 1
        m = torch.rand(b, hm, tq, tk, device=device, generator=g) > 0.3
        if mask == "all_masked_row":
            m[:, :, 3] = False
    return [x.to(dtype) for x in (q, k, v, do)] + [m]


#: gradients: f32 reassociation; bf16 one rounding of values of order
#: the gradient's scale
GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
            torch.bfloat16: dict(rtol=0.05, atol=0.02)}


@pytest.mark.cuda
def test_flash_attention_on_cuda_is_differentiable(cuda_device):
    """On CUDA tensors that require grad, flash_attention's output has a
    grad_fn and its gradients match the plain version's (the kernel's
    fresh output tensor used to cut the graph at attention)."""
    q, k, v, do, m = _qkv(cuda_device, (4, 2, 9, 11, 16), torch.float32, 2,
                          "broadcast")
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    out = port.flash_attention(*ins, mask=m)
    assert out.grad_fn is not None
    out.backward(do)
    ref_ins = [x.clone().requires_grad_() for x in (q, k, v)]
    bias = torch.where(m, 0.0, port.NEG_MASK_VALUE)
    port.flash_attention_reference(*ref_ins, bias).backward(do)
    for a, b in zip(ins, ref_ins):
        torch.testing.assert_close(a.grad, b.grad, **GRAD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,causal,mask", [
    ((16, 1, 4, 65, 256), False, None),          # learner agent rows
    ((2, 1, 268, 131, 256), False, None),        # learner mixer rows
    ((8, 4, 65, 65, 64), False, None),           # dense learner heads
    ((8, 2, 5, 7, 12), False, "broadcast"),      # odd shapes
    ((4, 3, 33, 70, 256), True, "per_head"),     # multi tile, D 256
    ((4, 2, 40, 40, 8), True, "all_masked_row"),
    ((8, 1, 4, 257, 256), False, None),          # config 5 agent rows
    ((2, 1, 1036, 515, 256), False, None),       # config 5 mixer rows
])
def test_flash_backward_kernels_match_plain(cuda_device, dtype, shape,
                                            causal, mask):
    """K1 + residuals, K2 and K3 against their plain versions."""
    q, k, v, do, m = _qkv(cuda_device, shape, dtype, 3, mask)
    bias = None if m is None else torch.where(m, 0.0, port.NEG_MASK_VALUE)
    port.reset_launches()
    o, mm, ll = port._launch_res(q, k, v, bias, causal)
    dq, dk, dv = port._launch_bwd(q, k, v, bias, causal, o, mm, ll, do)
    torch.cuda.synchronize()
    assert port.LAUNCHES == {"flash_fwd": 0, "flash_fwd_res": 1,
                             "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    o_r, m_r, l_r = port.flash_attention_fwd_reference(q, k, v, bias, causal)
    _assert_row_max_close(mm, m_r, q, k, v, bias, causal)
    torch.testing.assert_close(ll, l_r, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(o, o_r, **TOL[dtype])
    ref = port.flash_attention_bwd_reference(q, k, v, bias, causal, o_r,
                                             m_r, l_r, do)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == want.shape
        scale = max(float(want.float().abs().max()), 1.0)
        tol = dict(GRAD_TOL[dtype])
        tol["atol"] *= scale if dtype == torch.bfloat16 else 1.0
        torch.testing.assert_close(got.float(), want.float(), **tol)
    if mask == "all_masked_row":
        assert float(dq[:, :, 3].abs().max()) == 0.0


def _assert_row_max_close(mm, m_r, q, k, v, bias, causal):
    """m within 1e-5 relative of the plain version; on rows where that
    fails, within 1e-5 relative of the exact row max (the plain version
    in f64). A row whose max is near 0 puts two f32 summation orders
    more than 1e-5 apart, and the plain f32 value itself that far from
    exact; K1 + residuals writes the correctly rounded max at both
    dtypes."""
    rel = lambda a, b: (a.double() - b.double()).abs() / b.double().abs()
    off = rel(mm, m_r) > 1e-5
    if bool(off.any()):
        _, m64, _ = port.flash_attention_fwd_reference(
            q.double(), k.double(), v.double(), bias, causal)
        assert float(rel(mm, m64)[off].max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,mask,extra", [
    ((16, 1, 4, 65, 256), False, None, "k_is_v"),      # agent, k0 once
    ((2, 1, 268, 131, 256), False, None, "k_is_v"),    # mixer, k0 once
    ((4, 3, 33, 70, 12), True, "per_head", None),      # D 12: scalar staging
    ((8, 4, 65, 65, 64), True, "per_head", None),      # bf16 causal
    ((16, 1, 4, 65, 256), False, None, "negative"),    # pad-key trap, Tq 4
    ((4, 2, 268, 131, 64), False, None, "negative"),   # pad-key trap, Tq 268
], ids=["agent_k_is_v", "mixer_k_is_v", "d12_causal", "causal_per_head",
        "negative_agent", "negative_mixer"])
def test_bf16_tensor_core_kernels_at_their_edges(cuda_device, shape, causal,
                                                 mask, extra):
    """The bf16 K1 (both launches) and K3 tensor-core bodies against the
    plain versions where their tiling and staging have edges: Tq 4 and
    268 and Tk 65 and 131 (no multiple of 16), D 12 (rows not 16-byte
    aligned), k and v one tensor (staged once), causal with a per-head
    mask, and all-negative logits, where a zero-filled pad key would win
    every row's max if it entered the softmax."""
    dtype = torch.bfloat16
    q, k, v, do, m = _qkv(cuda_device, shape, dtype, 5, mask)
    if extra == "negative":
        q, k = q.abs(), -k.abs()
    if extra == "k_is_v":
        v = k
    bias = None if m is None else torch.where(m, 0.0, port.NEG_MASK_VALUE)
    out = port._launch(q, k, v, bias, causal)
    o, mm, ll = port._launch_res(q, k, v, bias, causal)
    dq, dk, dv = port._launch_bwd(q, k, v, bias, causal, o, mm, ll, do)
    torch.cuda.synchronize()
    o_r, m_r, l_r = port.flash_attention_fwd_reference(q, k, v, bias, causal)
    torch.testing.assert_close(out, o_r, **TOL[dtype])
    torch.testing.assert_close(o, o_r, **TOL[dtype])
    _assert_row_max_close(mm, m_r, q, k, v, bias, causal)
    torch.testing.assert_close(ll, l_r, rtol=1e-5, atol=0.0)
    if extra == "negative":
        assert bool((mm < 0).all())
    ref = port.flash_attention_bwd_reference(q, k, v, bias, causal, o_r,
                                             m_r, l_r, do)
    for got, want in zip((dq, dk, dv), ref):
        scale = max(float(want.float().abs().max()), 1.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=0.05,
                                   atol=0.02 * scale)


@pytest.mark.cuda
def test_bf16_strided_serve_views(cuda_device):
    """The serve path's (B, T, H, D) projections, transposed, in bf16:
    the tensor-core K1 takes 16-byte copies of the 128-byte rows in
    place and writes its output in q's layout."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = (torch.randn(3, 16, 65, 4, 64, device=cuda_device, generator=g)
         * 0.35).to(torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in x)
    out = port.flash_attention(q, k, v)
    assert out.stride() == q.stride()
    torch.testing.assert_close(out, port.flash_attention_reference(q, k, v),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_backward_shared_kv_and_strided_views(cuda_device):
    """The query-slice call: one tensor as keys and values, strided
    views in, strided dO; autograd sums dk and dv."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q = (torch.randn(6, 12, 64, device=cuda_device, generator=g) * 0.3)
    k0 = torch.randn(6, 20, 64, device=cuda_device, generator=g) * 0.3
    do = torch.randn(6, 64, 12, device=cuda_device, generator=g)
    grads = []
    for fn in ("kernel", "plain"):
        qq = q.clone().requires_grad_()
        kk = k0.clone().requires_grad_()
        if fn == "kernel":
            out = port.flash_attention(qq[:, None], kk[:, None], kk[:, None])
        else:
            out = port.flash_attention_reference(qq[:, None], kk[:, None],
                                                 kk[:, None])
        out.backward(do.transpose(1, 2)[:, None])
        grads.append((qq.grad, kk.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **GRAD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,mask,extra", [
    ((16, 1, 4, 65, 256), False, None, None),          # agent, Tq 4
    ((2, 1, 268, 131, 256), False, None, None),        # mixer, Tq 268
    ((16, 1, 4, 65, 256), False, None, "k_is_v"),      # agent, k once
    ((2, 1, 268, 131, 256), False, None, "k_is_v"),    # mixer, k once
    ((64, 4, 65, 65, 64), False, None, "strided"),     # serve views, Tq 65
    ((4, 3, 33, 70, 12), True, "per_head", None),      # D 12: scalar staging
    ((8, 4, 65, 65, 64), True, "per_head", None),      # dP - Delta cancels
    ((16, 1, 4, 65, 256), False, None, "negative"),    # pad-key trap, Tq 4
    ((4, 2, 268, 131, 64), False, None, "negative"),   # pad-key trap, Tq 268
    ((4, 2, 40, 40, 8), True, "all_masked_row", None),
    ((32, 1, 22, 19, 32), False, None, None),          # config 6 mixer, D 32
    ((32, 1, 22, 19, 32), False, None, "k_is_v"),      # as the mixer calls it
], ids=["agent", "mixer", "agent_k_is_v", "mixer_k_is_v", "serve_strided",
        "d12_causal", "causal_per_head", "negative_agent", "negative_mixer",
        "all_masked_row", "mixer6_d32", "mixer6_d32_k_is_v"])
def test_f32_kernels_at_their_edges(cuda_device, shape, causal, mask, extra):
    """The f32 K1 and K1 + residuals (FP64 tensor cores), K2 and K3
    (3xTF32 on the tensor cores) against the plain versions at the f32
    tolerances where their tiling, staging and arithmetic have edges: Tq
    4, 22, 65 and 268 and Tk 19, 65 and 131 (no multiple of 16), D 8, 12,
    32 (config 6's mixer), 64 and 256, k and v one tensor (staged once), the serve path's strided (B, T,
    H, D) views, causal with a per-head mask (rows with one real key,
    where dP - Delta cancels), all-negative logits (a zero-filled pad key
    would win the row max and give exp(-m)/l > 1) and the all-masked row
    (uniform output, m = -1e9, l = Tk, dq exactly 0). One launch of each
    kernel."""
    q, k, v, do, m = _qkv(cuda_device, shape, torch.float32, 8, mask)
    if extra == "negative":
        q, k = q.abs(), -k.abs()
    if extra == "k_is_v":
        v = k
    if extra == "strided":
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in (q, k, v))
    bias = None if m is None else torch.where(m, 0.0, port.NEG_MASK_VALUE)
    port.reset_launches()
    out = port._launch(q, k, v, bias, causal)
    o, mm, ll = port._launch_res(q, k, v, bias, causal)
    dq, dk, dv = port._launch_bwd(q, k, v, bias, causal, o, mm, ll, do)
    torch.cuda.synchronize()
    assert port.LAUNCHES == {"flash_fwd": 1, "flash_fwd_res": 1,
                             "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    o_r, m_r, l_r = port.flash_attention_fwd_reference(q, k, v, bias, causal)
    assert out.stride() == q.stride() and o.stride() == q.stride()
    torch.testing.assert_close(out, o_r, **TOL[torch.float32])
    torch.testing.assert_close(o, o_r, **TOL[torch.float32])
    _assert_row_max_close(mm, m_r, q, k, v, bias, causal)
    torch.testing.assert_close(ll, l_r, rtol=1e-5, atol=0.0)
    if extra == "negative":
        assert bool((mm < 0).all())
    want = port.flash_attention_bwd_reference(q, k, v, bias, causal, o_r,
                                              m_r, l_r, do)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        torch.testing.assert_close(got, ref, **GRAD_TOL[torch.float32])
    if mask == "all_masked_row":
        torch.testing.assert_close(out[:, :, 3], v.mean(dim=2),
                                   **TOL[torch.float32])
        assert bool((mm[:, :, 3] == port.NEG_MASK_VALUE).all())
        assert bool((ll[:, :, 3] == shape[3]).all())
        assert float(dq[:, :, 3].abs().max()) == 0.0


# ---------------------------------------------------------------- the loop

def _loop_cfg(**model):
    from t2omca_tpu_torch.config import from_dict
    return from_dict({
        "batch_size_run": 4, "batch_size": 4, "epsilon_anneal_time": 100,
        "env_args": {"agv_num": 4, "mec_num": 2, "num_channels": 2,
                     "episode_limit": 12},
        "model": dict({"emb": 16, "heads": 2, "depth": 1, "mixer_emb": 16,
                       "mixer_heads": 2, "mixer_depth": 1,
                       "use_entity_tables": False}, **model),
        "replay": {"buffer_size": 8}, "kernels": {"attention": "pallas"}})


@pytest.mark.cuda
def test_threefry_on_cuda_equals_cpu_bit_for_bit(cuda_device):
    """The integer hash and every sampler built on its bits: CUDA equals
    the CPU (which the CPU tests hold against JAX)."""
    from t2omca_tpu_torch import prng
    for dev_keys in ((prng.PRNGKey(s, "cpu") for s in (0, 1, 2 ** 31 - 1)),
                     (prng.split(prng.PRNGKey(5, "cpu"), 128),)):
        for key in dev_keys:
            kc = key.to(cuda_device)
            for f in (lambda k: prng.split(k, 150),
                      lambda k: prng.fold_in(k, 0x5CE7),
                      lambda k: prng.random_bits(k, (64, 9)),
                      lambda k: prng.uniform(k, (64,)),
                      lambda k: prng.uniform(k, (64,), 4000.0, 12000.0),
                      lambda k: prng.uniform(k, (64,), 0.0, 6.2831855),
                      lambda k: prng.bernoulli(k, 0.5, (64,)),
                      lambda k: prng.randint(k, (64,), 0, 8)):
                assert torch.equal(f(kc).cpu(), f(key))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 65, 256), (32, 131, 256),
                                   (3, 5, 7), (1,)])
@pytest.mark.parametrize("keep", [0.9, 0.5])
def test_dropout_mask_kernel_matches_plain(cuda_device, shape, keep):
    """The dropout-mask kernel against ``prng.fold_in`` and
    ``prng.bernoulli`` bit for bit (the learner's agent and mixer shapes,
    a ragged tail), counted once a launch, and captured into a CUDA graph
    whose replay reads the key the static input holds."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.kernels import dropout as dk
    keys = prng.split(prng.PRNGKey(7, cuda_device), 3)
    folds = (0, 0x9E3779B9, 2 ** 32 - 1)
    dk.reset_launches()
    for key, fold in zip(keys.unbind(0), folds):
        got = dk.keep_mask(key, fold, keep, shape)
        assert got.dtype == torch.bool and got.shape == shape
        assert torch.equal(got, prng.bernoulli(prng.fold_in(key, fold),
                                               keep, shape))
    assert dk.LAUNCHES["dropout_mask"] == 3
    static = keys[0].clone()
    dk.keep_mask(static, 5, keep, shape)         # load the library first
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = dk.keep_mask(static, 5, keep, shape)
    static.copy_(keys[2])
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, prng.bernoulli(prng.fold_in(keys[2], 5), keep,
                                           shape))
    with pytest.raises(ValueError, match="int64 \\(2,\\)"):
        dk.keep_mask(keys, 0, keep, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_philox_on_cuda_equals_cpu_bit_for_bit(cuda_device, impl):
    """The rbg impls' draws (XLA's CPU Philox stream, int64 products that
    wrap) on the card equal the CPU's, the 128-bit carry keys too."""
    from t2omca_tpu_torch import prng
    keys = [prng.PRNGKey(3, "cpu", impl),
            torch.tensor([0xDEADBEEF, 7, 0xFFFFFFFF, 0xFFFFFFFF]),
            torch.tensor([1, 2, 0xFFFFFFFE, 0xFFFFFFFF])]
    for key in keys:
        kc = key.to(cuda_device)
        for f in (lambda k: prng.split(k, 150, impl),
                  lambda k: prng.fold_in(k, 0x5CE7, impl),
                  lambda k: prng.random_bits(k, (64, 9)),
                  lambda k: prng.random_bits(prng.split(k, 6, impl), (5,)),
                  lambda k: prng.uniform(k, (64,), 4000.0, 12000.0),
                  lambda k: prng.bernoulli(k, 0.5, (64,)),
                  lambda k: prng.randint(k, (64,), 0, 8, impl)):
            assert torch.equal(f(kc).cpu(), f(key))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
@pytest.mark.parametrize("shape,per", [((2048, 65, 256), 64),
                                       ((32, 131, 256), 1),
                                       ((8192, 65, 256), 64),
                                       ((6, 5, 7), 3), ((1,), 1)])
def test_dropout_mask_philox_path_matches_plain(cuda_device, impl, shape,
                                                per):
    """The kernel's Philox path (4-word keys) against its plain version
    bit for bit, with and without a rank's row map (lanes ``1, 3, ...``,
    each lane's rows together: rows of 35 elements start inside a
    block), carry keys included, counted under ``dropout_mask_philox``, a
    population member's key (``prng.seat``) giving its rows of member 0's
    draw, and captured into a graph whose replay reads the static key."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.flax_rng import Rows
    from t2omca_tpu_torch.kernels import dropout as dk
    keys = [prng.split(prng.PRNGKey(7, cuda_device, impl), 2, impl)[1],
            torch.tensor([5, 6, 0xFFFFFFFF, 0xFFFFFFFF],
                         device=cuda_device)]
    dk.reset_launches()
    for key in keys:
        for fold in (0, 0x9E3779B9, 2 ** 32 - 1):
            got = dk.keep_mask(key, fold, 0.9, shape, impl=impl)
            assert got.shape == shape
            assert torch.equal(got, dk.keep_mask_reference(
                key, fold, 0.9, shape, impl=impl))
    assert dk.LAUNCHES["dropout_mask_philox"] == 6
    assert dk.LAUNCHES["dropout_mask"] == 0
    key, fold = keys[0], 0x9E3779B9
    if shape[0] >= 2 * per:
        whole = dk.keep_mask(key, fold, 0.9, shape, impl=impl)
        lanes = shape[0] // per
        rows, _ = Rows(torch.arange(1, lanes, 2, device=cuda_device),
                       lanes).of(shape[0] // 2)
        got = dk.keep_mask(key, fold, 0.9, shape, rows, impl)
        assert torch.equal(got, whole[rows])
        assert torch.equal(got, dk.keep_mask_reference(key, fold, 0.9,
                                                       shape, rows, impl))
    # a population member's key: its rows of member 0's draw over 2
    doubled = dk.keep_mask(key, fold, 0.9, (2 * shape[0],) + shape[1:],
                           impl=impl)
    assert torch.equal(dk.keep_mask(prng.seat(key, 1), fold, 0.9, shape,
                                    impl=impl), doubled[shape[0]:])
    assert torch.equal(dk.keep_mask_reference(prng.seat(key, 1), fold, 0.9,
                                              shape, impl=impl),
                       doubled[shape[0]:])
    static = key.clone()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = dk.keep_mask(static, fold, 0.9, shape, impl=impl)
    static.copy_(keys[1])
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, dk.keep_mask_reference(keys[1], fold, 0.9,
                                                   shape, impl=impl))


@pytest.mark.cuda
def test_sp_mixer_on_two_streams_matches_the_dense_mixer(cuda_device):
    """``mixer_apply_sp`` with 2 placements as streams of the card
    against the dense mixer forward (a token count the placements do not
    divide, so one block ends in padding), and ``ring_attention``'s
    gradient through the streams against the dense one's."""
    from t2omca_tpu_torch.models.mixer import TransformerMixer
    from t2omca_tpu_torch.parallel import (mixer_apply_sp, ring_attention,
                                           sp_placements)
    from t2omca_tpu_torch.parallel.ring_attention import gather, scatter
    g = torch.Generator().manual_seed(0)
    m = TransformerMixer(6, 6, 8, 32, 2, 2, zero_init_gate=True)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    m = m.to(cuda_device)
    x = [torch.randn(s, generator=g).to(cuda_device)
         for s in ((4, 1, 6), (4, 6, 32), (4, 3, 32), (4, 48), (4, 6, 8))]
    places = sp_placements(2, cuda_device, share_cards=True)
    assert all(p.stream is not None for p in places)
    with torch.no_grad():
        y, h = m(*x)
        ys, hs = mixer_apply_sp(m, *x, places)
    torch.cuda.synchronize()
    torch.testing.assert_close(ys, y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hs, h, atol=1e-4, rtol=1e-4)
    q, k, v = (torch.randn(2, 3, 30, 16, generator=g).to(cuda_device)
               for _ in range(3))
    q.requires_grad_()
    cut = lambda t: scatter(list(t.tensor_split(2, dim=2)), places)
    out = ring_attention(cut(q), cut(k), cut(v), places)
    out = torch.cat(gather(out, places, cuda_device), dim=2)
    (gq,) = torch.autograd.grad(out.sum(), q)
    ref = torch.softmax(q @ k.transpose(-1, -2), -1) @ v
    (gr,) = torch.autograd.grad(ref.sum(), q)
    torch.cuda.synchronize()
    torch.testing.assert_close(gq, gr, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,shape,per", [
    ("block", (2048, 65, 256), 64), ("block", (32, 131, 256), 1),
    ("lanes", (8192, 65, 256), 64), ("lanes", (6, 5, 7), 3)])
def test_dropout_mask_kernel_with_a_row_map(cuda_device, layout, shape, per):
    """The dropout-mask kernel with a data-parallel rank's row map (its
    block of the learner's batch, or its lanes ``r, r + 2, ...`` of the
    rollout's, each lane's agent rows together) against those rows of its
    whole mask and its plain version with the map, bit for bit, for both
    ranks of 2; the map read from device memory in a captured graph."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.flax_rng import Rows
    from t2omca_tpu_torch.kernels import dropout as dk
    key = prng.split(prng.PRNGKey(9, cuda_device))[1]
    fold, keep = 0x9E3779B9, 0.9
    whole = dk.keep_mask(key, fold, keep, shape)
    batch = shape[0] // per
    for r in range(2):
        own = (torch.arange(r * batch // 2, (r + 1) * batch // 2,
                            device=cuda_device) if layout == "block" else
               torch.arange(r, batch, 2, device=cuda_device))
        rows, total = Rows(own, batch).of(shape[0] // 2)
        assert total == shape[0]
        got = dk.keep_mask(key, fold, keep, shape, rows)
        assert torch.equal(got, whole[rows])
        assert torch.equal(got, dk.keep_mask_reference(key, fold, keep,
                                                       shape, rows))
    static = rows.clone()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = dk.keep_mask(key, fold, keep, shape, static)
    first = whole[:static.numel()].clone()
    static.copy_(torch.arange(static.numel(), device=cuda_device))
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_norm", [False, True])
def test_env_step_on_cuda_matches_cpu(cuda_device, fast_norm):
    """One reset and one step from the same state, actions and keys:
    discrete fields exact, floats at the CPU tests' rtol/atol 1e-5."""
    import dataclasses
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import EnvConfig
    from t2omca_tpu_torch.envs.mec_offload import MultiAgvOffloadingEnv
    cfg = EnvConfig(agv_num=16, mec_num=4, num_channels=4,
                    fast_norm=fast_norm)
    envs = {d: MultiAgvOffloadingEnv(cfg, device=d)
            for d in ("cpu", cuda_device)}
    keys = prng.split(prng.PRNGKey(0, "cpu"), 8)
    out = {d: e.reset(keys.to(d)) for d, e in envs.items()}
    acts = out["cpu"][3].float().argmax(-1).to(torch.int32)
    skeys = prng.split(prng.PRNGKey(1, "cpu"), 8)
    step = {d: envs[d].step(out[d][0], acts.to(d), skeys.to(d),
                            envs[d].default_params(8)) for d in envs}

    def same(a, b):
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                same(getattr(a, f.name), getattr(b, f.name))
        elif a.dtype.is_floating_point:
            torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(a, b.cpu())

    for a, b in zip(step["cpu"], step[cuda_device]):
        same(a, b)


@pytest.mark.cuda
def test_one_loop_iteration_on_cuda(cuda_device):
    """Rollout → insert → train at small widths through the kernels:
    finite loss, every stored action available."""
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.run import Experiment, run_classic
    exp = Experiment.build(_loop_cfg(), device=cuda_device)
    ts = exp.init_state(0)
    att.reset_launches()
    ts, cursor, (rec,) = run_classic(exp, ts, 1)
    assert rec.info is not None and bool(rec.info["all_finite"])
    assert torch.isfinite(rec.info["loss"]).item()
    assert att.LAUNCHES["flash_bwd_dkv"] > 0
    st = ts.buffer.storage
    taken = torch.gather(st.avail_actions[:4, :-1], -1,
                         st.actions[:4].long().unsqueeze(-1))
    assert bool(taken.all()) and cursor.t_env == 4 * 12


@pytest.mark.cuda
def test_dp_world_1_over_nccl_equals_the_plain_path(cuda_device,
                                                    monkeypatch):
    """The data-parallel code at world 1 over NCCL (the reference of
    ``chip_smoke.py``'s ``[dp]``) against the one-process path on the
    card: one iteration through the kernels, every leaf bit for bit."""
    from t2omca_tpu_torch.parallel import distributed
    from t2omca_tpu_torch.parallel.mesh import RankComm
    from t2omca_tpu_torch.run import Experiment, run_classic
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    cfg = _loop_cfg()
    exp = Experiment.build(cfg, device=cuda_device)
    plain, _, _ = run_classic(exp, exp.init_state(0), 1)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(distributed.free_port())).items():
        monkeypatch.setenv(k, v)
    assert distributed.maybe_initialize_distributed()
    try:
        assert distributed.backend() == "nccl"
        dp = Experiment.build(cfg.replace(dp_devices=1),
                              distributed.rank_device(), comm=RankComm())
        ts, _, _ = run_classic(dp, dp.init_state(0), 1)     # born sharded
        a, b = flatten_state(plain)[0], flatten_state(ts)[0]
        assert [k for k in a if not torch.equal(a[k], b[k])] == []
    finally:
        distributed.shutdown()


# --------------------------------------------------- the default fast stack

def _entity_setup(cuda_device, dtype, noisy=False):
    """A MAC on the default stack and a few env steps at small widths on
    the card: → (exp, params, dense obs, compact obs, avail)."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.run import Experiment
    cfg = from_dict({
        "batch_size_run": 4, "batch_size": 4,
        "action_selector": "noisy-new" if noisy else "epsilon_greedy",
        "env_args": {"agv_num": 16, "mec_num": 4, "num_channels": 4,
                     "episode_limit": 12},
        "model": {"emb": 64, "heads": 4, "depth": 2, "mixer_emb": 64,
                  "mixer_heads": 4, "mixer_depth": 2,
                  "standard_heads": True, "dtype": dtype},
        "replay": {"buffer_size": 8}})
    exp = Experiment.build(cfg, device=cuda_device)
    assert exp.mac.use_entity_tables
    env = exp.env
    state, (dense, compact), _, avail = env.reset(
        prng.split(prng.PRNGKey(0, cuda_device), 4), obs_form="both")
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for i in range(3):
        acts = torch.where(avail > 0, torch.rand(avail.shape, device=cuda_device,
                                                 generator=g), -1.0).argmax(-1)
        state, _, _, _, (dense, compact), _, avail = env.step(
            state, acts, prng.split(prng.PRNGKey(10 + i, cuda_device), 4),
            env.default_params(4), obs_form="both")
    params = exp.mac.init_params(torch.Generator().manual_seed(0))
    return exp, params, dense, compact, avail


@pytest.mark.cuda
def test_entity_forward_matches_query_slice_on_cuda(cuda_device):
    """The entity-table forward against the query-slice forward on the
    env's dense obs, on the card at f32: q and h within rtol 2e-4 / atol
    2e-5 (tests/test_entity_tables.py's bound); it launches no flash
    kernel."""
    exp, params, dense, compact, _ = _entity_setup(cuda_device, "float32")
    hidden = torch.randn(4, 16, 64, device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(2))
    port.reset_launches()
    q_ent, h_ent = exp.mac.forward_entity(params, compact, hidden)
    assert sum(port.LAUNCHES.values()) == 0
    q_obs, h_obs = exp.mac.forward_qslice(params, dense, hidden)
    torch.testing.assert_close(q_ent, q_obs, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(h_ent, h_obs, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_noisy_select_actions_on_cuda(cuda_device):
    """One noisy ``select_actions`` on CUDA tensors through the entity
    tables: legal actions, the same actions as the CPU from the same key
    and inputs, and the mu head (test mode) differs in q."""
    from t2omca_tpu_torch import prng
    exp, params, _, compact, avail = _entity_setup(cuda_device, "float32",
                                                   noisy=True)
    mac = exp.mac
    key = prng.PRNGKey(7, cuda_device)
    hidden = mac.init_hidden(4)
    acts, h, _ = mac.select_actions(params, None, avail, hidden, key,
                                    compact=compact)
    assert acts.device.type == "cuda" and acts.shape == (4, 16)
    taken = torch.gather(avail, -1, acts.long().unsqueeze(-1))
    assert bool((taken > 0).all())
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    acts_cpu, _, _ = mac.select_actions(
        {k: v.cpu() for k, v in params.items()}, None, avail.cpu(),
        hidden.cpu(), key.cpu(), compact=tuple(map(cpu, compact)))
    assert torch.equal(acts.cpu(), acts_cpu)
    k_noise = prng.split(key)[0]
    q_noisy, _ = mac.forward_entity(params, compact, hidden, key=k_noise,
                                    deterministic=False)
    q_mu, _ = mac.forward_entity(params, compact, hidden)
    assert not torch.equal(q_noisy, q_mu)


# --------------------------------------------------- the driver's state

@pytest.mark.cuda
def test_checkpoint_round_trip_of_a_cuda_train_state(cuda_device, tmp_path):
    """A CUDA ``TrainState`` after one iteration saves to CPU tensors and
    loads back onto the card bit for bit, host values included."""
    from t2omca_tpu_torch.run import Experiment, run_classic
    from t2omca_tpu_torch.utils.checkpoint import (find_checkpoint,
                                                   flatten_state,
                                                   load_checkpoint,
                                                   save_checkpoint)
    exp = Experiment.build(_loop_cfg(), device=cuda_device)
    ts, _, _ = run_classic(exp, exp.init_state(0), 1)
    save_checkpoint(str(tmp_path), 48, ts)
    dirname, step = find_checkpoint(str(tmp_path))
    restored = load_checkpoint(dirname, exp.init_state(1))
    a, ha = flatten_state(ts)
    b, hb = flatten_state(restored)
    assert step == 48 and ha == hb and set(a) == set(b)
    assert all(v.device.type == "cuda" for v in b.values())
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
def test_memwatch_reads_the_card(cuda_device):
    from t2omca_tpu_torch.obs.memwatch import MemWatch
    mw = MemWatch()
    x = torch.empty(1 << 20, device=cuda_device)
    snap = mw.snapshot("startup", t_env=0)
    report = mw.report()
    assert report["supported"] is True and snap
    dev = report["devices"]["0"]
    assert dev["bytes_in_use"] >= x.numel() * 4
    assert dev["high_water_bytes"] >= dev["bytes_in_use"]
    assert dev["high_water_phase"] == "startup"


# ------------------------------------------- learning-health probes, remat

def _one_iteration(cuda_device, **over):
    """One classic iteration on the card from seed 0 → (state, info,
    launches)."""
    import dataclasses
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.run import Experiment, run_classic
    cfg = _loop_cfg(use_entity_tables=True)
    for sect, kw in over.items():
        cfg = dataclasses.replace(cfg, **{sect: dataclasses.replace(
            getattr(cfg, sect), **kw)})
    exp = Experiment.build(cfg, device=cuda_device)
    att.reset_launches()
    ts, _, (rec,) = run_classic(exp, exp.init_state(0), 1)
    torch.cuda.synchronize()
    return ts, rec.info, dict(att.LAUNCHES)


def _same_learner(a, b):
    for tree in ("params", "target_params"):
        ta, tb = getattr(a.learner, tree), getattr(b.learner, tree)
        for m in ta:
            for k in ta[m]:
                assert torch.equal(ta[m][k], tb[m][k]), (tree, m, k)


@pytest.mark.cuda
def test_sight_on_cuda_changes_no_bit_and_reads_sane(cuda_device):
    """obs.sight on the card: the iteration's state bit-identical to the
    gate off, the same kernel launches, the probes finite (histograms
    sum to 1, entropies in [0, 1]); the histogram on the card equals
    the CPU's on the same values."""
    from t2omca_tpu_torch.config import SightConfig
    from t2omca_tpu_torch.obs import sight
    off, _, l_off = _one_iteration(cuda_device)
    on, info, l_on = _one_iteration(
        cuda_device, obs={"sight": SightConfig(enabled=True)})
    _same_learner(off, on)
    assert torch.equal(off.buffer.priorities, on.buffer.priorities)
    assert l_on == l_off
    for k, v in info.items():
        if k.startswith("sight_"):
            assert bool(torch.isfinite(v).all()), k
            if k.endswith("_hist"):
                assert abs(float(v.sum()) - 1.0) < 1e-5, k
            if k.startswith("sight_attn_entropy"):
                assert bool(((v >= 0) & (v <= 1 + 1e-6)).all()), k
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 20
    m = torch.rand(4096, generator=torch.Generator().manual_seed(1)) < 0.7
    assert torch.equal(sight.masked_histogram(x.to(cuda_device),
                                              m.to(cuda_device), -10.0,
                                              10.0, 16).cpu(),
                       sight.masked_histogram(x, m, -10.0, 10.0, 16))


@pytest.mark.cuda
def test_remat_on_cuda_is_bit_identical_and_reruns_k1_res(cuda_device):
    """model.remat on the card: the same update bit for bit, K1 +
    residuals launched twice per online mixer step, K1, K2 and K3 as
    without remat."""
    off, i_off, l_off = _one_iteration(cuda_device)
    on, i_on, l_on = _one_iteration(cuda_device, model={"remat": True})
    _same_learner(off, on)
    assert torch.equal(i_off["loss"], i_on["loss"])
    assert torch.equal(i_off["grad_norm"], i_on["grad_norm"])
    assert l_on["flash_fwd_res"] == 2 * l_off["flash_fwd_res"] > 0
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert l_on[k] == l_off[k], k


# ------------------------------------------------- the fused superstep

def _fused_dispatch(exp, sup, ts, mirror):
    """One fused dispatch the driver's way: the host mirror of the
    counters gates each sub-iteration and the driver key splits only for
    the gated ones → (ts', stats, infos)."""
    from t2omca_tpu_torch import prng
    cfg = exp.cfg
    rows, gated = [], []
    for _ in range(sup.k):
        mirror["episode"] += cfg.batch_size_run
        mirror["filled"] = min(mirror["filled"] + cfg.batch_size_run,
                               cfg.replay.buffer_size)
        gated.append(mirror["filled"] >= cfg.batch_size
                     and mirror["episode"] >= cfg.accumulated_episodes)
        if gated[-1]:
            mirror["key"], k_sample = prng.split(mirror["key"]).unbind(0)
            rows.append(k_sample)
        else:
            rows.append(torch.zeros_like(mirror["key"]))
    out = sup(ts, torch.stack(rows), mirror["t_env"], gated)
    mirror["t_env"] += (sup.k * cfg.batch_size_run
                        * cfg.env_args.episode_limit)
    return out


@pytest.mark.cuda
def test_superstep_graphs_replay_the_eager_iterations(cuda_device):
    """The fused program on the card at small widths (the default stack,
    PER, pallas, obs.sight on). The first dispatch is the process's eager
    warm-up (where no stage ran before); the next captures both stages
    and replays them: bit-identical to K eager ``run_classic`` iterations
    from one state (learner, ring, priorities, runner, counters, stats,
    infos), with the eager iterations' kernel launches. A dispatch of
    replays makes no host sync and keeps every state tensor at its
    address, and a state handed in with other tensors (a restore) is
    written into the captured buffers: it replays to the same result."""
    import dataclasses
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.run import Experiment, LoopCursor, run_classic
    from t2omca_tpu_torch.train.superstep import clone_state
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    cfg = _loop_cfg(use_entity_tables=True)
    cfg = dataclasses.replace(cfg, obs=dataclasses.replace(
        cfg.obs, sight=dataclasses.replace(cfg.obs.sight, enabled=True)))
    exp = Experiment.build(cfg, device=cuda_device)
    ts = exp.init_state(0)
    sup = exp.superstep_program(3)
    mirror = {"key": prng.PRNGKey(1, cuda_device), "t_env": 0,
              "episode": 0, "filled": 0}
    ts, _, _ = _fused_dispatch(exp, sup, ts, mirror)
    start = dict(mirror)
    ref = clone_state(ts)
    att.reset_launches()
    ref, cursor, recs = run_classic(exp, ref, 3, LoopCursor(
        key=start["key"], t_env=start["t_env"], episode=start["episode"],
        buffer_filled=start["filled"]))
    torch.cuda.synchronize()
    eager = dict(att.LAUNCHES)
    att.reset_launches()
    ts, stats, infos = _fused_dispatch(exp, sup, ts, mirror)
    torch.cuda.synchronize()
    assert set(sup.graphs) == {"rollout", "train"}
    assert dict(att.LAUNCHES) == eager and eager["flash_bwd_dkv"] > 0
    assert sum(sup.launches["rollout"].values()) == 0
    assert {k: 3 * v for k, v in sup.launches["train"].items()} == eager
    a, ha = flatten_state(ts)
    b, hb = flatten_state(ref)
    assert ha == hb and set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(cursor.key, mirror["key"])
    for i, rec in enumerate(recs):
        for f in dataclasses.fields(stats):
            got = getattr(stats, f.name)[i]
            want = getattr(rec.stats, f.name)
            assert torch.equal(got.cpu(), want.reshape(got.shape).cpu()), \
                f.name
        for k, v in rec.info.items():
            assert torch.equal(infos[k][i], v), k
    del ref, recs
    ptrs = {k: v.data_ptr() for k, v in a.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts2, _, infos = _fused_dispatch(exp, sup, ts, mirror)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ts2 is ts and bool(infos["all_finite"].all())
    assert {k: v.data_ptr() for k, v in flatten_state(ts)[0].items()} \
        == ptrs
    saved, at = clone_state(ts), dict(mirror)
    once = flatten_state(clone_state(_fused_dispatch(exp, sup, ts,
                                                     mirror)[0]))[0]
    again = _fused_dispatch(exp, sup, saved, at)[0]
    assert again is ts
    for k, v in flatten_state(again)[0].items():
        assert v.data_ptr() == ptrs[k] and torch.equal(v, once[k]), k


# ------------------------------------------- serving artifact, scenarios

@pytest.mark.cuda
def test_serve_artifact_loads_on_cuda(cuda_device, tmp_path):
    """A checkpoint of a small model exported on the card and loaded on
    it: the f32 variant's actions and hiddens equal an in-memory front end
    built from the same agent leaves, bit for bit; with
    ``use_qslice=false`` and ``pallas`` a dispatch launches K1 once a
    block; a tampered blob is refused."""
    import numpy as np
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.serve.export import export_artifact
    from t2omca_tpu_torch.serve.frontend import ServeFrontend
    from t2omca_tpu_torch.utils.checkpoint import save_checkpoint
    d = {"batch_size_run": 2, "batch_size": 2,
         "env_args": {"agv_num": 4, "mec_num": 2, "num_channels": 2,
                      "episode_limit": 4},
         "model": {"emb": 16, "heads": 2, "depth": 2, "mixer_emb": 16,
                   "mixer_heads": 2, "mixer_depth": 1},
         "replay": {"buffer_size": 4}}
    cfg = from_dict(d)
    exp = Experiment.build(cfg, device=cuda_device)
    ts = exp.init_state(0)
    save_checkpoint(str(tmp_path / "models"), 8, ts)
    agent = {k: v.clone() for k, v in ts.learner.params["agent"].items()}
    rng = np.random.default_rng(0)
    for tag, over in (("qslice", {}),
                      ("dense", {"use_qslice": False})):
        c = from_dict(dict(d, model=dict(d["model"], **over),
                           kernels={"attention": "pallas"}))
        art = str(tmp_path / tag)
        export_artifact(c, str(tmp_path / "models"), art, buckets=(1, 4))
        fe = ServeFrontend.load(art, device=cuda_device)
        mem = ServeFrontend(c, agent, (1, 4), device=cuda_device)
        obs = rng.standard_normal((4, 4, fe.obs_dim)).astype(np.float32)
        avail = rng.random((4, 4, fe.n_actions)) < 0.7
        avail[..., 0] = True
        port.reset_launches()
        a1, h1 = fe.select(obs, avail)
        assert port.LAUNCHES["flash_fwd"] == (0 if tag == "qslice" else 2)
        a2, h2 = mem.select(obs, avail)
        assert (a1 == a2).all() and (h1 == h2).all()
        ServeFrontend.load(art, dtype="bfloat16", device=cuda_device)
    blob = bytearray(open(tmp_path / "dense" / "params_float32.pt",
                          "rb").read())
    blob[-20] ^= 1
    open(tmp_path / "dense" / "params_float32.pt", "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="integrity"):
        ServeFrontend.load(str(tmp_path / "dense"), device=cuda_device)


@pytest.mark.cuda
def test_mixture_draw_on_cuda_equals_cpu(cuda_device):
    """Config 6's mixture (four families, min_agents 4) sampled from the
    same lane keys on the card and on the CPU: every EnvParams leaf
    equal."""
    import dataclasses
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import EnvConfig, ScenarioConfig
    from t2omca_tpu_torch.envs.graftworld import make_distribution
    from t2omca_tpu_torch.envs.registry import make_env
    dist = make_distribution(ScenarioConfig(kind="mixture", min_agents=4))
    cfg = EnvConfig(agv_num=8, mec_num=2, num_channels=2)
    keys = prng.split(prng.PRNGKey(5, "cpu"), 256)
    cpu = dist.sample(keys, make_env(cfg, device="cpu"))
    gpu = dist.sample(keys.to(cuda_device), make_env(cfg,
                                                     device=cuda_device))
    for f in dataclasses.fields(cpu):
        assert torch.equal(getattr(gpu, f.name).cpu(),
                           getattr(cpu, f.name)), f.name
    assert len(set(cpu.family.tolist())) == 4


# ------------------------------------------------------------ the population

def _population(cuda_device, p, **pop):
    """A population of ``p`` on ``_loop_cfg``'s small widths (the default
    stack, PER, pallas, K = 2) with its program and mirror."""
    import dataclasses
    from t2omca_tpu_torch import population as popmod
    from t2omca_tpu_torch.config import sanity_check
    from t2omca_tpu_torch.run import Experiment
    cfg = _loop_cfg(use_entity_tables=True)
    cfg = sanity_check(dataclasses.replace(
        cfg, superstep=2, population=dataclasses.replace(
            cfg.population, size=p, **pop)))
    exp = Experiment.build(cfg, device=cuda_device)
    pts, spec = popmod.init_population(exp, cfg)
    prog = exp.population_superstep_program(2)
    mirror = {"keys": popmod.member_keys(cfg, cuda_device), "t_env": 0,
              "episode": 0, "filled": 0}
    return exp, pts, spec, prog, mirror


def _pop_dispatch(exp, prog, pts, spec, mirror, serial=False):
    """One population dispatch the driver's way (one gate mirror, each
    member's key split as the solo one) → (pts', stats, infos, gates)."""
    from t2omca_tpu_torch import prng
    cfg = exp.cfg
    rows, gated = [], []
    for _ in range(prog.k):
        mirror["episode"] += cfg.batch_size_run
        mirror["filled"] = min(mirror["filled"] + cfg.batch_size_run,
                               cfg.replay.buffer_size)
        gated.append(mirror["filled"] >= cfg.batch_size)
        row = []
        for m, key in enumerate(mirror["keys"]):
            if gated[-1]:
                mirror["keys"][m], k_s = prng.split(key).unbind(0)
                row.append(k_s)
            else:
                row.append(torch.zeros_like(key))
        rows.append(torch.stack(row))
    out = prog(pts, torch.stack(rows, 1), mirror["t_env"], gated, spec,
               serial=serial)
    mirror["t_env"] += (prog.k * cfg.batch_size_run
                        * cfg.env_args.episode_limit)
    return out + (gated,)


def _snapshot(pts, stats, infos):
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    out = {f"{m}.{k}": v.clone() for m, t in enumerate(pts)
           for k, v in flatten_state(t)[0].items()}
    out.update({f"stats.{k}": v.clone()
                for k, v in flatten_state(stats)[0].items()})
    out.update({f"info.{k}": v.clone() for k, v in infos.items()})
    return out


@pytest.mark.cuda
def test_population_overlapped_replay_equals_serial(cuda_device):
    """Three members with an lr, epsilon and PER-exponent grid and the
    scenario salt, each replaying its own graphs on its own stream: a
    dispatch with the members overlapped is bit-identical to the same
    dispatch with the members run one after another (each synced), from
    one state (params, Adam, rings, priorities, runners, stats, infos),
    and makes no host sync."""
    from t2omca_tpu_torch.train.superstep import clone_state
    exp, pts, spec, prog, mirror = _population(
        cuda_device, 3, lr=(1e-4, 5e-4, 2e-3), eps_scale=(1.0, 0.5, 2.0),
        per_alpha=(0.4, 0.6, 0.9), scenario_salt=True)
    for _ in range(3):          # warm-up where needed, captures, replays
        pts, _, _, _ = _pop_dispatch(exp, prog, pts, spec, mirror)
    assert all(set(m.graphs) == {"rollout", "train"} for m in prog.members)
    assert len({m.stream.cuda_stream for m in prog.members}) == 3
    start, at = [clone_state(t) for t in pts], dict(
        mirror, keys=list(mirror["keys"]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _pop_dispatch(exp, prog, pts, spec, mirror)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    overlapped = _snapshot(*out[:3])
    assert bool(out[2]["all_finite"].all())
    serial = _snapshot(*_pop_dispatch(exp, prog, start, spec, at,
                                      serial=True)[:3])
    assert set(overlapped) == set(serial)
    for k, v in overlapped.items():
        assert torch.equal(v, serial[k]), k


@pytest.mark.cuda
def test_population_dispatch_launch_counts(cuda_device):
    """A P = 2 dispatch of replays launches each kernel P times a gated
    sub-iteration's train replay, and a train replay launches what one
    eager train step launches."""
    from t2omca_tpu_torch.kernels import attention as att
    from t2omca_tpu_torch.run import run_classic
    exp, pts, spec, prog, mirror = _population(cuda_device, 2)
    for _ in range(3):
        pts, _, _, _ = _pop_dispatch(exp, prog, pts, spec, mirror)
    att.reset_launches()
    pts, _, _, gated = _pop_dispatch(exp, prog, pts, spec, mirror)
    torch.cuda.synchronize()
    got = dict(att.LAUNCHES)
    ts = exp.init_state(5)
    ts, _, _ = run_classic(exp, ts, 1)
    att.reset_launches()
    run_classic(exp, ts, 1)
    torch.cuda.synchronize()
    step = dict(att.LAUNCHES)
    assert step["flash_bwd_dkv"] > 0 and all(gated)
    assert got == {k: 2 * len(gated) * v for k, v in step.items()}
    assert all(m.launches["train"] == step for m in prog.members)


# ------------------------------------------------- the fleet, thread safety

@pytest.mark.cuda
def test_fleet_on_cuda_equals_one_frontend(cuda_device, tmp_path):
    """A 2-engine fleet over a dense pallas artifact, each engine on its
    own stream, serves the actions and hiddens of one front end bit for
    bit, with K1's launches exact across the engine threads (depth a
    dispatch)."""
    import numpy as np
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.serve.export import export_artifact
    from t2omca_tpu_torch.serve.fleet import FleetConfig, ServeFleet
    from t2omca_tpu_torch.serve.frontend import ServeFrontend
    from t2omca_tpu_torch.utils.checkpoint import save_checkpoint
    d = {"batch_size_run": 2, "batch_size": 2,
         "env_args": {"agv_num": 4, "mec_num": 2, "num_channels": 2,
                      "episode_limit": 4},
         "model": {"emb": 16, "heads": 2, "depth": 2, "mixer_emb": 16,
                   "mixer_heads": 2, "mixer_depth": 1,
                   "use_qslice": False},
         "kernels": {"attention": "pallas"},
         "replay": {"buffer_size": 4}}
    cfg = from_dict(d)
    exp = Experiment.build(cfg, device=cuda_device)
    save_checkpoint(str(tmp_path / "models"), 8, exp.init_state(0))
    art = str(tmp_path / "art")
    export_artifact(cfg, str(tmp_path / "models"), art, buckets=(1, 4))
    one = ServeFrontend.load(art, device=cuda_device)
    fleet = ServeFleet(art, n_engines=2, cfg=FleetConfig(poll_s=0.005),
                       device=cuda_device).start()
    try:
        assert fleet.serving_engines() == 2
        streams = [e.stream for e in fleet.engines]
        assert all(s is not None for s in streams)
        assert streams[0] != streams[1]
        rng = np.random.default_rng(0)
        reqs, want = [], []
        for n in (1, 3, 4, 9) * 4:
            obs = rng.standard_normal((n, 4, one.obs_dim)).astype(np.float32)
            avail = rng.random((n, 4, one.n_actions)) < 0.7
            avail[..., 0] = True
            reqs.append((obs, avail))
            want.append(one.select(obs, avail))
        port.reset_launches()
        pending = [fleet.submit(o, a) for o, a in reqs]
        got = [r.wait(30.0) for r in pending]
        dispatches = sum(-(-o.shape[0] // 4) for o, _ in reqs)
        assert port.LAUNCHES["flash_fwd"] == 2 * dispatches
        for r, (a, h) in zip(got, want):
            assert r.ok, r.error
            assert (r.actions == a).all() and (r.hidden == h).all()
        assert {r.engine for r in got} == {0, 1}
    finally:
        fleet.stop()


@pytest.mark.cuda
def test_launch_counts_exact_under_threads(cuda_device):
    """Four threads launch K1 at once, each on its own stream: the counts
    add up exactly."""
    import threading
    q, k, v, _, _ = _qkv(cuda_device, (4, 2, 9, 9, 16), torch.float32, 1)
    n_each = 200

    def work():
        s = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(s):
            for _ in range(n_each):
                port.flash_attention(q, k, v)
        s.synchronize()

    port.reset_launches()
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert port.LAUNCHES == {"flash_fwd": 4 * n_each, "flash_fwd_res": 0,
                             "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


@pytest.mark.cuda
def test_kernel_library_loads_once_under_threads(cuda_device, monkeypatch):
    """``kernels.build.load()`` called from four threads at once in a
    process that has not loaded the library builds and registers it
    once."""
    import threading
    from t2omca_tpu_torch.kernels import build
    calls = []
    real = build.build

    def counted(*a, **kw):
        calls.append(threading.get_ident())
        return real(*a, **kw)

    monkeypatch.setattr(build, "build", counted)
    monkeypatch.setattr(build, "_loaded", None)
    barrier = threading.Barrier(4)
    out = []

    def work():
        barrier.wait()
        out.append(build.load())

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and len(out) == 4
    assert build._loaded is not None


# ---------------------------------------------------------------- Sebulba

def _sebulba_cfg(tmp_path, **over):
    """``tests/test_torch_sebulba.py``'s tiny config with pallas, as a
    dict."""
    d = dict(t_max=47, batch_size_run=6, batch_size=4, test_interval=24,
             test_nepisode=6, log_interval=12, runner_log_interval=12,
             save_model=False, local_results_path=str(tmp_path),
             use_tensorboard=False, epsilon_anneal_time=50,
             kernels={"attention": "pallas"},
             env_args=dict(agv_num=3, mec_num=2, num_channels=2,
                           episode_limit=6),
             model=dict(emb=8, heads=2, depth=1, mixer_emb=8,
                        mixer_heads=2, mixer_depth=1),
             replay=dict(buffer_size=16))
    d.update(over)
    return d


@pytest.mark.cuda
def test_sebulba_lockstep_on_cuda_equals_the_classic_loop(cuda_device,
                                                           tmp_path):
    """Lockstep Sebulba with its actor and learner as two streams of the
    card (captured graphs, events between them) ends on the classic
    loop's state bit for bit, the test cadence mid-training included."""
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.run import run
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    from t2omca_tpu_torch.utils.logging import Logger
    classic = run(from_dict(_sebulba_cfg(tmp_path / "c")), Logger())
    seb = run(from_dict(_sebulba_cfg(tmp_path / "s", sebulba=dict(
        actor_devices=1, learner_devices=1, queue_slots=1, staleness=0))),
        Logger(), share_cards=True)
    (a, ha), (b, hb) = flatten_state(classic), flatten_state(seb)
    assert ha == hb and set(a) == set(b)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


@pytest.mark.cuda
def test_sebulba_three_streams_queue_digests(cuda_device, tmp_path):
    """3 actor streams + 1 learner stream, 2 slots, staleness 1, the test
    cadence off: every batch's ring rows digest as its emission at its put,
    every rollout acts within the staleness bound on the params of its
    publish, and every learner step replays the kernels' exact launches."""
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.parallel import sebulba as seb_mod
    from t2omca_tpu_torch.run import run
    from t2omca_tpu_torch.utils.logging import Logger
    built = []
    make = seb_mod.make_sebulba
    seb_mod.make_sebulba = lambda *a, **kw: built.append(make(*a, **kw)) \
        or built[-1]
    audit = seb_mod.AUDIT = seb_mod.Audit()
    try:
        run(from_dict(_sebulba_cfg(tmp_path, t_max=6 * 36 - 1,
                                   test_interval=10 ** 6,
                                   sebulba=dict(actor_devices=3,
                                                learner_devices=1,
                                                queue_slots=2,
                                                staleness=1))),
            Logger(), share_cards=True)
    finally:
        seb_mod.make_sebulba = make
        seb_mod.AUDIT = None
    # 6 rollouts of 36 env steps; 3 shards adopt before each, and before
    # the test cadence's rollout at the first iteration
    assert audit.check(1) == {"batches": 6, "rollouts": 6,
                              "adopts": 3 * (6 + 1), "publishes": 7}
    assert built[0].learner_launches == {"flash_fwd": 7, "flash_fwd_res": 6,
                                         "flash_bwd_dq": 6,
                                         "flash_bwd_dkv": 6}


def _set_cfg(tmp_path, learners, **over):
    """``_sebulba_cfg`` in lockstep at 1 actor and ``learners`` learner
    placements."""
    return _sebulba_cfg(tmp_path, **dict(dict(sebulba=dict(
        actor_devices=1, learner_devices=learners, queue_slots=1,
        staleness=0)), **over))


@pytest.mark.cuda
def test_sebulba_learner_set_step_on_cuda_equals_the_blocked_step(
        cuda_device, tmp_path, monkeypatch):
    """2 learner placements as streams of the card, each placement's train
    stage replayed as graphs split at its collectives: one step from a
    filled ring equals the step computed eagerly at world 1 over the same
    two row blocks (the gradients summed in placement order), bit for
    bit, and each placement replays one learner's launches."""
    import dataclasses
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.learners import qmix_learner as ql
    from t2omca_tpu_torch.parallel import sebulba as seb_mod
    from t2omca_tpu_torch.run import Experiment
    from t2omca_tpu_torch.train.superstep import clone_state
    from t2omca_tpu_torch.utils.checkpoint import flatten_state
    cfg = from_dict(_set_cfg(tmp_path, 2))
    seb = seb_mod.make_sebulba(Experiment.build(cfg), share_cards=True)
    try:
        seb.init_states(cfg.seed)
        seb.init_queue()
        seb.capture()
        seb.adopt(seb.publish())
        for _ in range(2):
            tms, _ = seb.actor_step()
            seb.queue_put(0, tms)
            seb.queue_get(0)
        seb.sync_learner()
        ts0 = clone_state(seb.join())
        key = prng.split(prng.PRNGKey(5, "cuda"))[0]
        ref = Experiment.build(dataclasses.replace(cfg, sebulba=type(
            cfg.sebulba)()))
        seen = {}
        train0 = ql.QMixLearner.train

        def train(self, ls, batch, weights, *a, **kw):
            if "params" not in seen:
                w = weights.float()
                n = w.shape[0] // 2
                total = batch.filled.float().sum()
                params = ql._tree_map(lambda p: p.detach().requires_grad_(),
                                      ls.params)
                leaves = [p for sub in params.values()
                          for p in sub.values()]
                grads = None

                class Block:
                    def __init__(self, r):
                        self.rank, self.world = r, 2

                    def sum(self, t):
                        return total.clone()
                for r in range(2):
                    part = batch.map(lambda x, r=r: x[r * n:(r + 1) * n])
                    lo, _ = dataclasses.replace(self, comm=Block(r))._loss(
                        params, ls.target_params, part, w[r * n:(r + 1) * n])
                    g = [ql._or_zeros(x, p) for x, p in zip(
                        torch.autograd.grad(lo, leaves, allow_unused=True),
                        leaves)]
                    grads = g if grads is None else [
                        x + y for x, y in zip(grads, g)]
                it = iter(grads)
                grads = ql._tree_map(lambda p: next(it), params)
                norm = ql.global_norm(grads)
                clipped = ql.clip_by_global_norm(grads, norm,
                                                 self.cfg.grad_norm_clip)
                updates, _ = ql.optimizer_update(self.cfg, clipped,
                                                 ls.opt_state)
                seen["params"] = ql._tree_map(lambda p, u: p.detach() + u,
                                              params, updates)
            return train0(self, ls, batch, weights, *a, **kw)
        monkeypatch.setattr(ql.QMixLearner, "train", train)
        beta = torch.full((), ref.buffer.per_beta(24), device="cuda")
        ref.programs()[2](ts0, key, 24, beta=beta)
        monkeypatch.undo()
        seb.learner_step(key, 24)
        seb.sync_learner()
        got = flatten_state(seb.ls.learner.params)[0]
        want = flatten_state(seen["params"])[0]
        assert [k for k in want if not torch.equal(got[k], want[k])] == []
        assert seb.seat_launches == [{"flash_fwd": 7, "flash_fwd_res": 6,
                                      "flash_bwd_dq": 6,
                                      "flash_bwd_dkv": 6}] * 2
        seb.digest()
    finally:
        seb.close()


@pytest.mark.cuda
def test_sebulba_learner_set_queue_digests(cuda_device, tmp_path):
    """3 actor + 2 learner streams, 2 slots, staleness 1: every batch's
    ring rows (summed over the placements) digest as its emission, every
    rollout within the bound, both placements' params at every publish
    placement 0's."""
    from t2omca_tpu_torch.config import from_dict
    from t2omca_tpu_torch.parallel import sebulba as seb_mod
    from t2omca_tpu_torch.run import run
    from t2omca_tpu_torch.utils.logging import Logger
    audit = seb_mod.AUDIT = seb_mod.Audit()
    try:
        run(from_dict(_sebulba_cfg(tmp_path, t_max=6 * 36 - 1,
                                   test_interval=10 ** 6,
                                   sebulba=dict(actor_devices=3,
                                                learner_devices=2,
                                                queue_slots=2,
                                                staleness=1))),
            Logger(), share_cards=True)
    finally:
        seb_mod.AUDIT = None
    assert audit.check(1) == {"batches": 6, "rollouts": 6,
                              "adopts": 3 * (6 + 1), "publishes": 7,
                              "replicas": 2 * 7}
