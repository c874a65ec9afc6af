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
], ids=["agent", "mixer", "agent_k_is_v", "mixer_k_is_v", "serve_strided",
        "d12_causal", "causal_per_head", "negative_agent", "negative_mixer",
        "all_masked_row"])
def test_f32_kernels_at_their_edges(cuda_device, shape, causal, mask, extra):
    """The f32 K1 and K1 + residuals (FP64 tensor cores), K2 and K3
    (3xTF32 on the tensor cores) against the plain versions at the f32
    tolerances where their tiling, staging and arithmetic have edges: Tq
    4, 65 and 268 and Tk 65 and 131 (no multiple of 16), D 8, 12, 64 and
    256, k and v one tensor (staged once), the serve path's strided (B, T,
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
