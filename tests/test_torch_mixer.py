"""Port parity of the mixer: the dense ``TransformerMixer``, the mixer
query slice (``mixer_forward_qslice``) under both sliced-attention
lowerings, forward and gradients, and ``transformer_rows`` pallas
against xla. Mirrors ``tests/test_qslice.py:195-262`` and
``tests/test_kernels.py:432-465``. flax ``init`` params carried across
by ``convert.py``; the same numpy inputs through both. Tolerances: 1e-5
forward, rtol 2e-4 / atol 2e-5 gradients (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.models.mixer import TransformerMixer as JaxMixer
from t2omca_tpu.ops.query_slice import \
    mixer_forward_qslice as jax_mixer_qslice
from t2omca_tpu_torch.convert import mixer_state_from_flax
from t2omca_tpu_torch.models.mixer import TransformerMixer, qmix_pos_func
from t2omca_tpu_torch.ops.query_slice import (FOLDED, fold_mixer_params,
                                              fold_transformer,
                                              mixer_forward_qslice,
                                              transformer_rows)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
A, N, FEAT, EMB, B = 3, 3, 8, 16, 4


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(B, 1, A), f(B, A, EMB), f(B, 3, EMB), f(B, N * FEAT),
            f(B, A, N * FEAT))


def _both(state_entity_mode=True, pos_func="abs", gate=False, seed=0):
    kw = dict(n_agents=A, n_entities=N, feat_dim=FEAT, emb=EMB, heads=2,
              depth=2, qmix_pos_func=pos_func,
              state_entity_mode=state_entity_mode)
    jm = JaxMixer(zero_init_gate=gate, **kw)
    x = _inputs(seed)
    variables = jm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, x))
    if gate:     # a zero gate would hide the readout: open it
        variables["params"]["out_gate"] = jnp.asarray([0.7], jnp.float32)
    sd = mixer_state_from_flax(jax.tree.map(np.asarray, variables),
                               device="cpu")
    tm = TransformerMixer(zero_init_gate=gate, **kw)
    tm.load_state_dict(sd)
    return jm, variables, tm, sd, x


@pytest.mark.parametrize("state_entity_mode", [True, False])
@pytest.mark.parametrize("pos_func", ["abs", "softplus"])
def test_dense_mixer_matches_flax(state_entity_mode, pos_func):
    jm, variables, tm, _, x = _both(state_entity_mode, pos_func)
    qj, hj = jm.apply(variables, *map(jnp.asarray, x))
    with torch.no_grad():
        qt, ht = tm(*map(torch.from_numpy, x))
    assert qt.shape == (B, 1, 1) and ht.shape == (B, 3, EMB)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), **FWD)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **FWD)


def test_dense_mixer_zero_init_gate_matches_flax():
    jm, variables, tm, sd, x = _both(gate=True)
    assert "out_gate" in sd and sd["out_gate"].shape == (1,)
    qj, _ = jm.apply(variables, *map(jnp.asarray, x))
    with torch.no_grad():
        qt, _ = tm(*map(torch.from_numpy, x))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), **FWD)


def test_softplus_matches_jax_above_torch_threshold():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 25.0, 80.0], np.float32)
    for beta in (1.0, 0.5):
        np.testing.assert_allclose(
            qmix_pos_func(torch.from_numpy(x), "softplus", beta).numpy(),
            np.asarray(jax.nn.softplus(beta * x) / beta), rtol=1e-6)


def _loss(q, hy):
    """Mean-scaled so the gradients are O(1), the scale the absolute
    tolerance is stated for."""
    return ((q ** 2).sum() + (hy * 0.3).sum()) / (B * 3 * EMB)


def _qslice_kw(impl, state_entity_mode=True):
    return dict(n_agents=A, n_entities=N, feat_dim=FEAT, emb=EMB, heads=2,
                depth=2, pos_func="abs", pos_func_beta=1.0,
                state_entity_mode=state_entity_mode, attn_impl=impl)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mixer_qslice_matches_jax_fwd_and_grad(impl):
    _, variables, _, sd, x = _both(gate=True, seed=3)
    kw = _qslice_kw(impl)

    def loss_j(p):
        q, hy = jax_mixer_qslice(p, *map(jnp.asarray, x), **kw)
        return _loss(q, hy), (q, hy)

    (_, (qj, hj)), gj = jax.value_and_grad(loss_j, has_aux=True)(variables)
    params = {k: v.clone().requires_grad_() for k, v in sd.items()}
    qt, ht = mixer_forward_qslice(params, *map(torch.from_numpy, x), **kw)
    np.testing.assert_allclose(qt.detach().numpy(), np.asarray(qj), **FWD)
    np.testing.assert_allclose(ht.detach().numpy(), np.asarray(hj), **FWD)
    _loss(qt, ht).backward()
    want = mixer_state_from_flax(jax.tree.map(np.asarray, gj), device="cpu")
    assert set(want) == set(params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD)


def test_mixer_qslice_matches_port_dense_and_q12():
    for mode in (True, False):
        _, _, tm, sd, x = _both(state_entity_mode=mode, seed=4)
        folded = fold_mixer_params(sd, emb=EMB, heads=2, depth=2)
        assert folded[FOLDED] and fold_mixer_params(
            folded, emb=EMB, heads=2, depth=2) is folded
        with torch.no_grad():
            qd, hd = tm(*map(torch.from_numpy, x))
            qs, hs = mixer_forward_qslice(folded, *map(torch.from_numpy, x),
                                          **_qslice_kw("pallas", mode))
        np.testing.assert_allclose(qs.numpy(), qd.numpy(), rtol=5e-5,
                                   atol=5e-5)
        np.testing.assert_allclose(hs.numpy(), hd.numpy(), rtol=5e-5,
                                   atol=5e-5)


def test_transformer_rows_pallas_matches_xla_fwd_and_grad():
    """The sliced attention under pallas (one flash call over the R·H
    rows, k0 as keys AND values) against the plain branch, forward and
    gradients into both the weights and k0."""
    from t2omca_tpu_torch.models.transformer import Transformer
    rng = np.random.default_rng(10)
    emb, heads, depth = 16, 2, 2
    tf = Transformer(emb, heads, depth)
    sd = {k: v.detach().clone() for k, v in tf.state_dict().items()}
    k0_np = rng.standard_normal((3, 9, emb)).astype(np.float32)
    outs = {}
    for impl in ("xla", "pallas"):
        params = {k: v.clone().requires_grad_() for k, v in sd.items()}
        k0 = torch.tensor(k0_np, requires_grad=True)
        folded = fold_transformer(params, emb=emb, heads=heads,
                                  head_dim=emb, depth=depth,
                                  dtype=torch.float32, prefix="")
        out = transformer_rows(folded, k0, k0[:, -4:, :], emb=emb,
                               heads=heads, depth=depth, attn_impl=impl)
        (out ** 2).sum().backward()
        outs[impl] = (out.detach(), k0.grad,
                      {k: p.grad for k, p in params.items()})
    (ox, kx, gx), (op, kp, gp) = outs["xla"], outs["pallas"]
    np.testing.assert_allclose(op.numpy(), ox.numpy(), **FWD)
    np.testing.assert_allclose(kp.numpy(), kx.numpy(), **GRAD)
    for name in gx:
        if gx[name] is None:
            assert gp[name] is None
            continue
        np.testing.assert_allclose(gp[name].numpy(), gx[name].numpy(),
                                   err_msg=name, **GRAD)
