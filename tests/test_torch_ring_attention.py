"""Port parity of sequence parallelism (``t2omca_tpu_torch.parallel.
ring_attention``, ``sp_mixer``) against the JAX package's on the CPU.

Each of ``tests/test_ring_attention.py``'s 7 tests is mirrored at its
sizes and tolerances: the same inputs (drawn by ``jax.random`` and handed
over as numpy) go through JAX's ``ring_attention`` / ``ulysses_attention``
/ ``mixer_apply_sp`` under ``shard_map`` on the conftest's 8 virtual CPU
devices and through the port's over 8 CPU placements, and both are held
against the dense reference and against each other: ring and Ulysses
outputs at atol = rtol = 1e-5, the ring's q gradient at 1e-4, the SP
mixer (on params converted from flax, ``convert.mixer_state_from_flax``)
at 1e-4, its agent gradient non-negative (monotonic mixing), its param
gradients finite when a placement's whole key block is padding (13
tokens over 8 placements: the double-``where`` guard). JAX's SP backward
compile is ``slow`` there; the port's mirror of that case runs in a
fraction of a second and stays in the gate. The port's SP mixer is also
held against the port's dense mixer at 2 placements (atol = rtol =
1e-5), forward and parameter gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from t2omca_tpu.models.mixer import TransformerMixer as JaxMixer
from t2omca_tpu.parallel import make_mesh
from t2omca_tpu.parallel.compat import shard_map
from t2omca_tpu.parallel.ring_attention import (
    ring_attention as jax_ring, ulysses_attention as jax_ulysses)
from t2omca_tpu.parallel.sp_mixer import mixer_apply_sp as jax_mixer_sp
from t2omca_tpu_torch.convert import mixer_state_from_flax
from t2omca_tpu_torch.models.mixer import TransformerMixer
from t2omca_tpu_torch.parallel import (mixer_apply_sp, ring_attention,
                                       sp_placements, ulysses_attention)
from test_torch_threads import one_intra_op_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(
    one_intra_op_thread)

N = 8
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
SP = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N, axis_names=("sp",))


@pytest.fixture(scope="module")
def places():
    return sp_placements(N, "cpu")


def _dense(q, k, v):
    logits = jnp.einsum("...qd,...kd->...qk", q, k)
    return jnp.einsum("...qk,...kd->...qd",
                      jax.nn.softmax(logits, axis=-1), v)


def _t(x):
    return torch.from_numpy(np.array(x))


def _normals(seed, *shape, n=3):
    ks = jax.random.split(jax.random.PRNGKey(seed), n)
    return [jax.random.normal(k, shape) for k in ks]


def _port_ring(places, q, k, v, axis, mask=None):
    """The port's ring over ``places`` with the token axis ``axis`` cut
    into equal blocks → the whole output."""
    cut = lambda x: list(_t(x).tensor_split(len(places), dim=axis))
    masks = None if mask is None else cut(mask)
    return torch.cat(ring_attention(cut(q), cut(k), cut(v), places, masks),
                     dim=axis)


def test_ring_attention_matches_dense(mesh, places):
    b, t, d = 2, 32, 16
    q, k, v = _normals(0, b, t, d)
    ring = shard_map(lambda q, k, v: jax_ring(q, k, v, "sp"), mesh=mesh,
                     in_specs=(P(None, "sp", None),) * 3,
                     out_specs=P(None, "sp", None))
    want = np.asarray(jax.jit(ring)(q, k, v))
    got = _port_ring(places, q, k, v, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(_dense(q, k, v)), **TOL)


def test_ring_attention_with_head_batch(mesh, places):
    b, h, t, d = 2, 3, 16, 8
    q, k, v = _normals(1, b, h, t, d)
    ring = shard_map(lambda q, k, v: jax_ring(q, k, v, "sp"), mesh=mesh,
                     in_specs=(P(None, None, "sp", None),) * 3,
                     out_specs=P(None, None, "sp", None))
    want = np.asarray(jax.jit(ring)(q, k, v))
    got = _port_ring(places, q, k, v, 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(_dense(q, k, v)), **TOL)


def test_ulysses_attention_matches_dense(mesh, places):
    b, t, h, d = 2, 16, 8, 4
    q, k, v = _normals(2, b, t, h, d)
    uly = shard_map(lambda q, k, v: jax_ulysses(q, k, v, "sp"), mesh=mesh,
                    in_specs=(P(None, "sp", None, None),) * 3,
                    out_specs=P(None, "sp", None, None))
    want = np.asarray(jax.jit(uly)(q, k, v))
    cut = lambda x: list(_t(x).tensor_split(N, dim=1))
    got = torch.cat(ulysses_attention(cut(q), cut(k), cut(v), places),
                    dim=1).numpy()
    qd, kd, vd = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    ref = np.asarray(_dense(qd, kd, vd).transpose(0, 2, 1, 3))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    with pytest.raises(ValueError, match="heads divisible"):
        ulysses_attention(cut(q)[:3], cut(k)[:3], cut(v)[:3], places[:3])


def test_ring_attention_grad_flows(mesh, places):
    b, t, d = 1, 16, 8
    q, k, v = _normals(3, b, t, d)
    ring = shard_map(lambda q, k, v: jax_ring(q, k, v, "sp"), mesh=mesh,
                     in_specs=(P(None, "sp", None),) * 3,
                     out_specs=P(None, "sp", None))
    want = np.asarray(jax.grad(lambda q: jax.jit(ring)(q, k, v).sum())(q))
    tq = _t(q).requires_grad_()
    cut = lambda x: list(x.tensor_split(N, dim=1))
    out = ring_attention(cut(tq), cut(_t(k)), cut(_t(v)), places)
    (g,) = torch.autograd.grad(torch.cat(out, dim=1).sum(), tq)
    g_ref = np.asarray(jax.grad(lambda q: _dense(q, k, v).sum())(q))
    np.testing.assert_allclose(g.numpy(), want, **GRAD)
    np.testing.assert_allclose(g.numpy(), g_ref, **GRAD)


def test_ring_attention_kv_mask_matches_dense(mesh, places):
    b, t_real, d, tp = 2, 13, 8, 16
    q, k, v = _normals(3, b, tp, d)
    mask = jnp.broadcast_to((jnp.arange(tp) < t_real)[None], (b, tp))
    ring = shard_map(lambda q, k, v, m: jax_ring(q, k, v, "sp", m),
                     mesh=mesh,
                     in_specs=(P(None, "sp", None),) * 3 + (P(None, "sp"),),
                     out_specs=P(None, "sp", None))
    want = np.asarray(jax.jit(ring)(q, k, v, mask))[:, :t_real]
    got = _port_ring(places, q, k, v, 1, mask).numpy()[:, :t_real]
    dense = np.asarray(_dense(q[:, :t_real], k[:, :t_real],
                              v[:, :t_real]))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, dense, **TOL)


def _mixers(seed, a, n_ent, feat, emb, depth, state_entity_mode,
            gate=False, obs_feat=8, states_dim=None, b=3):
    """JAX's mixer and its inputs as ``tests/test_ring_attention.py``
    draws them, and the port's mixer on the converted params."""
    kw = dict(n_agents=a, n_entities=n_ent, feat_dim=feat, emb=emb,
              heads=2, depth=depth, state_entity_mode=state_entity_mode)
    jm = JaxMixer(zero_init_gate=gate, **kw)
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    x = (jax.random.normal(ks[0], (b, 1, a)),
         jax.random.normal(ks[1], (b, a, emb)),
         jax.random.normal(ks[2], (b, 3, emb)),
         jax.random.normal(ks[3], (b, states_dim or n_ent * feat)),
         jax.random.normal(ks[4], (b, a, obs_feat)))
    params = jm.init(ks[5], *x)
    if gate:
        params["params"]["out_gate"] = jnp.full((1,), 0.7)
    tm = TransformerMixer(zero_init_gate=gate, **kw)
    tm.load_state_dict(mixer_state_from_flax(
        jax.tree.map(np.asarray, params), device="cpu"))
    return jm, params, tm, x


@pytest.mark.parametrize("gate", [False, True])
def test_sp_mixer_matches_dense_mixer(mesh, places, gate):
    jm, params, tm, x = _mixers(4, 5, 5, 8, 16, 2, True, gate=gate)
    y_dense, hyp_dense = jm.apply(params, *x)
    y_sp, hyp_sp = jax.jit(lambda p, *a: jax_mixer_sp(jm, p, *a, mesh))(
        params, *x)
    with torch.no_grad():
        ty, th = mixer_apply_sp(tm, *map(_t, x), places)
    for got, jsp, jdense in ((ty, y_sp, y_dense), (th, hyp_sp, hyp_dense)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jsp), **SP)
        np.testing.assert_allclose(got.numpy(), np.asarray(jdense), **SP)


def test_sp_mixer_monotonic_and_q12(mesh, places):
    jm, params, tm, x = _mixers(5, 4, 1, 6, 8, 1, False, obs_feat=6,
                                states_dim=4, b=2)
    y_dense, _ = jm.apply(params, *x)
    qv = _t(x[0]).requires_grad_()
    ty, _ = mixer_apply_sp(tm, qv, *map(_t, x[1:]), places)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y_dense),
                               **SP)
    jy, _ = jax.jit(lambda p, *a: jax_mixer_sp(jm, p, *a, mesh))(params,
                                                                  *x)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **SP)
    (g,) = torch.autograd.grad(ty.sum(), qv)
    assert (g >= 0).all()


def test_sp_mixer_param_grads_finite_with_padding(places):
    """13 tokens over 8 placements: 2 a block, the last block all
    padding; every param gradient finite (JAX's case is ``slow``: its SP
    backward compile)."""
    _, _, tm, x = _mixers(6, 5, 5, 8, 16, 1, True, b=2)
    y, _ = mixer_apply_sp(tm, *map(_t, x), places)
    grads = torch.autograd.grad((y ** 2).sum(), list(tm.parameters()),
                                allow_unused=True)
    got = [g for g in grads if g is not None]
    assert got and all(torch.isfinite(g).all() for g in got)


def test_sp_mixer_at_two_placements_matches_the_port_dense_mixer():
    _, _, tm, x = _mixers(7, 5, 5, 8, 16, 2, True, gate=True)
    two = sp_placements(2, "cpu")
    args = list(map(_t, x))
    y, h = tm(*args)
    ys, hs = mixer_apply_sp(tm, *args, two)
    np.testing.assert_allclose(ys.detach().numpy(), y.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(hs.detach().numpy(), h.detach().numpy(),
                               **TOL)
    params = list(tm.parameters())
    g = torch.autograd.grad((y ** 2).sum() + h.sum(), params,
                            allow_unused=True)
    gs = torch.autograd.grad((ys ** 2).sum() + hs.sum(), params,
                             allow_unused=True)
    for a, b in zip(g, gs):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4,
                                       rtol=1e-4)
