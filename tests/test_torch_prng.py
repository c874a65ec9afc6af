"""Port parity of the threefry PRNG (``t2omca_tpu_torch.prng``) against
``jax.random`` on the live config: ``threefry2x32`` with
``jax_threefry_partitionable=True``.

Bit-exact: ``PRNGKey``, ``split``, ``fold_in``, the 32-bit ``bits``,
``uniform`` (also with ``minval``/``maxval``: XLA's CPU backend fuses
``u · span + minval`` into one FMA, which the port computes in float64
and rounds once), ``bernoulli`` and ``randint`` (the two-draw modular
form), for single keys and for batched keys against ``jax.vmap``.
``choice`` (shape ``()``, ``replace=True``, a ``p``: the float32
cumsum, ``r = cum[-1] · (1 − u)`` and the left-side search) too.
``gumbel`` and ``normal`` go through ``log`` / ``erfinv``, whose float32
results differ from XLA's in the last bits: ``gumbel`` by a few ulp
(measured up to 2.4e-7), held at rtol 1e-6 / atol 1e-6; ``normal`` by
more in the tails, where ``erfinv`` amplifies the difference of the two
implementations (up to ~60 ulp near |u| = 1), held at rtol 1e-5 / atol
1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu_torch import prng

SEEDS = (0, 1, 7, 12345, -1, 2 ** 31 - 1)
SHAPES = ((), (7,), (3, 5))


def port_key(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def jax_key(seed):
    return jax.random.PRNGKey(seed)


def test_live_config_is_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_are_bit_exact(seed):
    jk, tk = jax_key(seed), prng.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for n in (2, 3, 7, 150):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      np.asarray(jax.random.split(jk, n)))
    for d in (0, 7, 0x5CE7, 123456789):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      np.asarray(jax.random.fold_in(jk, d)))
    # the partitionable split is a fold-in of the subkey index
    np.testing.assert_array_equal(prng.split(tk, 8)[7].numpy(),
                                  prng.fold_in(tk, 7).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_are_bit_exact(seed, shape):
    jk, tk = jax_key(seed), prng.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(
        prng.random_bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    for lo, hi in ((4000.0, 12000.0), (0.0, 2 * np.pi), (0.9, 1.1),
                   (-3.0, 0.5)):
        np.testing.assert_array_equal(
            prng.uniform(tk, shape, lo, hi).numpy(),
            np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi)))
    for p in (0.5, 0.1, 0.93):
        np.testing.assert_array_equal(
            prng.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_is_bit_exact(seed, shape):
    """The env's ranges: the serving MEC ``(0, n_mec)`` and the fleet size
    ``(min_agents, A + 1)``, plus a large and an empty span."""
    jk, tk = jax_key(seed), prng.PRNGKey(seed, device="cpu")
    for lo, hi in ((0, 2), (0, 8), (2, 5), (3, 65), (0, 1000003), (4, 4)):
        got = prng.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.randint(jk, shape, lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_and_normal_within_stated_tolerance(seed):
    jk, tk = jax_key(seed), prng.PRNGKey(seed, device="cpu")
    for shape in SHAPES + ((64, 9),):
        g, gj = prng.gumbel(tk, shape).numpy(), np.asarray(
            jax.random.gumbel(jk, shape))
        np.testing.assert_allclose(g, gj, rtol=1e-6, atol=1e-6)
        n, nj = prng.normal(tk, shape).numpy(), np.asarray(
            jax.random.normal(jk, shape))
        np.testing.assert_allclose(n, nj, rtol=1e-5, atol=1e-6)


def test_batched_keys_equal_jax_vmap():
    """One port call over keys ``(B, 2)`` is ``jax.vmap`` of the draw."""
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    tk = port_key(keys)
    vm = lambda f: np.asarray(jax.vmap(f)(keys))
    np.testing.assert_array_equal(
        prng.split(tk, 3).numpy(), vm(lambda k: jax.random.split(k, 3)))
    np.testing.assert_array_equal(
        prng.fold_in(tk, 7).numpy(), vm(lambda k: jax.random.fold_in(k, 7)))
    np.testing.assert_array_equal(
        prng.uniform(tk, (4,), 4000.0, 12000.0).numpy(),
        vm(lambda k: jax.random.uniform(k, (4,), minval=4000.0,
                                        maxval=12000.0)))
    np.testing.assert_array_equal(
        prng.randint(tk, (4,), 0, 2).numpy(),
        vm(lambda k: jax.random.randint(k, (4,), 0, 2)))
    np.testing.assert_array_equal(
        prng.randint(tk, (), 2, 5).numpy(),
        vm(lambda k: jax.random.randint(k, (), 2, 5)))
    p = jnp.asarray([0.1, 0.5, 0.5, 0.9, 0.3], jnp.float32)
    np.testing.assert_array_equal(
        prng.bernoulli(tk, torch.from_numpy(np.array(p))[:, None],
                       (6,)).numpy(),
        np.asarray(jax.vmap(lambda k, q: jax.random.bernoulli(k, q, (6,)))(
            keys, p)))
    # a batch of batches (T step keys of B lanes)
    keys2 = jax.random.split(jax.random.PRNGKey(9), 6).reshape(2, 3, 2)
    np.testing.assert_array_equal(
        prng.uniform(port_key(keys2), (4,)).numpy(),
        np.asarray(jax.vmap(jax.vmap(
            lambda k: jax.random.uniform(k, (4,))))(keys2)))


def test_prngkey_needs_a_device_or_cpu_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        prng.PRNGKey(0)
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 31, device="cpu")


def test_choice_is_bit_exact():
    """``prng.choice`` against ``jax.random.choice(replace=True, p=...)``
    for batched keys: weights that do not sum to 1 (as given, and
    normalized the mixture's way), ties from zero weights (the left side
    never picks a zero-weight index after a positive one), a single
    entry, eagerly and jitted."""
    from t2omca_tpu_torch.envs.graftworld import mixture_probs
    keys = jax.random.split(jax.random.PRNGKey(11), 2048)
    tk = port_key(keys)
    for w in ([0.2, 0.3, 0.9], [1e-3, 0.0, 2.5e-3, 0.0], [5.0],
              [0.0, 0.0, 1.0, 0.0, 3.0], [1 / 3, 1 / 3, 1 / 3]):
        n = len(w)
        pj = jnp.asarray(w, jnp.float32)
        for p in (w, mixture_probs(tuple(w), n)):
            want_jit = jax.jit(jax.vmap(
                lambda k, p=p: jax.random.choice(
                    k, n, p=jnp.asarray(p, jnp.float32))))(keys)
            want = jax.vmap(lambda k, p=p: jax.random.choice(
                k, n, p=jnp.asarray(p, jnp.float32)))(keys)
            got = prng.choice(tk, n, p).numpy()
            np.testing.assert_array_equal(got, np.asarray(want_jit))
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(mixture_probs(tuple(w), n),
                                      np.asarray(pj / pj.sum()))
    with pytest.raises(ValueError, match="3 entries"):
        prng.choice(tk, 3, [0.5, 0.5])
