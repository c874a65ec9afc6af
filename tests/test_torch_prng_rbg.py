"""Port parity of the ``rbg`` and ``unsafe_rbg`` PRNG impls
(``t2omca_tpu_torch.prng``, 4-word keys) against **jitted** ``jax.random``
under the same impl on the CPU.

XLA's CPU ``rng_bit_generator`` (``algorithm=DEFAULT``) is Philox4x32-10:
the Philox key is words ``(k0, k1)``, the counter the 128-bit
little-endian number of words ``(k2, k3, k0, k1)``, one block of 4
outputs a counter, outputs row-major. Bit-exact here: the raw bits at
edge keys (high words set, and keys whose block counter carries into the
high words), ``PRNGKey``, ``split`` and ``fold_in`` under both impls,
``uniform``, ``bernoulli``, ``randint`` and ``choice``; ``gumbel`` and
``normal`` within ``test_torch_prng.py``'s stated tolerances (``log`` /
``erfinv`` differ from XLA's in the last bits). The vmap rule: JAX's
batching rule draws ``(B, *shape)`` from the first key of a ``vmap``
(one and two levels, for bits and for ``unsafe_rbg``'s ``split``); the
port's ``scan`` dimensions are independent draws, as a loop over keys
is in JAX. ``rows`` equals the whole draw indexed.

The fixture switches ``jax_default_prng_impl`` for each test and restores
``threefry2x32`` on teardown, so nothing leaks to the next test of an
xdist worker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from t2omca_tpu_torch import prng
from t2omca_tpu_torch.kernels import dropout as dk
from test_torch_threads import one_intra_op_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(
    one_intra_op_thread)

IMPLS = ("rbg", "unsafe_rbg")
SEEDS = (0, 1, 7, 12345, -1, 2 ** 31 - 1)
SHAPES = ((), (7,), (3, 5), (2, 3, 4))
#: high words set; the block counter's carry out of (k2, k3) into (k0, k1)
EDGE_KEYS = ((1, 2, 3, 4), (0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 5),
             (0xDEADBEEF, 7, 0xFFFFFFFF, 0xFFFFFFFF),
             (1, 2, 0xFFFFFFFE, 0xFFFFFFFF),
             (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF))


@pytest.fixture
def jax_impl(request):
    """Switch JAX's process-wide impl to the test's, restore threefry."""
    jax.config.update("jax_default_prng_impl", request.param)
    try:
        yield request.param
    finally:
        jax.config.update("jax_default_prng_impl", "threefry2x32")


by_impl = pytest.mark.parametrize("jax_impl", IMPLS, indirect=True)


def port_key(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def test_threefry_is_restored_after_the_rbg_tests():
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("key", EDGE_KEYS)
@pytest.mark.parametrize("shape", SHAPES + ((9, 11),))
def test_raw_bits_equal_xla_rng_bit_generator(key, shape):
    f = jax.jit(lambda k: lax.rng_bit_generator(
        k, shape, dtype=jnp.uint32)[1])
    want = np.asarray(f(jnp.asarray(key, jnp.uint32)))
    got = prng.random_bits(port_key(key), shape).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@by_impl
@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_are_bit_exact(jax_impl, seed):
    jk = jax.random.PRNGKey(seed)
    assert jk.shape == (4,)
    tk = prng.PRNGKey(seed, device="cpu", impl=jax_impl)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    # fresh lambdas: jit's cache does not key on the default impl
    split = jax.jit(lambda k, n: jax.random.split(k, n), static_argnums=1)
    for n in (2, 3, 7, 30):
        np.testing.assert_array_equal(
            prng.split(tk, n, jax_impl).numpy(), np.asarray(split(jk, n)))
    fold = jax.jit(lambda k, d: jax.random.fold_in(k, d))
    for d in (0, 7, 0x5CE7, 123456789, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tk, d, jax_impl).numpy(),
            np.asarray(fold(jk, jnp.uint32(d))))


@by_impl
@pytest.mark.parametrize("seed", (0, 7, -1))
@pytest.mark.parametrize("shape", SHAPES)
def test_samplers_are_bit_exact(jax_impl, seed, shape):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed, device="cpu", impl=jax_impl)
    uni = jax.jit(lambda k: jax.random.uniform(k, shape))
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(uni(jk)))
    span = jax.jit(lambda k: jax.random.uniform(k, shape, minval=0.9,
                                                maxval=1.1))
    np.testing.assert_array_equal(prng.uniform(tk, shape, 0.9, 1.1).numpy(),
                                  np.asarray(span(jk)))
    bern = jax.jit(lambda k: jax.random.bernoulli(k, 0.3, shape))
    np.testing.assert_array_equal(prng.bernoulli(tk, 0.3, shape).numpy(),
                                  np.asarray(bern(jk)))
    for lo, hi in ((0, 5), (-3, 100), (0, 2 ** 31 - 1)):
        ri = jax.jit(lambda k: jax.random.randint(k, shape, lo, hi))
        np.testing.assert_array_equal(
            prng.randint(tk, shape, lo, hi, jax_impl).numpy(),
            np.asarray(ri(jk)))


@by_impl
def test_choice_is_bit_exact(jax_impl):
    p = np.asarray([0.1, 0.25, 0.05, 0.6], np.float32)
    ch = jax.jit(lambda k: jax.random.choice(k, 4, (), True, jnp.asarray(p)))
    for seed in range(20):
        got = prng.choice(prng.PRNGKey(seed, "cpu", jax_impl), 4, p)
        assert int(got) == int(ch(jax.random.PRNGKey(seed)))


@by_impl
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_gumbel_and_normal_within_stated_tolerance(jax_impl, seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed, device="cpu", impl=jax_impl)
    g = jax.jit(lambda k: jax.random.gumbel(k, (64,)))
    np.testing.assert_allclose(prng.gumbel(tk, (64,)).numpy(),
                               np.asarray(g(jk)), rtol=1e-6, atol=1e-6)
    n = jax.jit(lambda k: jax.random.normal(k, (64,)))
    np.testing.assert_allclose(prng.normal(tk, (64,)).numpy(),
                               np.asarray(n(jk)), rtol=1e-5, atol=1e-6)


@by_impl
def test_vmap_rule_one_and_two_levels(jax_impl):
    """JAX's batching rule draws the whole batch from the first key; the
    port's leading key dimensions follow it, its ``scan`` dimensions do
    not (a loop over keys in JAX)."""
    base = jax.random.PRNGKey(3)
    keys = jax.random.split(base, 6)                       # (6, 4)
    tkeys = port_key(keys)
    shape = (5, 3)
    one = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, shape)))
    np.testing.assert_array_equal(prng.uniform(tkeys, shape).numpy(),
                                  np.asarray(one(keys)))
    bits = jax.jit(jax.vmap(lambda k: jax.random.bits(k, shape)))
    np.testing.assert_array_equal(prng.random_bits(tkeys, shape).numpy(),
                                  np.asarray(bits(keys)).astype(np.int64))
    # every lane draws from keys[0]: lane 1 is not lane 1's own draw
    solo = jax.jit(lambda k: jax.random.uniform(k, shape))
    assert not np.array_equal(np.asarray(one(keys))[1],
                              np.asarray(solo(keys[1])))
    nested = keys.reshape(2, 3, 4)
    two = jax.jit(jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, shape))))
    np.testing.assert_array_equal(
        prng.uniform(tkeys.reshape(2, 3, 4), shape).numpy(),
        np.asarray(two(nested)))
    # the first axis scanned: each row its own vmapped draw
    scanned = np.stack([np.asarray(one(nested[i])) for i in range(2)])
    np.testing.assert_array_equal(
        prng.uniform(tkeys.reshape(2, 3, 4), shape, scan=1).numpy(),
        scanned)
    ri = jax.jit(jax.vmap(lambda k: jax.random.randint(k, (4,), 0, 9)))
    np.testing.assert_array_equal(
        prng.randint(tkeys, (4,), 0, 9, jax_impl).numpy(),
        np.asarray(ri(keys)))
    sp = jax.jit(jax.vmap(lambda k: jax.random.split(k, 3)))
    np.testing.assert_array_equal(prng.split(tkeys, 3, jax_impl).numpy(),
                                  np.asarray(sp(keys)))
    sp2 = jax.jit(jax.vmap(jax.vmap(lambda k: jax.random.split(k, 3))))
    np.testing.assert_array_equal(
        prng.split(tkeys.reshape(2, 3, 4), 3, jax_impl).numpy(),
        np.asarray(sp2(nested)))
    fo = jax.jit(jax.vmap(lambda k: jax.random.fold_in(k, 11)))
    np.testing.assert_array_equal(prng.fold_in(tkeys, 11, jax_impl).numpy(),
                                  np.asarray(fo(keys)))


@pytest.mark.parametrize("impl", ("threefry",) + IMPLS)
def test_rows_equal_the_whole_draw_indexed(impl):
    key = prng.PRNGKey(9, "cpu", impl)
    whole = prng.random_bits(key, (10, 7))
    for rows in (torch.tensor([0, 3, 9, 4]), slice(1, 10, 3)):
        np.testing.assert_array_equal(
            prng.random_bits(key, (10, 7), rows=rows).numpy(),
            whole[rows].numpy())
    # rows of the first vmapped key axis (a rank's lanes)
    keys = prng.split(key, 6, impl)
    whole = prng.uniform(keys, (5,))
    rows = torch.tensor([1, 3, 5])
    np.testing.assert_array_equal(
        prng.uniform(keys, (5,), rows=rows).numpy(), whole[rows].numpy())
    # under scan, rows index the draw's own first axis
    steps = prng.split(key, 2, impl)
    whole = prng.uniform(steps, (6, 3), scan=1)
    np.testing.assert_array_equal(
        prng.uniform(steps, (6, 3), rows=rows, scan=1).numpy(),
        whole[:, rows].numpy())


def test_a_key_of_the_wrong_width_is_refused():
    with pytest.raises(ValueError, match="unsafe_rbg key has 4 words"):
        prng.split(prng.PRNGKey(0, "cpu"), 2, "unsafe_rbg")
    with pytest.raises(ValueError, match="prng_impl must be one of"):
        prng.PRNGKey(0, "cpu", "philox")


@pytest.mark.parametrize("draw", [
    lambda k: prng.split(k),
    lambda k: prng.fold_in(k, 3),
    lambda k: prng.randint(k, (2,), 0, 5),
    lambda k: dk.keep_mask(k, 3, 0.9, (4, 2)),
], ids=["split", "fold_in", "randint", "keep_mask"])
def test_a_4_word_key_needs_its_impl_named(draw):
    """The width cannot tell rbg from unsafe_rbg, so a 4-word key (and a
    member's 5-word one) never defaults to either."""
    for key in (prng.PRNGKey(0, "cpu", "rbg"),
                prng.seat(prng.PRNGKey(0, "cpu", "rbg"), 1)):
        with pytest.raises(ValueError, match="needs its impl named"):
            draw(key)
