"""``model.remat`` in the port's learner (``torch.utils.checkpoint`` over
every unroll step that needs a gradient, JAX's ``jax.checkpoint`` around
each scan body).

* On and off are bit-identical on the CPU: loss, every info value, the
  params, the target params and Adam's moments after two steps, on the
  query-slice path over dense storage, the entity-table path over
  compact storage, the dense agent and with NoisyNet's q-head noise.
* Against the JAX learner with ``model.remat: true`` at
  ``tests/test_torch_learner.py``'s tolerances (info rtol 1e-5 / atol
  1e-6, ``grad_norm`` rtol 1e-4, params atol 1e-5), three steps.
* The launch routing: under remat the backward recomputes each online
  step, so the kernels' K1 + residuals runs twice a step (on the card:
  600 a config-3 train step), K1 and the backward kernels as before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
from t2omca_tpu_torch.envs.registry import make_env
from t2omca_tpu_torch.learners import QMixLearner
from t2omca_tpu_torch import prng

import test_torch_entity as entity_test
import test_torch_learner as tl_test

BATCH, T = tl_test.BATCH, tl_test.T

CASES = {
    "qslice_pallas": {"kernels.attention": "pallas",
                      "replay.compact_entity_store": False},
    "compact": {"kernels.attention": "pallas",
                "replay.compact_entity_store": True},
    "dense_agent": {"kernels.attention": "pallas", "model.use_qslice": False},
    "noisy": {"action_selector": "noisy-new",
              "replay.compact_entity_store": True},
}


def _config(case, remat, **over):
    return tl_test.config(**{**CASES[case], "model.depth": 2,
                             "model.mixer_depth": 2, "model.remat": remat,
                             **over})


def _learner(d):
    tcfg = from_dict(d)
    info = make_env(tcfg.env_args).get_env_info()
    tl = QMixLearner.build(tcfg, BasicMAC.build(tcfg, info, device="cpu"),
                           info, device="cpu")
    return tl, info


def _batch(case, rng, info):
    if CASES[case].get("replay.compact_entity_store") or case == "noisy":
        return entity_test.to_port(entity_test.episodes(rng, info, BATCH, T))
    return tl_test.to_port(tl_test.make_episodes(rng, info, BATCH, T))


def _leaves(ls):
    out = {}
    for name, tree in (("params", ls.params), ("target", ls.target_params),
                       ("mu", ls.opt_state["mu"]),
                       ("nu", ls.opt_state["nu"])):
        for m, sub in tree.items():
            for k, v in sub.items():
                out[f"{name}.{m}.{k}"] = v
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_on_and_off_are_bit_identical(case):
    runs = {}
    for remat in (False, True):
        tl, info = _learner(_config(case, remat))
        assert tl.cfg.model.remat is remat
        ls = tl.init_state(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(5)
        key = prng.PRNGKey(7, "cpu")
        infos = []
        for step in range(2):
            batch = _batch(case, rng, info)
            w = torch.from_numpy(rng.uniform(0.5, 1.0, BATCH)
                                 .astype(np.float32))
            key, k_learn = prng.split(key).unbind(0)
            ls, inf = tl.train(ls, batch, w, 0, step + 1,
                               key=k_learn if tl.needs_rngs else None)
            infos.append(inf)
        runs[remat] = (_leaves(ls), infos)
    (a, ia), (b, ib) = runs[False], runs[True]
    assert set(a) == set(b)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    for x, y in zip(ia, ib):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("case", ["qslice_pallas", "compact"])
def test_remat_matches_jax_remat(case):
    """Three steps of the port's remat learner against JAX's (jitted,
    Pallas in interpret mode) from the same params and batches."""
    d = _config(case, True)
    jl, jls, tl, tls, info = tl_test.build_pair(d, jit_init=True)
    assert jl.cfg.model.remat and tl.cfg.model.remat
    compact = case == "compact"
    to_jax = entity_test.to_jax if compact else tl_test.to_jax
    to_port = entity_test.to_port if compact else tl_test.to_port
    make = ((lambda rng: entity_test.episodes(rng, info, BATCH, T))
            if compact else
            (lambda rng: tl_test.make_episodes(rng, info, BATCH, T)))
    jtrain = jax.jit(jl.train)
    rng = np.random.default_rng(1)
    for step in range(3):
        ep = make(rng)
        w = rng.uniform(0.5, 1.0, BATCH).astype(np.float32)
        jls, jinfo = jtrain(jls, to_jax(ep), jnp.asarray(w), 0, step + 1)
        tls, tinfo = tl.train(tls, to_port(ep), torch.from_numpy(w), 0,
                              step + 1)
        for key in ("loss", "td_error_abs", "q_taken_mean", "target_mean",
                    "td_errors_abs"):
            np.testing.assert_allclose(tinfo[key].numpy(),
                                       np.asarray(jinfo[key]),
                                       err_msg=f"step {step} {key}",
                                       **tl_test.INFO)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-4)
        tl_test._params_close(tls.params, jls.params, f"step {step}")
        tl_test._params_close(tls.target_params, jls.target_params,
                              f"step {step} target")


@pytest.mark.parametrize("compact", [False, True])
def test_remat_reruns_the_online_forward_kernel(monkeypatch, compact):
    """The plain versions run where the card launches the kernels (see
    ``tests/test_torch_learner.py``'s routing test): under remat one
    train step runs K1 + residuals twice per online step with a
    gradient (the forward, then the backward's recompute), K1 and the
    backward kernels as without remat."""
    from t2omca_tpu_torch.kernels import attention as att
    calls = {"k1": 0, "k1_res": 0, "bwd": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(att, "flash_attention_reference",
                        counted("k1", att.flash_attention_reference))
    monkeypatch.setattr(att, "flash_attention_fwd_reference",
                        counted("k1_res", att.flash_attention_fwd_reference))
    monkeypatch.setattr(att, "flash_attention_bwd_reference",
                        counted("bwd", att.flash_attention_bwd_reference))
    case = "compact" if compact else "qslice_pallas"
    tl, info = _learner(_config(case, True))
    ls = tl.init_state(torch.Generator().manual_seed(0))
    tl.train(ls, _batch(case, np.random.default_rng(4), info),
             torch.ones(BATCH), 0, 0)
    depth = 2
    if compact:
        want = {"k1": (T + 1) * depth, "k1_res": 2 * T * depth,
                "bwd": T * depth}
    else:
        want = {"k1": (2 * (T + 1) + 1) * depth, "k1_res": 4 * T * depth,
                "bwd": 2 * T * depth}
    assert calls == want
