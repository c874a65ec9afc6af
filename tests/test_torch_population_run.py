"""The population driver (``t2omca_tpu_torch.run.run`` with
``population.size = P``) against JAX's ``run`` on the CPU, and the port's
own exact resume of a population.

The config is ``tests/test_torch_population_dispatch.py``'s ``cfg7``: its
cut config 7 (P = 2 with an lr, epsilon and PER-exponent grid and the
scenario salt, 4 lanes of 20 steps, 4 AGVs, the mixture, a ring of 8,
emb 8, depth 1, K = 2) with batch 8 (the gate opens in the second
iteration, after its rollout), ``obs.sight`` on, every cadence at each
of two dispatches and ``population.pbt.enabled``. JAX's members are initialized with its
learner, runner and buffer inits jitted (JAX's eager runner init rounds
the AGV positions of this config differently from its jitted one, which
the port follows), and the port starts from JAX's params
(``run(learner_params=[...])``). What is held:

* the set of ``(key, t)`` rows equals JAX's: ``pop<i>_*`` rows, the
  aggregate rows, ``test_pop<i>_*``, ``pop<i>_sight_*`` and
  ``pbt_copies``;
* every value the rollouts made before the first train step is exact
  (the first cadence's training-rollout rows, aggregate and per member),
  the first train step's learner rows per member and their across-member
  mean within ``tests/test_torch_loop.py``'s tolerances (``grad_norm`` at
  the default stack's 2e-3), and ``pbt_copies`` equal (the ranking is
  made from those exact returns);
(The population's exact resume is in
``tests/test_torch_population_dispatch.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from t2omca_tpu import population as jpop
from t2omca_tpu.config import from_dict as jax_from_dict
from t2omca_tpu.run import Experiment as JaxExperiment
from t2omca_tpu.run import TrainState as JaxTrainState
from t2omca_tpu.run import run as jax_run
from t2omca_tpu.utils.logging import Logger as JaxLogger
from t2omca_tpu_torch.config import from_dict
from t2omca_tpu_torch.convert import learner_params_from_flax
from t2omca_tpu_torch.run import run
from t2omca_tpu_torch.utils.logging import Logger

from test_torch_driver import INFO, LEARNER_KEYS, rows_of, wall_clock
from test_torch_population_dispatch import cfg7


def _jitted_init(self, seed):
    """JAX's ``init_train_state`` with each init jitted."""
    k_learner, k_runner = jax.random.split(jax.random.PRNGKey(seed))
    return JaxTrainState(learner=jax.jit(self.learner.init_state)(k_learner),
                         runner=jax.jit(self.runner.init_state)(k_runner),
                         buffer=jax.jit(self.buffer.init)(),
                         episode=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX rows, port rows) of one run each."""
    root = tmp_path_factory.mktemp("pop")
    inits = []
    mp = pytest.MonkeyPatch()
    original = jpop.init_population

    def keep(exp, cfg):
        out = original(exp, cfg)
        # the driver donates the state: keep a host copy of the params
        inits.append(jax.tree.map(np.asarray, out[0].learner.params))
        return out

    mp.setattr(JaxExperiment, "init_train_state", _jitted_init)
    mp.setattr(jpop, "init_population", keep)
    try:
        jax_run(jax_from_dict(cfg7(root / "jax")), JaxLogger())
    finally:
        mp.undo()
    (jparams,) = inits
    params = [learner_params_from_flax(jax.tree.map(
        lambda x, m=m: x[m], jparams), "cpu") for m in range(2)]
    run(from_dict(cfg7(root / "port")), Logger(), device="cpu",
        learner_params=params)
    return rows_of(root / "jax"), rows_of(root / "port")


def test_population_rows_match_jax_driver(both):
    rj, rt = both
    assert set(rt) == set(rj)
    keys = {k for k, _ in rt}
    for m in range(2):
        assert {f"pop{m}_return_mean", f"pop{m}_loss", f"pop{m}_grad_norm",
                f"pop{m}_task_completion_rate_mean",
                f"test_pop{m}_return_mean",
                f"pop{m}_sight_per_ess"} <= keys
    assert not any(k.startswith("pop2_") for k in keys)
    first_train = min(t for (k, t) in rj if k == "loss")
    assert first_train == 160
    early = [k for k in rj if not wall_clock(k[0]) and k[1] == first_train
             and not k[0].startswith(("test_", "sight_", "pbt"))
             and "sight_" not in k[0]
             and not k[0].endswith(LEARNER_KEYS)
             and k[0] not in ("stat_fetches",)]
    assert ("pop1_return_mean", 160) in early and len(early) > 20
    for k in early:
        assert rt[k] == rj[k], (k, rt[k], rj[k])
    for name in LEARNER_KEYS:
        tol = dict(rtol=2e-3, atol=1e-6) if name == "grad_norm" else INFO
        for key in (name, "pop0_" + name, "pop1_" + name):
            np.testing.assert_allclose(rt[(key, 160)], rj[(key, 160)],
                                       err_msg=key, **tol)
    pbt = sorted(k for k in rj if k[0] == "pbt_copies")
    assert pbt and pbt[0] == ("pbt_copies", 160)
    assert rt[pbt[0]] == rj[pbt[0]] == 1
    for k, v in rt.items():
        assert np.all(np.isfinite(v)), k
