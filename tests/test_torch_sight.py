"""Port parity of the learning-health probes (``t2omca_tpu_torch.obs.
sight``) against the JAX package's ``obs/sight.py``, and of the
learner's sight blocks against the JAX learner's.

The same numpy-made inputs go through jitted JAX and the port.
Tolerances:

* the module groups' leaf sets equal flax's, by converted name;
* ``masked_histogram`` exact, values planted on and beside every bin
  edge included (XLA folds ``/ (hi - lo) * bins`` into one float32
  factor; the port writes that form);
* per-module gradient and update norms, ESS and target drift rtol 1e-5;
* attention entropies atol 1e-6 at f32, and within 32 bf16 ULPs
  (``tests/test_torch_entity.py``'s bound) at bf16;
* a whole train step's sight info: the norms at ``grad_norm``'s rtol
  1e-4, ESS, drift and entropies at the info tolerance (rtol 1e-5,
  atol 1e-6), each histogram within one masked element moved between
  bins;
* training with the gate on is bit-identical to training with it off,
  and ``train_info_zeros`` mirrors the keys, shapes and dtypes;
* the detector monitor's logged stats, verdicts and trips equal JAX's
  on one stream, and the learning CLI's stdout is byte-equal to JAX's.
"""

import io
import os
import shutil
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2omca_tpu.config import SightConfig as JaxSightConfig
from t2omca_tpu.obs import sight as jsight
from t2omca_tpu_torch.config import SightConfig, from_dict
from t2omca_tpu_torch.convert import (_state_from_flax,
                                      learner_params_from_flax)
from t2omca_tpu_torch.obs import __main__ as obs_cli
from t2omca_tpu_torch.obs import sight
from t2omca_tpu_torch.run import Experiment, run, run_classic
from t2omca_tpu_torch.utils.logging import Logger

import test_torch_entity as entity_test
import test_torch_learner as tl_test

REPO = os.path.join(os.path.dirname(__file__), "..")
FIXTURE_RUN = os.path.join(REPO, "tests", "fixtures_sight_run")
BATCH, T = tl_test.BATCH, tl_test.T
NORMS = dict(rtol=1e-5, atol=0.0)
SIGHT = {"obs": {"sight": {"enabled": True}}}


def _config(**over):
    return tl_test.config(**{"model.depth": 2, "model.mixer_depth": 2,
                             **SIGHT, **over})


def _np(x):
    return np.asarray(x, np.float64)


# ------------------------------------------------------------ in-graph

def test_module_groups_match_flax_by_name():
    """``agent_tf`` is flax's ``agent["transformer"]`` subtree, ``embed``
    the rest of the agent, ``mixer`` the mixer: the port's groups hold
    the same leaves, matched by their converted names."""
    jl, jls, tl, tls, _ = tl_test.build_pair(_config(), jit_init=True)
    flax_agent = jax.tree.map(np.asarray, jls.params["agent"])["params"]
    want = {
        "agent_tf": set(_state_from_flax(
            {"transformer": flax_agent["transformer"]}, "cpu",
            torch.float32, ())),
        "embed": set(_state_from_flax(
            {k: v for k, v in flax_agent.items() if k != "transformer"},
            "cpu", torch.float32, ())),
        "mixer": set(tls.params["mixer"]),
    }
    named = {m: {k: k for k in sub} for m, sub in tls.params.items()}
    got = sight.module_groups(tl.cfg, named)
    assert tuple(got) == sight.module_group_names(tl.cfg) == \
        jsight.module_group_names(jl.cfg)
    assert {k: set(v) for k, v in got.items()} == want
    # the same leaves as JAX's groups, leaf for leaf by size
    jgroups = jsight.module_groups(jl.cfg, jls.params)
    for name, leaves in sight.module_groups(tl.cfg, tls.params).items():
        assert sorted(x.numel() for x in leaves) == \
            sorted(int(np.size(x)) for x in jgroups[name]), name


@pytest.mark.parametrize("lo,hi,bins", [(-10.0, 10.0, 16), (-50.0, 50.0, 16),
                                        (-3.0, 7.0, 13)])
def test_masked_histogram_matches_jitted_jax(lo, hi, bins):
    rng = np.random.default_rng(0)
    edges = (lo + (hi - lo) / bins * np.arange(bins + 1)).astype(np.float32)
    inf = np.float32(np.inf)
    x = np.concatenate([
        rng.normal(0, hi, 4000), rng.uniform(lo, hi, 4000), edges,
        np.nextafter(edges, inf), np.nextafter(edges, -inf),
        [np.nan, np.inf, -np.inf, 1e12, -1e12]]).astype(np.float32)
    x = np.concatenate([x, np.zeros(-x.size % 7, np.float32)])
    x = x[rng.permutation(x.size)].reshape(-1, 7)
    mask = rng.random((x.shape[0], 1)) < 0.8
    f = jax.jit(jsight.masked_histogram, static_argnums=(2, 3, 4))
    want = np.asarray(f(jnp.asarray(x), jnp.asarray(mask), lo, hi, bins))
    got = sight.masked_histogram(torch.from_numpy(x),
                                 torch.from_numpy(mask), lo, hi, bins)
    assert got.shape == (bins,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # value by value: every planted edge lands in JAX's bin
    planted = np.concatenate([edges, np.nextafter(edges, inf),
                              np.nextafter(edges, -inf)])
    one = jax.jit(jax.vmap(lambda v: jsight.masked_histogram(
        v[None], jnp.ones(1), lo, hi, bins)))(jnp.asarray(planted))
    per = np.stack([sight.masked_histogram(
        torch.from_numpy(planted[i:i + 1]), torch.ones(1), lo, hi,
        bins).numpy() for i in range(planted.size)])
    np.testing.assert_array_equal(per, np.asarray(one))


def test_learner_train_info_matches_jax():
    """Per-module norms of gradients and updates, ESS and drift on the
    same trees: rtol 1e-5."""
    jl, jls, tl, tls, _ = tl_test.build_pair(_config(), jit_init=True)
    rng = np.random.default_rng(3)
    trees = {}
    for name, scale in (("grads", 30.0), ("updates", 1e-3),
                        ("params", 0.5), ("target", 0.5)):
        leaves, treedef = jax.tree.flatten(jls.params)
        jt = jax.tree.unflatten(treedef, [
            (rng.standard_normal(np.shape(x)) * scale).astype(np.float32)
            for x in leaves])
        trees[name] = (jt, learner_params_from_flax(jt, "cpu"))
    w = rng.uniform(0.2, 1.0, BATCH).astype(np.float32)
    want = jax.jit(lambda g, u, p, t, w: jsight.learner_train_info(
        jl.cfg, g, u, p, t, w))(*(trees[k][0] for k in
                                  ("grads", "updates", "params", "target")),
                                jnp.asarray(w))
    got = sight.learner_train_info(tl.cfg, *(trees[k][1] for k in (
        "grads", "updates", "params", "target")), torch.from_numpy(w))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == () and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k,
                                   **NORMS)


def _probe_inputs(rng, info, emb):
    a = info["n_agents"]
    obs = rng.standard_normal((BATCH, a, info["obs_shape"])).astype(
        np.float32)
    ep = entity_test.compact_episodes(rng, BATCH, 0, a, 9, 2)
    mec = ep["mec_index"][:, 0]
    compact = (ep["rows"][:, 0], mec[:, :, None] == mec[:, None, :],
               ep["mean"][:, 0], ep["std"][:, 0])
    state = rng.standard_normal((BATCH, info["state_shape"])).astype(
        np.float32)
    hid = rng.standard_normal((BATCH, a, emb)).astype(np.float32)
    return obs, compact, state, hid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("probe", ["agent_dense", "agent_compact", "mixer"])
def test_attention_entropy_probes_match_jax(probe, dtype):
    d = _config(**{"model.dtype": dtype})
    jl, jls, tl, tls, info = tl_test.build_pair(d, jit_init=True)
    # params 4x their init scale, so the attention is far from uniform
    jls = jls.replace(params=jax.tree.map(lambda x: 4.0 * x, jls.params))
    tls.params = learner_params_from_flax(
        jax.tree.map(np.asarray, jls.params), "cpu")
    obs, compact, state, hid = _probe_inputs(np.random.default_rng(2),
                                             info, d["model"]["emb"])
    t = lambda x: torch.from_numpy(np.asarray(x))
    if probe == "agent_dense":
        want = jax.jit(lambda p, o: jsight.agent_attention_entropy(
            jl, p, o, None))(jls.params["agent"], obs)
        got = sight.agent_attention_entropy(tl, tls.params["agent"], t(obs),
                                            None)
    elif probe == "agent_compact":
        want = jax.jit(lambda p, c: jsight.agent_attention_entropy(
            jl, p, None, c))(jls.params["agent"], compact)
        got = sight.agent_attention_entropy(
            tl, tls.params["agent"], None, tuple(t(x) for x in compact))
    else:
        want = jax.jit(lambda p, s, h: jsight.mixer_attention_entropy(
            jl, p, s, None, h))(jls.params["mixer"], state, hid)
        got = sight.mixer_attention_entropy(tl, tls.params["mixer"],
                                            t(state), None, t(hid))
    assert got.shape == (2,) and got.dtype == torch.float32
    assert bool(((got >= 0) & (got <= 1 + 1e-6)).all())
    assert float(got.min()) < 0.95          # not the uniform attention
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    else:
        entity_test.assert_close_bf16_ulp(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fill", [5, 8])
def test_buffer_sight_info_matches_jax(fill):
    rng = np.random.default_rng(fill)
    pri = rng.uniform(0.05, 2.0, 8).astype(np.float32)
    want = jax.jit(jsight.buffer_sight_info)(jnp.asarray(pri),
                                             jnp.asarray(fill))
    got = sight.buffer_sight_info(torch.from_numpy(pri), fill)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k,
                                   **NORMS)
    host = sight.buffer_sight_info_host(pri, fill)
    jhost = jsight.buffer_sight_info_host(pri, fill)
    assert host == jhost


# ------------------------------------------------------ the train step

@pytest.mark.parametrize("compact", [False, True])
def test_train_step_sight_info_matches_jax(compact):
    over = {"kernels.attention": "pallas",
            "replay.compact_entity_store": compact}
    jl, jls, tl, tls, info = tl_test.build_pair(_config(**over),
                                                jit_init=True)
    rng = np.random.default_rng(1)
    ep = (entity_test.episodes(rng, info, BATCH, T) if compact
          else tl_test.make_episodes(rng, info, BATCH, T))
    to_jax = entity_test.to_jax if compact else tl_test.to_jax
    to_port = entity_test.to_port if compact else tl_test.to_port
    w = rng.uniform(0.5, 1.0, BATCH).astype(np.float32)
    _, jinfo = jax.jit(jl.train)(jls, to_jax(ep), jnp.asarray(w), 0, 1)
    _, tinfo = tl.train(tls, to_port(ep), torch.from_numpy(w), 0, 1)
    keys = {k for k in jinfo if k.startswith("sight_")}
    assert keys == {k for k in tinfo if k.startswith("sight_")}
    assert len(keys) == 13
    mask = ep["filled"].sum()
    for k in sorted(keys):
        got, want = _np(tinfo[k]), _np(jinfo[k])
        assert got.shape == want.shape, k
        if k.endswith("_hist"):
            total = mask * (info["n_agents"] if "q_taken" in k else 1)
            assert abs(got.sum() - 1.0) < 1e-5, k
            assert np.abs(got - want).sum() * total <= 2.0 + 1e-3, k
        elif k.startswith(("sight_grad_norm", "sight_update_norm")):
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **tl_test.INFO)


def _leaves(ls):
    return {f"{n}.{m}.{k}": v
            for n, tree in (("p", ls.params), ("t", ls.target_params),
                            ("mu", ls.opt_state["mu"]),
                            ("nu", ls.opt_state["nu"]))
            for m, sub in tree.items() for k, v in sub.items()}


@pytest.mark.parametrize("compact", [False, True])
def test_sight_on_and_off_train_bit_identical(compact):
    """Two learner steps from the same state and batches with the gate
    on and off: params, target, Adam and the shared info keys equal bit
    for bit; ``train_info_zeros`` mirrors ``train``'s keys, shapes and
    dtypes either way."""
    out = {}
    for on in (False, True):
        d = _config(**{"kernels.attention": "pallas",
                       "replay.compact_entity_store": compact,
                       "obs": {"sight": {"enabled": on}}})
        tcfg = from_dict(d)
        from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
        from t2omca_tpu_torch.envs.registry import make_env
        from t2omca_tpu_torch.learners import QMixLearner
        info = make_env(tcfg.env_args).get_env_info()
        tl = QMixLearner.build(tcfg, BasicMAC.build(tcfg, info,
                                                    device="cpu"),
                               info, device="cpu")
        ls = tl.init_state(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(6)
        for step in range(2):
            ep = (entity_test.episodes(rng, info, BATCH, T) if compact
                  else tl_test.make_episodes(rng, info, BATCH, T))
            batch = (entity_test.to_port if compact else tl_test.to_port)(ep)
            w = torch.from_numpy(rng.uniform(0.5, 1, BATCH)
                                 .astype(np.float32))
            ls, inf = tl.train(ls, batch, w, 0, step + 1)
        zeros = tl.train_info_zeros(BATCH)
        assert set(zeros) == set(inf)
        for k in inf:
            assert zeros[k].shape == inf[k].shape, k
            assert zeros[k].dtype == inf[k].dtype, k
        assert any(k.startswith("sight_") for k in inf) is on
        out[on] = (_leaves(ls), inf)
    (a, ia), (b, ib) = out[False], out[True]
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert set(ia) < set(ib)
    for k in ia:
        assert torch.equal(ia[k], ib[k]), k


def test_loop_with_sight_is_bit_identical_and_reads_the_ring():
    """Two ``run_classic`` iterations on the default stack with the gate
    on and off: the same state bit for bit; with it on the info carries
    the post-update priorities' entropy, which equals JAX's function on
    the ring it leaves."""
    states = {}
    for on in (False, True):
        cfg = from_dict(dict(entity_test.LOOP,
                             obs={"sight": {"enabled": on}}))
        exp = Experiment.build(cfg, device="cpu")
        ts, _, recs = run_classic(exp, exp.init_state(0), 2)
        states[on] = (ts, recs)
    (ta, ra), (tb, rb) = states[False], states[True]
    assert torch.equal(ta.buffer.priorities, tb.buffer.priorities)
    for m in ta.learner.params:
        for k in ta.learner.params[m]:
            assert torch.equal(ta.learner.params[m][k],
                               tb.learner.params[m][k]), (m, k)
    info = rb[-1].info
    assert "sight_priority_entropy" not in ra[-1].info
    want = jsight.buffer_sight_info(jnp.asarray(tb.buffer.priorities.numpy()),
                                    tb.buffer.episodes_in_buffer)
    for k in want:
        np.testing.assert_allclose(_np(info[k]), _np(want[k]), err_msg=k,
                                   **NORMS)


# ------------------------------------------------------------ host side

class _Rec:
    def __init__(self):
        self.marks = []

    def mark(self, kind, **meta):
        self.marks.append((kind, meta))


class _Log:
    def __init__(self):
        self.rows = []

    def log_stat(self, key, value, t):
        v = np.asarray(value)
        self.rows.append((key, v.tolist() if v.ndim else float(v), t))


def _stream():
    """Eight log cadences that trip and clear several detectors."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(8):
        info = {"loss": 2.0 + (0.001 if i > 2 else rng.random()),
                "q_taken_mean": 3.0 if i != 4 else 2e4,
                "target_mean": -1.0,
                "sight_per_ess": 0.9 if i < 5 else 0.01,
                "sight_priority_entropy_norm": np.float32(0.8),
                "sight_grad_norm_agent_tf": np.float32(1.0),
                "sight_grad_norm_embed": np.float32(1e-5),
                "sight_grad_norm_mixer": np.float32(2.0),
                "sight_attn_entropy_agent": np.array([0.7, 0.6], np.float32),
                "sight_attn_entropy_mixer": np.array(
                    [0.5, 0.01 if i == 6 else 0.4], np.float32),
                "sight_td_hist": np.full(16, 1 / 16, np.float32)}
        out.append((info, 1000 * (i + 1)))
    return out


def test_monitor_matches_jax_on_one_stream():
    kw = dict(window=3)
    mons = []
    for mod, cfg in ((sight, SightConfig(**kw)), (jsight,
                                                   JaxSightConfig(**kw))):
        log, rec = _Log(), _Rec()
        mon = mod.SightMonitor(cfg, logger=log, rec=rec)
        trips = [mon.observe(info, t) for info, t in _stream()]
        mons.append((log.rows, rec.marks, trips, mon.report()))
    assert mons[0] == mons[1]
    rows, marks, trips, report = mons[0]
    assert report["trips_total"] >= 3 and any(trips)
    assert {m[1]["detector"] for m in marks} >= {"q_divergence",
                                                  "priority_collapse",
                                                  "attention_collapse"}


def test_make_monitor_gates_and_refuses_a_population():
    """Off is None, on is a ``SightMonitor``, and a population gets the
    per-member ``PopulationSightMonitor`` (it raised before the population
    was ported; ``tests/test_torch_population.py`` holds it against
    JAX's): one monitor a member, named ``pop<i>`` at P > 1 and as the solo
    run at P = 1."""
    from types import SimpleNamespace
    off = SimpleNamespace(sight=SightConfig())
    on = SimpleNamespace(sight=SightConfig(enabled=True))
    assert sight.make_monitor(off) is None
    assert sight.make_monitor(off, population=2) is None
    assert isinstance(sight.make_monitor(on), sight.SightMonitor)
    for p in (1, 3):
        mon = sight.make_monitor(on, population=p)
        assert isinstance(mon, sight.PopulationSightMonitor)
        assert [m.member for m in mon.members] == (
            [None] if p == 1 else [0, 1, 2])


def _stdout(fn, *a):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(*a)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def port_run_dir(tmp_path_factory):
    import test_torch_driver as drv
    root = tmp_path_factory.mktemp("sight_run")
    run(from_dict(drv.tiny(root, **SIGHT)), Logger(), device="cpu")
    (d,) = [p for p in root.iterdir() if p.is_dir() and p.name != "models"]
    return str(d)


@pytest.mark.parametrize("which", ["fixture", "port_run", "missing"])
def test_learning_cli_matches_jax(which, port_run_dir, tmp_path):
    run_dir = {"fixture": FIXTURE_RUN, "port_run": port_run_dir,
               "missing": str(tmp_path / "nope")}[which]
    got = _stdout(sight.learning_main, run_dir)
    assert got == _stdout(jsight.learning_main, run_dir)
    if which == "missing":
        assert got == (2, "")
        return
    assert got[0] == 0 and "verdict:" in got[1]
    assert _stdout(obs_cli.main, ["learning", run_dir]) == got
    if which == "port_run":
        assert "attn entropy mixer (per layer)" in got[1]


def test_obs_cli_report_and_timeline_name_item_13b(tmp_path, capsys):
    """Once refusals naming ROADMAP item 13b; both subcommands are
    ported. The fixture run holds no spans: ``report`` refuses it (exit
    2) and reads it once a span stream sits beside its metrics, with the
    learning section; ``timeline`` reads it."""
    assert obs_cli.main(["report", FIXTURE_RUN]) == 2
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    shutil.copy(os.path.join(FIXTURE_RUN, "metrics.jsonl"), run_dir)
    (run_dir / "spans.jsonl").write_text(
        '{"event": "mark", "kind": "run", "backend": "cpu"}\n'
        '{"event": "span", "phase": "dispatch.superstep", "wall_ms": 5.0}\n')
    capsys.readouterr()
    assert obs_cli.main(["report", str(run_dir)]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"graftscope report — {run_dir}")
    assert "graftsight learning report" in out
    assert obs_cli.main(["timeline", "--runs", FIXTURE_RUN]) == 0
    assert "graftpulse timeline" in capsys.readouterr().out
