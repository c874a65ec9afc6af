"""Port parity of the serving artifact (``t2omca_tpu_torch/serve/export.py``,
``ServeFrontend.load``, ``python -m t2omca_tpu_torch.serve``), held to the
contract of ``tests/test_serve.py``'s export tests:

* a checkpoint that the port's CLI trained on ``configs/serve_smoke.yaml``
  (``python -m t2omca_tpu_torch train --device cpu``, ``t_max`` cut),
  exported through the serving CLI; the artifact's layout and provenance;
* f32 bit parity of the loaded front end with ``select_actions`` in test
  mode (actions and hidden states identical over carried requests of 1,
  3, 4 and 7 rows), the bf16 variant within ``test_serve.py``'s 0.15;
* the CLI's ``export``/``info`` and exit 2 on a missing checkpoint; a
  tampered blob, a checkpoint of another model, a newer format and a
  foreign artifact refused; no load on a card that is not there;
* the folded f32 leaves against the JAX ``prepare_acting_params`` on the
  same flax params (carried by ``convert.py``) at ``test_qslice.py``'s
  1e-5.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from t2omca_tpu import config as jax_config
from t2omca_tpu.controllers.basic_mac import BasicMAC as JaxMAC
from t2omca_tpu.envs.registry import make_env as jax_make_env
from t2omca_tpu_torch import __main__ as cli
from t2omca_tpu_torch import prng
from t2omca_tpu_torch.config import from_dict, load_config
from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
from t2omca_tpu_torch.convert import agent_state_from_flax
from t2omca_tpu_torch.envs.registry import make_env
from t2omca_tpu_torch.run import Experiment
from t2omca_tpu_torch.serve import __main__ as serve_cli
from t2omca_tpu_torch.serve.export import (AGENT_PREFIX, FRAMEWORK,
                                           export_artifact,
                                           load_acting_params)
from t2omca_tpu_torch.serve.frontend import ServeFrontend
from t2omca_tpu_torch.utils.checkpoint import _read_tensors, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "serve_smoke.yaml")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(checkpoint dir, artifact dir, meta): the port's CLI trains the
    smoke recipe on the CPU, the serving CLI exports it."""
    root = tmp_path_factory.mktemp("artifact")
    # cut in t_max only: 4 iterations, a checkpoint after the first
    # train step
    assert cli.main(["train", "--config", SMOKE, "--device", "cpu",
                     "t_max=128", f"local_results_path={root / 'res'}"]) == 0
    ck = glob.glob(str(root / "res" / "models" / "*"))[0]
    art = str(root / "art")
    assert serve_cli.main(["export", ck, "--config", SMOKE, "--out", art,
                           "--buckets", "1,2,4", "--device", "cpu"]) == 0
    with open(os.path.join(art, "meta.json")) as f:
        return ck, art, json.load(f)


def test_export_artifact_layout_and_provenance(trained):
    ck, art, meta = trained
    cfg = load_config(SMOKE)
    assert meta["format"] == 1 and meta["framework"] == FRAMEWORK
    steps = sorted(int(s) for s in os.listdir(ck) if s.isdigit())
    assert meta["checkpoint"]["t_env"] == steps[-1]
    with open(os.path.join(ck, str(steps[-1]), "meta.json")) as f:
        assert meta["checkpoint"]["state_sha256"] == json.load(f)["sha256"]
    assert meta["buckets"] == [1, 2, 4] and meta["folded"]
    assert meta["provenance"]["torch"] == torch.__version__
    assert meta["provenance"]["device"] == "cpu"
    assert from_dict(meta["train_config"]) == cfg
    assert (meta["n_agents"], meta["emb"]) == (cfg.env_args.agv_num,
                                               cfg.model.emb)
    for dt in ("float32", "bfloat16"):
        p = meta["params"][dt]
        path = os.path.join(art, p["file"])
        assert os.path.getsize(path) == p["bytes"]
        flat = torch.load(path, weights_only=True)
        assert all(v.device.type == "cpu" for v in flat.values())
        assert {v.dtype for v in flat.values()} == {getattr(torch, dt)}
    # no programs and no compile cache: the port has neither
    assert sorted(os.listdir(art)) == ["meta.json", "params_bfloat16.pt",
                                       "params_float32.pt"]
    assert (meta["params"]["bfloat16"]["bytes"]
            < 0.75 * meta["params"]["float32"]["bytes"])


def test_serve_bit_parity_with_training_select_actions(trained):
    """f32 actions and hiddens of the loaded front end equal
    ``select_actions(test_mode=True)`` on the checkpoint's agent params,
    with the hidden carried across requests, at batch 1, a bucket
    boundary plus one, an exact bucket and beyond the largest bucket."""
    ck, art, meta = trained
    fe = ServeFrontend.load(art, dtype="float32", device="cpu")
    cfg = from_dict(meta["train_config"])
    mac = BasicMAC.build(cfg, make_env(cfg.env_args).get_env_info(),
                         device="cpu")
    raw = _read_tensors(meta["checkpoint"]["dir"], False, "cpu",
                        prefix=AGENT_PREFIX)
    params = mac.prepare_acting_params(raw)
    a, d, na = fe.n_agents, fe.obs_dim, fe.n_actions
    rng = np.random.default_rng(7)
    for n in (1, 3, 4, 7):
        h_ref = torch.zeros(n, a, fe.emb)
        h_fe = None
        for step in range(3):
            obs = rng.standard_normal((n, a, d)).astype(np.float32)
            avail = rng.random((n, a, na)) < 0.7
            avail[..., 0] = True
            a_ref, h_ref, _ = mac.select_actions(
                params, torch.from_numpy(obs), torch.from_numpy(avail),
                h_ref, prng.PRNGKey(step, "cpu"), 10_000, test_mode=True)
            a_fe, h_fe = fe.select(obs, avail, h_fe)
            np.testing.assert_array_equal(a_ref.numpy(), a_fe,
                                          err_msg=f"n={n} step={step}")
            np.testing.assert_array_equal(h_ref.numpy(), h_fe,
                                          err_msg=f"hidden n={n} step={step}")


def test_serve_bf16_variant_within_tolerance(trained):
    _, art, _ = trained
    fe32 = ServeFrontend.load(art, dtype="float32", device="cpu")
    fe16 = ServeFrontend.load(art, dtype="bfloat16", device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in
               [fe16.params["tf"]["blocks"][0]["wqk"],
                fe16.params["fe"]["weight"]])
    rng = np.random.default_rng(3)
    obs = rng.standard_normal((4, fe32.n_agents,
                               fe32.obs_dim)).astype(np.float32)
    avail = np.ones((4, fe32.n_agents, fe32.n_actions), np.bool_)
    a16, h16 = fe16.select(obs, avail)
    _, h32 = fe32.select(obs, avail)
    assert ((a16 >= 0) & (a16 < fe32.n_actions)).all()
    np.testing.assert_allclose(h16, h32, atol=0.15, rtol=0.15)


def test_serve_export_cli_and_info(trained, tmp_path, capsys):
    """A second artifact through the CLI (overrides after ``--config``,
    one variant, two buckets), ``info`` on it, and exit 2 on a missing
    checkpoint, a bad artifact and ``refresh``."""
    ck, _, _ = trained
    out = str(tmp_path / "art2")
    assert serve_cli.main(["export", ck, "--config", SMOKE, "--out", out,
                           "--buckets", "1,2", "--dtypes", "float32",
                           "--device", "cpu", "test_nepisode=8"]) == 0
    assert "artifact written" in capsys.readouterr().out
    assert serve_cli.main(["info", out]) == 0
    said = capsys.readouterr().out
    assert "buckets: [1, 2]" in said and "params[float32]" in said
    assert "params[bfloat16]" not in said
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f)["train_config"]["test_nepisode"] == 8
    fe = ServeFrontend.load(out, device="cpu")
    a_out, _ = fe.select(np.zeros((3, fe.n_agents, fe.obs_dim), np.float32),
                         np.ones((3, fe.n_agents, fe.n_actions), np.bool_))
    assert a_out.shape == (3, fe.n_agents)
    assert serve_cli.main(["export", str(tmp_path / "none"), "--config",
                           SMOKE, "--device", "cpu"]) == 2
    assert "no valid checkpoint" in capsys.readouterr().err
    assert serve_cli.main(["info", str(tmp_path / "none")]) == 2
    # the refresh dry run: its own checkpoint is compatible, a missing
    # one refused
    assert serve_cli.main(["refresh", out, ck, "--device", "cpu"]) == 0
    assert "refresh compatible" in capsys.readouterr().out
    assert serve_cli.main(["refresh", out, str(tmp_path / "none"),
                           "--device", "cpu"]) == 2
    assert "REFUSED" in capsys.readouterr().err


def test_tampered_blob_and_foreign_artifacts_refused(trained, tmp_path):
    ck, art, meta = trained
    bad = tmp_path / "bad"
    bad.mkdir()
    for name in os.listdir(art):
        with open(os.path.join(art, name), "rb") as f:
            (bad / name).write_bytes(f.read())
    blob = bytearray((bad / "params_float32.pt").read_bytes())
    blob[len(blob) // 2] ^= 0x01
    (bad / "params_float32.pt").write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="integrity"):
        ServeFrontend.load(str(bad), device="cpu")
    ServeFrontend.load(str(bad), dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="no 'float16'"):
        ServeFrontend.load(art, dtype="float16", device="cpu")
    for key, value, match in (("format", 2, "newer"),
                              ("framework", None, "JAX package")):
        m = dict(meta)
        m[key] = value
        (bad / "meta.json").write_text(json.dumps(m))
        with pytest.raises(ValueError, match=match):
            ServeFrontend.load(str(bad), dtype="bfloat16", device="cpu")
    # the default device is the card: with none, the load raises
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeFrontend.load(art)


def test_checkpoint_of_another_model_refused(trained, tmp_path, capsys):
    ck, _, _ = trained
    cfg = load_config(SMOKE, ("model.emb=8", "model.mixer_emb=8"))
    with pytest.raises(ValueError, match="different MODEL"):
        export_artifact(cfg, ck, str(tmp_path / "x"), device="cpu")
    assert not os.path.exists(tmp_path / "x")
    assert serve_cli.main(["export", ck, "--config", SMOKE, "--out",
                           str(tmp_path / "y"), "--device", "cpu",
                           "model.heads=4"]) == 2
    assert "different MODEL" in capsys.readouterr().err


@pytest.mark.parametrize("standard_heads", [False, True],
                         ids=["q1_heads", "standard_heads"])
def test_folded_leaves_match_jax_fold(tmp_path, standard_heads):
    """The export's fold of a checkpoint whose agent holds flax-made
    params equals the JAX ``prepare_acting_params`` of those params at
    the train dtype: every block's folded products and biases."""
    d = {"env_args": {"agv_num": 3, "mec_num": 2, "num_channels": 2,
                      "episode_limit": 4},
         "batch_size_run": 2, "batch_size": 2,
         "replay": {"buffer_size": 4},
         "model": {"emb": 16, "heads": 2, "depth": 2, "mixer_emb": 16,
                   "mixer_heads": 2, "mixer_depth": 1,
                   "standard_heads": standard_heads}}
    jcfg = jax_config.from_dict(d)
    info = jax_make_env(jcfg.env_args).get_env_info()
    jmac = JaxMAC.build(jcfg, info)
    variables = jmac.init_params(jax.random.PRNGKey(3), info["obs_shape"])
    jfold = jmac.prepare_acting_params(variables, dtype=jmac.agent.dtype)
    cfg = from_dict(d)
    exp = Experiment.build(cfg, device="cpu")
    ts = exp.init_state(0)
    ts.learner.params["agent"] = agent_state_from_flax(
        jax.tree.map(np.asarray, variables), device="cpu")
    save_checkpoint(str(tmp_path / "models"), 8, ts)
    acting, mac, _, ck = load_acting_params(cfg, str(tmp_path / "models"),
                                            device="cpu")
    assert ck["t_env"] == 8 and mac.use_qslice
    tol = dict(rtol=1e-5, atol=1e-5)
    for jb, tb in zip(jfold["tf"]["blocks"], acting["tf"]["blocks"]):
        for leaf in ("wqk", "wvu", "u_bias"):
            assert tb[leaf].dtype == torch.float32
            np.testing.assert_allclose(tb[leaf].numpy(),
                                       np.asarray(jb[leaf]), **tol)
    np.testing.assert_allclose(acting["fe"]["weight"].numpy().T,
                               np.asarray(jfold["fe"]["kernel"]), **tol)
