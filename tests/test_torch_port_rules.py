"""Rules of the PyTorch port, checked statically and on the CPU.

* Nothing under ``t2omca_tpu_torch/`` and nothing in ``chip_smoke.py``
  imports ``jax``, ``flax`` or the JAX package ``t2omca_tpu`` (the port
  keeps its own copy of what it needs).
* Entry points default to the CUDA card and raise without one unless
  the caller asks for ``device="cpu"``.
* The kernel sources and the builder exist and target ``sm_90a``.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(REPO, "t2omca_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "t2omca_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    """Top-level package of every absolute import in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_flax_or_jax_package():
    files = _port_files()
    assert len(files) > 15 and all(os.path.isfile(f) for f in files)
    bad = [(os.path.relpath(f, REPO), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert bad == [], bad


def test_import_scan_catches_a_forbidden_import(tmp_path):
    """The scan distinguishes the JAX package from the port's own name."""
    p = tmp_path / "m.py"
    p.write_text("import t2omca_tpu_torch.config\n"
                 "from t2omca_tpu.config import TrainConfig\n"
                 "from flax import linen\n")
    assert [r for r in _imported_roots(str(p)) if r in FORBIDDEN] == \
        ["t2omca_tpu", "flax"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cfg():
    from t2omca_tpu_torch.config import from_dict
    return from_dict({"env_args": {"agv_num": 2, "mec_num": 1,
                                   "num_channels": 2},
                      "model": {"emb": 8, "heads": 2, "depth": 1,
                                "mixer_emb": 8, "mixer_heads": 2},
                      "replay": {"compact_entity_store": False}})


def test_entry_points_raise_without_cuda_unless_cpu_named(no_cuda):
    from t2omca_tpu_torch.components.episode_buffer import (
        PrioritizedReplayBuffer, ReplayBuffer)
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.convert import (agent_state_from_flax,
                                          mixer_state_from_flax)
    from t2omca_tpu_torch.learners import QMixLearner
    from t2omca_tpu_torch.device import resolve_device
    from t2omca_tpu_torch.envs.registry import make_env
    from t2omca_tpu_torch.serve.frontend import ServeFrontend
    cfg = _cfg()
    info = make_env(cfg.env_args).get_env_info()
    tree = {"feat_embedding": {"bias": np.zeros(8)}}
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.__main__ import main
    from t2omca_tpu_torch.run import Experiment, run
    cpu_mac = BasicMAC.build(cfg, info, device="cpu")
    buf_kw = dict(capacity=4, episode_limit=3, n_agents=2, n_actions=3,
                  obs_dim=info["obs_shape"], state_dim=info["state_shape"])
    cpu_key = prng.split(prng.PRNGKey(0, "cpu"), 2)
    for call in (lambda: resolve_device(),
                 lambda: prng.PRNGKey(0),
                 lambda: Experiment.build(cfg),
                 lambda: make_env(cfg.env_args).default_params(2),
                 lambda: make_env(cfg.env_args).reset(cpu_key),
                 lambda: resolve_device("cuda"),
                 lambda: BasicMAC.build(cfg, info),
                 lambda: agent_state_from_flax(tree),
                 lambda: mixer_state_from_flax(tree),
                 lambda: QMixLearner.build(cfg, cpu_mac, info),
                 lambda: ReplayBuffer(**buf_kw),
                 lambda: PrioritizedReplayBuffer(**buf_kw),
                 lambda: ServeFrontend(cfg, {}, (1,)),
                 lambda: run(cfg),
                 lambda: main(["train", "t_max=10",
                               "env_args.agv_num=2"])):
        with pytest.raises(RuntimeError, match="CUDA|cuda"):
            call()
    # the explicit CPU request builds, inits and serves
    mac = BasicMAC.build(cfg, info, device="cpu")
    params = mac.init_params(torch.Generator().manual_seed(0))
    assert all(v.device.type == "cpu" for v in params.values())
    assert mac.init_hidden(2).device.type == "cpu"
    learner = QMixLearner.build(cfg, mac, info, device="cpu")
    ls = learner.init_state(torch.Generator().manual_seed(0))
    assert all(v.device.type == "cpu" for sub in ls.params.values()
               for v in sub.values())
    assert ReplayBuffer(device="cpu", **buf_kw).init().priorities.device \
        .type == "cpu"
    exp = Experiment.build(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_entity_tables=False)), device="cpu")
    ts = exp.init_state(0)
    assert ts.runner.env_states.pos.device.type == "cpu"
    assert ts.runner.key.device.type == "cpu"
    fe = ServeFrontend(cfg, params, (1, 2), device="cpu")
    actions, _ = fe.select(np.zeros((3, 2, info["obs_shape"]), np.float32),
                           np.ones((3, 2, info["n_actions"]), np.bool_))
    assert actions.shape == (3, 2)


def test_init_params_are_seeded_and_complete():
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.envs.registry import make_env
    cfg = _cfg()
    mac = BasicMAC.build(cfg, make_env(cfg.env_args).get_env_info(),
                         device="cpu")
    p1 = mac.init_params(torch.Generator().manual_seed(3))
    p2 = mac.init_params(torch.Generator().manual_seed(3))
    p3 = mac.init_params(torch.Generator().manual_seed(4))
    assert set(p1) == set(dict(mac.agent.named_parameters()))
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert not torch.equal(p1["feat_embedding.weight"],
                           p3["feat_embedding.weight"])


def test_exploration_draws_from_the_key_chain():
    """Exploration is ported: the selector draws from the key it is
    given (the same key, the same actions), test mode is greedy."""
    from t2omca_tpu_torch import prng
    from t2omca_tpu_torch.controllers.basic_mac import BasicMAC
    from t2omca_tpu_torch.envs.registry import make_env
    cfg = _cfg()
    info = make_env(cfg.env_args).get_env_info()
    mac = BasicMAC.build(cfg, info, device="cpu")
    params = mac.init_params(torch.Generator().manual_seed(0))
    obs = torch.randn(8, 2, info["obs_shape"],
                      generator=torch.Generator().manual_seed(1))
    avail = torch.ones(8, 2, info["n_actions"], dtype=torch.bool)
    key = prng.PRNGKey(3, "cpu")
    act = lambda k, test: mac.select_actions(params, obs, avail,
                                             mac.init_hidden(8), k, 0,
                                             test_mode=test)
    (a1, _, e1), (a2, _, _) = act(key, False), act(key, False)
    assert torch.equal(a1, a2) and float(e1) == 1.0
    greedy, _, e0 = act(key, True)
    assert float(e0) == 0.0 and not torch.equal(a1, greedy)
    assert torch.equal(greedy, act(prng.PRNGKey(4, "cpu"), True)[0])


NEW_MODULES = ("prng.py", "run.py", "xla_float.py", "__main__.py",
               os.path.join("runners", "parallel_runner.py"),
               os.path.join("runners", "episode_runner.py"),
               os.path.join("envs", "normalization.py"),
               os.path.join("envs", "critic.py"),
               os.path.join("envs", "graftworld.py"),
               os.path.join("components", "transforms.py"),
               os.path.join("utils", "ioutil.py"),
               os.path.join("utils", "timehelper.py"),
               os.path.join("utils", "logging.py"),
               os.path.join("utils", "stats.py"),
               os.path.join("utils", "profiling.py"),
               os.path.join("utils", "resilience.py"),
               os.path.join("utils", "watchdog.py"),
               os.path.join("utils", "checkpoint.py"),
               os.path.join("obs", "spans.py"),
               os.path.join("obs", "memwatch.py"))


def test_import_scan_covers_the_loop_modules():
    scanned = {os.path.relpath(f, PORT) for f in _port_files()}
    assert set(NEW_MODULES) <= scanned


def test_env_job_and_collision_path_has_no_matmul():
    """The job compaction and the collision histogram are exact integer
    work: ``envs/mec_offload.py`` calls no matmul or einsum (a TF32 or
    bf16 product would round payload sizes) and uses no ``@``."""
    path = os.path.join(PORT, "envs", "mec_offload.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    banned = {"matmul", "einsum", "mm", "bmm", "dot", "tensordot",
              "linear", "addmm", "baddbmm", "mv", "inner", "outer"}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute) else
                    getattr(fn, "id", ""))
            if name in banned:
                found.append((node.lineno, name))
        elif isinstance(node, ast.BinOp) and isinstance(node.op,
                                                         ast.MatMult):
            found.append((node.lineno, "@"))
    assert found == []
    src = open(path).read()
    assert "scatter_add_" in src and "scatter_(" in src


def test_kernel_sources_and_builder_target_sm90a():
    """The builder targets sm_90a; every kernel body is its own CUDA source
    bound by a small op file, and computes its own products (no library
    GEMM); the C entry files flash_fwd.cu and flash_bwd.cu hold no kernel
    and say so."""
    csrc = os.path.join(PORT, "kernels", "csrc")
    build = open(os.path.join(PORT, "kernels", "build.py")).read()
    assert "sm_90a" in build and "compute_90a" in build
    for cu_name, op_name, kernels in (
            ("flash_fwd_tc.cu", "flash_fwd_op.cpp", ("flash_fwd_tc_kernel",)),
            ("flash_fwd_dmma.cu", "flash_fwd_op.cpp",
             ("flash_fwd_dmma_kernel",)),
            ("flash_bwd_tc.cu", "flash_bwd_op.cpp",
             ("flash_bwd_dkv_tc_kernel",)),
            ("flash_bwd_dkv_3xtf32.cu", "flash_bwd_op.cpp",
             ("flash_bwd_dkv_3xtf32_kernel",)),
            ("flash_bwd_dq_tc.cu", "flash_bwd_op.cpp",
             ("flash_bwd_dq_tc_kernel", "flash_bwd_dq_3xtf32_kernel"))):
        cu = open(os.path.join(csrc, cu_name)).read()
        op = open(os.path.join(csrc, op_name)).read()
        assert "sm_90a" in cu and "TORCH_LIBRARY" in op
        assert "__global__" in cu and all(k in cu for k in kernels)
        # the kernels compute their own products: no library GEMM inside
        for lib in ("cublas", "cudnn", "torch::", "at::matmul"):
            assert lib not in cu.lower()
    for entry in ("flash_fwd.cu", "flash_bwd.cu"):
        cu = open(os.path.join(csrc, entry)).read()
        assert "sm_90a" in cu and "__global__" not in cu
        assert "entry point" in cu.split("\n\n")[0]


def test_bf16_bodies_are_tensor_core_kernels():
    """Every body of every kernel, at both dtypes, is a tensor-core kernel:
    bf16 on mma.sync m16n8k16; at f32, K2 and K3 as 3xTF32 on mma.sync
    m16n8k8 and K1 on the FP64 tensor cores (mma.sync m16n8k4 f64), all
    from flash_mma.cuh (no library call computes their products). The
    CUDA-core bodies (the K1 and K3 of the first slices, the old K2) and
    the helpers only they used are gone, and the C entry points send f32
    to the f32 tensor-core bodies and bf16 to the m16n8k16 ones."""
    import re
    csrc = os.path.join(PORT, "kernels", "csrc")
    read = lambda n: open(os.path.join(csrc, n)).read()
    mma = read("flash_mma.cuh")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in mma
    assert "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64" in mma
    assert "ldmatrix" in mma and "cp.async" in mma
    for name, kernel, entry, product in (
            ("flash_fwd_tc.cu", "flash_fwd_tc_kernel", "t2o_flash_fwd_bf16",
             "mma_bf16("),
            ("flash_fwd_dmma.cu", "flash_fwd_dmma_kernel",
             "t2o_flash_fwd_f32", "mma_f64("),
            ("flash_bwd_tc.cu", "flash_bwd_dkv_tc_kernel",
             "t2o_flash_bwd_dkv_bf16", "mma_bf16("),
            ("flash_bwd_dkv_3xtf32.cu", "flash_bwd_dkv_3xtf32_kernel",
             "t2o_flash_bwd_dkv_f32", "mma_3xtf32("),
            ("flash_bwd_dq_tc.cu", "flash_bwd_dq_tc_kernel",
             "t2o_flash_bwd_dq_bf16", "mma_bf16("),
            ("flash_bwd_dq_tc.cu", "flash_bwd_dq_3xtf32_kernel",
             "t2o_flash_bwd_dq_f32", "mma_3xtf32(")):
        cu = read(name)
        assert "sm_90a" in cu and '#include "flash_mma.cuh"' in cu
        assert "__global__" in cu and kernel in cu and entry in cu
        assert product in cu
        for lib in ("cublas", "cudnn", "torch::", "at::matmul", "wmma"):
            assert lib not in cu.lower()
    sources = {n: read(n) for n in os.listdir(csrc)}
    for gone in ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                 "flash_bwd_dq_kernel", "launch_dkv", "launch_dq"):
        assert not any(re.search(rf"\b{gone}\b", src)
                       for src in sources.values()), gone
    common = sources["flash_common.cuh"]
    for helper in ("dot4", "fma4", "kAccTiles", "struct Slab", "stage(",
                   "write4"):
        assert helper not in common, helper
    fwd, bwd = sources["flash_fwd.cu"], sources["flash_bwd.cu"]
    assert "dtype == 0 ? t2o_flash_fwd_f32 : t2o_flash_fwd_bf16" in fwd
    assert "dtype == 0 ? t2o_flash_bwd_dq_f32 : t2o_flash_bwd_dq_bf16" in bwd
    assert ("dtype == 0 ? t2o_flash_bwd_dkv_f32 : t2o_flash_bwd_dkv_bf16"
            in bwd)


def test_builder_names_every_source_and_build_dir_is_ignored():
    from t2omca_tpu_torch.kernels import build
    listed = set(build.CUDA_SOURCES + build.HOST_SOURCES + build.HEADERS)
    assert {"flash_bwd.cu", "flash_bwd_op.cpp", "flash_fwd_tc.cu",
            "flash_fwd_dmma.cu", "flash_bwd_tc.cu",
            "flash_bwd_dkv_3xtf32.cu", "flash_bwd_dq_tc.cu",
            "flash_mma.cuh"} <= listed
    assert listed == set(os.listdir(build.CSRC))
    gitignore = open(os.path.join(REPO, ".gitignore")).read()
    assert "t2omca_tpu_torch/kernels/_build/" in gitignore
