"""Export a training checkpoint of the port as a serving artifact (port of
``t2omca_tpu/serve/export.py``).

``python -m t2omca_tpu_torch.serve export <ckpt_dir>`` turns a port
checkpoint (``utils/checkpoint.py``: ``<t_env>/{state.pt, meta.json}``)
into the directory that ``ServeFrontend.load`` reads:

* ``params_float32.pt`` / ``params_bfloat16.pt``: the agent's acting
  params only (optimizer, target net, mixer and replay are stripped),
  with ``BasicMAC.prepare_acting_params`` applied at the train dtype: the
  query-slice fold done once at export instead of at every load. Each is
  ``torch.save`` of one flat ``{dotted path: CPU tensor}`` dict, the
  checkpoint's own flat form (``utils.checkpoint.flatten_state``),
  readable with ``torch.load(weights_only=True)``. The float32 variant is
  the bit-parity one; bfloat16 halves the bytes.
* ``meta.json``: format and framework, the source checkpoint and its
  state SHA-256, provenance (git commit, torch and CUDA versions, the
  device the fold ran on), the full train config (the front end rebuilds
  the MAC from it), the model's sizes, the bucket list and each variant's
  file, SHA-256 and byte count.

The JAX artifact also ships ``jax.export`` programs per bucket and a
persistent XLA compile cache. PyTorch runs the step eagerly, so this
artifact has neither: the front end rebuilds the step from the config and
warms each bucket with one dispatch at load instead. The two packages'
artifacts do not cross (``framework`` names the writer).

The checkpoint is read host-side: ``state.pt`` is memory-mapped and only
the agent's leaves are copied out, so the replay ring (most of a config 3
checkpoint's 2.7 GB) is neither read whole nor put on the card. The fold
runs on the export's device (``cuda`` unless named otherwise), which is
the device a bit-parity check serves on.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import logging
import os
import subprocess
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TrainConfig, sanity_check
from ..controllers.basic_mac import (MAC_REGISTRY, map_float_leaves,
                                     torch_dtype)
from ..device import DeviceLike, resolve_device
from ..envs.registry import make_env
from ..utils.checkpoint import (_read_tensors, find_checkpoint,
                                flatten_state, read_meta)
from ..utils.ioutil import write_bytes_atomic, write_json_atomic

logger = logging.getLogger(__name__)

#: bump when the artifact layout changes incompatibly
ARTIFACT_FORMAT = 1

#: the writer's name in ``meta.json``: neither package loads the other's
FRAMEWORK = "t2omca_tpu_torch"

#: power-of-2 batch buckets: a request pads up to the smallest bucket
#: >= its size
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)

#: the param variants an artifact ships
PARAM_DTYPES: Tuple[str, ...] = ("float32", "bfloat16")

#: where the agent's leaves sit in a checkpoint's flat state
AGENT_PREFIX = "learner.params.agent."


def _git_commit() -> Optional[str]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def load_acting_params(cfg: TrainConfig, ckpt_dir: str, load_step: int = 0,
                       device: DeviceLike = None):
    """→ ``(acting_params, mac, env_info, ckpt_info)``: the checkpoint's
    agent params read host-side, checked against the config's own
    parameter shapes, moved to ``device`` (``cuda`` unless named) and
    folded for acting at the train dtype."""
    found = find_checkpoint(ckpt_dir, load_step)
    if found is None:
        raise FileNotFoundError(
            f"no valid checkpoint under {ckpt_dir!r} (export needs a "
            f"published training checkpoint; run with save_model=true)")
    dirname, step = found
    env_info = make_env(cfg.env_args).get_env_info()
    mac = MAC_REGISTRY[cfg.mac].build(cfg, env_info, device)
    ckpt_meta = read_meta(dirname)
    # find_checkpoint just verified the digest: no second hash here
    raw = _read_tensors(dirname, False, "cpu", mmap=True,
                        prefix=AGENT_PREFIX)
    if not raw:
        raise ValueError(
            f"checkpoint {dirname} has no {AGENT_PREFIX[:-1]} leaves — not "
            f"a t2omca_tpu_torch training checkpoint?")
    want = {k: tuple(p.shape) for k, p in mac.agent.named_parameters()}
    bad = sorted(k for k in set(want) | set(raw)
                 if k not in want or k not in raw
                 or tuple(raw[k].shape) != want[k])
    if bad:
        raise ValueError(
            f"checkpoint {dirname} holds a different MODEL than the "
            f"export config: {len(bad)} agent leaves mismatch (first: "
            f"{bad[0]}) — pass the training run's config")
    params = {k: v.to(mac.device) for k, v in raw.items()}
    # fold at the TRAIN dtype: model.act_dtype is a rollout knob, and the
    # canonical float32 variant must hold what select_actions folds
    acting = mac.prepare_acting_params(params, dtype=mac.dtype)
    ckpt_info = {"dir": dirname, "t_env": int(step),
                 "state_sha256": ckpt_meta.get("sha256")}
    return acting, mac, env_info, ckpt_info


def _cast_variant(tree, dtype_name: str):
    """A param variant: floating leaves cast to ``dtype_name``; float32
    keeps the canonical leaves untouched (the fold's products keep the
    model's compute dtype)."""
    if dtype_name == "float32":
        return tree
    dt = torch_dtype(dtype_name)
    return map_float_leaves(tree, lambda x: x.to(dt))


def _variant_bytes(tree) -> bytes:
    """``torch.save`` of the variant's flat ``{path: CPU tensor}`` form."""
    tensors, _ = flatten_state(tree)
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in tensors.items()}, buf)
    return buf.getvalue()


def export_artifact(cfg: TrainConfig, ckpt_dir: str, out_dir: str,
                    buckets: Sequence[int] = DEFAULT_BUCKETS,
                    dtypes: Sequence[str] = PARAM_DTYPES,
                    load_step: int = 0, device: DeviceLike = None) -> dict:
    """Write the serving artifact of ``cfg``'s newest (or
    ``load_step``-nearest) checkpoint under ``ckpt_dir`` into ``out_dir``
    → the ``meta.json`` dict. The checkpoint is resolved and read before
    anything is written, so a missing or mismatched one is a clean
    error."""
    cfg = sanity_check(cfg)
    buckets = sorted({int(b) for b in buckets})
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets}")
    for d in dtypes:
        torch_dtype(d)               # fail fast on a typo'd dtype
    device = resolve_device(device)
    acting, mac, env_info, ckpt_info = load_acting_params(
        cfg, ckpt_dir, load_step, device)
    os.makedirs(out_dir, exist_ok=True)
    params_meta: Dict[str, dict] = {}
    for dtype_name in dtypes:
        blob = _variant_bytes(_cast_variant(acting, dtype_name))
        fname = f"params_{dtype_name}.pt"
        write_bytes_atomic(os.path.join(out_dir, fname), blob)
        params_meta[dtype_name] = {"file": fname,
                                   "sha256": hashlib.sha256(blob).hexdigest(),
                                   "bytes": len(blob)}
    meta = {
        "format": ARTIFACT_FORMAT,
        "framework": FRAMEWORK,
        "created": time.time(),
        "checkpoint": ckpt_info,
        "provenance": {"git_commit": _git_commit(),
                       "torch": torch.__version__,
                       "cuda": torch.version.cuda,
                       "device": _device_name(device)},
        "train_config": dataclasses.asdict(cfg),
        "env_info": {k: int(v) for k, v in env_info.items()
                     if isinstance(v, (int, np.integer))},
        "n_agents": int(mac.n_agents),
        "obs_dim": int(env_info["obs_shape"]),
        "n_actions": int(env_info["n_actions"]),
        "emb": int(mac.emb),
        "folded": bool(mac.use_qslice),
        "buckets": buckets,
        "params": params_meta,
    }
    write_json_atomic(os.path.join(out_dir, "meta.json"), meta)
    logger.info("serve artifact written to %s (checkpoint t_env=%d)",
                out_dir, ckpt_info["t_env"])
    return meta
