"""Checkpoint save/resume of the full train state — crash-safe (the port's
own format, with the contract of ``t2omca_tpu/utils/checkpoint.py``).

Layout: ``<path>/<t_env>/{state.pt, meta.json}``, the reference's
``<results>/models/<token>/<t_env>/`` numeric-directory scan with
``load_step`` nearest-match.

* ``state.pt`` is ``torch.save`` of one flat ``{dotted path: CPU
  tensor}`` dict of every tensor of the state: the learner's params,
  target params, Adam state, ``train_steps`` and ``last_target_update``;
  the replay ring (dense or ``CompactEntityObs`` storage), its priorities
  and ``max_priority``; the runner's env states (with each lane's Welford
  norms), key, reward-scale state and env params. Loading uses
  ``torch.load(weights_only=True)``: no pickled code runs.
* ``meta.json`` holds the format version, the replay obs layout
  (``dense``/``compact``), the SHA-256 and byte count of ``state.pt``, a
  topology stamp, the state's **host values that are not tensors**
  (``host``: ``buffer.insert_pos``, ``buffer.episodes_in_buffer``,
  ``episode``, ``runner.t_env``, the reward scaler's ``gamma``; without
  them a resume would silently rewind the ring cursor), and whatever the
  driver adds under ``driver`` (its key chain).

The JAX checkpoints (flax msgpack, ``state.msgpack``) and these do not
cross: neither package reads the other's. Crash safety as in JAX: a
write lands in a ``tmp.<t_env>`` staging directory, is fsynced, and is
published by one atomic ``rename``; ``find_checkpoint`` verifies each
candidate by its digest and *skips back* to the newest valid step;
``prune_checkpoints`` bounds disk (newest K + every Nth step). Single
writer per checkpoint directory (the driver's token-unique
``models/<token>/``), one process. Per-host shards, multi-host gathers,
population lifts and elastic restore are ``ROADMAP.md`` items 11 and 12.

``LAST_TIMES`` holds the byte count and host seconds of the most recent
save (device→host copy, write + fsync, hash) and of the most recent
verify and load.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import resilience

logger = logging.getLogger(__name__)

#: bump when the checkpointed layout changes incompatibly
FORMAT_VERSION = 1
STATE_FILE = "state.pt"
META_FILE = "meta.json"

#: byte count and host seconds of the latest save / verify / load
LAST_TIMES: Dict[str, float] = {}


class CheckpointFormatError(ValueError):
    """The checkpoint's on-disk format is not readable by this build
    (newer ``FORMAT_VERSION``, or no ``meta.json``). NOT a config
    mismatch — no fallback applies."""


class CheckpointIntegrityError(RuntimeError):
    """The checkpoint bytes on disk do not match their recorded checksum
    (torn write, bit rot, manual tampering). Deliberately NOT a
    ValueError: the model-only restore fallback that callers apply to
    config mismatches is hopeless here — the bytes themselves are bad."""


# ---------------------------------------------------------------- the tree

_HOST_TYPES = (bool, int, float, str, type(None))


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``[(name, child)]`` of a container node (a dataclass, dict, list or
    tuple), None for a leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_state(state: Any) -> Tuple[Dict[str, torch.Tensor],
                                       Dict[str, Any]]:
    """→ (``{dotted path: tensor}``, ``{dotted path: host value}``): every
    tensor leaf of ``state`` and every host scalar (int, float, bool, str,
    None) beside them."""
    tensors: Dict[str, torch.Tensor] = {}
    host: Dict[str, Any] = {}

    def walk(node, path: str) -> None:
        if isinstance(node, torch.Tensor):
            tensors[path] = node
            return
        if isinstance(node, _HOST_TYPES):
            host[path] = node
            return
        kids = _children(node)
        if kids is None:
            raise TypeError(f"cannot checkpoint {path or 'the state'}: "
                            f"{type(node).__name__}")
        for name, child in kids:
            walk(child, f"{path}.{name}" if path else name)

    walk(state, "")
    return tensors, host


def _rebuild(template: Any, fn, path: str = "") -> Any:
    """``template`` with every leaf replaced by ``fn(path, leaf)``."""
    kids = _children(template)
    if kids is None:
        return fn(path, template)
    new = {name: _rebuild(child, fn, f"{path}.{name}" if path else name)
           for name, child in kids}
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **new)
    if isinstance(template, dict):
        return {k: new[str(k)] for k in template}
    return type(template)(new[str(i)] for i in range(len(template)))


def _obs_layout(state: Any) -> Optional[str]:
    """'compact' | 'dense' | None (no replay ring in the state)."""
    from ..components.episode_buffer import CompactEntityObs
    buf = getattr(state, "buffer", None)
    if buf is None:
        return None
    return ("compact" if isinstance(buf.storage.obs, CompactEntityObs)
            else "dense")


def _state_device(state: Any) -> torch.device:
    tensors, _ = flatten_state(state)
    return next(iter(tensors.values())).device if tensors else \
        torch.device("cpu")


def _topology_stamp(state: Any, extra: Optional[dict] = None) -> dict:
    """The ``meta.json`` topology stamp: the writing run's shape, so a
    resume under another shape can be told apart."""
    stamp = {"device": _state_device(state).type,
             "device_count": (torch.cuda.device_count()
                              if torch.cuda.is_available() else 0),
             "process_count": 1, "population": None,
             "format": FORMAT_VERSION}
    if extra:
        stamp.update(extra)
    return stamp


def _sha256_file(path: str, chunk: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _fsync_path(path: str) -> None:
    """fsync a file OR directory entry so the rename-based publish is
    durable, not merely atomic-in-page-cache."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ---------------------------------------------------------------- save

def save_checkpoint(path: str, t_env: int, state: Any,
                    topology: Optional[dict] = None,
                    driver: Optional[dict] = None) -> str:
    """Write ``<path>/<t_env>/{state.pt, meta.json}`` crash-safely.

    The write is staged in ``<path>/tmp.<t_env>``: the state's tensors
    are copied to the host (``collective.gather`` fires first: the
    device→host copy is where a device fault surfaces), ``torch.save``d
    and fsynced, hashed, then the sidecar is written and fsynced, then
    ONE ``os.rename`` publishes the directory and the parent is
    fsynced. Readers only ever see complete checkpoints; a crash leaves
    a ``tmp.*`` directory the numeric scan in ``find_checkpoint``
    ignores (and ``prune_checkpoints`` sweeps). Re-saving a published
    step (the preemption path's emergency checkpoint can land on the
    save cadence's step) replaces it. ``topology`` merges driver facts
    into the stamp; ``driver`` (JSON values) is stored as
    ``meta["driver"]``."""
    d = os.path.join(path, str(int(t_env)))
    stamp = _topology_stamp(state, topology)
    resilience.fire("collective.gather", t_env=int(t_env), multihost=False)
    t0 = time.perf_counter()
    tensors, host = flatten_state(state)
    flat = {k: v.detach().cpu() for k, v in tensors.items()}
    t_copy = time.perf_counter() - t0

    os.makedirs(path, exist_ok=True)
    staging = os.path.join(path, f"tmp.{int(t_env)}")
    if os.path.isdir(staging):
        shutil.rmtree(staging)       # leftover from a crashed writer
    os.makedirs(staging)
    state_path = os.path.join(staging, STATE_FILE)
    t0 = time.perf_counter()
    with open(state_path, "wb") as f:
        torch.save(flat, f)
        f.flush()
        os.fsync(f.fileno())
    t_write = time.perf_counter() - t0
    del flat
    t0 = time.perf_counter()
    digest = _sha256_file(state_path)
    t_hash = time.perf_counter() - t0
    # fault-injection hook (tests): crash / truncate between the state
    # write and the publish — the whole point of the staged layout
    resilience.fire("checkpoint.staged", dirname=staging, t_env=int(t_env))
    nbytes = os.path.getsize(state_path)
    with open(os.path.join(staging, META_FILE), "w") as f:
        json.dump({"format": FORMAT_VERSION,
                   "obs_layout": _obs_layout(state),
                   "t_env": int(t_env), "sha256": digest, "bytes": nbytes,
                   "topology": stamp, "host": host,
                   "driver": driver or {}}, f)
        f.flush()
        os.fsync(f.fileno())

    displaced = None
    if os.path.isdir(d):
        # replacing an already-published step: move the old version
        # ASIDE instead of deleting it before the publish, so a crash
        # between the two renames still leaves a complete copy on disk
        displaced = os.path.join(path, f"tmp.{int(t_env)}.replaced")
        if os.path.isdir(displaced):
            shutil.rmtree(displaced)
        os.rename(d, displaced)
    os.rename(staging, d)            # the atomic publish
    _fsync_path(path)                # make the rename itself durable
    if displaced is not None:
        shutil.rmtree(displaced)
    LAST_TIMES.update({"save_bytes": nbytes, "save_copy_s": t_copy,
                       "save_write_s": t_write, "save_hash_s": t_hash})
    return d


# ---------------------------------------------------------------- find

def verify_checkpoint(dirname: str) -> bool:
    """True iff ``dirname`` holds a restorable checkpoint: ``state.pt``
    and a ``meta.json`` whose byte count and SHA-256 match it (catches
    truncation AND bit flips)."""
    state_path = os.path.join(dirname, STATE_FILE)
    meta_path = os.path.join(dirname, META_FILE)
    if not (os.path.isfile(state_path) and os.path.isfile(meta_path)):
        return False
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    want = meta.get("sha256")
    if want is None:
        return False
    nbytes = meta.get("bytes")
    if nbytes is not None and os.path.getsize(state_path) != nbytes:
        return False                 # cheap reject before hashing
    t0 = time.perf_counter()
    ok = _sha256_file(state_path) == want
    LAST_TIMES.update({"verify_bytes": os.path.getsize(state_path),
                       "verify_hash_s": time.perf_counter() - t0})
    return ok


def find_checkpoint(path: str, load_step: int = 0,
                    verify: bool = True) -> Optional[Tuple[str, int]]:
    """Scan numeric subdirs; pick max ``t_env`` when ``load_step == 0`` else
    the nearest to ``load_step`` (ties resolve to the SMALLER step).
    Candidates failing :func:`verify_checkpoint` are skipped — selection
    falls back to the next-best valid step. ``tmp.*`` staging leftovers
    are never candidates (non-numeric names)."""
    if not os.path.isdir(path):
        return None
    steps = [int(name) for name in os.listdir(path)
             if name.isdigit()
             and os.path.isdir(os.path.join(path, name))]
    if not steps:
        return None
    if load_step == 0:
        ordered = sorted(steps, reverse=True)                  # newest first
    else:
        ordered = sorted(steps, key=lambda s: (abs(s - load_step), s))
    for step in ordered:
        d = os.path.join(path, str(step))
        if not verify or verify_checkpoint(d):
            return d, step
        logger.warning(
            "find_checkpoint: skipping corrupt/torn checkpoint %s "
            "(integrity check failed) — falling back to the next valid "
            "step", d)
    logger.warning("find_checkpoint: no valid checkpoint under %s "
                   "(%d candidates, all failed verification)", path,
                   len(steps))
    return None


def prune_checkpoints(path: str, keep_last: int = 5,
                      keep_every: int = 0) -> List[int]:
    """Retention for long runs: keep the newest ``keep_last`` steps plus —
    when ``keep_every > 0`` — every step divisible by ``keep_every``;
    delete the rest. Also sweeps ``tmp.*`` staging leftovers from crashed
    writers. Returns the deleted steps."""
    if not os.path.isdir(path):
        return []
    steps = sorted(int(n) for n in os.listdir(path)
                   if n.isdigit() and os.path.isdir(os.path.join(path, n)))
    keep = set(steps[-max(keep_last, 1):])
    if keep_every > 0:
        keep.update(s for s in steps if s % keep_every == 0)
    removed = []
    for s in steps:
        if s not in keep:
            shutil.rmtree(os.path.join(path, str(s)), ignore_errors=True)
            removed.append(s)
    for n in os.listdir(path):
        if n.startswith("tmp.") and os.path.isdir(os.path.join(path, n)):
            shutil.rmtree(os.path.join(path, n), ignore_errors=True)
    if removed:
        logger.info("prune_checkpoints: removed %d old checkpoints under "
                    "%s (kept %d)", len(removed), path, len(keep))
    return removed


# ---------------------------------------------------------------- load

def read_meta(dirname: str) -> dict:
    """The ``meta.json`` sidecar, format-checked."""
    meta_path = os.path.join(dirname, META_FILE)
    if not os.path.exists(meta_path):
        raise CheckpointFormatError(
            f"checkpoint {dirname} has no {META_FILE}; the port's "
            f"checkpoints always write one (a JAX msgpack checkpoint is "
            f"not readable by the port)")
    with open(meta_path) as f:
        meta = json.load(f)
    fmt = meta.get("format", 0)
    if fmt > FORMAT_VERSION:
        raise CheckpointFormatError(
            f"checkpoint {dirname} has format v{fmt}, newer than this "
            f"build's v{FORMAT_VERSION} — upgrade the framework to "
            f"restore it")
    return meta


def _check_obs_layout(meta: dict, target: Any, dirname: str) -> None:
    """Replay-layout mismatch → a precise config instruction before the
    state file is read."""
    saved = meta.get("obs_layout")
    configured = _obs_layout(target)
    if saved and configured and saved != configured:
        want = "true" if saved == "compact" else "false"
        raise ValueError(
            f"checkpoint {dirname} stores the replay ring with "
            f"'{saved}' obs layout but the config builds '{configured}' "
            f"storage — set replay.compact_entity_store={want} (and for "
            f"'compact' keep env_args.fast_norm=true and "
            f"model.use_entity_tables=true) to resume this checkpoint")


def _read_tensors(dirname: str, verify: bool, map_location,
                  mmap: bool = False) -> Dict[str, torch.Tensor]:
    state_path = os.path.join(dirname, STATE_FILE)
    if verify:
        meta = read_meta(dirname)
        digest = _sha256_file(state_path)
        if digest != meta.get("sha256"):
            raise CheckpointIntegrityError(
                f"checkpoint {dirname} fails its integrity check: "
                f"{STATE_FILE} hashes to {digest[:12]}… but {META_FILE} "
                f"recorded {str(meta.get('sha256'))[:12]}… — the file is "
                f"torn or corrupted; resume from an older step "
                f"(find_checkpoint skips invalid checkpoints "
                f"automatically)")
    return torch.load(state_path, map_location=map_location,
                      weights_only=True, mmap=mmap)


def _restore_leaves(template: Any, tensors: Dict[str, torch.Tensor],
                    host: Dict[str, Any], dirname: str, what: str,
                    prefix: str = "") -> Any:
    """``template`` with its tensor leaves from ``tensors`` (keys
    ``prefix + path``) and its host values from ``host``; every leaf's
    shape and dtype checked against the template first."""
    want, _ = flatten_state(template)
    names = {prefix + k for k in want}
    stored = {k for k in tensors if k.startswith(prefix)}
    if names != stored:
        missing, extra = sorted(names - stored), sorted(stored - names)
        raise ValueError(
            f"checkpoint {dirname} does not match the configured "
            f"{what} structure: {len(missing)} leaves missing (first: "
            f"{missing[:1]}), {len(extra)} unexpected (first: "
            f"{extra[:1]}). A common cause is the replay storage layout "
            f"(replay.compact_entity_store) or the model family")
    bad = [(k, tuple(t.shape), t.dtype, tuple(tensors[prefix + k].shape),
            tensors[prefix + k].dtype)
           for k, t in want.items()
           if (tuple(t.shape), t.dtype) != (tuple(tensors[prefix + k].shape),
                                            tensors[prefix + k].dtype)]
    if bad:
        k, st, sd, rt, rd = bad[0]
        raise ValueError(
            f"checkpoint {dirname} was written under a different config: "
            f"{len(bad)} {what} leaves mismatch the template (first: {k} "
            f"stored {rt} {rd} vs configured {st} {sd}). Use "
            f"load_learner_state for a model-only restore")

    def leaf(path, x):
        if isinstance(x, torch.Tensor):
            return tensors[prefix + path].to(x.device)
        return host.get(prefix + path, x)

    return _rebuild(template, leaf)


def load_checkpoint(dirname: str, target: Any, verify: bool = True) -> Any:
    """Restore into a template of the same structure (``target``: a
    ``TrainState`` of the configured shapes; its tensors' devices are
    where the restored ones land). The sidecar turns a replay-layout
    mismatch into a precise config instruction before ``state.pt`` is
    read, and its checksum turns silent corruption into
    :class:`CheckpointIntegrityError`. Callers that just selected
    ``dirname`` via :func:`find_checkpoint` already paid the SHA-256
    pass there and may set ``verify=False``."""
    meta = read_meta(dirname)
    _check_obs_layout(meta, target, dirname)
    t0 = time.perf_counter()
    tensors = _read_tensors(dirname, verify, _state_device(target))
    restored = _restore_leaves(target, tensors, meta.get("host", {}),
                               dirname, "train-state")
    LAST_TIMES.update({"load_s": time.perf_counter() - t0})
    return restored


def load_learner_state(dirname: str, target: Any) -> Any:
    """Restore ONLY the learner (params, target params, Adam state,
    counters) into a full train-state template — independent of the
    runner/replay config, so a model trained at one scale evaluates
    under any other (the reference's model-only checkpoint semantics;
    runner-side normalizer statistics start fresh). Only the learner's
    tensors are read (``state.pt`` is memory-mapped); the integrity
    re-hash is skipped — the caller just paid it in
    :func:`find_checkpoint`."""
    meta = read_meta(dirname)
    tensors = _read_tensors(dirname, False, "cpu", mmap=True)
    host = meta.get("host", {})
    try:
        learner = _restore_leaves(target.learner, tensors, host, dirname,
                                  "learner", prefix="learner.")
    except ValueError as e:
        raise ValueError(
            f"checkpoint {dirname} holds a different MODEL than the "
            f"configured one: {e}; fix the model config to match the "
            f"checkpoint") from e
    return dataclasses.replace(target, learner=learner)
