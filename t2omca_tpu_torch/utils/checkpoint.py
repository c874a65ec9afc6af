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
  (``host``: ``runner.t_env``, the reward scaler's ``gamma``), and
  whatever the driver adds under ``driver`` (its key chain). The ring
  cursor ``buffer.insert_pos``, its fill ``buffer.episodes_in_buffer``
  and the ``episode`` counter are 0-d device tensors and sit in
  ``state.pt``; a checkpoint of the earlier layout, which kept them under
  ``host``, loads into the tensors (without them a resume would silently
  rewind the ring cursor).

The JAX checkpoints (flax msgpack, ``state.msgpack``) and these do not
cross: neither package reads the other's. Crash safety as in JAX: a
write lands in a ``tmp.<t_env>`` staging directory, is fsynced, and is
published by one atomic ``rename``; ``find_checkpoint`` verifies each
candidate by its digest and *skips back* to the newest valid step;
``prune_checkpoints`` bounds disk (newest K + every Nth step). Single
writer per checkpoint directory (the driver's token-unique
``models/<token>/``), one process.

**Populations** (format 2): a ``population.PopState`` checkpoints as its
members' leaves under ``ts.<i>.`` and the spec under ``spec.``, with
``population: P`` in the topology stamp. A single-member checkpoint (any
format 1 checkpoint, and format 2 without a population) restored into a
population template is lifted (JAX's ``_lift_population``): every member
starts from the restored state, member 0 is the restored run, each member
``m >= 1`` has its rollout key re-salted with ``fold_in(key, m)`` (a
verbatim copy would make the members draw the same trajectories), and the
spec is the template's (the config's grids). A population checkpoint
restored under another P is reshaped (JAX's ``restore_elastic``,
:func:`restore_elastic`): a shrink keeps the stamped ``member_ranking``'s
best members, else the prefix; a grow replicates member ``m % P`` into
each new slot ``m`` and re-salts its rollout key with ``fold_in(key, m)``;
the spec rows move with their members; into a template without a
population the ranking's best member (else member 0) is extracted. A
``PopState`` whose ``members`` names a subset (a data-parallel rank's
members) restores only those.

**The per-rank shard save** (JAX's ``save_checkpoint_shards``): where the
collective save cannot run (a peer missed the preemption barrier, or the
gather to rank 0 failed), each rank writes only its own state with no
collective, as ``shard.<i>-of-<n>.pt`` and a sidecar
``shard.<i>-of-<n>.json`` (its bytes, SHA-256, host values, driver keys
and the rule that rebuilds each leaf), each written to a temporary name
and renamed; every surviving rank writes the same ``meta.json`` stamped
``partial: true, shards: n``. The rule is the inverse of the port's own
placement, not JAX's axis-0 concat: a data-parallel rank's lane and slot
leaves (rows ``r::n``) interleave (``mesh.interleave_rows``, as
``DataParallel.gather`` does), and under population × dp each member's
leaves, written under its global id, come whole from the rank that holds
it (``mesh.member_blocks``, as ``PopulationParallel.gather`` does); the
rest is replicated and comes from shard 0. ``verify_checkpoint`` and
``find_checkpoint`` take a shard set only when a complete, intact group
is present (all-or-skip, the largest n first), ``prune_checkpoints``
removes it like a whole save, and every restore (``load_checkpoint``,
``restore_elastic``, ``utils/elastic.resume_state``) rebuilds the global
state from it first, so it resumes at any rank count, learner-set size
or P. In one process the set is 1-of-1, and complete.

**Data parallelism**: the driver of a data-parallel run gathers every
sharded leaf to rank 0 (``parallel/mesh.DataParallel.gather``), which
writes this same layout, so ``load_checkpoint``, ``serve export`` and
``ServeFrontend.load`` read it as a one-card checkpoint; the stamp then
says ``process_count``, ``device_count`` and ``mesh_shape``. A restore
onto a rank maps the global state's file and copies out the rank's part
of each leaf (``load_checkpoint(place=...)``), so a checkpoint resumes at
any rank count (``utils/elastic.py``) and a rank's host memory holds its
own rows, not the global ring.

``LAST_TIMES`` holds the byte count and host seconds of the most recent
save (device→host copy, write + fsync, hash), shard save and rebuild,
and of the most recent verify and load.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import prng
from . import resilience

logger = logging.getLogger(__name__)

#: bump when the checkpointed layout changes incompatibly (2: the
#: population layout)
FORMAT_VERSION = 2
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


def map_tensors(state: Any, fn) -> Any:
    """``state`` with every tensor leaf replaced by ``fn(leaf)`` (host
    values kept), e.g. ``map_tensors(ts, torch.clone)``."""
    return _rebuild(state, lambda _path, x: fn(x)
                    if isinstance(x, torch.Tensor) else x)


def _members(state: Any) -> Optional[list]:
    """A population state's member states (``population.PopState``:
    ``ts`` a list beside a ``spec``), else None."""
    ts = getattr(state, "ts", None)
    return ts if hasattr(state, "spec") and isinstance(ts, list) else None


def _population(state: Any) -> Optional[int]:
    """A population state's P (its spec's rows: a data-parallel rank's
    ``PopState`` holds only some of the members), else None."""
    if _members(state) is None:
        return None
    return int(state.spec.lr_scale.shape[0])


def _obs_layout(state: Any) -> Optional[str]:
    """'compact' | 'dense' | None (no replay ring in the state)."""
    from ..components.episode_buffer import CompactEntityObs
    members = _members(state)
    if members:
        state = members[0]
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
             "process_count": 1,
             "population": _population(state),
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


# ---------------------------------------------------------------- shards

#: ``shard.<i>-of-<n>.pt``: one rank's state in a degraded save
_SHARD_RE = re.compile(r"^shard\.(\d+)-of-(\d+)\.pt$")
#: a shard set's rebuild rules (module docstring): rank r's rows ``r::n``
#: interleave; a population member comes whole from the rank holding it
LANES, MEMBERS = "lanes", "members"


def _shard_files(i: int, n: int) -> Tuple[str, str]:
    return f"shard.{i}-of-{n}.pt", f"shard.{i}-of-{n}.json"


def _write_atomic(dirname: str, name: str, write, tag: str = "") -> None:
    """``write(f)`` into ``<dirname>/.tmp.<name><tag>``, fsynced, then
    renamed to ``name``: a file at a time, where no writer owns the
    directory (the ranks write into one step directory at once, each
    through a temporary name of its own)."""
    tmp = os.path.join(dirname, f".tmp.{name}{tag}")
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(dirname, name))


def save_checkpoint_shards(path: str, t_env: int, state: Any,
                           shard: int = 0, shards: int = 1, sharded=None,
                           topology: Optional[dict] = None,
                           driver: Optional[dict] = None) -> str:
    """The degraded save (module docstring): this rank's ``state`` as
    shard ``shard`` of ``shards`` of ``<path>/<t_env>/``, with no
    collective. ``sharded(path, leaf)`` names the leaves that hold the
    rank's rows ``r::n`` (``DataParallel.sharded``); a population state
    (``PopState``, its ``members`` the held ids) writes its members under
    their global ids. ``driver`` (JSON values) goes into the sidecar: a
    population's ``keys`` are the held members'. The
    ``checkpoint.shard_save`` fault point fires first. A step that already
    holds a whole save (the save cadence's, at the step the run stops at:
    the same state) is left as it is. → the step directory."""
    resilience.fire("checkpoint.shard_save", t_env=int(t_env),
                    shard=int(shard), shards=int(shards))
    d = os.path.join(path, str(int(t_env)))
    if os.path.isfile(os.path.join(d, STATE_FILE)):
        logger.warning("save_checkpoint_shards t_env=%d: %s already holds "
                       "the whole save of this step; no shard written",
                       int(t_env), d)
        return d
    t0 = time.perf_counter()
    tensors, host = flatten_state(state)
    rules: Dict[str, str] = {}
    members = _members(state)
    ids = None
    if members is not None:
        ids = _member_ids(state)
        glob_id = lambda k: (f"ts.{ids[int(k.split('.', 2)[1])]}."  # noqa
                             + k.split(".", 2)[2]) if k.startswith("ts.") \
            else k
        tensors = {glob_id(k): v for k, v in tensors.items()}
        host = {glob_id(k): v for k, v in host.items()}
        rules = {k: MEMBERS for k in tensors if k.startswith("ts.")}
    elif sharded is not None:
        rules = {k: LANES for k, v in tensors.items() if sharded(k, v)}
    flat = {k: v.detach().cpu() for k, v in tensors.items()}
    os.makedirs(d, exist_ok=True)
    sname, jname = _shard_files(int(shard), int(shards))
    _write_atomic(d, sname, lambda f: torch.save(flat, f))
    del flat
    spath = os.path.join(d, sname)
    side = {"shard": int(shard), "shards": int(shards), "t_env": int(t_env),
            "sha256": _sha256_file(spath),
            "bytes": os.path.getsize(spath), "rules": rules, "host": host,
            "driver": driver or {}}
    if ids is not None:
        side["members"] = ids
    _write_atomic(d, jname,
                  lambda f: f.write(json.dumps(side, sort_keys=True)
                                    .encode()))
    meta = {"format": FORMAT_VERSION, "obs_layout": _obs_layout(state),
            "t_env": int(t_env), "partial": True, "shards": int(shards),
            "topology": _topology_stamp(state, topology)}
    _write_atomic(d, META_FILE,
                  lambda f: f.write(json.dumps(meta, sort_keys=True)
                                    .encode()), tag=f".{int(shard)}")
    _fsync_path(d)
    _fsync_path(path)
    LAST_TIMES.update({"shard_save_s": time.perf_counter() - t0,
                       "shard_bytes": side["bytes"]})
    logger.warning("save_checkpoint_shards t_env=%d: wrote shard %d of %d "
                   "under %s (a resume takes it once every shard landed)",
                   int(t_env), int(shard), int(shards), d)
    return d


def _shard_groups(dirname: str) -> Dict[int, Dict[int, str]]:
    """``{n: {i: file name}}`` of the shard files in a step directory."""
    groups: Dict[int, Dict[int, str]] = {}
    try:
        names = os.listdir(dirname)
    except OSError:
        return groups
    for name in names:
        m = _SHARD_RE.match(name)
        if m:
            groups.setdefault(int(m.group(2)), {})[int(m.group(1))] = name
    return groups


def _complete_shard_group(dirname: str, verify: bool = True
                          ) -> Optional[int]:
    """The ``n`` of a complete, intact shard set in ``dirname`` (every
    shard and sidecar present, the byte counts and, with ``verify``, the
    SHA-256 digests matching), the largest first, else None."""
    for n, idxs in sorted(_shard_groups(dirname).items(), reverse=True):
        if set(idxs) != set(range(n)):
            continue
        ok = True
        for i in range(n):
            sname, jname = _shard_files(i, n)
            spath = os.path.join(dirname, sname)
            try:
                with open(os.path.join(dirname, jname)) as f:
                    side = json.load(f)
            except (OSError, json.JSONDecodeError):
                ok = False
                break
            if (os.path.getsize(spath) != side.get("bytes")
                    or verify and _sha256_file(spath) != side.get("sha256")):
                ok = False
                break
        if ok:
            return n
    return None


def _shard_sides(dirname: str, n: int) -> List[dict]:
    sides = []
    for i in range(n):
        with open(os.path.join(dirname, _shard_files(i, n)[1])) as f:
            sides.append(json.load(f))
    return sides


def _shard_meta(dirname: str, n: int) -> Tuple[dict, dict]:
    """The host values and the driver meta of a shard set, as a whole
    save's ``meta.json`` holds them: the union of the shards' host values,
    and a population's driver keys in member order."""
    sides = _shard_sides(dirname, n)
    host: Dict[str, Any] = {}
    for side in sides:
        for k, v in side.get("host", {}).items():
            host.setdefault(k, v)
    driver = dict(sides[0].get("driver", {}))
    if "members" in sides[0] and "keys" in driver:
        keys: Dict[int, Any] = {}
        for side in sides:
            keys.update(zip(side["members"], side["driver"]["keys"]))
        driver["keys"] = [keys[m] for m in sorted(keys)]
    return host, driver


def _assemble_shards(dirname: str, n: int) -> Dict[str, torch.Tensor]:
    """A complete shard set → the flat ``{dotted path: CPU tensor}`` of
    the global state, by each leaf's recorded rule (module docstring)."""
    t0 = time.perf_counter()
    rules: Dict[str, str] = {}
    for side in _shard_sides(dirname, n):
        rules.update(side.get("rules", {}))
    parts = [torch.load(os.path.join(dirname, _shard_files(i, n)[0]),
                        map_location="cpu", weights_only=True, mmap=True)
             for i in range(n)]
    from ..parallel.mesh import interleave_rows
    out: Dict[str, torch.Tensor] = {}
    for k in sorted({k for p in parts for k in p}):
        rule = rules.get(k)
        holders = [p[k] for p in parts if k in p]
        if rule == LANES and len(holders) == n:
            out[k] = interleave_rows(holders)
        elif rule == MEMBERS and len(holders) == 1:
            out[k] = holders[0].clone()
        elif rule is None and k in parts[0]:
            out[k] = parts[0][k].clone()
        else:
            raise CheckpointIntegrityError(
                f"partial checkpoint {dirname}: leaf {k} ({rule or 'whole'})"
                f" is held by {len(holders)} of {n} shards — the shards "
                f"were written by incompatible runs; resume from an older "
                f"complete step")
    LAST_TIMES.update({"rebuild_s": time.perf_counter() - t0})
    return out


# ---------------------------------------------------------------- find

def verify_checkpoint(dirname: str) -> bool:
    """True iff ``dirname`` holds a restorable checkpoint: ``state.pt``
    and a ``meta.json`` whose byte count and SHA-256 match it (catches
    truncation AND bit flips), or a ``partial`` save whose shard set is
    complete and intact (``_complete_shard_group``)."""
    state_path = os.path.join(dirname, STATE_FILE)
    meta_path = os.path.join(dirname, META_FILE)
    if not os.path.isfile(meta_path):
        return False
    if not os.path.isfile(state_path):
        return _complete_shard_group(dirname) is not None
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
    if meta.get("partial") and not os.path.isfile(
            os.path.join(dirname, STATE_FILE)):
        # a shard set: its host values and driver meta are the shards'
        n = _complete_shard_group(dirname, verify=False)
        if n is not None:
            meta["host"], meta["driver"] = _shard_meta(dirname, n)
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
                  mmap: bool = False, prefix: Optional[str] = None
                  ) -> Dict[str, torch.Tensor]:
    """``state.pt``'s tensors (a partial save's rebuilt from its shards);
    with ``prefix``, only the leaves under it,
    keyed by the rest of their path and copied out of the file (with
    ``mmap`` only their pages are read: the serving export takes the
    agent's few MB out of a multi-GB state this way)."""
    state_path = os.path.join(dirname, STATE_FILE)
    if not os.path.isfile(state_path):
        # a partial save: the global state rebuilt from its shard set
        n = _complete_shard_group(dirname, verify=verify)
        if n is None:
            raise CheckpointIntegrityError(
                f"checkpoint {dirname} holds neither {STATE_FILE} nor a "
                f"complete, intact shard set; resume from an older step "
                f"(find_checkpoint skips it automatically)")
        tensors = _assemble_shards(dirname, n)
        if torch.device(map_location or "cpu").type != "cpu":
            tensors = {k: v.to(map_location) for k, v in tensors.items()}
    else:
        if verify:
            meta = read_meta(dirname)
            digest = _sha256_file(state_path)
            if digest != meta.get("sha256"):
                raise CheckpointIntegrityError(
                    f"checkpoint {dirname} fails its integrity check: "
                    f"{STATE_FILE} hashes to {digest[:12]}… but "
                    f"{META_FILE} recorded "
                    f"{str(meta.get('sha256'))[:12]}… — the file is torn "
                    f"or corrupted; resume from an older step "
                    f"(find_checkpoint skips invalid checkpoints "
                    f"automatically)")
        tensors = torch.load(state_path, map_location=map_location,
                             weights_only=True, mmap=mmap)
    if prefix is None:
        return tensors
    return {k[len(prefix):]: v.clone() for k, v in tensors.items()
            if k.startswith(prefix)}


def _restore_leaves(template: Any, tensors: Dict[str, torch.Tensor],
                    host: Dict[str, Any], dirname: str, what: str,
                    prefix: str = "", place=None) -> Any:
    """``template`` with its tensor leaves from ``tensors`` (keys
    ``prefix + path``) and its host values from ``host``; every leaf's
    shape and dtype checked against the template first. A tensor leaf
    that the checkpoint holds as a host value (the counters of the
    earlier layout) is made from it on the template's device. ``place``
    (``(path, tensor) -> tensor``) maps each stored leaf first: a
    data-parallel rank's part of the global leaf."""
    if place is not None:
        tensors = {k: place(k[len(prefix):], v) for k, v in tensors.items()
                   if k.startswith(prefix)}
    want, _ = flatten_state(template)
    legacy = {k for k in want
              if prefix + k not in tensors and prefix + k in host}
    want = {k: t for k, t in want.items() if k not in legacy}
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
        keys = [b for b in bad if b[0].endswith("key")]
        why = (f"; a key of {keys[0][3][-1]} words was stored and "
               f"{keys[0][1][-1]} are configured: the checkpoint's "
               f"prng_impl is not this run's (threefry keys have 2 words, "
               f"rbg and unsafe_rbg keys 4)" if keys else "")
        raise ValueError(
            f"checkpoint {dirname} was written under a different config: "
            f"{len(bad)} {what} leaves mismatch the template (first: {k} "
            f"stored {rt} {rd} vs configured {st} {sd}{why}). Use "
            f"load_learner_state for a model-only restore")

    def leaf(path, x):
        if isinstance(x, torch.Tensor):
            if path in legacy:
                return torch.tensor(host[prefix + path], dtype=x.dtype,
                                    device=x.device)
            # a placed leaf may still be a view of the mapped file
            return tensors[prefix + path].to(x.device,
                                             copy=place is not None)
        return host.get(prefix + path, x)

    return _rebuild(template, leaf)


def _member_ids(target: Any) -> List[int]:
    """The global ids of the members a population template holds (all of
    them unless its ``members`` names a subset)."""
    ids = getattr(target, "members", None)
    return list(range(len(_members(target)))) if ids is None else list(ids)


def _lift_population(target: Any, tensors: Dict[str, torch.Tensor],
                     host: Dict[str, Any], dirname: str, place=None,
                     prng_impl: Optional[str] = None) -> Any:
    """A single-member checkpoint restored into the population template
    ``target`` (the module docstring): every member from the one state,
    each with tensors of its own, members ``m >= 1`` with their rollout
    key re-salted by ``fold_in(key, m)`` under ``prng_impl`` (which a
    4-word key requires; None: threefry); the spec stays the
    template's."""
    members = []
    for m, template in zip(_member_ids(target), _members(target)):
        st = _restore_leaves(template, tensors, host, dirname,
                             "train-state", place=place)
        if m:
            st = map_tensors(st, torch.clone)
            runner = getattr(st, "runner", None)
            if runner is not None and hasattr(runner, "key"):
                runner.key = prng.fold_in(runner.key, m, prng_impl)
        members.append(st)
    return dataclasses.replace(target, ts=members)


def _restore_population(target: Any, tensors: Dict[str, torch.Tensor],
                        host: Dict[str, Any], dirname: str,
                        place=None) -> Any:
    """A population checkpoint of the template's P into ``target``: each
    held member from its ``ts.<id>.`` leaves, the spec from ``spec.``."""
    ts = [_restore_leaves(t, tensors, host, dirname, "train-state",
                          prefix=f"ts.{m}.", place=place)
          for m, t in zip(_member_ids(target), _members(target))]
    spec = _restore_leaves(target.spec, tensors, host, dirname,
                           "population spec", prefix="spec.", place=place)
    return dataclasses.replace(target, ts=ts, spec=spec)


# ------------------------------------------------------- elastic reshape

def _stored_population(tensors: Dict[str, torch.Tensor]) -> Optional[int]:
    """P of a stored state (its spec's rows), None for one member."""
    spec = tensors.get("spec.lr_scale")
    return None if spec is None else int(spec.shape[0])


def _take_members(tensors: Dict[str, torch.Tensor], host: Dict[str, Any],
                  idx: List[int]) -> Tuple[Dict[str, torch.Tensor],
                                           Dict[str, Any]]:
    """The stored state with member ``j`` of the result taken from member
    ``idx[j]`` and the spec rows with them. A member taken twice gets
    tensors of its own from its second use on."""
    by_member: Dict[int, List[str]] = {}
    for k in tensors:
        if k.startswith("ts."):
            by_member.setdefault(int(k.split(".", 2)[1]), []).append(k)
    rows = torch.tensor(idx, dtype=torch.long)
    out = {k: v.index_select(0, rows) for k, v in tensors.items()
           if k.startswith("spec.")}
    out_host = {k: v for k, v in host.items() if not k.startswith("ts.")}
    seen = set()
    for j, m in enumerate(idx):
        src, dst = f"ts.{m}.", f"ts.{j}."
        for k in by_member.get(m, ()):
            v = tensors[k]
            out[dst + k[len(src):]] = v.clone() if m in seen else v
        for k, v in host.items():
            if k.startswith(src):
                out_host[dst + k[len(src):]] = v
        seen.add(m)
    return out, out_host


def _resalt_member_keys(tensors: Dict[str, torch.Tensor],
                        members: List[int],
                        prng_impl: Optional[str] = None) -> None:
    """Re-salt the listed members' rollout keys (``ts.<m>.runner.key``)
    with ``fold_in(key, m)`` (JAX's ``_resalt_member_keys``): a member
    replicated from another must not draw its trajectories."""
    for m in members:
        k = f"ts.{m}.runner.key"
        if k in tensors:
            tensors[k] = prng.fold_in(tensors[k], m, prng_impl)


def _reshape_population(tensors: Dict[str, torch.Tensor],
                        host: Dict[str, Any], p_dst: int,
                        member_ranking: Optional[List[int]] = None,
                        prng_impl: Optional[str] = None
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """A stored population resized to ``p_dst`` members (JAX's
    ``_reshape_population``): a shrink keeps ``member_ranking[:p_dst]``
    (a permutation prefix of the stored members, checked) else the
    prefix; a grow keeps every member and replicates member ``m % P``
    into each new slot ``m``, whose rollout key is re-salted. The spec
    rows move with their members."""
    p_src = _stored_population(tensors)
    if p_src == p_dst:
        return tensors, host
    if p_dst < p_src:
        if member_ranking is not None:
            idx = [int(i) for i in list(member_ranking)[:p_dst]]
            if len(set(idx)) != len(idx) or not all(
                    0 <= i < p_src for i in idx):
                raise ValueError(
                    f"member_ranking {list(member_ranking)!r} is not a "
                    f"permutation prefix of range({p_src}) — cannot "
                    f"shrink the population to P={p_dst}")
        else:
            idx = list(range(p_dst))
        salted: List[int] = []
    else:
        idx = list(range(p_src)) + [m % p_src for m in range(p_src, p_dst)]
        salted = list(range(p_src, p_dst))
    tensors, host = _take_members(tensors, host, idx)
    _resalt_member_keys(tensors, salted, prng_impl)
    logger.info("_reshape_population: %s P=%d -> P=%d (members %s%s)",
                "shrank" if p_dst < p_src else "grew", p_src, p_dst, idx,
                f", re-salted {salted}" if salted else "")
    return tensors, host


def _extract_member(tensors: Dict[str, torch.Tensor], host: Dict[str, Any],
                    member_ranking: Optional[List[int]] = None
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """One member of a stored population as a bare state (JAX's
    ``_extract_member``): the ranking's best, else member 0; the spec is
    dropped."""
    m = int(member_ranking[0]) if member_ranking else 0
    src = f"ts.{m}."
    return ({k[len(src):]: v for k, v in tensors.items()
             if k.startswith(src)},
            {k[len(src):]: v for k, v in host.items() if k.startswith(src)})


def _load(dirname: str, target: Any, meta: dict, verify: bool, place,
          elastic: bool, prng_impl: Optional[str] = None) -> Any:
    """The restore core: ``state.pt`` into ``target``, reshaped first when
    ``elastic`` (a shrink or an extract by the ``member_ranking`` stamped
    into ``meta.json``)."""
    t0 = time.perf_counter()
    members = _members(target)
    subset = members is not None and getattr(target, "members",
                                             None) is not None
    mapped = place is not None or subset or elastic
    tensors = _read_tensors(dirname, verify, "cpu" if mapped
                            else _state_device(target), mmap=mapped)
    if mapped and place is None:
        place = lambda _path, x: x    # noqa: E731 — copy off the mapping
    host = meta.get("host", {})
    want_p = _population(target)
    if elastic:
        member_ranking = (meta.get("topology") or {}).get("member_ranking")
        saved_p = _stored_population(tensors)
        if want_p is None and saved_p is not None:
            tensors, host = _extract_member(tensors, host, member_ranking)
        elif want_p is not None and saved_p is not None:
            tensors, host = _reshape_population(tensors, host, want_p,
                                                member_ranking, prng_impl)
    if members is not None and _stored_population(tensors) is None:
        restored = _lift_population(target, tensors, host, dirname, place,
                                    prng_impl)
    elif members is not None:
        restored = _restore_population(target, tensors, host, dirname,
                                       place)
    else:
        restored = _restore_leaves(target, tensors, host, dirname,
                                   "train-state", place=place)
    LAST_TIMES.update({"load_s": time.perf_counter() - t0})
    return restored


def load_checkpoint(dirname: str, target: Any, verify: bool = True,
                    place=None, prng_impl: Optional[str] = None) -> Any:
    """Restore into a template of the same structure (``target``: a
    ``TrainState`` of the configured shapes, or a ``population.PopState``
    of them; its tensors' devices are where the restored ones land). A
    single-member checkpoint restored into a population template is lifted
    and a population of another size is reshaped (the module docstring:
    :func:`restore_elastic`). The sidecar turns a replay-layout mismatch
    into a precise config instruction before ``state.pt`` is read, and its
    checksum turns silent corruption into
    :class:`CheckpointIntegrityError`. Callers that just selected
    ``dirname`` via :func:`find_checkpoint` already paid the SHA-256
    pass there and may set ``verify=False``. ``place``: a data-parallel
    rank's part of each leaf (``DataParallel.place``); the file is then
    mapped on the host, so a rank reads only the pages of its own rows
    and of the replicated leaves, not the whole global ring (a rank's
    population members are read the same way). ``prng_impl``: the run's,
    for the rollout keys a lift or a grow re-salts."""
    meta = read_meta(dirname)
    _check_obs_layout(meta, target, dirname)
    saved_p = (meta.get("topology") or {}).get("population")
    if saved_p is not None and saved_p != _population(target):
        return restore_elastic(dirname, target, verify=verify, meta=meta,
                               prng_impl=prng_impl)
    return _load(dirname, target, meta, verify, place, elastic=False,
                 prng_impl=prng_impl)


def restore_elastic(dirname: str, target: Any, verify: bool = True,
                    meta: Optional[dict] = None,
                    prng_impl: Optional[str] = None) -> Any:
    """Restore any checkpoint into the current run's population shape
    (JAX's ``restore_elastic``): a population of another P is reshaped
    (:func:`_reshape_population`), a population into a template without
    one gives its best member (:func:`_extract_member`), a single-member
    state into a population is lifted. The ranking is the
    ``member_ranking`` stamped into ``meta.json`` (best first); without
    one, a shrink keeps the prefix and an extract member 0. Fires the ``checkpoint.elastic`` resilience hook
    after the sidecar read. Device, process and loop changes need no
    reshape (``utils/elastic.py``)."""
    meta = read_meta(dirname) if meta is None else meta
    _check_obs_layout(meta, target, dirname)
    resilience.fire("checkpoint.elastic", dirname=dirname,
                    format=meta.get("format"))
    try:
        return _load(dirname, target, meta, verify, None, elastic=True,
                     prng_impl=prng_impl)
    except ValueError as e:
        raise ValueError(
            f"checkpoint {dirname} does not match the configured "
            f"train-state structure even after elastic reshaping: {e}"
        ) from e


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
