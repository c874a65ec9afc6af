"""Batched inference front end: ragged requests → fixed buckets (port of
``t2omca_tpu/serve/frontend.py``).

* **bucketing** — a request of ``n`` rows pads up to the smallest bucket
  ≥ ``n``; larger requests split into max-bucket chunks plus a bucketed
  remainder, so the step only ever sees ``len(buckets)`` batch shapes.
* **mask-correct padding** — pad rows get an avail mask with only action
  0 legal, zero obs and zero hidden; their outputs are sliced away.
* **per-request hidden carry** — ``select`` threads the recurrent hidden
  state explicitly; :class:`SessionStore` keys it by session id.

A front end is built in-process from ``(cfg, params, buckets, dtype)``
(it folds the params), or loaded from a serving artifact that the port
exported (``ServeFrontend.load``, ``serve/export.py``): the artifact's
params are folded already, its blob is checked against its SHA-256
before ``torch.load(weights_only=True)``, the MAC is rebuilt from its
train config, and each bucket is warmed with one dispatch, so the first
request does not pay for loading the kernel library or cuBLAS.

Telemetry, as in the JAX front end: every boundary is spanned
(``serve.load`` / ``serve.pad`` / ``serve.dispatch`` / ``serve.unpad``,
registered in ``obs/spans.KNOWN_PHASES``), so ``python -m
t2omca_tpu_torch.obs report`` reads a serving run like a training run;
with a ``MetricsHub`` (``obs/pulse.py``) each request adds the
per-bucket ``serve_dispatches_total`` / ``serve_rows_total`` counters,
``serve_requests_total`` and the ``serve_select_ms`` latency window, and
:class:`SessionStore` sets ``serve_sessions``,
``serve_session_lru_fill`` and ``serve_session_evicted``. With
``hub=None`` and the null recorder a request does no extra work. The
warm-up dispatches of :meth:`ServeFrontend.load` run before the recorder
and the hub are bound, so they count in neither.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import TrainConfig, from_dict
from ..controllers.basic_mac import MAC_REGISTRY, torch_dtype
from ..device import DeviceLike
from ..envs.registry import make_env
from ..obs.spans import NULL_RECORDER
from ..utils.checkpoint import _rebuild, flatten_state
from .export import ARTIFACT_FORMAT, FRAMEWORK, _cast_variant
from .program import build_serve_step


def _watched(phase, rec, **meta):
    """One spanned serving boundary (module-level like the driver's
    wrapper: every literal phase here is in ``KNOWN_PHASES``)."""
    return rec.span(phase, **meta)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ ``n`` (``buckets`` sorted ascending). A request
    above the largest bucket is the caller's chunking job."""
    if n < 1:
        raise ValueError(f"request batch must be >= 1 row, got {n}")
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(
        f"request batch {n} exceeds the largest bucket {buckets[-1]} — "
        f"chunk it first (ServeFrontend.select does)")


def pad_request(obs: np.ndarray, avail: np.ndarray, hidden: np.ndarray,
                bucket: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad ``(n, ...)`` request arrays up to ``bucket`` rows: zero
    obs/hidden and an avail mask legalizing only action 0 in pad rows;
    real rows pass through (avail cast to bool)."""
    n = obs.shape[0]
    avail = avail.astype(np.bool_, copy=False)
    if n == bucket:
        return obs, avail, hidden
    pad = bucket - n
    pad_avail = np.zeros((pad,) + avail.shape[1:], np.bool_)
    pad_avail[..., 0] = True
    return (np.concatenate([obs, np.zeros((pad,) + obs.shape[1:],
                                          obs.dtype)]),
            np.concatenate([avail, pad_avail]),
            np.concatenate([hidden, np.zeros((pad,) + hidden.shape[1:],
                                             hidden.dtype)]))


def _build_mac(cfg: TrainConfig, device: DeviceLike):
    env_info = make_env(cfg.env_args).get_env_info()
    return MAC_REGISTRY[cfg.mac].build(cfg, env_info, device), env_info


class ServeFrontend:
    """Greedy serving over a MAC rebuilt from ``cfg``. ``params`` is the
    agent state dict (train dtype, e.g. from ``BasicMAC.init_params`` or
    ``convert.agent_state_from_flax``); ``dtype`` picks the param
    variant ("float32" or "bfloat16": floating leaves cast after the
    acting fold). Runs on ``cuda`` unless ``device`` says otherwise.
    :meth:`load` builds one from an exported artifact instead. One
    dispatcher thread per front end. ``rec`` (a span recorder) and
    ``hub`` (a ``MetricsHub``) are the telemetry of the module
    docstring."""

    def __init__(self, cfg: TrainConfig, params, buckets: Sequence[int],
                 dtype: str = "float32", device: DeviceLike = None,
                 rec=NULL_RECORDER, hub=None) -> None:
        mac, env_info = _build_mac(cfg, device)
        params = {k: v.to(mac.device) for k, v in params.items()}
        acting = mac.prepare_acting_params(params, dtype=mac.dtype)
        self._setup(mac, env_info, _cast_variant(acting, dtype), buckets,
                    dtype)
        self._rec, self._hub = rec, hub

    def _setup(self, mac, env_info: dict, params, buckets: Sequence[int],
               dtype: str) -> None:
        """Bind the MAC and the acting params of one variant (folded and
        cast already)."""
        self.mac = mac
        self.device = mac.device
        self.dtype = dtype
        self.buckets: List[int] = sorted(int(b) for b in buckets)
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {buckets}")
        self.n_agents = mac.n_agents
        self.obs_dim = env_info["obs_shape"]
        self.n_actions = env_info["n_actions"]
        self.emb = mac.emb
        self.params = params
        self._step = build_serve_step(mac)
        self._rec, self._hub = NULL_RECORDER, None

    # ------------------------------------------------------------- load

    @classmethod
    def load(cls, artifact_dir: str, dtype: str = "float32",
             device: DeviceLike = None, rec=NULL_RECORDER,
             hub=None) -> "ServeFrontend":
        """Load an artifact of ``serve/export.py``'s layout on ``device``
        (``cuda`` unless named). ``dtype`` picks the param variant, which
        is not folded again. One batch a bucket is dispatched before the
        front end is returned (inside the ``serve.load`` span, before
        ``rec`` and ``hub`` are bound)."""
        with _watched("serve.load", rec, dtype=dtype):
            fe = cls._load(artifact_dir, dtype, device)
        fe._rec, fe._hub = rec, hub
        return fe

    @classmethod
    def _load(cls, artifact_dir: str, dtype: str,
              device: DeviceLike) -> "ServeFrontend":
        with open(os.path.join(artifact_dir, "meta.json")) as f:
            meta = json.load(f)
        fmt = meta.get("format", 0)
        if fmt > ARTIFACT_FORMAT:
            raise ValueError(
                f"serve artifact {artifact_dir} has format v{fmt}, newer "
                f"than this build's v{ARTIFACT_FORMAT} — upgrade the "
                f"framework to load it")
        if meta.get("framework") != FRAMEWORK:
            raise ValueError(
                f"serve artifact {artifact_dir} was written by "
                f"{meta.get('framework') or 'the JAX package'!r}, not "
                f"{FRAMEWORK!r}: export the checkpoint with python -m "
                f"{FRAMEWORK}.serve export")
        entry = meta.get("params", {}).get(dtype)
        if entry is None:
            raise ValueError(
                f"artifact {artifact_dir} ships no {dtype!r} param variant "
                f"(has: {sorted(meta.get('params', {}))})")
        with open(os.path.join(artifact_dir, entry["file"]), "rb") as f:
            blob = f.read()
        digest = hashlib.sha256(blob).hexdigest()
        if digest != entry.get("sha256"):
            raise ValueError(
                f"param blob {entry['file']} fails its integrity check "
                f"({digest[:12]}… != recorded "
                f"{str(entry.get('sha256'))[:12]}…) — re-export the "
                f"artifact")
        flat = torch.load(io.BytesIO(blob), map_location="cpu",
                          weights_only=True)
        del blob

        cfg = from_dict(meta["train_config"])
        mac, env_info = _build_mac(cfg, device)
        if (mac.n_agents != meta["n_agents"]
                or env_info["obs_shape"] != meta["obs_dim"]
                or env_info["n_actions"] != meta["n_actions"]):
            raise ValueError(
                f"artifact {artifact_dir} meta disagrees with its own "
                f"train_config rebuild (agents/obs/actions "
                f"{meta['n_agents']}/{meta['obs_dim']}/{meta['n_actions']}"
                f" vs {mac.n_agents}/{env_info['obs_shape']}/"
                f"{env_info['n_actions']}) — corrupt meta.json?")
        # the variant's tree from the MAC's meta tensors: its paths,
        # shapes and dtypes, with nothing drawn or computed
        template = _cast_variant(mac.prepare_acting_params(
            dict(mac.agent.named_parameters()), dtype=mac.dtype), dtype)
        want, _ = flatten_state(template)
        bad = sorted(k for k in set(want) | set(flat)
                     if k not in want or k not in flat
                     or (flat[k].shape, flat[k].dtype)
                     != (want[k].shape, want[k].dtype))
        if bad:
            raise ValueError(
                f"artifact {artifact_dir} {dtype} params do not match the "
                f"model of its train_config: {len(bad)} leaves differ "
                f"(first: {bad[0]})")
        params = _rebuild(template, lambda path, x: flat[path].to(
            mac.device) if isinstance(x, torch.Tensor) else x)
        fe = cls.__new__(cls)
        fe._setup(mac, env_info, params, meta["buckets"], dtype)
        fe.warmup()
        return fe

    def _validate(self, obs, avail, hidden) -> None:
        a, d, na = self.n_agents, self.obs_dim, self.n_actions
        if obs.ndim != 3 or obs.shape[1:] != (a, d):
            raise ValueError(f"obs must be (n, {a}, {d}), got {obs.shape}")
        if avail.shape != (obs.shape[0], a, na):
            raise ValueError(f"avail must be ({obs.shape[0]}, {a}, {na}), "
                             f"got {avail.shape}")
        if hidden.shape != (obs.shape[0], a, self.emb):
            raise ValueError(f"hidden must be ({obs.shape[0]}, {a}, "
                             f"{self.emb}), got {hidden.shape}")

    def _dispatch(self, obs: np.ndarray, avail: np.ndarray,
                  hidden: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One padded bucket through the step; blocks until the result
        is on the host."""
        dev = self.device
        a, h = self._step(self.params, torch.from_numpy(obs).to(dev),
                          torch.from_numpy(avail).to(dev),
                          torch.from_numpy(hidden).to(dev))
        return a.cpu().numpy(), h.float().cpu().numpy()

    def select(self, obs, avail, hidden=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy actions for a ragged request: ``obs (n, A, obs_dim)``,
        ``avail (n, A, n_actions)``, optional carried ``hidden (n, A,
        emb)`` (None = episode start) → ``(actions (n, A) int32, hidden'
        (n, A, emb) f32)``."""
        obs = np.asarray(obs, np.float32)
        avail = np.asarray(avail)
        if obs.ndim != 3:
            raise ValueError(f"obs must be (n, {self.n_agents}, "
                             f"{self.obs_dim}), got shape {obs.shape}")
        n = obs.shape[0]
        if hidden is None:
            hidden = np.zeros((n, self.n_agents, self.emb), np.float32)
        else:
            hidden = np.asarray(hidden, np.float32)
        self._validate(obs, avail, hidden)

        bmax = self.buckets[-1]
        actions_out = np.empty((n, self.n_agents), np.int32)
        hidden_out = np.empty((n, self.n_agents, self.emb), np.float32)
        rec, hub = self._rec, self._hub
        t_req0 = time.perf_counter() if hub is not None else 0.0
        for lo in range(0, n, bmax):
            hi = min(lo + bmax, n)
            cn = hi - lo
            bucket = pick_bucket(cn, self.buckets)
            with _watched("serve.pad", rec, bucket=bucket, n=cn):
                po, pa, ph = pad_request(obs[lo:hi], avail[lo:hi],
                                         hidden[lo:hi], bucket)
            with _watched("serve.dispatch", rec, bucket=bucket):
                a_host, h_host = self._dispatch(po, pa, ph)
            with _watched("serve.unpad", rec, bucket=bucket):
                actions_out[lo:hi] = a_host[:cn]
                hidden_out[lo:hi] = h_host[:cn]
            if hub is not None:
                # rows / (dispatches x bucket) is the padding occupancy
                hub.inc("serve_dispatches_total", bucket=bucket)
                hub.inc("serve_rows_total", cn, bucket=bucket)
        if hub is not None:
            hub.observe("serve_select_ms",
                        (time.perf_counter() - t_req0) * 1000.0)
            hub.inc("serve_requests_total")
        return actions_out, hidden_out

    def warmup(self) -> None:
        """Dispatch one padded batch per bucket before traffic."""
        for b in self.buckets:
            obs = np.zeros((b, self.n_agents, self.obs_dim), np.float32)
            avail = np.ones((b, self.n_agents, self.n_actions), np.bool_)
            self.select(obs, avail)


class SessionStore:
    """Per-session hidden-state carry over a :class:`ServeFrontend`: each
    request row names a session id; the store gathers each row's carried
    hidden (zeros for new sessions), serves the batch and scatters the
    new hiddens back. ``max_sessions`` bounds it with LRU eviction; an
    evicted session restarts from zeros, counted in ``evicted`` (and the
    front end's hub's ``serve_session_evicted``) and flagged per row by
    ``select``'s ``fresh`` result. The hub also gets ``serve_sessions``
    and ``serve_session_lru_fill`` after each request."""

    def __init__(self, frontend: ServeFrontend,
                 max_sessions: int = 100_000) -> None:
        self._fe = frontend
        self._max = int(max_sessions)
        self._h: Dict[object, np.ndarray] = {}
        self.evicted = 0

    def __len__(self) -> int:
        return len(self._h)

    def select(self, session_ids: Sequence, obs, avail
               ) -> Tuple[np.ndarray, np.ndarray]:
        """→ ``(actions (n, A) int32, fresh (n,) bool)``; ``fresh[i]`` is
        True when row i's session had no carried hidden."""
        if len(session_ids) != np.asarray(obs).shape[0]:
            raise ValueError(
                f"{len(session_ids)} session ids for "
                f"{np.asarray(obs).shape[0]} request rows")
        fe = self._fe
        zeros = np.zeros((fe.n_agents, fe.emb), np.float32)
        fresh = np.array([s not in self._h for s in session_ids], np.bool_)
        hidden = np.stack([self._h.get(s, zeros) for s in session_ids])
        actions, hidden2 = fe.select(obs, avail, hidden)
        for i, s in enumerate(session_ids):
            self._h.pop(s, None)            # move to the LRU end
            self._h[s] = hidden2[i]
        hub = getattr(fe, "_hub", None)     # duck-typed front ends
        while len(self._h) > self._max:
            self._h.pop(next(iter(self._h)))
            self.evicted += 1
            if hub is not None:
                hub.inc("serve_session_evicted")
        if hub is not None:
            hub.set("serve_sessions", len(self._h))
            hub.set("serve_session_lru_fill",
                    len(self._h) / self._max if self._max else 1.0)
        return actions, fresh

    def end(self, session_id) -> None:
        self._h.pop(session_id, None)
