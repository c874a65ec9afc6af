"""Host-RAM prioritized replay with a device-side stratified PER sample
(port of ``t2omca_tpu/components/host_replay.py``,
``replay.buffer_cpu_only``).

Episode storage lives in host tensors (pinned when the device is a
card), so the ring is bounded by host RAM and not by the card's memory;
only sampled batches cross to the device. The PER index is mirrored: an
f32 ``(capacity,)`` priority vector on the host and one on the device,
written together through ``_set_priorities``, so the two never drift.

One ``sample``:

* the stratum uniforms come from ``numpy.random.default_rng(0)`` and
  are cast to f32 before use, as in JAX;
* index selection and importance weights run as device tensor ops over
  the device mirror (``stratified_sample``: the JAX program's
  inverse-CDF over the fill-masked mass, ``searchsorted`` side right,
  clamped to the last filled slot);
* the indices come home in ONE device-to-host copy (the gather reads
  host memory); the weights stay on the device;
* the episodes are gathered from host memory into one pinned staging
  buffer (every leaf at an 8-byte-aligned offset) and cross in ONE
  host-to-device copy, unpacked on the device as views.

Priority feedback is deferred: ``defer_priority_update`` starts
non-blocking copies of the train step's ``|TD|`` and finite flag into
pinned memory and records an event; the next ``sample`` or ``insert``
consumes them (``insert`` first, so a wrapped slot never takes an
evicted episode's ``|TD|``), one iteration late. A tripped step leaves
the mirrors untouched. ``drop_pending_update`` abandons the copies (the
driver's checkpoint restore). Dense storage only: compact entity
storage is ineligible here (``ops/query_slice.entity_store_eligible``).

``PySumTree`` and ``NativeSumTree`` (``native/sumtree.cpp`` through
ctypes) are the reference formulation the tests hold the device sample
against; the live path calls neither.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..xla_float import recip
from .episode_buffer import EpisodeBatch

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PySumTree:
    """NumPy sum-tree formulation (reference only)."""

    def __init__(self, cap: int):
        self.cap = cap
        self.leaf = np.zeros(cap, np.float64)

    def set_batch(self, idx, pri):
        self.leaf[idx] = pri

    def get(self, idx):
        return self.leaf[idx]

    def total(self):
        return float(self.leaf.sum())

    def sample(self, us: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n = len(us)
        cdf = np.cumsum(self.leaf)
        u = (np.arange(n) + us) / n * cdf[-1]
        idx = np.minimum(np.searchsorted(cdf, u, side="right"),
                         self.cap - 1)
        return idx.astype(np.int64), self.leaf[idx]


class NativeSumTree:
    """ctypes wrapper over ``native/sumtree.cpp`` (reference only). Its
    capacity rounds up to a power of two."""

    def __init__(self, cap: int):
        from ..native import load_sumtree
        self._lib = load_sumtree()
        self.cap = 1
        while self.cap < cap:
            self.cap *= 2
        self._ptr = self._lib.sumtree_create(self.cap)
        if not self._ptr:
            raise MemoryError("sumtree_create failed")

    def __del__(self):
        lib, ptr = getattr(self, "_lib", None), getattr(self, "_ptr", None)
        if lib is not None and ptr:
            lib.sumtree_free(ptr)

    @staticmethod
    def _ptrs(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    def set_batch(self, idx, pri):
        idx = np.ascontiguousarray(idx, np.int64)
        pri = np.ascontiguousarray(pri, np.float64)
        self._lib.sumtree_set_batch(self._ptr,
                                    self._ptrs(idx, ctypes.c_int64),
                                    self._ptrs(pri, ctypes.c_double),
                                    len(idx))

    def get(self, idx):
        idx = np.ascontiguousarray(np.atleast_1d(idx), np.int64)
        out = np.empty(len(idx), np.float64)
        self._lib.sumtree_get_batch(self._ptr,
                                    self._ptrs(idx, ctypes.c_int64),
                                    len(idx),
                                    self._ptrs(out, ctypes.c_double))
        return out

    def total(self):
        return self._lib.sumtree_total(self._ptr)

    def sample(self, us: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n = len(us)
        us = np.ascontiguousarray(us, np.float64)
        out_idx = np.empty(n, np.int64)
        out_pri = np.empty(n, np.float64)
        self._lib.sumtree_sample(self._ptr, self._ptrs(us, ctypes.c_double),
                                 n, self._ptrs(out_idx, ctypes.c_int64),
                                 self._ptrs(out_pri, ctypes.c_double))
        return out_idx, out_pri


# ----------------------------------------------------- the device sample

def valid_mass(pri: torch.Tensor, n) -> torch.Tensor:
    """The priority mass of the filled slots (``< n``), zero beyond."""
    slots = torch.arange(pri.shape[0], device=pri.device)
    return torch.where(slots < n, pri, torch.zeros((), device=pri.device))


def weights_from_mass(p: torch.Tensor, idx: torch.Tensor, n,
                      beta) -> torch.Tensor:
    """Max-normalized ``(N·P)^-β`` over the masked mass."""
    probs = p[idx] / torch.clamp(p.sum(), min=1e-12)
    nn = float(max(int(n), 1))
    w = (nn * torch.clamp(probs, min=1e-12)) ** (-beta)
    return w / torch.clamp(w.max(), min=1e-12)


def importance_weights(pri: torch.Tensor, idx: torch.Tensor, n,
                       beta) -> torch.Tensor:
    """The weights at given indices over the raw mirror (the tests
    evaluate it at the sum-tree's own samples)."""
    return weights_from_mass(valid_mass(pri, n), idx, n, beta)


def stratified_sample(pri: torch.Tensor, us: torch.Tensor, n: int,
                      beta) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sum-tree's stratified inverse-CDF sample as device ops: one
    uniform a stratum, ``u = (i + us_i) / bs · cdf[-1]`` (the divisor as
    XLA's reciprocal multiply), ``searchsorted(cdf, u, right)`` clamped
    to the last filled slot → (idx int64, weights f32), both on the
    device."""
    p = valid_mass(pri, n)
    cdf = torch.cumsum(p, dim=0)
    bs = us.shape[0]
    u = (torch.arange(bs, dtype=torch.float32, device=pri.device) + us) \
        * recip(bs) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    idx = torch.clamp(idx, max=max(int(n) - 1, 0))
    return idx, weights_from_mass(p, idx, n, beta)


# ----------------------------------------------------------------- buffer

@dataclasses.dataclass
class HostReplayBuffer:
    """Prioritized episode replay in host RAM. ``device``: where samples
    go and the priority mirror lives (``cuda`` unless named)."""

    capacity: int
    episode_limit: int
    n_agents: int
    n_actions: int
    obs_dim: int
    state_dim: int
    alpha: float = 0.6
    beta0: float = 0.4
    t_max: int = 1
    store_dtype: str = "float32"
    prioritized: bool = True
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.store_dtype not in _STORE_DTYPES:
            raise ValueError(f"store_dtype must be one of "
                             f"{sorted(_STORE_DTYPES)}, got "
                             f"{self.store_dtype!r}")
        self._pin = self.device.type == "cuda"
        t, cap, a = self.episode_limit, self.capacity, self.n_agents
        sd = _STORE_DTYPES[self.store_dtype]
        z = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                             pin_memory=self._pin)
        self._storage = EpisodeBatch(
            obs=z((cap, t + 1, a, self.obs_dim), sd),
            state=z((cap, t + 1, self.state_dim), sd),
            avail_actions=z((cap, t + 1, a, self.n_actions), torch.bool),
            actions=z((cap, t, a), torch.int32),
            reward=z((cap, t), torch.float32),
            terminated=z((cap, t), torch.bool),
            filled=z((cap, t), torch.bool))
        # stored-space p^alpha, twin-mirrored (host f32, device f32)
        self._pri = np.zeros(cap, np.float32)
        self._pri_dev = torch.zeros(cap, device=self.device)
        self._pos = 0
        self._count = 0
        self._max_priority = 1.0
        self._rng = np.random.default_rng(0)
        self._pending_update = None
        self._staging = {}            # batch size -> pinned byte buffer
        self._staged = None           # event after the last staging copy
        #: copies made by ``sample`` (the chip smoke reads them)
        self.copies = {"d2h": 0, "h2d": 0}

    # --------------------------------------------------------- protocol

    @property
    def episodes_in_buffer(self) -> int:
        return self._count

    def insert_episode_batch(self, batch: EpisodeBatch) -> None:
        """Ring-insert ``B`` episodes into host RAM at the running max
        priority. Any deferred feedback is consumed first."""
        self.flush_priority_updates()
        b = batch.batch_size
        if b > self.capacity:
            raise ValueError(f"insert batch of {b} episodes exceeds buffer "
                             f"capacity {self.capacity}")
        idx = (self._pos + np.arange(b)) % self.capacity
        idx_t = torch.from_numpy(idx)
        for f in dataclasses.fields(EpisodeBatch):
            dst = getattr(self._storage, f.name)
            src = getattr(batch, f.name)
            dst.index_copy_(0, idx_t, src.to("cpu", dst.dtype))
        if self.prioritized:
            self._set_priorities(idx, np.full(
                b, self._max_priority ** self.alpha, np.float32))
        self._pos = int((self._pos + b) % self.capacity)
        self._count = int(min(self._count + b, self.capacity))

    def _set_priorities(self, idx: np.ndarray, vals: np.ndarray) -> None:
        """O(batch) write of the same f32 values into both mirrors."""
        self._pri[idx] = vals
        self._pri_dev.index_put_(
            (torch.from_numpy(np.asarray(idx, np.int64)).to(self.device),),
            torch.from_numpy(np.asarray(vals, np.float32)).to(self.device))

    def can_sample(self, batch_size: int) -> bool:
        return self._count >= batch_size

    def defer_priority_update(self, idx: np.ndarray, td: torch.Tensor,
                              finite: torch.Tensor) -> None:
        """Start the device-to-host copies of a train step's ``|TD|`` and
        finite flag (non-blocking, into pinned memory, an event behind
        them); the next ``sample`` or insert consumes them."""
        if not self.prioritized:
            return
        self.flush_priority_updates()          # at most one in flight
        td_h = torch.empty(td.shape, dtype=td.dtype, pin_memory=self._pin)
        ok_h = torch.empty(finite.shape, dtype=finite.dtype,
                           pin_memory=self._pin)
        td_h.copy_(td, non_blocking=True)
        ok_h.copy_(finite, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._pending_update = (np.asarray(idx, np.int64), td_h, ok_h,
                                event)

    def drop_pending_update(self) -> None:
        """Abandon deferred feedback without consuming it (its step was
        rolled back)."""
        self._pending_update = None

    def flush_priority_updates(self) -> None:
        """Consume the deferred feedback, if any: wait on its event, and
        write ``|TD| + 1e-6`` (f64 on the host) when the step was
        finite."""
        if self._pending_update is None:
            return
        idx, td_h, ok_h, event = self._pending_update
        self._pending_update = None
        if event is not None:
            event.synchronize()
        if bool(ok_h):
            td = td_h.double().numpy()
            self.update_priorities(idx, td + 1e-6)             # Q9

    def update_priorities(self, idx: np.ndarray, priorities) -> None:
        if not self.prioritized:
            return
        pri = np.asarray(priorities, np.float64)
        self._max_priority = float(max(self._max_priority, pri.max()))
        self._set_priorities(np.asarray(idx, np.int64),
                             (pri ** self.alpha).astype(np.float32))

    def beta(self, t_env: int) -> np.float32:
        """β annealed to 1 over ``t_max``, on the host, cast once to
        f32."""
        return np.float32(self.beta0 + (1.0 - self.beta0) * min(
            max(float(t_env) / self.t_max, 0.0), 1.0))

    def sample(self, batch_size: int, t_env: int
               ) -> Tuple[EpisodeBatch, np.ndarray, torch.Tensor]:
        """→ (batch on the device, host indices, device weights)."""
        self.flush_priority_updates()
        n = self._count
        if self.prioritized:
            us = self._rng.random(batch_size).astype(np.float32)
            idx_dev, w = stratified_sample(
                self._pri_dev, torch.from_numpy(us).to(self.device), n,
                float(self.beta(t_env)))
            idx = idx_dev.cpu().numpy()            # the one D2H
            self.copies["d2h"] += 1
        else:
            idx = self._rng.choice(n, size=batch_size, replace=False)
            w = torch.ones(batch_size, device=self.device)
        return self._gather(np.asarray(idx, np.int64)), idx, w

    def _gather(self, idx: np.ndarray) -> EpisodeBatch:
        """The episodes at ``idx`` from host memory into one staging
        buffer, one host-to-device copy, unpacked as views."""
        b = len(idx)
        fields = [f.name for f in dataclasses.fields(EpisodeBatch)]
        layout, at = [], 0
        for name in fields:
            src = getattr(self._storage, name)
            shape = (b,) + tuple(src.shape[1:])
            nbytes = int(np.prod(shape)) * src.element_size()
            layout.append((name, src.dtype, shape, at, nbytes))
            at += -(-nbytes // 8) * 8
        buf = self._staging.get(b)
        if buf is None or buf.numel() < at:
            buf = torch.empty(at, dtype=torch.uint8, pin_memory=self._pin)
            self._staging[b] = buf
        if self._staged is not None:      # the last copy has left buf
            self._staged.synchronize()
        idx_t = torch.from_numpy(idx)
        for name, dtype, shape, off, nbytes in layout:
            dst = buf[off:off + nbytes].view(dtype).view(shape)
            torch.index_select(getattr(self._storage, name), 0, idx_t,
                               out=dst)
        dev = buf[:at].to(self.device, non_blocking=self._pin, copy=True)
        self.copies["h2d"] += 1
        if self._pin:
            self._staged = torch.cuda.Event()
            self._staged.record()
        return EpisodeBatch(**{
            name: dev[off:off + nbytes].view(dtype).view(shape)
            for name, dtype, shape, off, nbytes in layout})

    def sight_priority_info(self) -> dict:
        """The PER-health read over the host mirror (numpy), as 0-d f32
        tensors on the device beside the train info."""
        from ..obs.sight import buffer_sight_info_host
        return {k: torch.tensor(float(v), device=self.device)
                for k, v in buffer_sight_info_host(self._pri,
                                                   self._count).items()}
