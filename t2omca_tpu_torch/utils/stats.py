"""Terminal-info stat aggregation — the reference runner's contract (port of
``t2omca_tpu/utils/stats.py``).

Re-creates ``cur_stats`` / ``cur_returns`` semantics of the reference's
``parallel_runner.py:193-231`` exactly:

* only the info dict of the TERMINAL step of each episode enters the stats;
* values are summed across envs AND across rollouts until a flush, with
  ``n_episodes`` accumulating ``batch_size`` per rollout;
* a flush logs ``<k>_mean = Σv / n_episodes`` plus ``return_mean`` over the
  accumulated per-episode returns, then clears;
* test stats flush only when exactly the rounded ``test_nepisode`` quota of
  returns has accumulated (quirk Q10); train stats flush on the
  ``runner_log_interval`` cadence with ``epsilon`` logged alongside.

Where the port differs: the per-rollout fold runs on the device. Each
pending ``RolloutStats`` is summed there (one sum per terminal key, in
numpy's float32 pairwise order: :func:`np_sum_f32`, so every sum is the
number the JAX accumulator's ``np.sum`` gives), and one ``.cpu()`` copy
of one flat tensor (the per-episode returns and those sums of every
pending rollout, then each rollout's per-episode family ids and
``SLICE_KEYS`` values) is the fold's only device→host transfer.

Per-scenario slices (graftworld): the fold sums each family's episodes
on the host from that copy, as the JAX accumulator does (numpy float32
sums of ``ret[sel]``, accumulated in Python floats), and a flush logs
``<prefix>slice<fam>_n``, ``_return_mean`` and ``_<key>_mean`` rows only
when the flushed episodes span more than one family, so a single-
scenario run keeps its stream unchanged.

A population (``StatsAccumulator(population=P)``, ``population.py``)
pushes stats with a leading ``(P,)`` member axis. The same fold also sums
each member's episodes (numpy's float32 sum of the member's slice, on the
device, in the same one copy), and a flush at P > 1 logs
``<prefix>pop<i>_return_mean`` and ``_<key>_mean`` for
``POP_MEMBER_KEYS``; at every P it refreshes ``member_return_ema``, PBT's
ranking. The aggregate rows are over all members' episodes, and the
logged ``epsilon`` is member 0's, as in JAX; P = 1 keeps the solo stream.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

#: info keys present in the reference env's terminal-step info dict, plus
#: the graftworld deadline-miss rate (envs/mec_offload.StepInfo)
TERMINAL_INFO_KEYS = (
    "reward", "delay_reward", "overtime_penalty",
    "channel_utilization_rate", "conflict_ratio", "episode_limit",
    "task_completion_rate", "task_completion_delay",
    "deadline_miss_rate",
)

#: per-slice keys (graftworld per-scenario eval): return plus the
#: generalization-relevant rates
SLICE_KEYS = ("conflict_ratio", "task_completion_rate",
              "deadline_miss_rate")

#: per-member keys of the population's ``pop<i>_*`` rows (with
#: ``pop<i>_return_mean``)
POP_MEMBER_KEYS = ("task_completion_rate", "conflict_ratio",
                   "deadline_miss_rate")

#: numpy's pairwise-summation leaf size (``PW_BLOCKSIZE``) and its
#: iterator's buffer size (a reduction's inner loop sees at most this
#: many elements at once)
_PW_BLOCK = 128
_NP_BUFSIZE = 8192


@lru_cache(maxsize=64)
def _pairwise_plan(n: int) -> Tuple[tuple, tuple]:
    """numpy's pairwise recursion over ``n`` elements → (leaves as
    ``(start, length)`` in order, combine steps as ``(a, b)`` indices into
    the growing list of partial sums, each appending ``s[a] + s[b]``)."""
    leaves, steps = [], []

    def rec(lo: int, m: int) -> int:
        if m <= _PW_BLOCK:
            leaves.append((lo, m))
            return len(leaves) - 1
        m2 = m // 2
        m2 -= m2 % 8
        a, b = rec(lo, m2), rec(lo + m2, m - m2)
        steps.append((a, b))
        return -len(steps)              # combine results: -1, -2, ...

    rec(0, n)
    return tuple(leaves), tuple(steps)


def _leaf_sums(x: torch.Tensor, m: int) -> torch.Tensor:
    """numpy's leaf sum of ``x (..., m)`` (m ≤ 128) in float32 → (...)."""
    if m < 8:
        res = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(m):
            res = res + x[..., i]
        return res
    r = x[..., :8]
    full = m - m % 8
    for i in range(8, full, 8):
        r = r + x[..., i:i + 8]
    res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + \
          ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
    for i in range(full, m):
        res = res + x[..., i]
    return res


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise sum of each row of ``x (F, n)``, 1 ≤ n ≤ 8192."""
    leaves, steps = _pairwise_plan(x.shape[1])
    sums = [None] * len(leaves)
    by_len = defaultdict(list)
    for i, (lo, m) in enumerate(leaves):
        by_len[m].append(i)
    for m, ids in by_len.items():
        starts = torch.tensor([leaves[i][0] for i in ids], device=x.device)
        idx = starts[:, None] + torch.arange(m, device=x.device)
        part = _leaf_sums(x[:, idx], m)             # (F, G)
        for j, i in enumerate(ids):
            sums[i] = part[:, j]
    combined = []
    pick = lambda k: sums[k] if k >= 0 else combined[-k - 1]
    for a, b in steps:
        combined.append(pick(a) + pick(b))
    return combined[-1] if combined else sums[0]


def np_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """``np.sum`` of each row of a float32 ``x (F, n)`` → ``(F,)``, bit for
    bit: numpy's pairwise summation (leaves of up to 128 elements summed
    with eight running partial sums, halves split at multiples of 8) over
    each chunk of its 8192-element iterator buffer, the chunks added in
    order to a zero start, every add rounded to float32. Runs on ``x``'s
    device; leaves of one length are summed together."""
    x = x.to(torch.float32)
    total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for lo in range(0, x.shape[1], _NP_BUFSIZE):
        total = total + _pairwise_sum(x[:, lo:lo + _NP_BUFSIZE])
    return total


@dataclasses.dataclass
class _Pending:
    """One pushed ``RolloutStats`` reduced on the device: the per-episode
    returns and the terminal keys' sums."""

    returns: torch.Tensor        # (n,) f32
    sums: torch.Tensor           # (len(keys),) f32
    keys: Tuple[str, ...]
    #: (1 + len(SLICE_KEYS), n) f32: the family ids, then the per-episode
    #: values of SLICE_KEYS
    slices: torch.Tensor
    #: under a population: (P,) member return sums, then the terminal
    #: keys' member sums (len(keys) · P, key-major); else empty
    members: torch.Tensor


class StatsAccumulator:
    """Accumulates RolloutStats across rollouts; flush = reference ``_log``.

    ``push`` reduces the rollout's stats on the device (no transfer); the
    device→host copy happens once per fold (every ``FOLD_EVERY`` pushes
    and at each ``flush``), one ``.cpu()`` for every pending rollout."""

    #: fold threshold: past this many pushes the pending device results
    #: are folded into the host-side sums, bounding what stays pinned
    #: on the device when ``runner_log_interval`` spans many rollouts
    FOLD_EVERY = 64

    def __init__(self, population: int = 0):
        self.n_episodes = 0
        #: P > 0: pushed stats carry a leading (P,) member axis
        self.population = population
        #: per-member return EMA across flushes (PBT's ranking); None
        #: until the member has flushed once
        self.member_return_ema: List = [None] * max(population, 0)
        # member id -> {n, return, <TERMINAL_INFO_KEYS sums>}
        self._members = defaultdict(lambda: defaultdict(float))
        #: device→host round-trips this accumulator has performed (folds
        #: + mid-interval epsilon reads), logged as ``stat_fetches``
        self.fetches = 0
        self._pending: List[_Pending] = []
        self._eps_ref = None        # epsilon pushed since the last fetch
        self._eps_val = 0.0         # cached host value
        self._returns: List[float] = []   # folded per-episode returns
        self._stats = defaultdict(float)  # folded terminal-info sums
        # family id -> {n, return, <SLICE_KEYS sums>}
        self._slices = defaultdict(lambda: defaultdict(float))

    def push(self, rollout_stats) -> None:
        """A rollout's ``(B,)`` stats, or a K-iteration dispatch's stacked
        ``(K, B)`` (flattened to one per-episode stream)."""
        ret = rollout_stats.episode_return.reshape(-1).to(torch.float32)
        keys = tuple(k for k in TERMINAL_INFO_KEYS
                     if getattr(rollout_stats, k, None) is not None)
        rows = torch.stack([getattr(rollout_stats, k).reshape(-1)
                            .to(torch.float32) for k in keys])
        slices = torch.stack([rollout_stats.scenario.reshape(-1).float()]
                             + [getattr(rollout_stats, k).reshape(-1).float()
                                for k in SLICE_KEYS])
        p = self.population
        members = (torch.cat([np_sum_f32(ret.reshape(p, -1)),
                              np_sum_f32(rows.reshape(len(keys) * p, -1))])
                   if p else ret.new_zeros(0))
        self._pending.append(_Pending(ret, np_sum_f32(rows), keys, slices,
                                      members))
        self._eps_ref = rollout_stats.epsilon
        # episode count is static shape info — reading it syncs nothing
        self.n_episodes += int(
            np.prod(tuple(rollout_stats.episode_return.shape)) or 1)
        if len(self._pending) >= self.FOLD_EVERY:
            self._fold()

    def _fold(self) -> None:
        """Copy every pending device result to the host in ONE transfer
        and fold it into the host-side sums; clears ``_pending``."""
        if not self._pending:
            return
        self.fetches += 1
        flat = torch.cat([t.reshape(-1) for p in self._pending
                          for t in (p.returns, p.sums, p.slices, p.members)]
                         ).cpu().numpy()
        at = 0
        for p in self._pending:
            n = p.returns.numel()
            ret = flat[at:at + n]
            self._returns.extend(float(x) for x in ret)
            at += n
            for k in p.keys:
                self._stats[k] += float(flat[at])
                at += 1
            rows = flat[at:at + p.slices.numel()].reshape(-1, n)
            at += p.slices.numel()
            self._fold_slices(ret, rows[0].astype(np.int64), rows[1:])
            if self.population:
                pop = self.population
                msum = flat[at:at + p.members.numel()]
                at += p.members.numel()
                for m in range(pop):
                    mem = self._members[m]
                    mem["n"] += float(n // pop)
                    mem["return"] += float(msum[m])
                    for i, k in enumerate(p.keys):
                        mem[k] += float(msum[pop + i * pop + m])
        # the most recent push's epsilon (a stacked push's LAST row; member
        # 0's under a population); the port's epsilon is a host value
        # already
        eps = np.asarray(torch.as_tensor(self._eps_ref).cpu()) \
            if self._eps_ref is not None else np.asarray(self._eps_val)
        if self.population and self._eps_ref is not None:
            eps = eps[0]
        self._eps_val = float(np.mean(eps.reshape(-1)[-1:]))
        self._eps_ref = None
        self._pending.clear()

    def _fold_slices(self, ret: np.ndarray, fam: np.ndarray,
                     vals: np.ndarray) -> None:
        """Per-family sums of one rollout's episodes, as the JAX fold
        forms them: float32 numpy sums of each family's entries."""
        for f in np.unique(fam):
            sel = fam == f
            sl = self._slices[int(f)]
            sl["n"] += float(sel.sum())
            sl["return"] += float(ret[sel].sum())
            for k, v in zip(SLICE_KEYS, vals):
                sl[k] += float(v[sel].sum())

    @property
    def epsilon(self) -> float:
        """Exploration rate of the most recent rollout (logged alongside
        each train-stat flush). A read with pushes since the last fold
        counts as a fetch, as in the JAX accumulator; ``flush`` refreshes
        the cached value inside its own fold."""
        if self._eps_ref is not None:
            self.fetches += 1
            eps = np.asarray(torch.as_tensor(self._eps_ref).cpu())
            if self.population:
                eps = eps[0]
            self._eps_val = float(eps.reshape(-1)[-1])
            self._eps_ref = None
        return self._eps_val

    def flush(self, logger, t_env: int, prefix: str = "") -> None:
        """Log ``return_mean`` + every ``<k>_mean``, then the
        ``<prefix>slice<fam>_*`` rows when more than one scenario family
        was seen, and clear."""
        self._fold()                              # ONE host round-trip
        if self._returns:
            logger.log_stat(prefix + "return_mean",
                            float(np.mean(self._returns)), t_env)
        n = max(self.n_episodes, 1)
        for k, v in self._stats.items():
            logger.log_stat(prefix + k + "_mean", v / n, t_env)
        if self.population:
            for m in sorted(self._members):
                mem = self._members[m]
                if not mem.get("n"):
                    continue
                mn = max(mem["n"], 1.0)
                r = mem["return"] / mn
                ema = self.member_return_ema[m]
                self.member_return_ema[m] = (
                    r if ema is None else 0.7 * ema + 0.3 * r)
                if self.population > 1:
                    tag = f"{prefix}pop{m}_"
                    logger.log_stat(tag + "return_mean", r, t_env)
                    for k in POP_MEMBER_KEYS:
                        if k in mem:
                            logger.log_stat(tag + k + "_mean",
                                            mem[k] / mn, t_env)
        if len(self._slices) > 1:
            for fam in sorted(self._slices):
                sl = self._slices[fam]
                sn = max(sl["n"], 1.0)
                tag = f"{prefix}slice{fam}_"
                logger.log_stat(tag + "n", sl["n"], t_env)
                logger.log_stat(tag + "return_mean", sl["return"] / sn,
                                t_env)
                for k in SLICE_KEYS:
                    logger.log_stat(tag + k + "_mean", sl[k] / sn, t_env)
        self._returns.clear()
        self._stats.clear()
        self._members.clear()
        self._slices.clear()
        self.n_episodes = 0
