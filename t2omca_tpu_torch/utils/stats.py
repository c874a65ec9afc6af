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
pending rollout) is the fold's only device→host transfer. The JAX
accumulator's per-scenario slice rows need episodes of more than one
scenario family; the port's env has only the fixed scenario (the
uniform and mixture kinds are ``ROADMAP.md`` item 11), so this
accumulator keeps no slices, and the JAX one logs none for such runs.
Population (``pop<i>_*``) rows are item 11 too.
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


class StatsAccumulator:
    """Accumulates RolloutStats across rollouts; flush = reference ``_log``.

    ``push`` reduces the rollout's stats on the device (no transfer); the
    device→host copy happens once per fold (every ``FOLD_EVERY`` pushes
    and at each ``flush``), one ``.cpu()`` for every pending rollout."""

    #: fold threshold: past this many pushes the pending device results
    #: are folded into the host-side sums, bounding what stays pinned
    #: on the device when ``runner_log_interval`` spans many rollouts
    FOLD_EVERY = 64

    def __init__(self):
        self.n_episodes = 0
        #: device→host round-trips this accumulator has performed (folds
        #: + mid-interval epsilon reads), logged as ``stat_fetches``
        self.fetches = 0
        self._pending: List[_Pending] = []
        self._eps_ref = None        # epsilon pushed since the last fetch
        self._eps_val = 0.0         # cached host value
        self._returns: List[float] = []   # folded per-episode returns
        self._stats = defaultdict(float)  # folded terminal-info sums

    def push(self, rollout_stats) -> None:
        """A rollout's ``(B,)`` stats, or a K-iteration dispatch's stacked
        ``(K, B)`` (flattened to one per-episode stream)."""
        ret = rollout_stats.episode_return.reshape(-1).to(torch.float32)
        keys = tuple(k for k in TERMINAL_INFO_KEYS
                     if getattr(rollout_stats, k, None) is not None)
        rows = torch.stack([getattr(rollout_stats, k).reshape(-1)
                            .to(torch.float32) for k in keys])
        self._pending.append(_Pending(ret, np_sum_f32(rows), keys))
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
        flat = torch.cat([t for p in self._pending
                          for t in (p.returns, p.sums)]).cpu().numpy()
        at = 0
        for p in self._pending:
            n = p.returns.numel()
            self._returns.extend(float(x) for x in flat[at:at + n])
            at += n
            for k in p.keys:
                self._stats[k] += float(flat[at])
                at += 1
        # the most recent push's epsilon (a stacked push's LAST row); the
        # port's epsilon is a host value already
        eps = np.asarray(torch.as_tensor(self._eps_ref).cpu()) \
            if self._eps_ref is not None else np.asarray(self._eps_val)
        self._eps_val = float(np.mean(eps.reshape(-1)[-1:]))
        self._eps_ref = None
        self._pending.clear()

    @property
    def epsilon(self) -> float:
        """Exploration rate of the most recent rollout (logged alongside
        each train-stat flush). A read with pushes since the last fold
        counts as a fetch, as in the JAX accumulator; ``flush`` refreshes
        the cached value inside its own fold."""
        if self._eps_ref is not None:
            self.fetches += 1
            eps = np.asarray(torch.as_tensor(self._eps_ref).cpu())
            self._eps_val = float(eps.reshape(-1)[-1])
            self._eps_ref = None
        return self._eps_val

    def flush(self, logger, t_env: int, prefix: str = "") -> None:
        """Log ``return_mean`` + every ``<k>_mean`` and clear."""
        self._fold()                              # ONE host round-trip
        if self._returns:
            logger.log_stat(prefix + "return_mean",
                            float(np.mean(self._returns)), t_env)
        n = max(self.n_episodes, 1)
        for k, v in self._stats.items():
            logger.log_stat(prefix + k + "_mean", v / n, t_env)
        self._returns.clear()
        self._stats.clear()
        self.n_episodes = 0
