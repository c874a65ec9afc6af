"""Resilience primitives: graceful-shutdown guard + fault-injection hooks
(the port's copy of ``t2omca_tpu/utils/resilience.py``; the code is
unchanged, the hook table lists the points the port fires).

Long-lived runs die three ways the happy-path driver cannot survive:
preemption (a scheduler SIGTERMs the job mid-iteration), torn checkpoints
(a crash mid-``save_checkpoint`` leaves a truncated ``state.pt`` at the
HIGHEST step, which a naive resume then selects), and numeric collapse
(one NaN loss poisons params, then every checkpoint after it). Podracer
(arxiv 2104.06272) treats preemption-safe checkpointing as table stakes;
EnvPool (arxiv 2206.10558) shows a long-running vectorized loop must
survive component faults. This module holds the two process-level pieces:

* :class:`ShutdownGuard` — installs SIGTERM/SIGINT handlers that only SET A
  FLAG; the driver loop polls it once per dispatch and performs an orderly
  exit (final emergency checkpoint, resume hint, exit code 0). The handler
  itself does no I/O — async-signal-safe by construction.
* fault-injection registry (``register_fault``/``fire``) — named hook
  points inside the checkpoint writer and the driver loop where tests
  deterministically inject crashes (truncate a staged file, raise
  mid-write, deliver a signal at an exact ``t_env``). Production code calls
  ``fire(...)`` unconditionally; with nothing registered it is a dict
  lookup returning immediately.

The third piece — the non-finite guard over loss/grads — lives inside the
train step (``learners/qmix_learner.py``) because it must not block the
asynchronous device queue; the driver only counts its ``all_finite`` flags
at the log cadence (``run.py``). Config knobs: ``resilience.*`` in
``config.py``.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------- faults

#: hook point name -> injector callables, fired in registration order.
#:
#: The device-facing point names below (``dispatch.*``, ``fetch.*``,
#: ``collective.gather``) double as span phases (``obs/spans.
#: KNOWN_PHASES``): when ``config.ObsConfig.enabled`` the driver records a
#: span around the same region each hook fires in, so an injected
#: fault/hang and its telemetry trail share one name.
#:
#: Points the port fires (each passes keyword context):
#:   ``checkpoint.staged``   dirname=<staging dir>, t_env=<int>
#:       after state.pt is written+fsynced into the tmp.<t_env> staging
#:       directory, BEFORE the sidecar write and atomic publish — raising
#:       here simulates a crash mid-checkpoint; truncating
#:       <dirname>/state.pt here simulates a torn write that still gets
#:       published (the checksum must catch it on resume).
#:   ``driver.iteration``    t_env=<int>, guard=<ShutdownGuard>,
#:                           state=<TrainState>, key=<driver key>
#:       top of every run_sequential dispatch — deliver a signal or trip
#:       the guard at an exact env-step. ``state`` and ``key`` are what
#:       the next dispatch starts from (read-only: an observer, e.g. a
#:       check that a resumed state equals its checkpoint).
#:   ``dispatch.superstep``  t_env=<int>, attempt=<int>, k=<int>
#:       before EACH attempt of a K-iteration dispatch (run.py
#:       ``_dispatch``) — sleep here to simulate a hung dispatch (the
#:       watchdog must fire), raise a transient-classified error to
#:       exercise retry/backoff and the degradation ladder.
#:   ``dispatch.rollout`` / ``dispatch.train``   t_env=<int>, attempt=<int>
#:       same, for the K = 1 loop's two dispatches.
#:   ``dispatch.test``       t_env=<int>, attempt=<int>
#:       same, for each test-cadence evaluation rollout.
#:   ``dispatch.wait``       t_env=<int>
#:       before the run-ahead device wait — the steady-state blocking
#:       point where asynchronous device faults surface; transient errors
#:       route to the ladder's restore rung (no in-place retry is
#:       possible at a sync point).
#:   ``fetch.train_infos``   t_env=<int>
#:       before the log-cadence device→host fetch of the accumulated
#:       train-info rows (non-finite flags + last stats row) — same
#:       sync-point routing as ``dispatch.wait``.
#:   ``fetch.train_stats`` / ``fetch.test_stats``   t_env=<int>
#:       before each StatsAccumulator device fetch (the per-push fold
#:       and the runner-log / test-quota flushes) — same sync-point
#:       routing as ``dispatch.wait``.
#:   ``collective.gather``   t_env=<int>, multihost=<bool>
#:       inside save_checkpoint's device→host copy of the state — raise
#:       to simulate a flaky copy; the driver's save cadence retries
#:       transient errors.
_FAULTS: Dict[str, List[Callable]] = {}


def register_fault(point: str, fn: Callable) -> None:
    """Register ``fn(**context)`` to run whenever ``point`` fires.

    Test-only by intent: nothing in the production config path registers
    injectors. Injectors run inline in the faulting thread and may raise —
    that IS the fault."""
    _FAULTS.setdefault(point, []).append(fn)


def clear_faults(point: Optional[str] = None) -> None:
    """Drop all injectors (or just ``point``'s). Tests pair this with
    ``register_fault`` in a fixture finalizer so faults never leak."""
    if point is None:
        _FAULTS.clear()
    else:
        _FAULTS.pop(point, None)


def fire(point: str, **context) -> None:
    """Run every injector registered for ``point``. No-op (one dict
    lookup) when nothing is registered — safe on hot paths."""
    for fn in _FAULTS.get(point, ()):
        fn(**context)


# ---------------------------------------------------------------- shutdown

class ShutdownGuard:
    """Flag-based SIGTERM/SIGINT latch for the driver loop.

    Usage::

        with ShutdownGuard.install() as guard:
            while training:
                if guard.triggered:
                    break          # orderly: emergency checkpoint + exit 0
                ...

    The handler records WHICH signal fired (``guard.signame``) and sets a
    ``threading.Event`` — nothing else, so it is safe at any interrupt
    point. A second delivery of the same signal while shutdown is already
    in progress re-raises the default behavior (operator escalation:
    kill -TERM twice = die now), so a wedged emergency checkpoint cannot
    make the process unkillable.

    Signal handlers are process-global and main-thread-only; ``install``
    degrades gracefully (returns a guard with ``installed == False``) when
    called off the main thread, where ``triggered`` can still be tripped
    programmatically via :meth:`request` (fault injection uses this).
    """

    def __init__(self) -> None:
        self._event = threading.Event()
        self._prev: Dict[int, object] = {}
        self.signame: Optional[str] = None
        self.installed = False

    # -- construction ----------------------------------------------------

    @classmethod
    def install(cls, signals=(signal.SIGTERM, signal.SIGINT)
                ) -> "ShutdownGuard":
        guard = cls()
        for s in signals:
            try:
                guard._prev[s] = signal.signal(s, guard._handler)
            except ValueError:
                # not the main thread (or an unsupported signal on this
                # platform): signal.signal refuses — run guarded-by-flag
                # only, preemption falls back to the default disposition
                logger.warning(
                    "ShutdownGuard: cannot install handler for %s "
                    "(not the main thread?) — graceful shutdown limited "
                    "to programmatic request()", signal.Signals(s).name)
                continue
            guard.installed = True
        return guard

    def _handler(self, signum, frame) -> None:
        if self._event.is_set():
            # escalation: restore default dispositions so the NEXT signal
            # (or this one re-raised) terminates immediately
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.signame = signal.Signals(signum).name
        self._event.set()

    # -- queries / control ----------------------------------------------

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def request(self, name: str = "request") -> None:
        """Trip the guard without a real signal (fault injection, tests,
        or an in-process watchdog)."""
        self.signame = self.signame or name
        self._event.set()

    def uninstall(self) -> None:
        """Restore the previous handlers (idempotent)."""
        prev, self._prev = self._prev, {}
        for s, h in prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, TypeError):
                pass
        self.installed = False

    # -- context manager -------------------------------------------------

    def __enter__(self) -> "ShutdownGuard":
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()
