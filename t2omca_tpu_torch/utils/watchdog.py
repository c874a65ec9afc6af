"""Dispatch watchdog, retry/backoff, and the degradation ladder (the
port's copy of ``t2omca_tpu/utils/watchdog.py``).

A dispatch of K training iterations concentrates all progress into one
long device-facing call, and a wedged device or driver can make that
call *hang* rather than fail — longer than any scheduler's preemption
grace, so the run would die with nothing on disk and no diagnosis.
Podracer-style loops (arxiv 2104.06272) assume the driver can detect a
starved accelerator; this module supplies the three host-side pieces the
driver (``run.run_sequential``) composes around every device-facing
boundary:

* :class:`Watchdog` — a heartbeat monitor. The driver stamps a phase
  before each dispatch / collective / checkpoint gather and clears it
  when the call returns; a daemon thread fires once per armed stamp that
  outlives ``timeout_s``, capturing a :class:`StallDiagnosis` (phase,
  t_env, elapsed, backend) and invoking ``on_stall`` — the driver's
  callback writes an emergency checkpoint from the stamped (pre-dispatch,
  still-consistent) state, persists the diagnosis, and trips the
  ShutdownGuard so the loop exits orderly if the stalled call ever
  returns. If it never does, an optional hard-exit stage terminates the
  process after ``grace_s`` with a distinctive exit code — the supervisor
  restarts and resume picks the emergency checkpoint.
* :func:`retry_call` — bounded attempts with exponential backoff +
  jitter, gated on :func:`is_transient` error classification (gloo
  ``EnforceNotMet``, connection resets, rendezvous timeouts, ...).
  Deterministic errors (shape bugs, config mistakes) propagate on the
  first attempt — retrying those only delays the real diagnosis.
* :class:`DegradationLadder` — the escalation policy for dispatch
  failures that survive in-place retries: shrink the blast radius
  (superstep K→1, so a preemption or the next failure loses ≤1
  iteration), then restore the last good checkpoint, then abort with the
  captured diagnosis. Config knobs: ``resilience.*`` (config.py);
  contract: docs/RESILIENCE.md §5.

Everything here is host-side; tests drive it with millisecond timeouts
on the CPU (``tests/test_torch_resilience.py``).

Where the port differs from the JAX module: :func:`state_intact` is
true for any state (torch donates no buffers), and the diagnosis's
``backend`` is the device type the driver hands the watchdog
(``"cuda"`` or ``"cpu"``), not ``jax.default_backend()``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Optional

from .ioutil import write_json_atomic

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------- errors


class DispatchFailed(RuntimeError):
    """A device-facing dispatch failed and exhausted its in-place retries
    (or could not be retried because its donated inputs were already
    consumed). Carries what the degradation ladder needs to pick a rung
    and what the final abort diagnosis reports."""

    def __init__(self, phase: str, attempts: int, cause: BaseException):
        super().__init__(
            f"dispatch {phase!r} failed after {attempts} attempt(s): "
            f"{type(cause).__name__}: {cause}")
        self.phase = phase
        self.attempts = attempts
        self.cause = cause


# ---------------------------------------------------------------- retry

#: substrings (lowercased, matched against ``TypeName: message``) that mark
#: an error as plausibly transient — worth a bounded retry. Collected from
#: the failure modes this repo has actually hit (CHANGES.md): the gloo
#: ``EnforceNotMet`` preamble-size crash on the 2-process CPU transport,
#: coordinator rendezvous races, dropped remote-tunnel connections.
TRANSIENT_PATTERNS = (
    "enforcenotmet",            # gloo transport assertion (CPU collectives)
    "gloo",
    "connection",               # reset / refused / aborted
    "broken pipe",
    "reset by peer",
    "socket",
    "timed out",
    "timeout",
    "deadline",
    "unavailable",
    "temporarily",
    "rendezvous",
    "barrier",
    "preempt",
    "resource exhausted",
    "too many open files",
)


def is_transient(exc: BaseException) -> bool:
    """Heuristic retriable-error classification. Connection/timeout OS
    errors are transient by type; everything else by message substring
    (a backend surfaces transport faults with the transport's text
    inside). Interrupts/exits are never transient — callers only catch
    ``Exception``, but guard anyway. Nothing here classifies a CUDA
    error as transient: a CUDA error leaves the context unusable, and a
    retry on it would only fail again."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError,
                        BrokenPipeError)):
        return True
    msg = f"{type(exc).__name__}: {exc}".lower()
    return any(p in msg for p in TRANSIENT_PATTERNS)


def backoff_delay(attempt: int, base_s: float, mult: float = 2.0,
                  max_s: float = 30.0, jitter: float = 0.25,
                  _random: Callable[[], float] = random.random) -> float:
    """Exponential backoff for 1-based ``attempt`` with multiplicative
    jitter in ``[0, jitter]`` — the jitter decorrelates peers retrying the
    same shared resource (coordinator, tunnel, filesystem) in lockstep."""
    delay = min(base_s * (mult ** max(attempt - 1, 0)), max_s)
    return delay * (1.0 + jitter * _random())


def retry_call(fn: Callable[[], Any], *, attempts: int = 3,
               backoff_s: float = 0.5, backoff_mult: float = 2.0,
               max_backoff_s: float = 30.0, jitter: float = 0.25,
               retriable: Callable[[BaseException], bool] = is_transient,
               label: str = "", sleep: Callable[[float], None] = time.sleep
               ) -> Any:
    """Call ``fn()`` with up to ``attempts`` tries. Non-retriable errors
    (per ``retriable``) and the final failure propagate unmodified —
    callers keep their existing except clauses. ``sleep`` is injectable so
    tests assert the backoff sequence without waiting it out."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:          # noqa: BLE001 — classified below
            if attempt >= attempts or not retriable(e):
                raise
            delay = backoff_delay(attempt, backoff_s, backoff_mult,
                                  max_backoff_s, jitter)
            logger.warning(
                "%s: transient failure (attempt %d/%d), retrying in "
                "%.2fs: %s: %s", label or getattr(fn, "__name__", "call"),
                attempt, attempts, delay, type(e).__name__, e)
            sleep(delay)


def state_intact(state: Any) -> bool:
    """Whether a failed dispatch left ``state`` usable for an in-place
    retry. In the JAX package this is false once a donated input buffer
    was consumed (``jax.Array.is_deleted``). Torch donates nothing: a
    program's inputs stay allocated whatever happens inside it, so in the
    port this is true for any state. (The ring's episode storage and
    priorities are written in place by the insert, but the cursor that
    says where is a new tensor committed only after the dispatch
    succeeds, so a retried insert rewrites the same slots with the same
    episodes and stamps. A train step's priority feedback is written in
    place as its last write. The fused superstep writes its whole state
    in place: the driver never retries it, ``retryable=False``.)"""
    del state
    return True


# ---------------------------------------------------------------- watchdog


@dataclasses.dataclass
class StallDiagnosis:
    """What the watchdog knew when it fired — everything a post-mortem (or
    the abort message) needs to locate the hang without a debugger."""

    phase: str                  # the stamped boundary (e.g. dispatch.superstep)
    t_env: int                  # driver env-step cursor at the stamp
    elapsed_s: float            # how long the call had been in flight
    timeout_s: float            # the configured resilience.dispatch_timeout
    backend: str                # the device type ("cuda"/"cpu")
    state: Any = None           # pre-dispatch TrainState snapshot (not serialized)

    def to_dict(self) -> dict:
        return {"phase": self.phase, "t_env": self.t_env,
                "elapsed_s": round(self.elapsed_s, 3),
                "timeout_s": self.timeout_s, "backend": self.backend}

    def message(self) -> str:
        return (f"stalled dispatch: phase={self.phase} t_env={self.t_env} "
                f"elapsed={self.elapsed_s:.1f}s "
                f"(resilience.dispatch_timeout={self.timeout_s}s, "
                f"backend={self.backend})")


def write_diagnosis(diag: StallDiagnosis, dirname: str,
                    extra: Optional[dict] = None) -> Optional[str]:
    """Persist ``dirname/stall_diagnosis.json`` (best-effort: diagnosis
    must never be the thing that crashes the diagnostic path).
    ``extra`` is merged into the payload — the driver passes the
    graftscope flight-recorder tail as ``recent_spans`` (the hanging
    span last, docs/OBSERVABILITY.md), so a wedged run's causal trail
    lands in the same file as its diagnosis. Written via
    ``write_json_atomic`` (tmp + fsync + rename, ``default=repr``): a
    hard exit racing the write must not publish a torn JSON, and a
    non-JSON span-meta value must not cost the whole diagnosis."""
    try:
        payload = diag.to_dict()
        if extra:
            payload.update(extra)
        return write_json_atomic(
            os.path.join(dirname, "stall_diagnosis.json"), payload)
    except (OSError, TypeError, ValueError) as e:  # pragma: no cover
        logger.warning("could not persist stall diagnosis: %s", e)
        return None


class Watchdog:
    """Heartbeat monitor for device-facing calls.

    Usage (the driver's shape)::

        wd = Watchdog(timeout_s=cfg.resilience.dispatch_timeout,
                      on_stall=_emergency_exit)
        wd.start()
        ...
        with wd.watch("dispatch.superstep", t_env=t_env, state=ts):
            ts, stats, infos = superstep(ts, keys, t0)
        ...
        wd.stop()

    ``stamp`` arms a deadline; ``clear`` disarms it — while no stamp is
    armed (host-side bookkeeping between dispatches) the watchdog never
    fires, so a slow *host* (logging to a wedged NFS, say) is not
    misdiagnosed as a stalled *device*. The monitor thread fires **once
    per armed stamp**: it records the :class:`StallDiagnosis` and runs
    ``on_stall(diag)`` on a dedicated daemon thread (the stalled main
    thread cannot run anything, and the monitor itself must keep
    watching — a callback wedged inside the stalled backend must not
    blind it to later stalls). If ``grace_s > 0`` and the main thread still
    has not progressed past the stamped call ``grace_s`` seconds after
    the fire, ``_exit(exit_code)`` terminates the process — the escape
    hatch for a dispatch that never returns, sized so a supervisor
    restart + checkpoint resume beats waiting out the hang. ``_exit`` is
    injectable for tests (default ``os._exit``: a wedged C++ call ignores
    normal interpreter shutdown).

    **Warm-up exemption.** The FIRST occurrence of each phase pays the
    one-time costs (the kernels' first load, the allocator's growth to
    its working set, cuBLAS handles), so ``timeout_s`` only applies to a
    phase once a previous occurrence has completed cleanly (its warm
    steady-state is then the thing being bounded). Until that first
    completion the deadline is ``first_timeout_s`` (0 = unbounded: an
    operator who wants startup hangs bounded sets
    ``resilience.first_dispatch_timeout`` explicitly).
    """

    def __init__(self, timeout_s: float,
                 on_stall: Optional[Callable[[StallDiagnosis], None]] = None,
                 poll_s: Optional[float] = None, grace_s: float = 0.0,
                 exit_code: int = 17, first_timeout_s: float = 0.0,
                 backend: str = "cuda",
                 _exit: Callable[[int], None] = os._exit) -> None:
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0 (0 disables the "
                             f"watchdog at the config layer), got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.first_timeout_s = float(first_timeout_s)
        self.grace_s = float(grace_s)
        self.exit_code = int(exit_code)
        self.on_stall = on_stall
        self.backend = backend
        # poll fast enough that 'fires within the configured timeout'
        # means within ~1.25x of it even at millisecond test timeouts
        self.poll_s = poll_s if poll_s else min(max(timeout_s / 4.0, 0.005),
                                                1.0)
        self._exit = _exit
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # armed stamp: (generation, phase, t_env, state, monotonic since)
        self._gen = 0
        self._beat = time.monotonic()   # last stamp/clear (pulse telemetry)
        self._armed: Optional[tuple] = None
        self._fired_gen = -1
        self._completed: set = set()    # phases with ≥1 clean completion
        self.diagnosis: Optional[StallDiagnosis] = None
        self.stall_count = 0

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="t2omca-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Disarm and stop the monitor (also cancels a pending hard
        exit). Idempotent; safe from any thread."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2 * self.poll_s + 1.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- heartbeat -------------------------------------------------------

    def stamp(self, phase: str, t_env: int = 0, state: Any = None) -> None:
        """Arm the deadline for one device-facing call. ``state`` is the
        pre-call train state — what the emergency checkpoint saves if this
        call stalls (pass None when no consistent state exists)."""
        with self._lock:
            self._gen += 1
            self._beat = time.monotonic()
            self._armed = (self._gen, phase, int(t_env), state,
                           self._beat)

    def clear(self, completed: bool = True) -> None:
        """Disarm (the call returned). Drops the state reference.
        ``completed=True`` (a clean return, not an exception) marks the
        phase warm: ``timeout_s`` applies to its next occurrences instead
        of the warm-up-exempt ``first_timeout_s``."""
        with self._lock:
            if completed and self._armed is not None:
                self._completed.add(self._armed[1])
            self._gen += 1
            self._beat = time.monotonic()
            self._armed = None

    def watch(self, phase: str, t_env: int = 0, state: Any = None):
        """Context manager: ``stamp`` on entry, ``clear`` on exit."""
        return _Watch(self, phase, t_env, state)

    def heartbeat(self) -> dict:
        """Live telemetry snapshot for the pulse plane (obs/pulse.py,
        docs/OBSERVABILITY.md §pulse): the armed phase and how long its
        call has been in flight, the age of the last heartbeat (any
        stamp or clear), and the cumulative stall count. Read-only and
        lock-bounded — safe from the HTTP scrape thread while the main
        thread is wedged inside the armed call (that is the read the
        endpoint exists for)."""
        now = time.monotonic()
        with self._lock:
            armed = self._armed
            out = {"armed_phase": armed[1] if armed is not None else None,
                   "armed_s": (round(now - armed[4], 3)
                               if armed is not None else 0.0),
                   "beat_age_s": round(now - self._beat, 3),
                   "stall_count": self.stall_count}
        return out

    def take_diagnosis(self) -> Optional[StallDiagnosis]:
        """Consume the latest stall diagnosis (None if none fired).
        Called by the driver loop once it regains control."""
        with self._lock:
            d, self.diagnosis = self.diagnosis, None
            return d

    # -- monitor thread --------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                armed = self._armed
                if armed is None:
                    continue
                gen, phase, t_env, state, since = armed
                # warm-up exemption: a phase that has never completed is
                # bound by first_timeout_s only
                limit = (self.timeout_s if phase in self._completed
                         else self.first_timeout_s)
                elapsed = time.monotonic() - since
                if limit <= 0 or elapsed < limit or gen == self._fired_gen:
                    continue
                self._fired_gen = gen
                timeout_used = limit
            # build + publish outside the lock: on_stall may checkpoint
            diag = StallDiagnosis(phase=phase, t_env=t_env,
                                  elapsed_s=elapsed,
                                  timeout_s=timeout_used,
                                  backend=self.backend, state=state)
            with self._lock:
                self.diagnosis = diag
                self.stall_count += 1
            logger.error("watchdog: %s", diag.message())
            # arm the hard-exit timer BEFORE the callback: on_stall's
            # emergency checkpoint reads device state over the possibly
            # wedged backend and can itself hang without raising — a
            # sequential grace timer would then never start and the
            # process would stall unbounded, the exact failure this
            # watchdog exists to bound
            if self.grace_s > 0:
                threading.Thread(target=self._maybe_hard_exit,
                                 args=(gen,), daemon=True,
                                 name="t2omca-watchdog-grace").start()
            if self.on_stall is None:
                diag.state = None       # nothing will consume it
            else:
                # the callback runs on its OWN daemon thread: its
                # emergency checkpoint reads device state over the
                # possibly wedged backend and can block indefinitely
                # without raising — run inline it would blind this
                # monitor to every later stall in the run (the stalled
                # call can return after ~25 min, the main thread wedge
                # again at the next stamp, and nothing would fire: no
                # diagnosis, no guard trip, no grace timer)
                threading.Thread(target=self._run_on_stall, args=(diag,),
                                 daemon=True,
                                 name="t2omca-watchdog-stall").start()

    def _run_on_stall(self, diag: StallDiagnosis) -> None:
        try:
            self.on_stall(diag)
        except Exception:               # noqa: BLE001 — diagnostics only
            logger.exception("watchdog on_stall callback failed")
        finally:
            # only the callback (the emergency save) needs the stamped
            # state; the retained diagnosis serves to_dict()/message()
            # consumers — keeping the reference would pin the
            # pre-stall TrainState (device ring included) through the
            # recovery and exit paths
            diag.state = None

    def _maybe_hard_exit(self, fired_gen: int) -> None:
        """Stage 2 (own thread, armed before ``on_stall`` runs): the
        stalled call never returned. Wait ``grace_s`` for the main thread
        to progress (any stamp/clear bumps the generation); if it never
        does, terminate the process so the supervisor can restart into a
        checkpoint resume."""
        if self.grace_s <= 0:
            return
        deadline = time.monotonic() + self.grace_s
        step = min(self.poll_s, 0.05)
        while time.monotonic() < deadline:
            if self._stop.wait(step):
                return                  # orderly exit reached wd.stop()
            with self._lock:
                if self._gen != fired_gen:
                    return              # main thread progressed
        # final re-check: the loop can expire on the clock before its
        # next poll observes a recovery that landed in the last window —
        # killing a run mid-orderly-exit would abandon the in-progress
        # exit checkpoint as a staged tmp dir
        if self._stop.is_set():
            return
        with self._lock:
            if self._gen != fired_gen:
                return
        logger.critical(
            "watchdog: stalled call never returned within the %.1fs grace "
            "after diagnosis — hard process exit (%d); resume from the "
            "emergency checkpoint", self.grace_s, self.exit_code)
        self._exit(self.exit_code)


class _Watch:
    """Re-entrant-free stamp/clear pair (plain class: contextmanager
    generators hold frames the watchdog thread would race)."""

    __slots__ = ("_wd", "_phase", "_t_env", "_state")

    def __init__(self, wd: Watchdog, phase: str, t_env: int, state: Any):
        self._wd, self._phase, self._t_env, self._state = (wd, phase,
                                                           t_env, state)

    def __enter__(self) -> None:
        self._wd.stamp(self._phase, self._t_env, self._state)

    def __exit__(self, exc_type, *exc) -> None:
        # an exception is not a completion: the phase stays warm-up-exempt
        # until one occurrence actually returns (an injected failure on
        # attempt 1 must not arm the warm timeout over attempt 2's warm-up)
        self._wd.clear(completed=exc_type is None)
        self._state = None


class ExitDeadline:
    """Hard wall-clock bound over a region of the EXIT path (plain class,
    same reason as :class:`_Watch`). The preemption/stall exit runs after
    ``wd.stop()`` — no stamp, no grace timer — yet its emergency save
    still reads device state over the possibly-wedged backend and can
    block without raising; with nothing left to bound it, the run would
    hang inside its own exit path, the exact failure this module exists
    to bound. A daemon timer terminates the process with the stall exit
    code if the region has not completed within ``bound_s`` — resume
    falls back to the newest published checkpoint."""

    __slots__ = ("_bound_s", "_exit_code", "_label", "_exit_fn", "_done")

    def __init__(self, bound_s: float, exit_code: int, *,
                 label: str = "exit path",
                 _exit: Callable[[int], None] = os._exit) -> None:
        self._bound_s = float(bound_s)
        self._exit_code = int(exit_code)
        self._label = label
        self._exit_fn = _exit
        self._done = threading.Event()

    def _run(self) -> None:
        if self._done.wait(self._bound_s):
            return
        logger.critical(
            "%s did not complete within its %.1fs bound (wedged "
            "backend?) — hard process exit (%d); resume falls back to "
            "the newest published checkpoint", self._label,
            self._bound_s, self._exit_code)
        self._exit_fn(self._exit_code)

    def __enter__(self) -> "ExitDeadline":
        threading.Thread(target=self._run, daemon=True,
                         name="t2omca-exit-deadline").start()
        return self

    def __exit__(self, *exc) -> None:
        self._done.set()


# ---------------------------------------------------------------- ladder


class DegradationLadder:
    """Escalation policy for dispatches that exhausted in-place retries.

    Rung order (docs/RESILIENCE.md §5): **degrade** — drop superstep K→1
    so each dispatch risks one iteration instead of K (only once, and only
    when the fused path is active); **restore** — reload the last good
    checkpoint (up to ``max_restores`` times); **abort** — surface the
    captured diagnosis. Counters are cumulative for the life of the run
    (matching the non-finite escalation's ``max_restores`` semantics):
    intervening successful dispatches do NOT refund restores, and a run
    that had to degrade stays degraded (the fused program is the thing
    that keeps failing) — tune ``max_restores`` against lifetime budget,
    not per-incident streaks.
    """

    def __init__(self, max_restores: int) -> None:
        self.max_restores = max(int(max_restores), 0)
        self.degraded = False
        self.restores = 0
        self.failures = 0               # exhausted-retry episodes, total

    def next_action(self, can_degrade: bool) -> str:
        """→ ``'degrade' | 'restore' | 'abort'`` for one exhausted
        dispatch. The caller maps 'restore' to 'abort' itself when no
        valid checkpoint exists."""
        self.failures += 1
        if can_degrade and not self.degraded:
            self.degraded = True
            return "degrade"
        if self.restores < self.max_restores:
            self.restores += 1
            return "restore"
        return "abort"

    def describe(self) -> str:
        return (f"failures={self.failures} degraded={self.degraded} "
                f"restores={self.restores}/{self.max_restores}")
