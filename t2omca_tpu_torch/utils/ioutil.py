"""Atomic JSON persistence, shared by the diagnostic writers (the
port's copy of ``t2omca_tpu/utils/ioutil.py``, unchanged but for this
docstring).

The flight recorder (``obs/spans.py``) and the watchdog stall diagnosis
(``utils/watchdog.py``) persist post-mortem artifacts, each written on
paths (stall, crash, hard exit) where a torn or lost file defeats the
artifact's purpose.
One helper so the semantics can't drift between copies:

* tmp + flush + fsync + rename: a hard process exit (or power loss)
  racing the write never publishes a truncated JSON;
* ``default=repr``: a non-JSON value smuggled into span meta or a
  diagnosis field degrades to its repr instead of a ``TypeError``
  that silently drops the one artifact the post-mortem needs.

Raises propagate (``OSError``/``TypeError``/``ValueError``) — each
call site owns its best-effort policy (warn, or return None).
stdlib-only.

``read_jsonl_tolerant`` is the read-side counterpart: the post-mortem
CLIs must read past the torn final line a killed run leaves.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable


def read_jsonl_tolerant(path: str,
                        on_bad: "Callable[[int, bool], None] | None" = None
                        ) -> list:
    """Parse a JSONL file, skipping unparseable lines instead of
    raising. A run killed mid-write (crash, SIGKILL, hard watchdog
    exit) leaves exactly one torn artifact: a truncated FINAL line —
    and the post-mortem readers (``obs report``, ``obs timeline``) must
    read past it, because that torn tail is precisely the file a dead
    run leaves. ``on_bad(line_no, is_last)`` is invoked per skipped
    line (1-based; ``is_last`` distinguishes the expected torn tail
    from mid-file corruption) — callers print their own warning.
    Raises ``OSError`` only when the file itself cannot be read.

    Streams with a one-line lookahead (the ``is_last`` flag needs it)
    instead of slurping: the post-mortem CLIs read long runs'
    metrics.jsonl on exactly the constrained hosts where materializing
    the raw lines alongside the parsed events would hurt."""
    out = []

    def consume(line: str, line_no: int, is_last: bool) -> None:
        line = line.strip()
        if not line:
            return
        try:
            out.append(json.loads(line))
        except ValueError:
            if on_bad is not None:
                on_bad(line_no, is_last)

    with open(path) as f:
        prev = None
        prev_no = 0
        for i, line in enumerate(f):
            if prev is not None:
                consume(prev, prev_no, False)
            prev, prev_no = line, i + 1
        if prev is not None:
            consume(prev, prev_no, True)
    return out


def write_bytes_atomic(path: str, blob: bytes) -> str:
    """tmp + flush + fsync + rename for BINARY blobs — the twin of
    :func:`write_json_atomic` for binary artifacts: a crash mid-write
    must never leave a half-written blob at the final path for a reader
    to trust. Same unique-tmp rule as
    the JSON writer (concurrent writers of one artifact must not
    interleave), same cleanup-and-propagate error policy."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def write_json_atomic(path: str, payload: Any,
                      default: Callable[[Any], str] = repr) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # unique tmp per call: concurrent writers of the same artifact
    # (two watchdog stall callbacks run on their own threads) must not
    # interleave on a shared tmp file — a fixed name would let writer
    # B truncate A's bytes mid-write and A's rename publish the torn
    # mix, the exact failure this helper exists to rule out
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, default=default)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
