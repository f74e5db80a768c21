"""Structured JSONL event log — one line per query / maintenance op.

The log is append-only newline-delimited JSON so it can be tailed,
`jq`-filtered, or bulk-loaded without a parser.  A process-global default
log (set by `launch/serve.py --event-log`) receives events from every
subsystem via the module-level `emit()`; when no log is installed,
`emit()` is a cheap no-op.

Size-based rotation (`max_bytes` + keep-N segments) bounds disk use under
sustained traffic: when appending a line would push the active file past
``max_bytes`` the file rotates to ``<path>.1`` (existing segments shift to
``.2`` … ``.keep``, the oldest is dropped) and a fresh file is opened.
`read_events` reads a log back tolerating a torn final line — the shape a
crash mid-append leaves behind.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["EventLog", "emit", "get_event_log", "read_events",
           "set_event_log"]


class EventLog:
    """Thread-safe append-only JSONL writer with size-based rotation.

    ``max_bytes=None`` (default) never rotates — the pre-rotation
    behaviour.  With ``max_bytes`` set, an append that would exceed it
    first rotates the active file; ``keep`` bounds how many rotated
    segments survive (``<path>.1`` newest … ``<path>.keep`` oldest).
    A single event larger than ``max_bytes`` still lands whole in a fresh
    segment — events are never split across files.
    """

    def __init__(self, path: str, max_bytes: int | None = None,
                 keep: int = 3):
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.path = str(path)
        self.max_bytes = max_bytes
        self.keep = int(keep)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._size = self._f.tell()
        self._lock = threading.Lock()
        self.written = 0
        self.rotations = 0

    def _rotate_locked(self) -> None:
        self._f.close()
        oldest = f"{self.path}.{self.keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a", encoding="utf-8")
        self._size = 0
        self.rotations += 1

    def emit(self, event: str, level: str = "INFO", **fields) -> None:
        rec = {"ts": round(time.time(), 6), "level": level, "event": event}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        line = json.dumps(rec, default=str, separators=(",", ":")) + "\n"
        with self._lock:
            if self._f.closed:
                return
            nbytes = len(line.encode("utf-8"))
            if (self.max_bytes is not None and self._size > 0
                    and self._size + nbytes > self.max_bytes):
                self._rotate_locked()
            self._f.write(line)
            self._f.flush()
            self._size += nbytes
            self.written += 1

    def segments(self) -> list:
        """Existing log files, oldest first (rotated then active)."""
        out = [f"{self.path}.{i}" for i in range(self.keep, 0, -1)
               if os.path.exists(f"{self.path}.{i}")]
        if os.path.exists(self.path):
            out.append(self.path)
        return out

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def read_events(path: str, include_rotated: bool = False) -> list:
    """Parse a JSONL event log back into dicts, oldest first.

    A torn FINAL line (crash mid-append: no trailing newline, truncated
    JSON) is silently dropped — that is the valid on-disk shape after a
    crash.  A malformed line anywhere else raises ``ValueError``: interior
    corruption is a real problem and must not be skipped quietly.

    ``include_rotated`` also reads ``<path>.N`` segments (oldest first)
    written by the size-based rotation.
    """
    paths = []
    if include_rotated:
        i = 1
        found = []
        while os.path.exists(f"{path}.{i}"):
            found.append(f"{path}.{i}")
            i += 1
        paths.extend(reversed(found))        # .N is oldest
    paths.append(path)
    out = []
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p, encoding="utf-8", errors="replace") as f:
            raw = f.read()
        lines = raw.split("\n")
        last_complete = len(lines) - 1 if raw.endswith("\n") else \
            len(lines) - 2   # unterminated tail at lines[-1] (if any)
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if p == paths[-1] and i > last_complete:
                    break                    # torn tail — tolerated
                raise ValueError(
                    f"{p}:{i + 1}: malformed interior event line: "
                    f"{line[:120]!r}") from None
    return out


_global_log: EventLog | None = None
_global_lock = threading.Lock()


def get_event_log() -> EventLog | None:
    return _global_log


def set_event_log(log: EventLog | None) -> EventLog | None:
    """Install the process-global event log; returns the previous one."""
    global _global_log
    with _global_lock:
        old = _global_log
        _global_log = log
    return old


def emit(event: str, level: str = "INFO", **fields) -> None:
    """Emit to the process-global log if one is installed; else no-op."""
    log = _global_log
    if log is not None:
        log.emit(event, level=level, **fields)
