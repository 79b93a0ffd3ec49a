"""Flight recorder: a bounded ring of structured events, dumped as JSONL on
failures.

The last N events (worker timeline, degraded-mode transitions, failed
batches, and every tracer span, which the tracer mirrors here) are always
kept in memory; a failure site calls `dump(reason)` to write them to
`$SPIN_TRACE_DIR/flight-<reason>-<pid>-<seq>.jsonl`. With SPIN_TRACE_DIR
unset `dump` does nothing: recording stays one deque append under a lock,
on the host, and nothing touches the filesystem.

Dump format: line 1 is a header `{"flight_dump": reason, "events": N,
"ts": unix_time, "pid": ...}`; each following line is one event, oldest
first, `{"ts", "kind", ...attrs}`.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Optional

from .. import envconfig

__all__ = ["FlightRecorder", "recorder", "set_recorder", "DUMP_DIR_ENV"]

DUMP_DIR_ENV = "SPIN_TRACE_DIR"


class FlightRecorder:
    """Thread-safe ring of {ts, kind, **attrs} events."""

    def __init__(self, capacity: int | None = None, *, clock=time.time):
        if capacity is None:
            capacity = envconfig.env_int("SPIN_FLIGHT_CAPACITY", 512)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=capacity)
        self._seq = 0
        self.dumps: list[str] = []          # paths written by this recorder

    def record(self, kind: str, **attrs) -> None:
        evt = {"ts": self._clock(), "kind": kind}
        for k, v in attrs.items():
            evt[k] = _jsonable(v)
        with self._lock:
            self._events.append(evt)

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def dump(self, reason: str, directory: str | None = None
             ) -> Optional[str]:
        """Write the ring as JSONL; returns the path, or None when no dump
        directory is configured. Never raises: a failing post-mortem write
        must not hide the failure being recorded."""
        directory = directory or envconfig.env_str(DUMP_DIR_ENV)
        if not directory:
            return None
        with self._lock:
            events = list(self._events)
            self._seq += 1
            seq = self._seq
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason) or "dump"
        path = os.path.join(directory,
                            f"flight-{safe}-{os.getpid()}-{seq}.jsonl")
        try:
            os.makedirs(directory, exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps({"flight_dump": reason,
                                    "events": len(events),
                                    "ts": self._clock(),
                                    "pid": os.getpid()}) + "\n")
                for evt in events:
                    f.write(json.dumps(evt) + "\n")
        except OSError:
            return None
        with self._lock:
            self.dumps.append(path)
        return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    with contextlib.suppress(TypeError, ValueError, RuntimeError):
        return float(v)                    # numpy and one-element tensors
    return repr(v)


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    """The process-global flight recorder."""
    return _recorder


def set_recorder(rec: FlightRecorder) -> FlightRecorder:
    """Swap the global recorder (hermetic tests); returns the previous."""
    global _recorder
    prev, _recorder = _recorder, rec
    return prev
