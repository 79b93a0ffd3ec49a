"""The port's own threads, joined before the interpreter exits.

The coded pool's workers and `BackgroundTask`s (`parallel.straggler`) and
`checkpoint.ckpt.async_save` run on daemon threads, so that a straggler
never blocks its caller. A daemon thread is not joined at exit: one that
is still inside a CUDA call while the interpreter tears down (a coded
straggler's panel solve, a background solve) can kill the process after
its last line of work, "terminate called without an active exception".
`start` runs every such thread, and the first one installs an `atexit`
hook that joins each that is still alive (`join_all`), within
`EXIT_JOIN_S` seconds in all, naming them on stderr.
"""

from __future__ import annotations

import atexit
import sys
import threading
import time
import weakref
from typing import Any, Callable

__all__ = ["start", "join_all", "live", "EXIT_JOIN_S"]

EXIT_JOIN_S = 120.0           # the exit hook's budget for every live thread

_LIVE: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
_LOCK = threading.Lock()
_HOOKED = False


def start(target: Callable[..., Any], *, args: tuple = (),
          name: str | None = None) -> threading.Thread:
    """Start `target(*args)` on a daemon thread that the exit hook joins."""
    global _HOOKED
    t = threading.Thread(target=target, args=args, name=name, daemon=True)
    with _LOCK:
        _LIVE.add(t)
        if not _HOOKED:
            atexit.register(_join_at_exit)
            _HOOKED = True
    t.start()
    return t


def live() -> list[threading.Thread]:
    """The threads started here that are still running."""
    with _LOCK:
        return [t for t in _LIVE if t.is_alive()]


def join_all(timeout: float | None = None) -> list[threading.Thread]:
    """Join every live thread started here (but the caller's own), within
    `timeout` seconds in all; returns those still alive after it."""
    end = None if timeout is None else time.monotonic() + timeout
    me = threading.current_thread()
    for t in live():
        if t is not me:
            t.join(None if end is None else max(0.0, end - time.monotonic()))
    return [t for t in live() if t is not me]


def _join_at_exit() -> None:
    running = live()
    if not running:
        return
    print(f"repro_torch: joining {len(running)} live thread(s) at exit: "
          f"{sorted(t.name for t in running)}", file=sys.stderr, flush=True)
    left = join_all(EXIT_JOIN_S)
    if left:
        print(f"repro_torch: {len(left)} thread(s) still alive after "
              f"{EXIT_JOIN_S} s: {sorted(t.name for t in left)}", file=sys.stderr,
              flush=True)
