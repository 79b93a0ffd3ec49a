"""Structured span tracer (`$SPIN_TRACE`).

The recursion, the Strassen engine, the planner and the serving tick loop
emit *spans*, `{name, kind, t0, t1, attrs, thread}` records, into one
process-global `SpanTracer`:

  * **Nothing when off.** Every instrumentation site is guarded by one
    attribute read (`if TRACER.enabled:`). With `SPIN_TRACE` unset no span
    object is built, no attribute dict is made, and nothing synchronises
    the device: a span never calls `torch.cuda.synchronize`.
  * **Emitted on every eager call.** The port runs the recursion eagerly,
    so each call emits its spans again (the JAX package emits them once
    per jit trace). A span's duration is host dispatch time, not device
    time: CUDA launches return before the kernels finish. The structure,
    one span a node with its level, grid, op and engine, is the
    recursion's, and is what the tests hold against the JAX package. The
    planned entry points that want a device time synchronise themselves,
    and only while tracing (`planner.dispatch`).
  * **Profiler bridging.** While tracing, a span opens a
    `torch.profiler.record_function` of the same name, so a captured
    profile shows the names this module records.

Every span is also mirrored into the flight recorder's ring
(`obs.flight`), so a post-mortem dump carries the trace tail.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Iterator, Optional

import torch

from .. import envconfig

__all__ = ["Span", "SpanTracer", "TRACER", "tracer", "trace_enabled",
           "tracing", "refresh", "TRACE_ENV", "TRACE_DIR_ENV"]

TRACE_ENV = "SPIN_TRACE"
TRACE_DIR_ENV = "SPIN_TRACE_DIR"


@dataclasses.dataclass
class Span:
    """One structured event. Point events have t1 == t0."""

    name: str
    kind: str                 # "recursion_level" | "planner_decision" | ...
    t0: float
    t1: float
    attrs: dict[str, Any]
    thread: int

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind, "t0": self.t0,
                "t1": self.t1, "duration_s": self.duration_s,
                "thread": self.thread, **self.attrs}


class SpanTracer:
    """Bounded in-memory span store with an `enabled` fast-path guard.

    `enabled` is a plain attribute, not a property: the disabled cost at
    every instrumentation site is one attribute load. Flip it with
    `tracing(...)` or `refresh()`.
    """

    def __init__(self, *, enabled: bool | None = None, capacity: int = 65536,
                 clock=time.perf_counter):
        self.enabled = (envconfig.env_bool(TRACE_ENV)
                        if enabled is None else bool(enabled))
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._dropped = 0

    # -- recording -----------------------------------------------------------

    def _store(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) >= self.capacity:
                self._dropped += 1
                return
            self._spans.append(span)
        # Attrs last: an event carrying its own name or duration_s attr
        # overrides the span's value instead of clashing with it.
        from . import flight

        flight.recorder().record(span.kind, **{
            "name": span.name, "duration_s": span.duration_s, **span.attrs})

    def event(self, name: str, kind: str, **attrs) -> Optional[Span]:
        """Record a point event (no duration). No-op when disabled."""
        if not self.enabled:
            return None
        now = self._clock()
        span = Span(name=name, kind=kind, t0=now, t1=now, attrs=attrs,
                    thread=threading.get_ident())
        self._store(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, kind: str, **attrs) -> Iterator[Optional[Span]]:
        """Timed span context, bridged to `torch.profiler.record_function`.
        Call sites still guard with `if TRACER.enabled:`: entering a
        context manager is not free."""
        if not self.enabled:
            yield None
            return
        t0 = self._clock()
        span = Span(name=name, kind=kind, t0=t0, t1=t0, attrs=attrs,
                    thread=threading.get_ident())
        try:
            with torch.profiler.record_function(name):
                yield span
        finally:
            span.t1 = self._clock()
            self._store(span)

    # -- reading -------------------------------------------------------------

    def spans(self, kind: str | None = None, name: str | None = None
              ) -> list[Span]:
        with self._lock:
            out = list(self._spans)
        if kind is not None:
            out = [s for s in out if s.kind == kind]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    def refresh(self) -> bool:
        """Re-read $SPIN_TRACE (for processes that flip it mid-run)."""
        self.enabled = envconfig.env_bool(TRACE_ENV)
        return self.enabled


# The process-global tracer every subsystem guards on.
TRACER = SpanTracer()


def tracer() -> SpanTracer:
    return TRACER


def trace_enabled() -> bool:
    return TRACER.enabled


def refresh() -> bool:
    return TRACER.refresh()


@contextlib.contextmanager
def tracing(enabled: bool = True, *, clear: bool = False) -> Iterator[SpanTracer]:
    """Temporarily flip the global tracer (tests, measured sections).

    `clear=True` empties the span store on entry, so assertions see only
    the spans of the guarded region. The previous state is restored.
    """
    prev = TRACER.enabled
    if clear:
        TRACER.clear()
    TRACER.enabled = bool(enabled)
    try:
        yield TRACER
    finally:
        TRACER.enabled = prev
