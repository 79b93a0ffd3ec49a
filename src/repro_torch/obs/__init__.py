"""The observability layer, one import surface for four pieces:

  * `trace`    — structured span tracer ($SPIN_TRACE); off, a site costs one
                 attribute read and never synchronises the device.
  * `registry` — counters, gauges, histograms; Prometheus text and JSON.
  * `flight`   — bounded ring of events, JSONL dumps on failures to
                 $SPIN_TRACE_DIR.
  * `ledger`   — modeled against measured cost, fed back to the planner's
                 calibration.

Importing it imports neither the planner nor the kernels: the tracer and
registry are read by modules that load before them.
"""

from . import flight, ledger, registry, trace
from .flight import FlightRecorder, recorder
from .ledger import CostLedger, LedgerEntry, StraggleStats
from .ledger import ledger as cost_ledger
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       default_registry)
from .trace import TRACER, Span, SpanTracer, trace_enabled, tracing

__all__ = [
    "trace", "registry", "flight", "ledger",
    "TRACER", "Span", "SpanTracer", "trace_enabled", "tracing",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "FlightRecorder", "recorder",
    "CostLedger", "LedgerEntry", "StraggleStats", "cost_ledger",
]
