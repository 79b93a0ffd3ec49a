"""The environment knobs the port reads, under the JAX package's names.

Each knob has one entry in `ENV_VARS`, its name and what it does. The
accessors refuse a name that has no entry, so a knob cannot be read
without being documented here. Reads are not cached: tests set these
variables per test, and `SPIN_STRASSEN_CUTOFF` is read on every multiply.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["ENV_VARS", "env_raw", "env_str", "env_int", "env_bool"]

ENV_VARS: dict[str, str] = {
    "SPIN_TRACE":
        "bool: enable the structured span tracer (obs.trace); off by "
        "default, and then every instrumentation site is one attribute "
        "read and no span synchronises the device.",
    "SPIN_TRACE_DIR":
        "path: directory for the flight recorder's JSONL dumps "
        "(obs.flight); unset = no dump (events still ring in memory).",
    "SPIN_FLIGHT_CAPACITY":
        "int: ring capacity in events of the default flight recorder "
        "(default 512).",
    "SPIN_FAULT_PLAN":
        "json: a serialized FaultPlan (scripted stragglers and failures), "
        "read by parallel.straggler.FaultPlan.from_env.",
    "SPIN_STRASSEN_CUTOFF":
        "int: operand size at/below which Strassen goes classical (default "
        "512, costmodel.STRASSEN_CUTOFF); read by core.strassen.",
    "SPIN_PRECISION":
        "str: default PrecisionPolicy preset or descriptor (e.g. 'bf16') "
        "for calls without precision=; unset = exact; read by "
        "core.precision.",
    "SPIN_PRECISION_POLISH_SWEEPS":
        "int: override a resolved policy's Newton-Schulz sweep count.",
    "SPIN_PRECISION_MAX_POLISH_SWEEPS":
        "int: override a resolved policy's cap on polish sweeps.",
    "SPIN_PRECISION_TOL":
        "float: override a resolved policy's residual tolerance.",
    "SPIN_COORDINATOR":
        "str: host:port of process 0 for a multi-process run; read by "
        "launch.mesh.init_distributed (unset = single process).",
    "SPIN_NUM_PROCS":
        "int: number of processes under SPIN_COORDINATOR (default 1).",
    "SPIN_PROC_ID":
        "int: this process's index under SPIN_COORDINATOR (default 0).",
    "SPIN_PLAN_CACHE":
        "path: the JAX package's plan-cache file; the port keeps its own "
        "beside it (plans.json -> plans.torch.json); unset = "
        "$XDG_CACHE_HOME or ~/.cache, /repro_torch_spin/plans.json; read "
        "by planner.cache.",
}


def _check(name: str) -> None:
    if name not in ENV_VARS:
        raise KeyError(f"{name} is not in envconfig.ENV_VARS; register a "
                       f"knob there before reading it")


def env_raw(name: str) -> Optional[str]:
    """The raw value, or None when unset."""
    _check(name)
    return os.environ.get(name)


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """The value, or `default` when unset or blank."""
    _check(name)
    v = os.environ.get(name)
    return default if v is None or not v.strip() else v


# Spellings taken as a boolean, those of the JAX package's table.
_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """The value as an int, or `default` when unset or blank."""
    _check(name)
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None


def env_bool(name: str, default: bool = False) -> bool:
    """Unset -> `default`; 1/true/yes/on -> True; 0/false/no/off/'' ->
    False; anything else raises, so a misspelt SPIN_TRACE=yess does not
    silently leave tracing off."""
    _check(name)
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"{name} must be boolean-ish (1/0/true/false), got {raw!r}")
