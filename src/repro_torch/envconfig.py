"""The environment knobs the port reads, under the JAX package's names.

Each knob has one `EnvVar` row in `ENV_VARS` (name, type, default,
what it does, the module that reads it, keyed by name), the port of
`repro.envconfig`'s table. The
accessors refuse a name that has no row, so a knob cannot be read
without being documented here, and `env_table_markdown()` renders the
table. Reads are not cached: tests set these variables per test, and
`SPIN_STRASSEN_CUTOFF` is read on every multiply.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["EnvVar", "ENV_VARS", "registered_names", "spec",
           "env_raw", "env_str", "env_int", "env_float", "env_bool", "is_set",
           "env_table_markdown"]


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One documented knob: its name, type, default, and what it does."""

    name: str
    kind: str                 # "str" | "int" | "float" | "bool" | "path" | "json"
    default: Optional[str]    # rendered default (None = unset / disabled)
    description: str
    owner: str                # the module that reads it


_ROWS = (
    EnvVar("SPIN_TRACE", "bool", None,
           "Enable the structured span tracer; off by default, and then every "
           "instrumentation site is one attribute read and no span "
           "synchronises the device.", "repro_torch.obs.trace"),
    EnvVar("SPIN_TRACE_DIR", "path", None,
           "Directory for the flight recorder's JSONL dumps; unset = no dump "
           "(events still ring in memory).", "repro_torch.obs.flight"),
    EnvVar("SPIN_FLIGHT_CAPACITY", "int", "512",
           "Ring capacity in events of the default flight recorder.",
           "repro_torch.obs.flight"),
    EnvVar("SPIN_FAULT_PLAN", "json", None,
           "A serialized FaultPlan (scripted stragglers and failures), read by "
           "FaultPlan.from_env.", "repro_torch.parallel.straggler"),
    EnvVar("SPIN_STRASSEN_CUTOFF", "int", "512",
           "Operand size at/below which Strassen goes classical "
           "(costmodel.STRASSEN_CUTOFF).", "repro_torch.core.strassen"),
    EnvVar("SPIN_PRECISION", "str", None,
           "Default PrecisionPolicy preset or descriptor (e.g. 'bf16') for calls "
           "without precision=; unset = exact.", "repro_torch.core.precision"),
    EnvVar("SPIN_PRECISION_POLISH_SWEEPS", "int", None,
           "Override a resolved policy's Newton-Schulz sweep count.",
           "repro_torch.core.precision"),
    EnvVar("SPIN_PRECISION_MAX_POLISH_SWEEPS", "int", None,
           "Override a resolved policy's cap on polish sweeps.",
           "repro_torch.core.precision"),
    EnvVar("SPIN_PRECISION_TOL", "float", None,
           "Override a resolved policy's residual tolerance.",
           "repro_torch.core.precision"),
    EnvVar("SPIN_COORDINATOR", "str", None,
           "host:port of process 0 (or an init URL such as file:///path) for a "
           "multi-process run; unset = single process.", "repro_torch.launch.mesh"),
    EnvVar("SPIN_NUM_PROCS", "int", "1",
           "Number of processes under SPIN_COORDINATOR.", "repro_torch.launch.mesh"),
    EnvVar("SPIN_PROC_ID", "int", "0",
           "This process's index under SPIN_COORDINATOR.", "repro_torch.launch.mesh"),
    EnvVar("SPIN_PLAN_CACHE", "path", "$XDG_CACHE_HOME/repro_torch_spin/plans.json",
           "The JAX package's plan-cache file; the port keeps its own beside it "
           "(plans.json -> plans.torch.json); unset = $XDG_CACHE_HOME, else "
           "~/.cache, /repro_torch_spin/plans.json.", "repro_torch.planner.cache"),
)

ENV_VARS: dict[str, EnvVar] = {v.name: v for v in _ROWS}


def registered_names() -> frozenset[str]:
    return frozenset(ENV_VARS)


def spec(name: str) -> EnvVar:
    return ENV_VARS[name]


def _check(name: str) -> None:
    if name not in ENV_VARS:
        raise KeyError(f"{name} is not in envconfig.ENV_VARS; register "
                       f"a knob there before reading it")


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


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    """The value as a float, or `default` when unset or blank."""
    _check(name)
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None


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


def is_set(name: str) -> bool:
    """Whether the knob is set to anything but blanks."""
    _check(name)
    return bool(os.environ.get(name, "").strip())


def env_table_markdown() -> str:
    """The table as Markdown, one row a knob."""
    rows = ["| Variable | Type | Default | Purpose |", "|---|---|---|---|"]
    for v in ENV_VARS.values():
        default = "*(unset)*" if v.default is None else f"`{v.default}`"
        rows.append(f"| `{v.name}` | {v.kind} | {default} | {v.description} |")
    return "\n".join(rows)
