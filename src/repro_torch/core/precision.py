"""Precision policy: one object for every dtype knob of the entry points.

  * store dtype    — what the returned inverse lives in;
  * compute dtype  — what the recursion's products and leaves run in;
  * accum dtype    — the accumulator the GEMM flushes from (f32 for f32,
                     bf16 and f16 operands alike);
  * polish         — f32 Newton–Schulz sweeps after a low-precision
                     recursion;
  * tolerance      — the residual bound; defaults to the conformance
                     table's `residual_tolerance` of the weaker dtype.

A policy resolves from, strongest first: a `PrecisionPolicy` object, a
preset name ("exact", "bf16", "auto", "fp8") or descriptor string, or the
``SPIN_PRECISION`` environment variable, with per-field environment
overrides on the last two. `descriptor()` round-trips a policy through a
compact string. Dtypes are held as names ("bfloat16", "float32", ...), the
JAX package's spelling, so descriptors and presets read the same in both
packages.

The "fp8" preset stores in float8_e4m3fn and computes in bf16; it exists
only where `compat.supports_float8()` finds the dtype.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

__all__ = ["PrecisionPolicy", "PRECISION_PRESETS", "resolve_precision",
           "DEFAULT_PRECISION_ENV", "warn_deprecated_dtype_kwarg",
           "policy_from_compute_dtype", "resolve_with_legacy_kwarg",
           "torch_dtype"]

# The env knob selecting the default policy (preset name or descriptor).
DEFAULT_PRECISION_ENV = "SPIN_PRECISION"

# Per-field numeric overrides, applied on top of env/preset-string
# resolution (never on top of a policy object the caller built).
_FIELD_ENV = {
    "polish_sweeps": "SPIN_PRECISION_POLISH_SWEEPS",
    "max_polish_sweeps": "SPIN_PRECISION_MAX_POLISH_SWEEPS",
    "tolerance": "SPIN_PRECISION_TOL",
}

_STORE_DTYPES = ("bfloat16", "float16", "float32", "float64",
                 "float8_e4m3fn")


def _valid_dtype(name: str) -> bool:
    return name in _STORE_DTYPES


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Everything the entry points may vary about precision.

    `store_dtype=None` means the operand's own dtype; `compute_dtype=None`
    follows the store dtype. `auto_store=True` hands the store dtype to the
    planner. `tolerance=None` defaults to `residual_tolerance` of the
    policy's weaker resolved dtype.
    """

    name: str = "exact"
    store_dtype: str | None = None
    compute_dtype: str | None = None
    accum_dtype: str = "float32"
    auto_store: bool = False
    polish_sweeps: int = 1        # Newton–Schulz sweeps after the recursion
    max_polish_sweeps: int = 8    # cap on sweeps a certification may run
    tolerance: float | None = None

    def __post_init__(self):
        for field in ("store_dtype", "compute_dtype"):
            v = getattr(self, field)
            if v is not None and not _valid_dtype(v):
                raise ValueError(f"{field}={v!r} is not a supported dtype "
                                 f"(one of {_STORE_DTYPES})")
        if self.accum_dtype not in ("float32", "float64"):
            raise ValueError(f"accum_dtype must be float32/float64, got "
                             f"{self.accum_dtype!r}")
        if (self.store_dtype or "").startswith("float8"):
            from .. import compat

            if not compat.supports_float8():
                raise ValueError(
                    "store_dtype=float8 requested but this PyTorch has no "
                    "usable float8_e4m3fn (compat.supports_float8() is "
                    "False); use the 'bf16' preset instead")
        if self.polish_sweeps < 0 or self.max_polish_sweeps < 0:
            raise ValueError("polish sweep counts must be >= 0")

    # -- resolution ---------------------------------------------------------
    @property
    def is_exact(self) -> bool:
        """True when the policy changes nothing about the default path."""
        return (self.store_dtype is None and self.compute_dtype is None
                and not self.auto_store)

    def resolve_store(self, operand_dtype) -> str:
        return self.store_dtype or _dtype_name(operand_dtype)

    def resolve_compute(self, operand_dtype) -> str:
        return (self.compute_dtype or self.store_dtype
                or _dtype_name(operand_dtype))

    def bound(self, operand_dtype) -> float:
        """The residual bound of a result under this policy."""
        if self.tolerance is not None:
            return self.tolerance
        from .verify import residual_tolerance  # late: verify imports spin

        return max(residual_tolerance(self.resolve_store(operand_dtype)),
                   residual_tolerance(self.resolve_compute(operand_dtype)))

    def candidate_store_dtypes(self, operand_dtype) -> tuple[str, ...]:
        """Store dtypes a planner may price for this policy."""
        op = _dtype_name(operand_dtype)
        if self.store_dtype:
            return (self.store_dtype,)
        if self.auto_store:
            # bf16 is the low-precision store; fp8 stays opt-in.
            return (op, "bfloat16") if op in ("float32", "float64") else (op,)
        return (op,)

    # -- serialization ------------------------------------------------------
    def descriptor(self) -> str:
        """Compact round-trippable string: a preset name, or the fields."""
        for key, preset in PRECISION_PRESETS.items():
            if preset == self:
                return key
        parts = [f"n={self.name}",
                 f"s={self.store_dtype or '-'}",
                 f"c={self.compute_dtype or '-'}",
                 f"a={self.accum_dtype}",
                 f"auto={int(self.auto_store)}",
                 f"ps={self.polish_sweeps}",
                 f"mps={self.max_polish_sweeps}",
                 f"tol={'-' if self.tolerance is None else repr(self.tolerance)}"]
        return ";".join(parts)

    @classmethod
    def from_descriptor(cls, text: str) -> "PrecisionPolicy":
        if text in PRECISION_PRESETS:
            return PRECISION_PRESETS[text]
        if "=" not in text:
            raise ValueError(f"unknown precision preset {text!r} "
                             f"(known: {sorted(PRECISION_PRESETS)})")
        fields = dict(part.split("=", 1) for part in text.split(";"))
        try:
            return cls(
                name=fields.get("n", "custom"),
                store_dtype=None if fields.get("s", "-") == "-" else fields["s"],
                compute_dtype=(None if fields.get("c", "-") == "-"
                               else fields["c"]),
                accum_dtype=fields.get("a", "float32"),
                auto_store=bool(int(fields.get("auto", "0"))),
                polish_sweeps=int(fields.get("ps", "1")),
                max_polish_sweeps=int(fields.get("mps", "8")),
                tolerance=(None if fields.get("tol", "-") == "-"
                           else float(fields["tol"])))
        except (KeyError, ValueError) as e:
            raise ValueError(f"malformed precision descriptor {text!r}: {e}") from e

    @classmethod
    def resolve(cls, precision) -> "PrecisionPolicy":
        """None -> $SPIN_PRECISION or exact; str -> preset/descriptor;
        PrecisionPolicy -> itself (verbatim, no env overrides)."""
        if isinstance(precision, cls):
            return precision
        if precision is None:
            from .. import envconfig

            env = envconfig.env_str(DEFAULT_PRECISION_ENV)
            if env is None:
                return PRECISION_PRESETS["exact"]
            precision = env
        if not isinstance(precision, str):
            raise TypeError(f"precision must be a PrecisionPolicy, preset "
                            f"string, or None; got {type(precision).__name__}")
        return _apply_field_env(cls.from_descriptor(precision))


def _apply_field_env(policy: PrecisionPolicy) -> PrecisionPolicy:
    from .. import envconfig

    overrides = {}
    for field, var in _FIELD_ENV.items():
        raw = envconfig.env_raw(var)
        if raw is None:
            continue
        overrides[field] = float(raw) if field == "tolerance" else int(raw)
    return dataclasses.replace(policy, **overrides) if overrides else policy


def _dtype_name(dtype) -> str:
    """A dtype's name in the JAX package's spelling: "float32" for
    torch.float32; a name passes through."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    raise TypeError(f"expected a torch.dtype or a dtype name, got {dtype!r}")


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a dtype name (a torch.dtype passes through)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _STORE_DTYPES:
        raise ValueError(f"{dtype!r} is not a supported dtype "
                         f"(one of {_STORE_DTYPES})")
    return getattr(torch, dtype)


def _make_presets() -> dict[str, PrecisionPolicy]:
    presets = {
        "exact": PrecisionPolicy(name="exact"),
        "bf16": PrecisionPolicy(name="bf16", store_dtype="bfloat16",
                                compute_dtype="bfloat16"),
        "auto": PrecisionPolicy(name="auto", auto_store=True),
    }
    presets["f32"] = presets["exact"]
    presets["float32"] = presets["exact"]
    presets["bfloat16"] = presets["bf16"]
    # fp8 storage hook: registered only where the probe passes, so that
    # `resolve("fp8")` fails as an unknown preset elsewhere.
    from .. import compat

    if compat.supports_float8():
        presets["fp8"] = PrecisionPolicy(name="fp8",
                                         store_dtype="float8_e4m3fn",
                                         compute_dtype="bfloat16",
                                         polish_sweeps=2,
                                         max_polish_sweeps=12)
    return presets


PRECISION_PRESETS = _make_presets()


def resolve_precision(precision) -> PrecisionPolicy:
    """Module-level alias for `PrecisionPolicy.resolve`."""
    return PrecisionPolicy.resolve(precision)


# ---------------------------------------------------------------------------
# Deprecation shim for the pre-policy dtype kwarg
# ---------------------------------------------------------------------------

_WARNED_SITES: set[str] = set()


def warn_deprecated_dtype_kwarg(site: str, kwarg: str = "compute_dtype"
                                ) -> None:
    """One DeprecationWarning per call site per process, then silence."""
    if site in _WARNED_SITES:
        return
    _WARNED_SITES.add(site)
    warnings.warn(
        f"{site}({kwarg}=...) is deprecated; pass "
        f"precision=PrecisionPolicy({kwarg}=...) or a preset string "
        f"like precision='bf16'", DeprecationWarning, stacklevel=3)


def policy_from_compute_dtype(dtype) -> PrecisionPolicy:
    """The policy a legacy `compute_dtype=` forwards to: compute in the
    requested dtype, return at the operand dtype, no polish."""
    return PrecisionPolicy(name="legacy", compute_dtype=_dtype_name(dtype),
                           polish_sweeps=0)


def resolve_with_legacy_kwarg(site: str, precision, compute_dtype
                              ) -> PrecisionPolicy:
    """The policy of entry point `site` called with `precision=` and the
    deprecated `compute_dtype=`: a given `compute_dtype` warns once a site
    and, when `precision` is None, forwards to `policy_from_compute_dtype`."""
    if compute_dtype is not None:
        warn_deprecated_dtype_kwarg(site)
        if precision is None:
            precision = policy_from_compute_dtype(compute_dtype)
    return resolve_precision(precision)
