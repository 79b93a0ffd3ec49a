"""Persistent JSON plan cache for the SPIN autotuner.

One JSON file holds (a) chosen plans keyed by problem-signature key and
(b) per-(backend, cores, dtype) cost-model calibration constants fit by
`costmodel.fit_scale`. The file is shared across processes: a plan chosen
in one process is recalled by the next, which makes `block_size=None`
cheap after its first use.

The port keeps a file of its own, beside the JAX package's and never the
same one: that package discards a whole file whose version is not its
own, so a shared file would lose one package's plans at every write of
the other. With ``SPIN_PLAN_CACHE=<dir>/plans.json`` the port's file is
``<dir>/plans.torch.json``; without it, ``$XDG_CACHE_HOME`` (or
``~/.cache``) ``/repro_torch_spin/plans.json``.

Invalidation rules:
  * a `version` other than PLAN_CACHE_VERSION discards the whole file;
  * the signature key embeds kind/n/dtype/backend/device_count/cores, so a
    change of device or dtype never reuses a plan: it misses;
  * each entry stores its full signature dict, re-checked on read;
  * a cost-model-only entry is replaced the first time the same problem is
    planned with measurement.

Writes are atomic (a temporary file, then os.replace) and best-effort: a
read-only cache directory degrades to in-memory planning, never an error.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading

from .. import envconfig
from .plan import Plan, ProblemSignature

__all__ = ["PlanCache", "default_cache", "default_cache_path",
           "PLAN_CACHE_VERSION"]

# The port's own schema version, independent of the JAX package's.
PLAN_CACHE_VERSION = 1

_ENV_VAR = "SPIN_PLAN_CACHE"


def default_cache_path() -> str:
    """The port's plan file (see the module docstring for the rule)."""
    env = envconfig.env_str(_ENV_VAR)
    if env:
        root, ext = os.path.splitext(env)
        return f"{root}.torch{ext or '.json'}"
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch_spin", "plans.json")


def _empty() -> dict:
    return {"version": PLAN_CACHE_VERSION, "plans": {}, "calibration": {}}


class PlanCache:
    """Load-on-first-use, save-on-put JSON store of plans and calibrations."""

    def __init__(self, path: str | None = None):
        self.path = path or default_cache_path()
        self._lock = threading.Lock()
        self._data: dict | None = None

    # -- persistence --------------------------------------------------------
    def _read_file(self) -> dict:
        data = _empty()
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if raw.get("version") == PLAN_CACHE_VERSION:
                data["plans"].update(raw.get("plans", {}))
                data["calibration"].update(raw.get("calibration", {}))
        except (OSError, ValueError, AttributeError):
            pass                      # missing or corrupt -> start empty
        return data

    def _load(self) -> dict:
        if self._data is None:
            self._data = self._read_file()
        return self._data

    def _save(self, merge: bool = True) -> None:
        # Merge on save: another process may have added entries since our
        # load; re-read and overlay ours, so a write never deletes another
        # writer's plans (the last writer wins only per key).
        merged = self._read_file() if merge else _empty()
        merged["plans"].update(self._data["plans"])
        merged["calibration"].update(self._data["calibration"])
        self._data = merged
        directory = os.path.dirname(self.path) or "."
        try:
            os.makedirs(directory, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            pass                      # read-only file system -> in-memory only

    # -- plans ---------------------------------------------------------------
    def get(self, sig: ProblemSignature) -> Plan | None:
        with self._lock:
            entry = self._load()["plans"].get(sig.key())
            if not entry or entry.get("sig") != sig.as_dict():
                return None
            return Plan.from_dict(entry["plan"])

    def put(self, sig: ProblemSignature, plan: Plan) -> None:
        with self._lock:
            self._load()["plans"][sig.key()] = {"sig": sig.as_dict(),
                                                "plan": plan.to_dict()}
            self._save()

    # -- calibration ---------------------------------------------------------
    @staticmethod
    def calibration_key(sig: ProblemSignature) -> str:
        return f"{sig.backend}/c{sig.cores}/{sig.dtype}"

    def get_calibration(self, sig: ProblemSignature) -> dict | None:
        with self._lock:
            return self._load()["calibration"].get(self.calibration_key(sig))

    def put_calibration(self, sig: ProblemSignature, constants: dict) -> None:
        with self._lock:
            self._load()["calibration"][self.calibration_key(sig)] = dict(constants)
            self._save()

    def clear(self) -> None:
        with self._lock:
            self._data = _empty()
            self._save(merge=False)


_DEFAULT: PlanCache | None = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> PlanCache:
    """Process-wide cache at `default_cache_path()`."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None or _DEFAULT.path != default_cache_path():
            _DEFAULT = PlanCache()
        return _DEFAULT
